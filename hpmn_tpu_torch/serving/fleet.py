"""Fleet launcher: N uid-hash shard daemons from one command —
counterpart of ``hpmn_tpu/serving/fleet.py``.

    python -m hpmn_tpu_torch.tools.serve_fleet --bundle DIR --shards N
        [--base_port 7600] [--host 127.0.0.1] [--journal_dir DIR] [--aot]
        [--device cuda|cuda:N|cpu] [--force_cpu] [--max_batch 256]
        [--max_wait_ms 2.0] [--device_resident] [--arena_dtype float32]

Scale-out needs no coordination between shards (serving/sharded.py:
per-user state, sticky ``uid % N`` placement), so a fleet is N daemons
(``serving/server.py``) on consecutive ports with the same bundle. This
launcher starts them, waits until every shard reports ready, prints one
machine-readable line

    FLEET ready: host:port host:port ...

(the address list ``ShardedServingClient`` takes), prefixes and relays
each shard's log lines, forwards SIGTERM/SIGINT to the whole fleet, and
exits with the worst shard exit code. ``--device`` goes to every shard:
on a machine with one card every shard shares ``cuda:0``.

Durability: ``--journal_dir`` gives each shard its own write-ahead log
(``shard_<i>.journal``); on restart with the same N, each shard replays
exactly its own users' events. ``--save_on_exit`` is NOT offered here:
all shards share one bundle directory, and N last-writer-wins snapshots
of ``user_memory.npz`` would silently drop N-1 shards' users; journals
are the fleet's persistence.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
from typing import List


def _relay(proc: subprocess.Popen, idx: int, ready: threading.Event,
           addr: List[str]) -> None:
    """Mirror one shard's stdout with a shard prefix; capture the actual
    listen address from its ready line (so --base_port 0 works: every
    shard binds an ephemeral port, and fleets never collide)."""
    for line in proc.stdout:  # type: ignore[union-attr]
        if "serving bundle" in line and " on " in line:
            # rsplit: the bundle PATH may itself contain " on "
            addr.append(line.rsplit(" on ", 1)[1].split()[0])
            ready.set()
        print(f"[shard {idx}] {line}", end="", flush=True)
    ready.set()  # EOF: either way, stop waiting on this shard


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--shards", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--base_port", type=int, default=7600)
    ap.add_argument("--journal_dir", default="",
                    help="per-shard write-ahead logs (shard_<i>.journal)")
    ap.add_argument("--max_batch", type=int, default=256)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--device_resident", action="store_true")
    ap.add_argument("--arena_dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--aot", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="every shard's device: cuda (default), cuda:N or "
                         "cpu")
    ap.add_argument("--force_cpu", action="store_true")
    ap.add_argument("--ready_timeout_s", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.shards < 1:
        ap.error("--shards must be >= 1")

    # base_port 0: every shard binds an ephemeral port (collision-free);
    # otherwise consecutive ports from base_port.
    # Children must import the package even when the launcher ran from a
    # checkout without pip install: propagate the package's parent dir.
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = (
        pkg_root + os.pathsep + child_env["PYTHONPATH"]
        if child_env.get("PYTHONPATH") else pkg_root)

    ports = [0 if args.base_port == 0 else args.base_port + i
             for i in range(args.shards)]
    procs: List[subprocess.Popen] = []
    readies: List[threading.Event] = []
    addrs: List[List[str]] = []
    for i, port in enumerate(ports):
        cmd = [sys.executable, "-u", "-m", "hpmn_tpu_torch.serving.server",
               "--bundle", args.bundle, "--host", args.host,
               "--port", str(port), "--max_batch", str(args.max_batch),
               "--max_wait_ms", str(args.max_wait_ms),
               "--arena_dtype", args.arena_dtype, "--device", args.device]
        if args.journal_dir:
            os.makedirs(args.journal_dir, exist_ok=True)
            cmd += ["--journal",
                    os.path.join(args.journal_dir, f"shard_{i}.journal")]
        for flag in ("device_resident", "aot", "force_cpu"):
            if getattr(args, flag):
                cmd.append("--" + flag)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=child_env)
        ev: threading.Event = threading.Event()
        captured: List[str] = []
        threading.Thread(target=_relay, args=(proc, i, ev, captured),
                         daemon=True).start()
        procs.append(proc)
        readies.append(ev)
        addrs.append(captured)

    failed = []

    def _forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _forward)

    for i, ev in enumerate(readies):
        if not ev.wait(timeout=args.ready_timeout_s):
            print(f"FLEET error: shard {i} not ready within "
                  f"{args.ready_timeout_s}s; terminating", flush=True)
            failed.append(i)
            _forward(None, None)
            break
        if not addrs[i] or procs[i].poll() is not None:
            print(f"FLEET error: shard {i} exited "
                  f"{procs[i].returncode} during startup; terminating",
                  flush=True)
            failed.append(i)
            _forward(None, None)
            break
    else:
        print("FLEET ready: " + " ".join(a[0] for a in addrs), flush=True)

    codes = [p.wait() for p in procs]
    # A startup failure must show in the exit code: SIGTERM'd shards exit
    # 0 (a graceful shutdown), so their codes alone would report success
    # for a fleet that never came up.
    sys.exit(max([abs(c) for c in codes] + ([1] if failed else [])))


if __name__ == "__main__":
    main()
