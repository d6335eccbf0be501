"""The port's serving daemon as OS processes, on the CPU
(``python -m hpmn_tpu_torch.tools.serve --device cpu`` and
``tools.serve_fleet``): the cases of tests/test_server.py that start the
daemon (--save_on_exit, two models saved from one bundle path, the
journal replayed after a SIGKILL, the fleet of shards), and the port's own
flags: --warmup, --aot, and the refusals (--compilation_cache,
--aot --device_resident, and no card without --device cpu).

Tolerances: a daemon's scores against the same bundle's store in this
process, 1e-6 (tests/test_server.py's).
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpmn_tpu_torch import configs
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.serving import UserMemoryStore, load_bundle
from hpmn_tpu_torch.serving.client import ServingClient
from hpmn_tpu_torch.serving.journal import UpdateJournal
from hpmn_tpu_torch.serving.sharded import ShardedServingClient
from hpmn_tpu_torch.serving import server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITEMS, N_CATS = 200, 20
TOL = 1e-6


def _bundle(tmp_path, n_users=5, T=9, export_compiled=False):
    """A taobao_hpmn bundle of users 1..n_users with T events each -> (its
    directory, the store it was saved from)."""
    cfg = configs.get_config("taobao_hpmn")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=0, device="cpu")
    store = UserMemoryStore(cfg, model, device="cpu")
    rng = np.random.default_rng(3)
    uids = np.arange(1, n_users + 1, dtype=np.int32)
    items = rng.integers(1, N_ITEMS, size=(n_users, T)).astype(np.int32)
    store.ingest_histories(uids, items, items % N_CATS)
    bundle = tmp_path / "bundle"
    store.save_bundle(str(bundle), export_compiled=export_compiled,
                      export_platforms=("cpu",))
    return bundle, store


def _launch(*args):
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "hpmn_tpu_torch.tools.serve", *args,
         "--port", "0", "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _ready(proc):
    """Read the daemon's lines up to its ready line -> (host, port, the
    lines read)."""
    lines = []
    while True:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        lines.append(line)
        if "serving bundle" in line:
            host, port = line.split(" on ")[1].split()[0].rsplit(":", 1)
            return host, int(port), lines


def _stop(proc, sig=signal.SIGTERM):
    proc.send_signal(sig)
    try:
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_daemon_cli(tmp_path):
    """bundle -> daemon (--warmup) -> predict/update -> SIGTERM with
    --save_on_exit persists the advanced memories."""
    bundle, store = _bundle(tmp_path)
    uids = np.arange(1, 6, dtype=np.int32)
    proc = _launch("--bundle", str(bundle), "--save_on_exit", "--warmup",
                   "--max_batch", "8")
    try:
        host, port, lines = _ready(proc)
        assert any("warmed predict buckets 1..8" in s for s in lines)
        assert "device=cpu" in lines[-1]
        with ServingClient(host, port, timeout_s=120) as cl:
            s = cl.predict(uids, uids % N_ITEMS, uids % N_CATS)
            np.testing.assert_allclose(
                s, store.predict(uids, uids % N_ITEMS, uids % N_CATS),
                atol=TOL)
            cl.update(uids, uids % N_ITEMS, uids % N_CATS)
            assert cl.stats()["n_users"] == 5  # warm-up created none
        assert _stop(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    back = load_bundle(str(bundle), device="cpu")
    np.testing.assert_array_equal(back._gather(uids)[1].numpy(), 10)


def test_save_on_exit_duplicate_bundle_paths_do_not_clobber(tmp_path):
    """A canary reloaded from the bundle that serves default: on
    --save_on_exit default keeps the path, the canary goes to
    <bundle>.canary, and both models' memories survive."""
    bundle, _ = _bundle(tmp_path)
    uids = np.arange(1, 6, dtype=np.int32)
    items = (uids * 3 % N_ITEMS).astype(np.int32)
    proc = _launch("--bundle", str(bundle), "--save_on_exit")
    try:
        host, port, _ = _ready(proc)
        with ServingClient(host, port, timeout_s=120) as cl:
            cl.reload(str(bundle), model="canary")
            cl.update(uids, items, items % N_CATS)
            cl.update(uids, items, items % N_CATS, model="canary")
            cl.update(uids, (items + 1) % N_ITEMS, (items + 1) % N_CATS,
                      model="canary")
        _stop(proc)
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "shares a bundle path" in out, out
    back = load_bundle(str(bundle), device="cpu")
    np.testing.assert_array_equal(back._gather(uids)[1].numpy(), 10)
    canary = load_bundle(f"{bundle}.canary", device="cpu")
    np.testing.assert_array_equal(canary._gather(uids)[1].numpy(), 11)


def test_daemon_crash_replays_journal(tmp_path):
    """SIGKILL after accepted updates; a restart on the same bundle and
    journal replays them; bundle + journal offline give the same
    counters."""
    bundle, _ = _bundle(tmp_path)
    uids = np.arange(1, 6, dtype=np.int32)
    jrnl = str(tmp_path / "updates.jrnl")
    proc = _launch("--bundle", str(bundle), "--journal", jrnl)
    try:
        host, port, _ = _ready(proc)
        with ServingClient(host, port, timeout_s=120) as cl:
            cl.update(uids, uids % N_ITEMS, uids % N_CATS)
            cl.update(uids[:2], uids[:2] % N_ITEMS, uids[:2] % N_CATS)
        _stop(proc, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
    proc = _launch("--bundle", str(bundle), "--journal", jrnl)
    try:
        host, port, lines = _ready(proc)
        assert any("replayed 7 journaled events" in s for s in lines), lines
        with ServingClient(host, port, timeout_s=120) as cl:
            assert cl.stats()["n_users"] == 5
            got = cl.predict(uids, uids, uids % N_CATS)
        _stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    back = load_bundle(str(bundle), device="cpu")
    for u, i, c in UpdateJournal.replay(jrnl):
        back.update(u, i, c)
    np.testing.assert_array_equal(back._gather(uids)[1].numpy(),
                                  [11, 11, 10, 10, 10])
    np.testing.assert_allclose(got, back.predict(uids, uids, uids % N_CATS),
                               atol=TOL)


def test_serve_fleet_cli(tmp_path):
    """serve_fleet: 2 shards on ephemeral ports, the FLEET ready line,
    sticky placement, per-shard journals, and SIGTERM stops the fleet
    with exit code 0."""
    bundle, store = _bundle(tmp_path, n_users=8)
    uids = np.arange(1, 9, dtype=np.int32)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "hpmn_tpu_torch.tools.serve_fleet",
         "--bundle", str(bundle), "--shards", "2", "--base_port", "0",
         "--device", "cpu", "--journal_dir", str(tmp_path / "journals")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        start_new_session=True)  # its own group: the shards die with it
    try:
        addrs = None
        for _ in range(50):
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            if line.startswith("FLEET ready:"):
                addrs = [(h, int(p)) for h, p in
                         (a.rsplit(":", 1)
                          for a in line.split(":", 1)[1].split())]
                break
        assert addrs and len(addrs) == 2, addrs
        cand = (uids * 7 % N_ITEMS).astype(np.int32)
        ccat = (cand % N_CATS).astype(np.int32)
        with ShardedServingClient(addrs, timeout_s=120) as cl:
            np.testing.assert_allclose(cl.predict(uids, cand, ccat),
                                       store.predict(uids, cand, ccat),
                                       atol=TOL)
            cl.update(uids, cand, ccat)
            store.update(uids, cand, ccat)
            np.testing.assert_allclose(cl.predict(uids, cand, ccat),
                                       store.predict(uids, cand, ccat),
                                       atol=TOL)
        # every shard loaded the whole bundle; each journaled only the
        # updates of its own users (uid % 2)
        jdir = tmp_path / "journals"
        assert sorted(os.listdir(jdir)) == ["shard_0.journal",
                                            "shard_1.journal"]
        for i in range(2):
            (rec,) = UpdateJournal.replay(str(jdir / f"shard_{i}.journal"))
            np.testing.assert_array_equal(rec[0], uids[uids % 2 == i])
        assert _stop(proc) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def test_aot_daemon_cli(tmp_path):
    """serve --aot on a bundle with exported graphs: the daemon's scores
    are the eager store's on the same bundle."""
    bundle, _ = _bundle(tmp_path, export_compiled=True)
    eager = load_bundle(str(bundle), device="cpu")
    uids = np.arange(1, 7, dtype=np.int32)  # 6: new to the bundle
    cand = (uids * 5 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    ci2 = np.stack([cand, (cand + 1) % N_ITEMS, (cand + 2) % N_ITEMS], 1)
    proc = _launch("--bundle", str(bundle), "--aot", "--warmup",
                   "--max_batch", "4")
    try:
        host, port, lines = _ready(proc)
        assert "aot" in lines[-1]
        with ServingClient(host, port, timeout_s=120) as cl:
            np.testing.assert_allclose(cl.predict(uids, cand, ccat),
                                       eager.predict(uids, cand, ccat),
                                       atol=TOL)
            np.testing.assert_allclose(cl.rank(uids, ci2, ci2 % N_CATS),
                                       eager.rank(uids, ci2, ci2 % N_CATS),
                                       atol=TOL)
            cl.update(uids, cand, ccat)
            eager.update(uids, cand, ccat)
            np.testing.assert_allclose(cl.predict(uids, ccat, ccat),
                                       eager.predict(uids, ccat, ccat),
                                       atol=TOL)
        _stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_refused_flags(tmp_path, capsys):
    """--compilation_cache (a jit cache the port has not) and --aot with
    --device_resident (as the JAX daemon) end with a usage error; without
    a card the daemon raises unless told --device cpu."""
    for extra in (["--compilation_cache", str(tmp_path)],
                  ["--aot", "--device_resident"]):
        with pytest.raises(SystemExit) as e:
            server.main(["--bundle", str(tmp_path), "--device", "cpu",
                         *extra])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "jit cache" in err and "drop --device_resident" in err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="serving daemon runs on the"):
            server.main(["--bundle", str(tmp_path)])
