"""Online serving daemon: a TCP front end and a micro-batching dispatcher
over the port's stores — counterpart of ``hpmn_tpu/serving/server.py``,
with its frame protocol, its batching and its command line, so the JAX
package's client talks to this daemon and this package's client to the
JAX daemon.

- **MicroBatcher**: concurrent client requests land in a queue; one
  dispatcher thread drains up to ``max_batch`` of them (waiting at most
  ``max_wait_ms`` after the first), groups them by kind, concatenates,
  and runs each group as ONE store call. Each store call pays a host cost
  of its own (the kernels' launches, the ids up and the scores down), so
  fusing many small requests into one call is what the batcher buys. The
  one dispatcher thread also makes the store's mutation path race-free:
  every kernel launch and arena write happens on that thread.

- **Shape buckets**: fused batches are padded up to power-of-two sizes,
  so the AOT store's graphs and the kernels see few distinct shapes.
  predict/rank pads replicate the first request row (its scores are
  discarded on split); update pads replicate the first (uid, event) row
  WHOLE, which is exact because the store gathers all rows before writing
  any: duplicates of one pair collapse to a single application, so
  padding never applies an event twice and no sentinel user exists to
  evict or persist. The same gather-before-write fact means one fused
  batch must not carry two DIFFERENT events for one uid; updates split
  greedily into conflict-free sub-batches. rank groups also key on the
  candidate count C.

- **Frame protocol**: length-prefixed JSON, a 4-byte big-endian length
  and a UTF-8 JSON object per message, both directions. Methods:
  ``predict`` (uids, cand_items, cand_cats -> scores [B]), ``rank``
  ([B, C] candidates -> scores [B, C]), ``update`` (uids, item_ids,
  cat_ids; ack), ``stats`` (the batcher's counts, latency percentiles,
  users per model, and this process's kernel launches), ``reload`` (a
  bundle path; the store is swapped with no downtime). Every request may
  carry a ``model`` field to address a named store of a multi-model
  daemon (``--extra_bundle``). ``serving.client.ServingClient`` is the
  matching client.

Responses keep their order per connection (each connection's handler
blocks on its request's future), and a client's update->predict sequence
observes the update because the dispatcher drains the queue in FIFO group
order (updates queued before a predict are flushed in the same or an
earlier drain cycle; within a cycle groups run update, then reload, then
predict/rank).

The daemon (:func:`main`, ``python -m hpmn_tpu_torch.tools.serve``) runs
on the card (``--device``, default ``cuda``) and raises when there is no
card; ``--device cpu`` (or ``--force_cpu``) serves on the CPU. ``--aot``
serves a bundle's exported graphs (``serving/aot.py``).
"""

from __future__ import annotations

import json
import os
import queue
import socket
import socketserver
import struct
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

_HDR = struct.Struct(">I")
_MAX_FRAME = 64 << 20


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (length,) = _HDR.unpack(hdr)
    if length > _MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    body = _recv_exact(sock, length)
    if body is None:
        return None
    return json.loads(body.decode("utf-8"))


def write_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj).encode("utf-8")
    sock.sendall(_HDR.pack(len(body)) + body)


def _bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n. Always rounds up: max_batch caps the
    REQUEST count per drain, but fused ROW counts can exceed it (many
    multi-row requests), and exact sizes there would give every distinct
    total a shape of its own. max_batch is not in the math; it stays in
    the signature for the JAX package's callers."""
    del max_batch
    b = 1
    while b < n:
        b <<= 1
    return b


class MicroBatcher:
    """Queue + dispatcher thread fusing concurrent requests into batched
    store calls. ``submit`` returns a Future resolved with the request's
    slice of the fused result (or an exception)."""

    def __init__(self, store, max_batch: int = 256, max_wait_ms: float = 2.0,
                 journal=None, loader=None, bundles=None,
                 journal_factory=None):
        # Multi-model serving: `store` may be one store (named "default")
        # or a dict {name: store} — requests route by their optional
        # "model" field (A/B tests, canaries, one daemon per host).
        # `journal` correspondingly is one journal (for "default") or a
        # dict {name: journal}.
        self.stores = store if isinstance(store, dict) else {"default": store}
        self.store = self.stores.get("default",
                                     next(iter(self.stores.values())))
        self.journals = (journal if isinstance(journal, dict)
                         else {"default": journal})
        self.journal = self.journals.get("default")
        self.loader = loader  # bundle path -> store (reload support)
        # name -> bundle path, kept CURRENT across reloads so persistence
        # (--save_on_exit) writes each store's memories next to the params
        # it actually served — never back into a superseded bundle.
        self.bundles: Dict[str, str] = dict(bundles or {})
        # name -> new UpdateJournal; lets a reload that introduces a new
        # model name get write-ahead logging like the startup models.
        self.journal_factory = journal_factory
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "fused_rows": 0,
                      "padded_rows": 0}
        import collections

        self._lat = collections.deque(maxlen=4096)  # recent latencies (s)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-dispatcher")
        self._thread.start()

    def submit(self, method: str, payload: dict) -> Future:
        fut: Future = Future()
        fut._t0 = _now()  # queue-to-resolution latency, read in _run_group
        self._q.put((method, payload, fut))
        return fut

    def latency_ms(self) -> dict:
        """Recent request-latency percentiles (queue wait + fused compute)."""
        if not self._lat:
            return {"n": 0}
        lat = np.sort(np.asarray(self._lat)) * 1e3
        pick = lambda q: float(lat[min(len(lat) - 1, int(q * len(lat)))])
        return {"n": len(lat), "p50": round(pick(0.50), 2),
                "p95": round(pick(0.95), 2), "p99": round(pick(0.99), 2)}

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the dispatcher; it drains the queue first
        self._thread.join(timeout=60)

    # ---------------------------------------------------- dispatcher ----

    def _drain(self) -> List[Tuple[str, dict, Future]]:
        """Block for the first request, then collect more until max_batch
        requests are pending or max_wait_ms passed."""
        try:
            first = self._q.get(timeout=0.25)
        except queue.Empty:
            return []
        if first is None:
            return []
        items = [first]
        deadline = _now() + self.max_wait_s
        while len(items) < self.max_batch:
            remaining = deadline - _now()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self) -> None:
        while True:
            items = self._drain()
            if not items:
                # On shutdown keep draining until the queue is empty so
                # accepted requests (e.g. updates a client was promised)
                # complete before close() returns and --save_on_exit
                # persists (tested: no dropped futures on SIGTERM).
                if self._stop.is_set():
                    return
                continue
            groups: Dict[tuple, List[Tuple[dict, Future]]] = {}
            order: List[tuple] = []
            for method, payload, fut in items:
                try:
                    # Parses untrusted payload — a malformed request must
                    # fail ITS future, never the dispatcher thread.
                    key = self._group_key(method, payload)
                except Exception as e:
                    fut.set_exception(
                        ValueError(f"malformed {method} payload: {e}"))
                    continue
                if key not in groups:
                    groups[key] = []
                    order.append(key)
                groups[key].append((payload, fut))
            # updates first so same-cycle predicts observe queued events;
            # reloads after updates (pending writes land on the store that
            # accepted them) and before reads
            order.sort(key=lambda k: {"update": 0, "reload": 1}.get(k[0], 2))
            for key in order:
                self._run_group(key, groups[key])

    def _group_key(self, method: str, payload: dict) -> tuple:
        model = payload.get("model") or "default"
        if method == "reload":
            # reload may introduce a NEW model name; no existence check
            return ("reload", model, payload.get("_seq", id(payload)))
        if model not in self.stores:
            raise ValueError(f"unknown model {model!r}; serving "
                             f"{sorted(self.stores)}")
        if method == "rank":
            c = len(payload["cand_items"][0]) if payload["cand_items"] else 0
            return ("rank", model, c)
        return (method, model)

    def _run_group(self, key: tuple,
                   reqs: List[Tuple[dict, Future]]) -> None:
        method = key[0]
        try:
            results = self._execute(key, reqs)
        except Exception as e:  # surface to every caller, keep serving
            for _, fut in reqs:
                if not fut.done():
                    fut.set_exception(e)
            return
        t1 = _now()
        for (_, fut), res in zip(reqs, results):
            fut.set_result(res)
            self._lat.append(t1 - getattr(fut, "_t0", t1))

    @staticmethod
    def _conflict_free(reqs):
        """Greedy split of update requests into sub-batches where no uid
        repeats (FIFO order preserved within each user's stream: a request
        bumped to a later sub-batch still executes after the earlier one)."""
        batches: List[Tuple[list, set]] = []
        for item in reqs:
            us = set(int(u) for u in item[0]["uids"])
            for sub, seen in batches:
                if not (us & seen):
                    sub.append(item)
                    seen |= us
                    break
            else:
                batches.append(([item], us))
        return [sub for sub, _ in batches]

    def _run_update(self, reqs: List[Tuple[dict, Future]],
                    model: str = "default") -> None:
        store = self.stores[model]
        journal = self.journals.get(model)
        uids = np.concatenate(
            [np.asarray(r["uids"], np.int32) for r, _ in reqs])
        items = np.concatenate(
            [np.asarray(r["item_ids"], np.int32) for r, _ in reqs])
        cats = np.concatenate(
            [np.asarray(r["cat_ids"], np.int32) for r, _ in reqs])
        n = uids.shape[0]
        if journal is not None:
            # Write-ahead: persist the accepted events BEFORE applying, so
            # a crash between here and the arena write replays them.
            journal.append(uids, items, cats)
        pad = _bucket(n, self.max_batch) - n
        if pad:
            # Replicate the first row WHOLE (uid + event). Exact: the
            # store gathers all rows before writing, so duplicates of one
            # (uid, event) pair collapse to a single application — no
            # sentinel user, nothing to evict or persist.
            uids = np.concatenate([uids, np.repeat(uids[:1], pad)])
            items = np.concatenate([items, np.repeat(items[:1], pad)])
            cats = np.concatenate([cats, np.repeat(cats[:1], pad)])
        self.stats["requests"] += len(reqs)
        self.stats["batches"] += 1
        self.stats["fused_rows"] += n
        self.stats["padded_rows"] += pad
        store.update(uids, items, cats)

    def _execute(self, key: tuple,
                 reqs: List[Tuple[dict, Future]]) -> List[object]:
        method, model = key[0], key[1]
        if method == "reload":
            # Zero-downtime model refresh: runs ON the dispatcher thread,
            # so the swap serializes with every fused batch — requests
            # queued behind it simply observe the new store. The load
            # itself blocks dispatch for its duration (seconds); queued
            # requests wait, none drop.
            if self.loader is None:
                raise ValueError("daemon has no bundle loader configured "
                                 "(in-process ServingServer: pass loader=)")
            out = []
            for r, _ in reqs:
                new_model = model not in self.stores
                self.stores[model] = self.loader(r["bundle"])
                self.bundles[model] = r["bundle"]
                if model == "default":
                    self.store = self.stores[model]
                if new_model and self.journal_factory is not None:
                    self.journals[model] = self.journal_factory(model)
                j = self.journals.get(model)
                if j is not None:
                    # the new bundle is the new ground truth; journaled
                    # events (incl. a stale file left by a previously
                    # added model of the same name) predate it and must
                    # not replay over it
                    j.truncate()
                out.append({"ok": True,
                            "n_users": self.stores[model].n_users})
            return out
        store = self.stores[model]
        if method == "update":
            # A fused update batch must not contain the same uid twice:
            # the store gathers all rows BEFORE writing any, so two events
            # for one user would collapse to one (last write wins). Split
            # the requests greedily into conflict-free sub-batches.
            for sub in self._conflict_free(reqs):
                self._run_update(sub, model)
            return [{"ok": True} for _ in reqs]

        sizes = [len(r["uids"]) for r, _ in reqs]
        uids = np.concatenate(
            [np.asarray(r["uids"], np.int32) for r, _ in reqs])
        n = uids.shape[0]
        b = _bucket(n, self.max_batch)
        pad = b - n
        self.stats["requests"] += len(reqs)
        self.stats["batches"] += 1
        self.stats["fused_rows"] += n
        self.stats["padded_rows"] += pad

        def cat(field, pad_row):
            a = np.concatenate(
                [np.asarray(r[field], np.int32) for r, _ in reqs])
            if pad:
                a = np.concatenate([a, np.broadcast_to(
                    pad_row, (pad,) + a.shape[1:]).astype(np.int32)])
            return a

        if pad:  # replicate row 0; its scores are sliced away below
            uids = np.concatenate([uids, np.repeat(uids[:1], pad)])
        if method == "predict":
            items = cat("cand_items", np.int32(0))
            cats = cat("cand_cats", np.int32(0))
            scores = np.asarray(store.predict(uids, items, cats))
        elif method == "rank":
            first = np.asarray(reqs[0][0]["cand_items"], np.int32)
            pad_row = np.zeros((first.shape[1],), np.int32)
            items = cat("cand_items", pad_row)
            cats = cat("cand_cats", pad_row)
            scores = np.asarray(store.rank(uids, items, cats))
        else:
            raise ValueError(f"unknown method {method!r}")
        out, off = [], 0
        for s in sizes:
            out.append(scores[off:off + s].tolist())
            off += s
        return out


def kernel_launches() -> Dict[str, int]:
    """This process's launches of the kernels that serving runs so far:
    K1 (``gru_scan_fwd``, every form) and K5 (``readout_fwd``). A client
    reads them through ``stats`` to see that its requests went through
    the kernels (they stay 0 on the CPU, where the plain versions run)."""
    from ..ops import cuda_gru, cuda_readout

    return {"gru_scan_fwd": cuda_gru.launches,
            "gru_scan_fwd_bf16": cuda_gru.launches_bf16,
            "gru_scan_fwd_scale": cuda_gru.launches_scale,
            "gru_scan_fwd_scale_bf16": cuda_gru.launches_scale_bf16,
            "readout_fwd": cuda_readout.launches}


def _now() -> float:
    import time

    return time.monotonic()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        srv: "ServingServer" = self.server.owner  # type: ignore[attr-defined]
        while True:
            try:
                msg = read_frame(self.request)
            except (ValueError, ConnectionError, OSError):
                return
            if msg is None:
                return
            rid = msg.get("id")
            method = msg.get("method", "")
            try:
                if method == "stats":
                    # list() snapshots the dict atomically — a concurrent
                    # reload on the dispatcher thread may insert a new
                    # model name mid-request.
                    resp = {"ok": True, "stats": dict(srv.batcher.stats),
                            "latency_ms": srv.batcher.latency_ms(),
                            "n_users": srv.store.n_users,
                            "models": {name: st.n_users for name, st
                                       in list(srv.stores.items())},
                            "launches": kernel_launches()}
                elif method in ("predict", "rank", "update", "reload"):
                    fut = srv.batcher.submit(method, msg)
                    res = fut.result(timeout=srv.request_timeout_s)
                    if method in ("predict", "rank"):
                        resp = {"ok": True, "scores": res}
                    elif method == "reload":
                        resp = res  # {"ok": True, "n_users": ...}
                    else:
                        resp = {"ok": True}
                else:
                    resp = {"ok": False, "error": f"unknown method "
                                                  f"{method!r}"}
            except Exception as e:
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if rid is not None:
                resp["id"] = rid
            try:
                write_frame(self.request, resp)
            except (ConnectionError, OSError):
                return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ServingServer:
    """Threaded TCP serving daemon over one or more UserMemoryStores.

    Usage::

        with ServingServer(store, port=0) as srv:
            client = ServingClient("127.0.0.1", srv.port)
            scores = client.predict(uids, items, cats)

    Multi-model (A/B, canary): pass ``store={"default": a, "candidate": b}``
    (and optionally ``journal={name: journal}``); clients address models
    with the request's ``model`` field (``ServingClient(...).predict(...,
    model="candidate")``).
    """

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 request_timeout_s: float = 60.0, journal=None,
                 loader=None, bundles=None, journal_factory=None):
        self.batcher = MicroBatcher(store, max_batch, max_wait_ms,
                                    journal=journal, loader=loader,
                                    bundles=bundles,
                                    journal_factory=journal_factory)
        self.stores = self.batcher.stores
        self.request_timeout_s = request_timeout_s
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.owner = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="serving-acceptor")
        self._thread.start()

    @property
    def store(self):
        """The live default-model store. A property (not a snapshot) so a
        zero-downtime ``reload`` is observed here too — and so this object
        holds no reference pinning a superseded arena in memory."""
        return self.batcher.store

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        self.batcher.close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ServingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv=None) -> None:
    """Daemon CLI (also ``python -m hpmn_tpu_torch.tools.serve``): load a
    bundle, listen, serve; ``--save_on_exit`` persists the advanced
    memories back into the bundle on SIGINT/SIGTERM."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7600)
    ap.add_argument("--device", default="cuda",
                    help="where the stores run: cuda (default), cuda:N or "
                         "cpu")
    ap.add_argument("--device_resident", action="store_true",
                    help="accepted for the JAX command line; changes "
                         "nothing: the port's arena always lives on "
                         "--device")
    ap.add_argument("--arena_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="memory-arena storage dtype; bfloat16 halves the "
                         "per-user bytes (compute stays f32)")
    ap.add_argument("--max_batch", type=int, default=256)
    ap.add_argument("--max_score_rows", type=int, default=8192,
                    help="history-store bound on one scoring dispatch "
                         "(rank flattens B*C rows; larger requests are "
                         "chunked server-side; peak activation ~ rows*W)")
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--save_on_exit", action="store_true")
    ap.add_argument("--journal", default="",
                    help="write-ahead update log (serving/journal.py): "
                         "replayed over the bundle on startup, so a "
                         "crashed daemon loses no accepted updates; "
                         "truncated after --save_on_exit snapshots")
    ap.add_argument("--extra_bundle", action="append", default=[],
                    metavar="NAME=PATH",
                    help="serve additional models from the same daemon "
                         "(A/B / canary); clients address them with the "
                         "request's 'model' field. Repeatable. Each extra "
                         "model journals to <--journal>.<NAME> and "
                         "save_on_exit snapshots into its own bundle dir")
    ap.add_argument("--aot", action="store_true",
                    help="serve the bundle's exported graphs "
                         "(save_bundle(export_compiled=True), "
                         "export_bundle --export_compiled): no model code")
    ap.add_argument("--compilation_cache", default="",
                    help="the JAX daemon's jit cache; the port has none "
                         "and refuses the flag")
    ap.add_argument("--warmup", action="store_true",
                    help="load the kernels' library and run the predict "
                         "path at every power-of-two batch bucket up to "
                         "max_batch before accepting connections (cold-"
                         "start reads of unknown users: no state is "
                         "created)")
    ap.add_argument("--force_cpu", action="store_true",
                    help="the same as --device cpu")
    args = ap.parse_args(argv)

    if args.compilation_cache:
        ap.error("--compilation_cache names a jit cache; the port runs "
                 "eager PyTorch and hand-written kernels and has none")
    if args.aot and args.device_resident:
        ap.error("--aot serves the host arena; drop --device_resident")

    from ..train.train import resolve_device

    device = resolve_device("cpu" if args.force_cpu else args.device,
                            "the serving daemon")

    def load(path):
        if args.aot:
            from .aot import load_aot_store

            return load_aot_store(path, device=device,
                                  arena_dtype=args.arena_dtype,
                                  max_score_rows=args.max_score_rows)
        # Dispatch on the bundle's store kind: "memory" (the O(1) arena)
        # or "history" (DIEN's recent-window re-encode store).
        from .history import load_bundle

        return load_bundle(path, device=device,
                           arena_dtype=args.arena_dtype,
                           max_score_rows=args.max_score_rows)

    bundles = {"default": args.bundle}
    for spec in args.extra_bundle:
        name, _, path = spec.partition("=")
        if not path or name in bundles:
            ap.error(f"--extra_bundle wants NAME=PATH with a fresh name, "
                     f"got {spec!r}")
        bundles[name] = path
    stores = {name: load(path) for name, path in bundles.items()}
    journals = {}
    journal_factory = None
    if args.journal:
        from .journal import UpdateJournal

        def _jpath(name):
            return (args.journal if name == "default"
                    else f"{args.journal}.{name}")

        # A reload that introduces a NEW model name gets write-ahead
        # logging too (the dispatcher truncates it: journaled events
        # predate the fresh bundle).
        journal_factory = lambda name: UpdateJournal(_jpath(name))
        for name, st in stores.items():
            replayed = 0
            for uids, items, cats in UpdateJournal.replay(_jpath(name)):
                st.update(uids, items, cats)
                replayed += len(uids)
            journals[name] = UpdateJournal(_jpath(name))
            if replayed:
                print(f"replayed {replayed} journaled events"
                      + (f" for model {name}" if name != "default" else ""),
                      flush=True)
        # Journals of models added by `reload` in an earlier life of the
        # daemon are replayed only if the operator registers the model
        # again with --extra_bundle; say so loudly, so that their events
        # are not stranded (or truncated unreplayed if the name comes back
        # through reload).
        import glob as _glob

        from .journal import MAGIC

        for orphan in sorted(_glob.glob(args.journal + ".*")):
            name = orphan[len(args.journal) + 1:]
            # A truncated journal is just the MAGIC header (save_on_exit
            # truncates, never deletes): zero events, nothing stranded.
            if (name and name not in stores
                    and os.path.getsize(orphan) > len(MAGIC)):
                print(f"warning: journal {orphan} belongs to model "
                      f"{name!r}, which is not configured; its events "
                      f"will NOT be replayed. Re-register the model with "
                      f"--extra_bundle {name}=PATH to replay it.",
                      flush=True)
    if args.warmup:
        if device.type == "cuda":
            from ..ops import _build

            _build.load_library()  # nvcc at first use, before serving
        from .lifelong import reads_user_ids

        top = _bucket(args.max_batch, 0)
        for st in stores.values():
            # Unknown users read the cold-start state and create none; a
            # store that reads a table by uid (the user table, SVD++'s
            # p_u) needs a real row.
            uid = 0 if reads_user_ids(st.cfg) else -1
            b = 1
            while b <= top:
                u = np.full((b,), uid, np.int64)
                ones = np.ones((b,), np.int32)
                st.predict(u, ones, ones)
                b <<= 1
        print(f"warmed predict buckets 1..{top}", flush=True)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    with ServingServer(stores, host=args.host, port=args.port,
                       max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms,
                       journal=journals, loader=load, bundles=bundles,
                       journal_factory=journal_factory) as srv:
        extra = (f" + models {sorted(set(stores) - {'default'})}"
                 if len(stores) > 1 else "")
        print(f"serving bundle {args.bundle} on {srv.host}:{srv.port} "
              f"(n_users={srv.store.n_users}, device={device}"
              f"{', aot' if args.aot else ''}){extra}", flush=True)
        done.wait()
        if args.save_on_exit:
            srv.batcher.close()  # flush queued updates before persisting
            # The batcher's store and bundle maps are the live ones:
            # reloads swap stores, point each name at the bundle it
            # actually served, and may have added model names.
            live = srv.batcher
            # Two names can point at one bundle path (a canary reloaded
            # FROM the bundle that serves default). Saving both there
            # would let the last writer clobber the first and then
            # truncate BOTH journals, losing the overwritten model's
            # memories since the snapshot. Every name after the first
            # claimant goes to a per-model path instead.
            claimed = {}
            saved_to = {}
            for name in sorted(live.stores,
                               key=lambda n: (n != "default", n)):
                shared = live.bundles[name]
                # Key on the real path: './bundle', 'bundle/' and an
                # absolute spelling are one directory.
                shared_key = os.path.realpath(shared)
                if shared_key in claimed:
                    # From a normalized spelling: a trailing slash would
                    # nest 'bundle/.canary' INSIDE the shared bundle.
                    path = shared.rstrip(os.sep) + f".{name}"
                    print(f"warning: model {name!r} shares a bundle path "
                          f"with {claimed[shared_key]!r}; saving it "
                          f"to {path} instead (re-register it with "
                          f"--extra_bundle {name}={path})", flush=True)
                    # Seed the path with the shared bundle's params and
                    # config so it loads on its own; save() below
                    # replaces the memory snapshot with THIS model's.
                    import shutil
                    shutil.copytree(shared, path, dirs_exist_ok=True)
                else:
                    claimed[shared_key] = name
                    path = shared
                saved_to[name] = path
            for name, st in list(live.stores.items()):
                st.save(saved_to[name])
                if live.journals.get(name) is not None:
                    live.journals[name].truncate()  # the snapshot has them
            print("saved memories back to "
                  + ", ".join(sorted(set(saved_to.values()))), flush=True)


if __name__ == "__main__":
    main()
