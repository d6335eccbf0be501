"""The port's serving daemon in one process, on the CPU: the cases of
tests/test_server.py (frames, the MicroBatcher's fusion, padding and
conflict-free update splits, the client, shards, the journal, several
models, reload, warm-up reads, garbage on the wire) against the port's
stores on ``device="cpu"``, DIEN's history store through the daemon, and
the two packages side by side: a JAX bundle served by the port's daemon,
each package's client against the other's server, and journals written by
one package replayed by the other.

Tolerances:
- the daemon against a direct call of the same store: 1e-6 (the JAX
  test's; on the CPU a padded bucket computes the same rows, so the
  scores are in fact equal);
- the port's daemon serving a JAX bundle against the JAX store on the
  same state: SERVE_TOL = 1e-5, the serving tolerance of
  tests/test_torch_bundle.py.
"""

import os
import socket
import struct
import threading

import jax
import numpy as np
import pytest

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving import UserMemoryStore as JStore
from hpmn_tpu.serving.client import ServingClient as JClient
from hpmn_tpu.serving.journal import UpdateJournal as JJournal
from hpmn_tpu.serving.server import ServingServer as JServer
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.serving import (HistoryStore, UserMemoryStore,
                                    load_bundle)
from hpmn_tpu_torch.serving.client import ServingClient
from hpmn_tpu_torch.serving.journal import MAGIC, UpdateJournal
from hpmn_tpu_torch.serving.server import MicroBatcher, ServingServer, _bucket
from hpmn_tpu_torch.serving.sharded import ShardedServingClient

N_ITEMS, N_CATS = 200, 20
TOL = 1e-6
SERVE_TOL = 1e-5


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _store(seed=0, family="hpmn"):
    if family == "dien":
        cfg = configs.get_config("taobao_dien").with_model(use_pallas=True)
        model = init_model(cfg, N_ITEMS, N_CATS, seed=seed, device="cpu")
        return cfg, model, HistoryStore(cfg, model, window=12, device="cpu")
    cfg = configs.get_config("taobao_hpmn")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=seed, device="cpu")
    return cfg, model, UserMemoryStore(cfg, model, device="cpu")


def _seed_users(store, uids, T=9, seed=3):
    rng = np.random.default_rng(seed)
    items = rng.integers(1, N_ITEMS, size=(len(uids), T)).astype(np.int32)
    cats = (items % N_CATS).astype(np.int32)
    store.ingest_histories(np.asarray(uids, np.int32), items, cats)
    return items, cats


def _counts(store, uids):
    return store._gather(np.asarray(uids))[1].numpy()


def test_bucket_sizes():
    assert _bucket(1, 256) == 1
    assert _bucket(3, 256) == 4
    assert _bucket(17, 256) == 32
    # above max_batch it still rounds up: max_batch caps the requests per
    # drain, not the fused rows
    assert _bucket(300, 256) == 512


@pytest.mark.parametrize("family", ["hpmn", "dien"])
def test_server_predict_rank_update_roundtrip(family):
    """predict, rank and update through the daemon equal direct calls of
    the same store, for the memory store and DIEN's history store; stats
    count the requests and the users."""
    _, _, store = _store(family=family)
    uids = np.arange(1, 9, dtype=np.int32)
    _seed_users(store, uids)
    cand_i = np.arange(1, 9, dtype=np.int32)
    cand_c = cand_i % N_CATS
    ref_pred = store.predict(uids, cand_i, cand_c)
    ci2 = np.stack([cand_i, cand_i + 1], axis=1) % N_ITEMS
    cc2 = ci2 % N_CATS
    ref_rank = store.rank(uids, ci2, cc2)

    with ServingServer(store, max_wait_ms=1.0) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            np.testing.assert_allclose(cl.predict(uids, cand_i, cand_c),
                                       ref_pred, atol=TOL)
            np.testing.assert_allclose(cl.rank(uids, ci2, cc2), ref_rank,
                                       atol=TOL)
            cl.update(uids, cand_i, cand_c)
            got2 = cl.predict(uids, cand_i, cand_c)
            assert not np.allclose(got2, ref_pred)
            np.testing.assert_allclose(got2,
                                       store.predict(uids, cand_i, cand_c),
                                       atol=TOL)
            st = cl.stats()
            assert st["stats"]["requests"] >= 4
            assert st["n_users"] == len(uids)
            # the kernels' launches of this process: 0 on the CPU, where
            # the plain versions run
            assert set(st["launches"]) >= {"gru_scan_fwd", "readout_fwd",
                                           "gru_scan_fwd_scale"}


def test_server_error_reply_keeps_serving():
    _, _, store = _store()
    _seed_users(store, np.arange(1, 5, dtype=np.int32))
    with ServingServer(store) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            with pytest.raises(RuntimeError, match="unknown method"):
                cl._call("bogus")
            assert cl.predict([1], [2], [2 % N_CATS]).shape == (1,)


def test_microbatcher_fuses_concurrent_requests():
    """16 threads x 1-row predicts in a wide fuse window: fewer batches
    than requests, the direct calls' scores."""
    _, _, store = _store()
    uids = np.arange(1, 17, dtype=np.int32)
    _seed_users(store, uids)
    cand_i = (uids * 3 % N_ITEMS).astype(np.int32)
    cand_c = cand_i % N_CATS
    ref = store.predict(uids, cand_i, cand_c)

    with ServingServer(store, max_wait_ms=50.0) as srv:
        results, errs = {}, []
        barrier = threading.Barrier(len(uids))

        def one(i):
            try:
                with ServingClient(srv.host, srv.port) as cl:
                    barrier.wait(timeout=10)
                    results[i] = cl.predict([uids[i]], [cand_i[i]],
                                            [cand_c[i]])[0]
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(uids))]
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert not errs
        got = np.array([results[i] for i in range(len(uids))])
        np.testing.assert_allclose(got, ref, atol=TOL)
        stats = srv.batcher.stats
        assert stats["requests"] == len(uids)
        assert stats["batches"] < len(uids)


def test_update_padding_is_exact_and_creates_no_users():
    """5 update rows pad to the bucket of 8 by repeating the first (uid,
    event) row: it lands once, and no user is created."""
    _, _, store = _store()
    uids = np.arange(1, 6, dtype=np.int32)
    _seed_users(store, uids)
    ref = _store()[2]
    _seed_users(ref, uids)
    batcher = MicroBatcher(store, max_batch=64, max_wait_ms=1.0)
    try:
        items = (uids * 3 % N_ITEMS).astype(np.int32)
        batcher.submit("update", {
            "uids": uids.tolist(), "item_ids": items.tolist(),
            "cat_ids": (items % N_CATS).tolist()}).result(timeout=10)
        ref.update(uids, items, (items % N_CATS).astype(np.int32))
        (m1, c1), (m2, c2) = store._gather(uids), ref._gather(uids)
        np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=TOL)
        np.testing.assert_array_equal(c1.numpy(), c2.numpy())
        assert store.n_users == len(uids)
        assert batcher.stats["padded_rows"] == 3
    finally:
        batcher.close()


def test_fused_updates_same_user_apply_sequentially():
    """Two queued updates of one uid both land (conflict-free splits)."""
    _, _, store = _store()
    _seed_users(store, np.array([5], np.int32), T=3)
    ref = _store()[2]
    _seed_users(ref, np.array([5], np.int32), T=3)
    batcher = MicroBatcher(store, max_batch=64, max_wait_ms=200.0)
    try:
        f1 = batcher.submit("update", {"uids": [5], "item_ids": [10],
                                       "cat_ids": [10 % N_CATS]})
        f2 = batcher.submit("update", {"uids": [5], "item_ids": [11],
                                       "cat_ids": [11 % N_CATS]})
        f1.result(timeout=10), f2.result(timeout=10)
        ref.update([5], [10], [10 % N_CATS])
        ref.update([5], [11], [11 % N_CATS])
        (m1, c1), (m2, c2) = (store._gather(np.array([5])),
                              ref._gather(np.array([5])))
        np.testing.assert_array_equal(c1.numpy(), c2.numpy())
        np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=TOL)
    finally:
        batcher.close()


def test_malformed_rank_fails_request_not_dispatcher():
    _, _, store = _store()
    _seed_users(store, np.arange(1, 4, dtype=np.int32))
    with ServingServer(store) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            with pytest.raises(RuntimeError, match="malformed|scores|dim"):
                cl._call("rank", uids=[1], cand_items=[2], cand_cats=[2])
            assert cl.predict([1], [2], [2 % N_CATS]).shape == (1,)


def test_close_flushes_queued_updates():
    """close() answers every accepted request first (--save_on_exit)."""
    _, _, store = _store()
    _seed_users(store, np.arange(1, 9, dtype=np.int32))
    batcher = MicroBatcher(store, max_batch=2, max_wait_ms=0.0)
    futs = [batcher.submit("update", {"uids": [int(u)], "item_ids": [3],
                                      "cat_ids": [3]})
            for u in range(1, 9)]
    batcher.close()
    assert all(f.done() for f in futs)
    np.testing.assert_array_equal(_counts(store, np.arange(1, 9)), 10)


def test_sharded_serving_matches_single_store():
    """Two daemons behind uid-hash fan-out give one store's scores, and
    each shard holds half of the users."""
    _, _, ref_store = _store()
    uids = np.arange(1, 17, dtype=np.int64)
    T = 9
    items, cats = _seed_users(ref_store, uids, T=T)
    stores = [_store()[2] for _ in range(2)]
    with ServingServer(stores[0]) as s0, ServingServer(stores[1]) as s1:
        with ShardedServingClient([(s0.host, s0.port),
                                   (s1.host, s1.port)]) as cl:
            for t in range(T):
                cl.update(uids, items[:, t], cats[:, t])
            cand_i = (uids * 7 % N_ITEMS).astype(np.int32)
            cand_c = cand_i % N_CATS
            np.testing.assert_allclose(
                cl.predict(uids, cand_i, cand_c),
                ref_store.predict(uids, cand_i, cand_c), atol=SERVE_TOL)
            ci2 = np.stack([cand_i, cand_i + 1], 1) % N_ITEMS
            np.testing.assert_allclose(
                cl.rank(uids, ci2, ci2 % N_CATS),
                ref_store.rank(uids, ci2, ci2 % N_CATS), atol=SERVE_TOL)
            st = cl.stats()
            assert len(st) == 2 and all(s["n_users"] == 8 for s in st)


def test_sharded_client_empty_request_returns_arrays():
    _, _, store = _store()
    _seed_users(store, np.arange(1, 4, dtype=np.int32))
    with ServingServer(store) as srv:
        with ShardedServingClient([(srv.host, srv.port)]) as cl:
            assert cl.predict([], [], []).shape == (0,)
            r = cl.rank(np.zeros((0,), np.int64),
                        np.zeros((0, 4), np.int32), np.zeros((0, 4), np.int32))
            assert r.shape == (0, 4)


def test_journal_roundtrip_and_torn_tail(tmp_path):
    """Whole records replay; a torn last record is dropped; truncate
    resets the journal to its magic."""
    p = str(tmp_path / "updates.jrnl")
    j = UpdateJournal(p)
    j.append([1, 2], [10, 11], [3, 4])
    j.append([5], [12], [6])
    j.close()
    got = list(UpdateJournal.replay(p))
    assert len(got) == 2
    np.testing.assert_array_equal(got[0][0], [1, 2])
    np.testing.assert_array_equal(got[1][1], [12])
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-3])
    assert len(list(UpdateJournal.replay(p))) == 1
    j2 = UpdateJournal(p)
    j2.truncate()
    j2.close()
    assert list(UpdateJournal.replay(p)) == []
    assert os.path.getsize(p) == len(MAGIC)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal written by one package replays in the other, record by
    record; the two packages write the same bytes."""
    batches = [([1, 2, 3], [10, 11, 12], [1, 2, 3]), ([7], [40], [5])]
    paths = {}
    for name, cls in (("port", UpdateJournal), ("jax", JJournal)):
        paths[name] = str(tmp_path / f"{name}.jrnl")
        j = cls(paths[name])
        for b in batches:
            j.append(*b)
        j.close()
    assert open(paths["port"], "rb").read() == open(paths["jax"],
                                                    "rb").read()
    reader = JJournal if writer == "port" else UpdateJournal
    got = list(reader.replay(paths[writer]))
    assert len(got) == len(batches)
    for rec, want in zip(got, batches):
        for a, b in zip(rec, want):
            np.testing.assert_array_equal(a, b)


def test_stats_latency_percentiles():
    _, _, store = _store()
    _seed_users(store, np.arange(1, 4, dtype=np.int32))
    with ServingServer(store) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            for _ in range(5):
                cl.predict([1], [2], [2 % N_CATS])
            lat = cl.stats()["latency_ms"]
            assert lat["n"] >= 5
            assert 0 <= lat["p50"] <= lat["p95"] <= lat["p99"]


def test_multi_model_daemon():
    """Named stores: requests route by 'model', updates hit only the named
    store, stats count users per model, an unknown model fails only its
    request."""
    _, _, a = _store(seed=0)
    _, _, b = _store(seed=1)
    uids = np.arange(1, 6, dtype=np.int32)
    _seed_users(a, uids, T=9, seed=3)
    _seed_users(b, uids, T=9, seed=4)
    cand = (uids * 3 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    want_a = a.predict(uids, cand, ccat)
    want_b = b.predict(uids, cand, ccat)
    assert not np.allclose(want_a, want_b)
    with ServingServer({"default": a, "candidate": b}, port=0) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            np.testing.assert_allclose(cl.predict(uids, cand, ccat),
                                       want_a, atol=TOL)
            np.testing.assert_allclose(
                cl.predict(uids, cand, ccat, model="candidate"), want_b,
                atol=TOL)
            cl.update(uids, cand, ccat, model="candidate")
            np.testing.assert_array_equal(_counts(a, uids), 9)
            np.testing.assert_array_equal(_counts(b, uids), 10)
            assert cl.stats()["models"] == {"default": 5, "candidate": 5}
            with pytest.raises(RuntimeError, match="unknown model"):
                cl.predict(uids, cand, ccat, model="nope")
            np.testing.assert_allclose(cl.predict(uids, cand, ccat),
                                       a.predict(uids, cand, ccat), atol=TOL)


def test_daemon_bundle_reload(tmp_path):
    """reload swaps the store on the dispatcher thread: later requests see
    the new model, the journal is truncated, serving goes on."""
    _, _, a = _store(seed=0)
    _, _, b = _store(seed=1)
    uids = np.arange(1, 6, dtype=np.int32)
    _seed_users(a, uids, T=9, seed=3)
    _seed_users(b, uids, T=9, seed=4)
    bdir = tmp_path / "b"
    b.save_bundle(str(bdir))
    cand = (uids * 3 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    jpath = str(tmp_path / "wal")
    loader = lambda path: load_bundle(path, device="cpu")  # noqa: E731
    with ServingServer(a, port=0, journal=UpdateJournal(jpath),
                       loader=loader) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            cl.update(uids, cand, ccat)
            assert os.path.getsize(jpath) > len(MAGIC)
            want_old = cl.predict(uids, cand, ccat)
            assert cl.reload(str(bdir)) == 5
            got = cl.predict(uids, cand, ccat)
            np.testing.assert_allclose(got, b.predict(uids, cand, ccat),
                                       atol=TOL)
            assert not np.allclose(got, want_old)
            assert os.path.getsize(jpath) == len(MAGIC)
            cl.update(uids, cand, ccat)
            np.testing.assert_array_equal(
                _counts(srv.batcher.stores["default"], uids), 10)


def test_reload_retargets_persistence_and_registers_new_models(tmp_path):
    """After a reload the live bundle map names the new bundle and
    srv.store is the new store; a reload that adds a model name gives it a
    journal, a persistence target and a place in stats."""
    _, _, a = _store(seed=0)
    _, _, b = _store(seed=1)
    uids = np.arange(1, 6, dtype=np.int32)
    _seed_users(a, uids, T=9, seed=3)
    _seed_users(b, uids, T=9, seed=4)
    adir, bdir = tmp_path / "a", tmp_path / "b"
    b.save_bundle(str(bdir))
    cand = (uids * 3 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)

    def jpath(name):  # main()'s naming
        return str(tmp_path / ("wal" if name == "default" else
                               f"wal.{name}"))

    with ServingServer(a, port=0,
                       loader=lambda p: load_bundle(p, device="cpu"),
                       journal={"default": UpdateJournal(jpath("default"))},
                       bundles={"default": str(adir)},
                       journal_factory=lambda n: UpdateJournal(jpath(n))
                       ) as srv:
        with ServingClient(srv.host, srv.port) as cl:
            cl.reload(str(bdir))
            assert srv.batcher.bundles["default"] == str(bdir)
            assert srv.store is srv.batcher.stores["default"]
            cl.reload(str(bdir), model="canary")
            assert srv.batcher.bundles["canary"] == str(bdir)
            assert "canary" in cl.stats()["models"]
            cl.update(uids, cand, ccat, model="canary")
            assert os.path.getsize(jpath("canary")) > len(MAGIC)
            assert os.path.getsize(jpath("default")) == len(MAGIC)
            live = srv.batcher
            assert set(live.stores) == set(live.bundles) == {"default",
                                                             "canary"}


@pytest.mark.parametrize("family", ["hpmn", "dien"])
def test_warmup_creates_no_users(family):
    """The daemon's warm-up reads (unknown uids at every bucket) score the
    cold-start state and create no user."""
    _, _, store = _store(family=family)
    _seed_users(store, np.arange(1, 4, dtype=np.int32), T=9)
    before = store.n_users
    for b in (1, 2, 4, 8):
        ones = np.ones((b,), np.int32)
        assert store.predict(np.full((b,), -1, np.int64), ones,
                             ones).shape == (b,)
    assert store.n_users == before


def test_protocol_garbage_does_not_kill_daemon():
    """Noise, an absurd length, framed non-JSON, missing fields and wrong
    types fail only their connection or request."""
    _, _, store = _store()
    uids = np.arange(1, 4, dtype=np.int32)
    _seed_users(store, uids, T=9)
    cand = (uids % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    with ServingServer(store, port=0) as srv:
        def attack(payload: bytes):
            s = socket.create_connection((srv.host, srv.port), timeout=10)
            try:
                s.sendall(payload)
                s.settimeout(5)
                try:
                    s.recv(4096)
                except (socket.timeout, ConnectionError, OSError):
                    pass
            finally:
                s.close()

        rng = np.random.default_rng(0)
        attack(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
        attack(struct.pack(">I", 1 << 30))
        body = b"this is not json"
        attack(struct.pack(">I", len(body)) + body)
        body = b'{"id": 1, "method": "predict"}'
        attack(struct.pack(">I", len(body)) + body)
        body = b'{"id": 1, "method": "update", "uids": [1], ' \
               b'"item_ids": "nope", "cat_ids": [2]}'
        attack(struct.pack(">I", len(body)) + body)
        with ServingClient(srv.host, srv.port) as cl:
            got = cl.predict(uids, cand, ccat)
        np.testing.assert_allclose(got, store.predict(uids, cand, ccat),
                                   atol=TOL)


# ------------------------------------------------- across the packages --

def _jax_hpmn(seed=0):
    j_cfg = j_get_config("taobao_hpmn")
    params = j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS)
    return j_cfg, params, JStore(j_cfg, params)


def test_port_daemon_serves_a_jax_bundle(tmp_path, interpret):
    """JAX's save_bundle, loaded by the port and served by its daemon:
    predict, rank and then update+predict within SERVE_TOL of the JAX
    store on the same requests."""
    _, _, js = _jax_hpmn(seed=2)
    uids = np.arange(1, 9, dtype=np.int32)
    _seed_users(js, uids)
    js.save_bundle(str(tmp_path))
    store = load_bundle(str(tmp_path), device="cpu")
    cand = (uids * 5 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    ci2 = np.stack([cand, (cand + 3) % N_ITEMS], 1)
    with ServingServer(store) as srv, ServingClient(srv.host,
                                                    srv.port) as cl:
        np.testing.assert_allclose(cl.predict(uids, cand, ccat),
                                   js.predict(uids, cand, ccat),
                                   atol=SERVE_TOL)
        np.testing.assert_allclose(cl.rank(uids, ci2, ci2 % N_CATS),
                                   js.rank(uids, ci2, ci2 % N_CATS),
                                   atol=SERVE_TOL)
        cl.update(uids, cand, ccat)
        js.update(uids, cand, ccat)
        np.testing.assert_allclose(cl.predict(uids, ccat, ccat),
                                   js.predict(uids, ccat, ccat),
                                   atol=SERVE_TOL)


def test_jax_client_talks_to_the_port_server():
    """The JAX package's ServingClient against the port's daemon: the
    same frames, the same answers as the store's direct calls."""
    _, _, store = _store()
    uids = np.arange(1, 7, dtype=np.int32)
    _seed_users(store, uids)
    cand = (uids * 3 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    want = store.predict(uids, cand, ccat)
    with ServingServer(store) as srv, JClient(srv.host, srv.port) as cl:
        np.testing.assert_allclose(cl.predict(uids, cand, ccat), want,
                                   atol=TOL)
        ci2 = np.stack([cand, cand + 1], 1) % N_ITEMS
        np.testing.assert_allclose(cl.rank(uids, ci2, ci2 % N_CATS),
                                   store.rank(uids, ci2, ci2 % N_CATS),
                                   atol=TOL)
        cl.update(uids, cand, ccat)
        np.testing.assert_array_equal(_counts(store, uids), 10)
        assert cl.stats()["n_users"] == len(uids)


def test_port_client_talks_to_the_jax_server(interpret):
    """The port's ServingClient against the JAX package's daemon."""
    _, _, js = _jax_hpmn()
    uids = np.arange(1, 7, dtype=np.int32)
    _seed_users(js, uids)
    cand = (uids * 3 % N_ITEMS).astype(np.int32)
    ccat = (cand % N_CATS).astype(np.int32)
    want = js.predict(uids, cand, ccat)
    with JServer(js) as srv, ServingClient(srv.host, srv.port) as cl:
        np.testing.assert_allclose(cl.predict(uids, cand, ccat), want,
                                   atol=TOL)
        cl.update(uids, cand, ccat)
        assert cl.stats()["n_users"] == len(uids)
        np.testing.assert_array_equal(
            np.asarray(js._gather(uids)[1]), 10)
