"""The port's AOT serving on the CPU: ``serving/aot.py`` (``export_serving``,
``AotStore``, ``load_aot_store``), ``serving/history.py``'s
``export_history_scoring`` and ``AotHistoryStore``, and the custom ops of
``ops/library.py`` that put K1 and K5 into the graphs.

The cases of tests/test_aot.py, held to the port's eager stores on the
same bundle: hpmn with and without ``use_user_emb``, one artifact over
several batch and candidate counts, int8 tables, the guards, the daemon,
the exported programs serialized and read back, the bf16 arena; then
DIEN's scoring graph against ``HistoryStore``, ``torch.library.opcheck``
on both ops, a store that serves while the model code is patched to
raise, the refusal of a JAX-exported bundle (and of another torch version
or platform), and the JAX package's eager ``load_bundle`` reading the
port's AOT bundle.

Tolerances: an AOT store against the eager store, 1e-6 (tests/test_aot.py's;
on the CPU the graphs run the same ops on the same values, so the scores
are in fact equal); the bf16 arena against the f32 eager store, 1e-2
(JAX's); the JAX package's store against the port's on the same bundle,
SERVE_TOL = 1e-5 (tests/test_torch_bundle.py's).
"""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving import UserMemoryStore as JStore
from hpmn_tpu.serving import load_bundle as j_load_bundle
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.ops import library
from hpmn_tpu_torch.serving import (HistoryStore, UserMemoryStore,
                                    load_bundle)
from hpmn_tpu_torch.serving.aot import (AotStore, export_serving,
                                        load_aot_store)
from hpmn_tpu_torch.serving.history import (AotHistoryStore,
                                            export_history_scoring)

N_ITEMS, N_CATS, N_USERS = 200, 20, 64
TOL, BF16_TOL, SERVE_TOL = 1e-6, 1e-2, 1e-5
W = 12  # DIEN's window


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _make(directory, use_user=False, quantize=False, n_hist=16, T=13):
    """taobao_hpmn (3 layers, period 3), users 0..n_hist-1 ingested, saved
    with its graphs for the CPU -> (the eager store, uids)."""
    cfg = configs.get_config("taobao_hpmn").with_model(use_user_emb=use_user)
    model = init_model(cfg, N_ITEMS, N_CATS, seed=0, device="cpu",
                       n_users=N_USERS if use_user else 0)
    store = UserMemoryStore(cfg, model, device="cpu")
    rng = np.random.default_rng(11)
    uids = np.arange(n_hist)
    hist = rng.integers(1, N_ITEMS, size=(n_hist, T)).astype(np.int32)
    store.ingest_histories(uids, hist, (hist % N_CATS).astype(np.int32))
    store.save_bundle(str(directory), quantize_embeddings=quantize,
                      export_compiled=True, export_platforms=("cpu",))
    return store, uids


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One bundle per setting, exported once for the module."""
    out = {}
    for name, kw in (("plain", {}), ("user", {"use_user": True}),
                     ("q8", {"quantize": True})):
        d = tmp_path_factory.mktemp(name)
        out[name] = (d,) + _make(d, **kw)
    return out


def _cands(rng, shape):
    c = rng.integers(1, N_ITEMS, size=shape).astype(np.int32)
    return c, (c % N_CATS).astype(np.int32)


@pytest.mark.parametrize("setting", ["plain", "user"])
def test_aot_matches_eager_store(bundles, setting):
    """predict, rank, then updates (new users among them) and their
    memories and counters: the AOT store against the eager store."""
    d, store, uids = bundles[setting]
    eager = load_bundle(str(d), device="cpu")
    aot = load_aot_store(str(d), device="cpu")
    assert isinstance(aot, AotStore) and aot.n_users == len(uids)
    rng = np.random.default_rng(1)
    ci, cc = _cands(rng, len(uids))
    np.testing.assert_allclose(aot.predict(uids, ci, cc),
                               eager.predict(uids, ci, cc), atol=TOL)
    np.testing.assert_allclose(aot.predict(uids, ci, cc),
                               store.predict(uids, ci, cc), atol=TOL)
    ri, rc = _cands(rng, (len(uids), 5))
    np.testing.assert_allclose(aot.rank(uids, ri, rc),
                               eager.rank(uids, ri, rc), atol=TOL)
    new = np.concatenate([uids[:4], [40, 41]])
    ei, ec = _cands(rng, len(new))
    aot.update(new, ei, ec)
    eager.update(new, ei, ec)
    (m_a, c_a), (m_e, c_e) = aot._gather(new), eager._gather(new)
    np.testing.assert_array_equal(c_a.numpy(), c_e.numpy())
    np.testing.assert_allclose(m_a.numpy(), m_e.numpy(), atol=TOL)
    np.testing.assert_allclose(aot.predict(new, ei, ec),
                               eager.predict(new, ei, ec), atol=TOL)
    if setting == "user":
        with pytest.raises(ValueError, match="user table"):
            aot.predict([N_USERS], [1], [1])


def test_aot_shape_polymorphism(bundles):
    """One artifact serves (1, 1), (3, 7) and (16, 4): no retrace, no
    per-shape files."""
    d, store, uids = bundles["plain"]
    aot = load_aot_store(str(d), device="cpu")
    rng = np.random.default_rng(2)
    for b, c in [(1, 1), (3, 7), (16, 4)]:
        ci, cc = _cands(rng, (b, c))
        np.testing.assert_allclose(aot.rank(uids[:b], ci, cc),
                                   store.rank(uids[:b], ci, cc), atol=TOL)
    assert sorted(f for f in os.listdir(d) if f.startswith("exported")) == [
        "exported_predict.cpu.pt2", "exported_rank.cpu.pt2",
        "exported_update.cpu.pt2"]


def test_aot_with_quantized_tables(bundles):
    """An int8 bundle: the graphs take the dequantized leaves, so AOT ==
    eager on the same quantized bundle."""
    d, _, uids = bundles["q8"]
    eager = load_bundle(str(d), device="cpu")
    aot = load_aot_store(str(d), device="cpu")
    ci, cc = _cands(np.random.default_rng(3), len(uids))
    np.testing.assert_allclose(aot.predict(uids, ci, cc),
                               eager.predict(uids, ci, cc), atol=TOL)
    with np.load(d / "params.npz") as z:
        assert "__q8__['embedding']['item']" in z.files


def test_aot_store_guards(bundles, tmp_path):
    """ingest and save_bundle need the model and raise; a bundle without
    graphs, one for another platform and one from another torch version
    are refused with pointed messages."""
    d, store, uids = bundles["plain"]
    aot = load_aot_store(str(d), device="cpu")
    with pytest.raises(ValueError, match="serving-only"):
        aot.ingest_histories(uids[:2], np.ones((2, 4), np.int32),
                             np.ones((2, 4), np.int32))
    with pytest.raises(ValueError, match="cannot re-export"):
        aot.save_bundle(str(tmp_path / "x"))
    plain = tmp_path / "plain"
    store.save_bundle(str(plain))
    with pytest.raises(ValueError, match="no exported"):
        load_aot_store(str(plain), device="cpu")
    with open(d / "serving_config.json") as f:
        meta = json.load(f)
    for field, value, match in (("platforms", ["cuda"], "not cpu"),
                                ("torch_version", "0.0.1", "0.0.1")):
        bad = tmp_path / field
        os.makedirs(bad)
        for name in os.listdir(d):
            os.link(d / name, bad / name)
        os.remove(bad / "serving_config.json")
        m = json.loads(json.dumps(meta))
        m["exported"][field] = value
        with open(bad / "serving_config.json", "w") as f:
            json.dump(m, f)
        with pytest.raises(ValueError, match=match):
            load_aot_store(str(bad), device="cpu")
    assert meta["exported"]["format"] == "torch.export"
    assert meta["exported"]["torch_version"] == torch.__version__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exporting for cuda"):
            export_serving(store.cfg, store.model, ("cpu", "cuda"))


def test_aot_through_daemon(bundles):
    """The daemon serves an AotStore as it serves the eager store."""
    from hpmn_tpu_torch.serving import ServingClient, ServingServer

    d, store, uids = bundles["plain"]
    aot = load_aot_store(str(d), device="cpu")
    ci, cc = _cands(np.random.default_rng(4), len(uids))
    with ServingServer(aot, port=0) as srv:
        with ServingClient(srv.host, srv.port) as client:
            got = client.predict(uids.tolist(), ci.tolist(), cc.tolist())
    np.testing.assert_allclose(got, store.predict(uids, ci, cc), atol=TOL)


def test_export_serving_bytes_roundtrip(bundles):
    """export_serving's programs serialize to bytes and load back on their
    own; the graphs hold K5 as the op and no weight."""
    _, store, uids = bundles["plain"]
    progs = export_serving(store.cfg, store.model, platforms=("cpu",))
    assert set(progs) == {"update", "predict", "rank"}
    buf = io.BytesIO()
    torch.export.save(progs["predict"]["cpu"], buf)
    buf.seek(0)
    ep = torch.export.load(buf)
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert torch.ops.hpmn.readout_fwd.default in ops
    assert not ep.state_dict and not ep.constants
    mem, _ = store._gather(uids)
    ids = torch.as_tensor(uids, dtype=torch.int32)
    leaves = [p.detach() for p in store.model.parameters()]
    with torch.no_grad():
        got = ep.module()((mem, ids, ids, ids), leaves)
    np.testing.assert_allclose(got.numpy(), store.predict(uids, uids, uids),
                               atol=TOL)


def test_aot_bf16_arena(bundles):
    """--aot with the bf16 arena: the graphs take the f32 upcast gather,
    the state rounds at write-back."""
    d, store, uids = bundles["plain"]
    aot = load_aot_store(str(d), device="cpu", arena_dtype="bfloat16")
    assert aot._mem.dtype == torch.bfloat16
    ci, cc = _cands(np.random.default_rng(5), len(uids))
    np.testing.assert_allclose(aot.predict(uids, ci, cc),
                               store.predict(uids, ci, cc), atol=BF16_TOL)
    aot.update(uids, ci, cc)
    assert aot._mem.dtype == torch.bfloat16


# ------------------------------------------------------------- DIEN --

@pytest.fixture(scope="module")
def dien(tmp_path_factory):
    d = tmp_path_factory.mktemp("dien")
    cfg = configs.get_config("taobao_dien").with_model(use_pallas=True)
    model = init_model(cfg, N_ITEMS, N_CATS, seed=1, device="cpu")
    store = HistoryStore(cfg, model, window=W, device="cpu")
    rng = np.random.default_rng(6)
    hist = rng.integers(1, N_ITEMS, size=(10, 17)).astype(np.int32)
    mask = np.ones((10, 17), np.float32)
    mask[5:, :9] = 0  # 5 users with 8 events (fewer than W)
    store.ingest_histories(np.arange(10), hist, hist % N_CATS, masks=mask)
    store.save_bundle(str(d), export_compiled=True,
                      export_platforms=("cpu",))
    return d, store


def test_aot_history_store_matches_history_store(dien):
    """DIEN's exported scoring (K1 and K1-scale as two op nodes) against
    HistoryStore: predict, rank chunked by max_score_rows, and updates,
    cold-start users included."""
    d, store = dien
    aot = load_aot_store(str(d), device="cpu", max_score_rows=7)
    assert isinstance(aot, AotHistoryStore) and aot.window == W
    assert aot.n_users == store.n_users
    ep = torch.export.load(str(d / "exported_score.cpu.pt2"))
    scans = [n for n in ep.graph.nodes
             if n.target == torch.ops.hpmn.gru_scan_fwd.default]
    assert len(scans) == 2  # the interest GRU, then the AUGRU (a scale)
    assert scans[1].args[6] is not None and scans[0].args[6] is None
    rng = np.random.default_rng(7)
    uids = np.array([0, 3, 5, 9, 77])  # 77: unknown
    ci, cc = _cands(rng, len(uids))
    np.testing.assert_allclose(aot.predict(uids, ci, cc),
                               store.predict(uids, ci, cc), atol=TOL)
    ri, rc = _cands(rng, (len(uids), 3))
    np.testing.assert_allclose(aot.rank(uids, ri, rc),
                               store.rank(uids, ri, rc), atol=TOL)
    aot.update(uids, ci, cc)
    store.update(uids, ci, cc)
    np.testing.assert_allclose(aot.predict(uids, cc, cc),
                               store.predict(uids, cc, cc), atol=TOL)
    with pytest.raises(ValueError, match="cannot re-export"):
        aot.save_bundle(str(d))
    progs = export_history_scoring(store.cfg, store.model, W, ("cpu",))
    assert list(progs) == ["score"] and list(progs["score"]) == ["cpu"]


# ---------------------------------------------------------- the ops --

_RNG = np.random.default_rng(8)


def _t(*shape, scale=1.0):
    return torch.from_numpy((_RNG.standard_normal(shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("form", ["plain", "mask_h0", "scale_strided",
                                  "bf16"])
def test_gru_scan_op_opcheck(form):
    """hpmn::gru_scan_fwd: schema, fake and CPU implementations
    (torch.library.opcheck), and the op equals cuda_gru.scan_by_device."""
    from hpmn_tpu_torch.ops.cuda_gru import scan_by_device

    T, B, d_in = 7, 5, 24
    x = _t(2 * T if form == "scale_strided" else T, B, d_in)
    if form == "scale_strided":
        x = x[1::2]  # a time-strided view, as gru_sequence_tm passes
    w = (_t(d_in, 96, scale=0.2), _t(32, 96, scale=0.2), _t(96, scale=0.1))
    mask = (torch.from_numpy((_RNG.random((T, B)) > 0.3).astype(np.float32))
            if form != "plain" else None)
    h0 = _t(B, 32, scale=0.5) if form == "mask_h0" else None
    scale = (torch.from_numpy(_RNG.random((T, B)).astype(np.float32))
             if form == "scale_strided" else None)
    args = [x, mask, h0, *w, scale]
    if form == "bf16":
        args = [None if a is None else a.to(torch.bfloat16) for a in args]
    torch.library.opcheck(library.gru_scan_fwd, tuple(args))
    out = library.gru_scan_fwd(*args)
    assert out.shape == (T, B, 32) and out.dtype == args[0].dtype
    assert torch.equal(out, scan_by_device(*args))


@pytest.mark.parametrize("L,d_q", [(3, 32), (6, 40)])
def test_readout_op_opcheck(L, d_q):
    """hpmn::readout_fwd: opcheck, and the op equals the plain readout."""
    from hpmn_tpu_torch.ops.cuda_readout import readout_by_device

    B = 9
    args = (_t(B, L, 32), _t(B, d_q), _t(32, 32, scale=0.2),
            _t(d_q, 32, scale=0.2), _t(32, scale=0.1), _t(32))
    torch.library.opcheck(library.readout_fwd, args)
    out = library.readout_fwd(*args)
    assert out.shape == (B, 32)
    assert torch.equal(out, readout_by_device(*args))


# ------------------------------------------------- no model code --

def test_aot_store_serves_without_model_code(bundles, dien, monkeypatch):
    """With the model builder, apply_model and the eager request math
    patched to raise, both AOT stores load and serve: predict, rank,
    update."""
    from hpmn_tpu_torch import convert
    from hpmn_tpu_torch.models import model as model_mod
    from hpmn_tpu_torch.serving import aot as aot_mod
    from hpmn_tpu_torch.serving import history as history_mod
    from hpmn_tpu_torch.serving import lifelong as lifelong_mod

    def boom(*a, **k):
        raise AssertionError("model code was called")

    for mod, names in ((model_mod, ("build_model", "apply_model")),
                       (convert, ("build_model",)),
                       (aot_mod, ("build_model", "update_memory",
                                  "predict_scores", "rank_scores")),
                       (history_mod, ("apply_model", "score_batch")),
                       (lifelong_mod, ("update_memory", "predict_scores",
                                       "rank_scores", "update_state",
                                       "read_state", "dense_lookup"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    d, _, uids = bundles["plain"]
    aot = load_aot_store(str(d), device="cpu")
    ci, cc = _cands(np.random.default_rng(9), len(uids))
    assert aot.predict(uids, ci, cc).shape == (len(uids),)
    assert aot.rank(uids[:3], ci[:6].reshape(3, 2),
                    cc[:6].reshape(3, 2)).shape == (3, 2)
    aot.update(uids, ci, cc)
    dd, _ = dien
    ah = load_aot_store(str(dd), device="cpu")
    assert ah.predict(np.arange(4), ci[:4], cc[:4]).shape == (4,)
    with pytest.raises(AssertionError, match="model code"):
        load_bundle(str(d), device="cpu")  # the eager store builds one


# ---------------------------------------------- across the packages --

def test_jax_exported_bundle_is_refused(tmp_path, interpret):
    """A bundle the JAX package exported (StableHLO) is refused by the
    port's AOT loader, which names the format; the port's eager loader
    still serves its params and memories, within SERVE_TOL of JAX."""
    j_cfg = j_get_config("taobao_hpmn")
    params = j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS)
    js = JStore(j_cfg, params)
    uids = np.arange(6)
    hist = np.random.default_rng(10).integers(1, N_ITEMS, size=(6, 9))
    js.ingest_histories(uids, hist.astype(np.int32),
                        (hist % N_CATS).astype(np.int32))
    js.save_bundle(str(tmp_path), export_compiled=True,
                   export_platforms=("cpu",))
    with pytest.raises(ValueError, match="StableHLO"):
        load_aot_store(str(tmp_path), device="cpu")
    eager = load_bundle(str(tmp_path), device="cpu")
    ci, cc = _cands(np.random.default_rng(11), len(uids))
    np.testing.assert_allclose(eager.predict(uids, ci, cc),
                               np.asarray(js.predict(uids, ci, cc)),
                               atol=SERVE_TOL)


def test_jax_reads_the_port_aot_bundle(bundles, interpret):
    """The JAX package's eager load_bundle reads the port's AOT bundle
    (params.npz, user_memory.npz and the config are the same files) and
    scores as the port's AOT store."""
    d, _, uids = bundles["plain"]
    js = j_load_bundle(str(d))
    aot = load_aot_store(str(d), device="cpu")
    ci, cc = _cands(np.random.default_rng(12), len(uids))
    np.testing.assert_allclose(np.asarray(js.predict(uids, ci, cc)),
                               aot.predict(uids, ci, cc), atol=SERVE_TOL)
    ri, rc = _cands(np.random.default_rng(13), (len(uids), 3))
    np.testing.assert_allclose(np.asarray(js.rank(uids, ri, rc)),
                               aot.rank(uids, ri, rc), atol=SERVE_TOL)
