"""Persistence of the port's serving stores against the JAX package's, on
the CPU: ``save``/``load`` (``user_memory.npz``), deployment bundles both
ways (the JAX package's ``save_bundle`` read by the port's ``load_bundle``,
the port's read by JAX's ``load_bundle_params`` and ``load_bundle``) for
``UserMemoryStore`` (hpmn, gru4rec, rum) and ``HistoryStore`` (dien),
int8 tables, the bf16 arena and ``config_from_dict``.

Tolerances:
- arrays that cross the file boundary (parameters, memories, counters,
  windows, the int8 tables and their dequantization) bit for bit;
- scores of the two packages' stores on the same state at 1e-5, the
  serving tolerance of tests/test_torch_serving.py;
- an int8 bundle's scores within 0.03 of the f32 bundle's and not equal
  to them, its params.npz under 0.45 of the f32 one's (JAX's bounds,
  tests/test_serving.py::test_quantized_bundle_roundtrip);
- the bf16 arena against JAX's bf16 arena over 20 events: counters equal,
  memories within BF16_MEM_TOL = 2^-7 (two bf16 ulps at |m| < 1) and
  scores within BF16_SCORE_TOL = 1e-4. Both stores round the same f32
  values, which differ by float ulps, so a rounding may flip: measured on
  the CPU over 3 seeds x 4 configs, one flip in 13,824 values (4.88e-4,
  one ulp) and scores 2.0e-6 apart. Against the port's own f32 arena, JAX's
  bounds: memories 3e-2, scores 1e-2.
"""

import os

import jax
import ml_collections
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving import HistoryStore as JHistoryStore
from hpmn_tpu.serving import UserMemoryStore as JStore
from hpmn_tpu.serving import load_bundle as j_load_bundle
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu.serving.lifelong import load_bundle_params as j_load_params
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import flat_from_model, model_from_flat
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.serving import HistoryStore, UserMemoryStore, load_bundle
from hpmn_tpu_torch.serving.lifelong import load_bundle_params

SERVE_TOL = 1e-5
Q8_TOL, Q8_SIZE = 0.03, 0.45
BF16_MEM_TOL, BF16_SCORE_TOL = 2.0 ** -7, 1e-4
BF16_VS_F32_MEM, BF16_VS_F32_SCORE = 3e-2, 1e-2
N_ITEMS, N_CATS = 200, 20
T, W = 17, 12  # history length; DIEN's window (T > W: the window slides)
# family -> (config, model overrides): hpmn at three layers (periods 1,
# 3, 9), DIEN with its kernels' path (the wrappers' plain versions here)
CONFIGS = {"hpmn": ("xlong_hpmn", dict(hpmn_layers=3)),
           "gru4rec": ("amazon_gru4rec", {}),
           "rum": ("amazon_rum", {}),
           "dien": ("taobao_dien", dict(use_pallas=True))}


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _j_flat(params):
    keys, leaves, _ = flatten_with_keys(params)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _cfgs(family):
    name, over = CONFIGS[family]
    j_cfg = j_get_config(name)
    for k, v in over.items():
        setattr(j_cfg.model, k, v)
    return j_cfg, configs.get_config(name).with_model(**over)


def _jax_pair(family, seed=0):
    """(JAX cfg, JAX params, the port's cfg, the port's model of them)."""
    j_cfg, cfg = _cfgs(family)
    params = j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS)
    return j_cfg, params, cfg, model_from_flat(cfg, _j_flat(params),
                                               device="cpu")


def _requests(rng):
    """Ingests and updates: 4 full and 4 left-padded histories of T
    events, then 3 rounds of events for 6 users (two new)."""
    items = rng.integers(1, N_ITEMS, size=(8, T)).astype(np.int32)
    mask = np.ones((8, T), np.float32)
    mask[4:] = np.arange(T)[None, :] >= T - rng.integers(1, T, 4)[:, None]
    items = (items * mask).astype(np.int32)
    ev = rng.integers(1, N_ITEMS, size=(3, 6)).astype(np.int32)

    def feed(s):
        s.ingest_histories(np.arange(4), items[:4], items[:4] % N_CATS)
        s.ingest_histories(np.arange(10, 14), items[4:], items[4:] % N_CATS,
                           masks=mask[4:])
        for r in range(3):
            s.update(np.array([0, 2, 11, 13, 20 + r, 30]), ev[r],
                     ev[r] % N_CATS)

    return feed


UIDS = np.array([0, 1, 2, 3, 10, 11, 12, 13, 20, 21, 22, 30, 99])  # 99: new


def _scores(s, rng_seed=7):
    rng = np.random.default_rng(rng_seed)
    ci = rng.integers(1, N_ITEMS, size=(len(UIDS), 3)).astype(np.int32)
    return (np.asarray(s.predict(UIDS, ci[:, 0], ci[:, 0] % N_CATS)),
            np.asarray(s.rank(UIDS, ci, ci % N_CATS)))


def _assert_scores_close(a, b, tol=SERVE_TOL):
    for x, y in zip(_scores(a), _scores(b)):
        np.testing.assert_allclose(x, y, atol=tol)


def _state(s):
    """The store's state as host arrays, users in uid order: (uids,
    memories f32, counters) or, for a history store, (uids, items, cats,
    counts)."""
    uids = np.sort(np.fromiter(s._row, np.int64))
    if isinstance(s, (HistoryStore, JHistoryStore)):
        rows = np.array([s._row[int(u)] for u in uids])
        return (uids, s._items[rows], s._cats[rows],
                np.asarray(s._cnt)[rows].astype(np.int64))
    m, c = s._gather(uids)
    m = m.numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
    c = c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
    return uids, m.astype(np.float32), c.astype(np.int64)


def _assert_same_state(a, b):
    for x, y in zip(_state(a), _state(b)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------ save and load --

@pytest.mark.parametrize("family", ["hpmn", "gru4rec", "rum"])
def test_save_load_round_trip_and_across_packages(tmp_path, family):
    """The port's save/load brings memories and counters back bit for bit;
    JAX's user_memory.npz loads into the port and the port's into JAX,
    bit for bit, and each then scores as the other package's store."""
    j_cfg, params, cfg, model = _jax_pair(family)
    feed = _requests(np.random.default_rng(1))
    js = JStore(j_cfg, params)
    ts = UserMemoryStore(cfg, model, device="cpu")
    feed(js)
    feed(ts)
    ts.save(str(tmp_path / "port"))
    js.save(str(tmp_path / "jax"))
    with np.load(tmp_path / "port" / "user_memory.npz") as z:
        assert z["memory"].dtype == np.float32
        assert z["counters"].dtype == np.int64
    back = UserMemoryStore.load(str(tmp_path / "port"), cfg, model,
                                device="cpu")
    _assert_same_state(back, ts)
    from_jax = UserMemoryStore.load(str(tmp_path / "jax"), cfg, model,
                                    device="cpu")
    _assert_same_state(from_jax, js)
    in_jax = JStore.load(str(tmp_path / "port"), j_cfg, params)
    _assert_same_state(in_jax, ts)
    _assert_scores_close(from_jax, js)
    _assert_scores_close(in_jax, ts)
    # an empty directory restores an empty store
    empty = UserMemoryStore.load(str(tmp_path / "none"), cfg, model,
                                 device="cpu")
    assert empty.n_users == 0


def test_constructor_seeds_users(tmp_path):
    """uid_to_memory and counters seed the store as the JAX store's do."""
    j_cfg, params, cfg, model = _jax_pair("hpmn")
    rng = np.random.default_rng(2)
    mems = {u: rng.standard_normal((3, 32)).astype(np.float32)
            for u in (5, 9, 2)}
    cnts = {5: 4, 2: 7}
    ts = UserMemoryStore(cfg, model, device="cpu", uid_to_memory=mems,
                         counters=cnts)
    js = JStore(j_cfg, params, uid_to_memory=mems, counters=cnts)
    _assert_same_state(ts, js)
    assert ts._gather(np.array([9]))[1].item() == 0


# ----------------------------------------------------------- bundles --

def _new_store(family, cfg, model, **kw):
    if family == "dien":
        return HistoryStore(cfg, model, window=W, device="cpu", **kw)
    return UserMemoryStore(cfg, model, device="cpu", **kw)


def _new_j_store(family, j_cfg, params):
    if family == "dien":
        return JHistoryStore(j_cfg, params, window=W)
    return JStore(j_cfg, params)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("family", list(CONFIGS))
def test_jax_bundle_loads_in_the_port(tmp_path, interpret, family):
    """JAX's save_bundle -> the port's load_bundle: parameters and state
    equal the bundle's arrays bit for bit, scores within 1e-5 of the JAX
    store's."""
    j_cfg, params, _, _ = _jax_pair(family, seed=3)
    js = _new_j_store(family, j_cfg, params)
    _requests(np.random.default_rng(4))(js)
    js.save_bundle(str(tmp_path))
    ts = load_bundle(str(tmp_path), device="cpu")
    assert type(ts) is (HistoryStore if family == "dien"
                        else UserMemoryStore)
    assert ts.cfg == _cfgs(family)[1]
    saved = _npz(tmp_path / "params.npz")
    mine = flat_from_model(ts.model)
    assert mine.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    if family == "dien":
        z = _npz(tmp_path / "user_history.npz")
        assert ts.window == W == int(z["window"])
        order = np.argsort(z["uids"])  # the file is in row order
        for got, key in zip(_state(ts), ("uids", "items", "cats", "counts")):
            np.testing.assert_array_equal(got, z[key][order])
    else:
        z = _npz(tmp_path / "user_memory.npz")
        uids, mem, cnt = _state(ts)
        np.testing.assert_array_equal(uids, z["uids"])
        np.testing.assert_array_equal(mem, z["memory"])
        np.testing.assert_array_equal(cnt, z["counters"])
    _assert_scores_close(ts, js)


@pytest.mark.parametrize("family", list(CONFIGS))
def test_port_bundle_loads_in_jax(tmp_path, interpret, family):
    """The port's save_bundle (from the port's own init) -> JAX's
    load_bundle_params and load_bundle: arrays bit for bit, scores within
    1e-5 of the port's store; the port reads its own bundle back."""
    _, cfg = _cfgs(family)
    model = init_model(cfg, N_ITEMS, N_CATS, seed=5, device="cpu")
    ts = _new_store(family, cfg, model, max_users=64)
    _requests(np.random.default_rng(6))(ts)
    ts.save_bundle(str(tmp_path))
    meta, j_cfg, params = j_load_params(str(tmp_path))
    assert meta["store"] == ("history" if family == "dien" else "memory")
    assert meta["max_users"] == 64
    assert isinstance(j_cfg, ml_collections.ConfigDict)
    theirs, mine = _j_flat(params), flat_from_model(model)
    assert theirs.keys() == mine.keys()
    for k, v in mine.items():
        np.testing.assert_array_equal(theirs[k], v, err_msg=k)
    js = j_load_bundle(str(tmp_path))
    _assert_same_state(js, ts)
    _assert_scores_close(js, ts)
    back = load_bundle(str(tmp_path), device="cpu")
    _assert_same_state(back, ts)
    assert back.max_users == 64
    np.testing.assert_array_equal(_scores(back)[1], _scores(ts)[1])


def test_each_store_refuses_the_other_kind(tmp_path):
    _, cfg = _cfgs("dien")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=1, device="cpu")
    HistoryStore(cfg, model, window=W, device="cpu").save_bundle(
        str(tmp_path / "h"))
    with pytest.raises(ValueError, match="history"):
        UserMemoryStore.load_bundle(str(tmp_path / "h"), device="cpu")
    _, cfg = _cfgs("rum")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=1, device="cpu")
    UserMemoryStore(cfg, model, device="cpu").save_bundle(str(tmp_path / "m"))
    with pytest.raises(ValueError, match="not a history-store"):
        HistoryStore.load_bundle(str(tmp_path / "m"), device="cpu")


# -------------------------------------------------------------- int8 --

def test_int8_tables_are_jax_bits(tmp_path):
    """The port's __q8__/__q8scale__ arrays and the dequantized tables are
    bit for bit JAX's for the same parameters (a zero row included)."""
    j_cfg = j_get_config("taobao_hpmn")
    params = j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS)
    params["embedding"]["cat"] = params["embedding"]["cat"].at[0].set(0.0)
    cfg = configs.get_config("taobao_hpmn")
    model = model_from_flat(cfg, _j_flat(params), device="cpu")
    JStore(j_cfg, params).save_bundle(str(tmp_path / "j"),
                                      quantize_embeddings=True)
    UserMemoryStore(cfg, model, device="cpu").save_bundle(
        str(tmp_path / "t"), quantize_embeddings=True)
    theirs, mine = (_npz(tmp_path / d / "params.npz") for d in ("j", "t"))
    assert theirs.keys() == mine.keys()
    assert {k for k in mine if k.startswith("__q8__")} == {
        "__q8__['embedding']['cat']", "__q8__['embedding']['item']"}
    for k, v in theirs.items():
        assert mine[k].dtype == v.dtype, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    # the dequantization, through each package's bundle reader
    _, _, deq_j = j_load_params(str(tmp_path / "j"))
    _, _, deq_t = load_bundle_params(str(tmp_path / "t"), device="cpu")
    theirs, mine = _j_flat(deq_j), flat_from_model(deq_t)
    assert theirs.keys() == mine.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    table = mine["['embedding']['item']"]
    assert not np.array_equal(table, _j_flat(params)["['embedding']['item']"])


def test_int8_bundle_scores_and_size(tmp_path):
    """A realistic table (50k items): the int8 params.npz is under 0.45 of
    the f32 one, its scores within 0.03 of the f32 bundle's and not equal;
    memories and counters intact."""
    cfg = configs.get_config("taobao_hpmn")
    n_items = 50_000
    model = init_model(cfg, n_items, N_CATS, seed=0, device="cpu")
    store = UserMemoryStore(cfg, model, device="cpu")
    rng = np.random.default_rng(5)
    uids = np.arange(8)
    hist = rng.integers(1, n_items, size=(8, 12)).astype(np.int32)
    store.ingest_histories(uids, hist, (hist % N_CATS).astype(np.int32))
    store.save_bundle(str(tmp_path / "f32"))
    store.save_bundle(str(tmp_path / "q8"), quantize_embeddings=True)
    sizes = [os.path.getsize(tmp_path / d / "params.npz")
             for d in ("f32", "q8")]
    assert sizes[1] < Q8_SIZE * sizes[0], sizes
    cand = rng.integers(1, n_items, size=8).astype(np.int32)
    ref = UserMemoryStore.load_bundle(str(tmp_path / "f32"), device="cpu")
    got = UserMemoryStore.load_bundle(str(tmp_path / "q8"), device="cpu")
    want = store.predict(uids, cand, cand % N_CATS)
    np.testing.assert_array_equal(ref.predict(uids, cand, cand % N_CATS),
                                  want)
    q8 = got.predict(uids, cand, cand % N_CATS)
    np.testing.assert_allclose(q8, want, atol=Q8_TOL)
    assert not np.allclose(q8, want)
    _assert_same_state(got, store)


# ------------------------------------------------------- bf16 arena --

# hpmn: JAX's own bf16 test's config (three layers of period 10)
BF16_CONFIGS = {"hpmn": "taobao_hpmn", "gru4rec": "amazon_gru4rec",
                "rum": "amazon_rum"}


def _event_stream(rng, B=6, n=20):
    items = rng.integers(1, N_ITEMS, size=(B, n)).astype(np.int32)
    return items, (items % N_CATS).astype(np.int32)


@pytest.mark.parametrize("family", ["hpmn", "gru4rec", "rum"])
def test_bf16_arena_against_jax_and_f32(family):
    """20 events for 6 users: the port's bf16 arena against JAX's bf16
    arena (counters equal, memories and scores at the measured bounds
    above) and against the port's f32 arena (JAX's bounds)."""
    j_cfg = j_get_config(BF16_CONFIGS[family])
    cfg = configs.get_config(BF16_CONFIGS[family])
    params = j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS)
    model = model_from_flat(cfg, _j_flat(params), device="cpu")
    js = JStore(j_cfg, params, arena_dtype="bfloat16")
    b16 = UserMemoryStore(cfg, model, device="cpu", arena_dtype="bfloat16")
    f32 = UserMemoryStore(cfg, model, device="cpu")
    assert b16._mem.dtype == torch.bfloat16 and b16._mem.element_size() == 2
    items, cats = _event_stream(np.random.default_rng(5))
    uids = np.arange(items.shape[0])
    for t in range(items.shape[1]):
        for s in (js, b16, f32):
            s.update(uids, items[:, t], cats[:, t])
    m_j, c_j = js._gather(uids)
    m_b, c_b = b16._gather(uids)
    m_f, c_f = f32._gather(uids)
    assert m_b.dtype == torch.float32
    np.testing.assert_array_equal(c_b.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(c_b.numpy(), c_f.numpy())
    gap = np.abs(m_b.numpy() - np.asarray(m_j)).max()
    print(f"{family}: bf16 arena vs JAX's: memories {gap:.3e}")
    assert gap <= BF16_MEM_TOL
    np.testing.assert_allclose(m_b.numpy(), m_f.numpy(),
                               atol=BF16_VS_F32_MEM)
    ci = np.random.default_rng(6).integers(1, N_ITEMS, size=(6, 4))
    for a, b in zip((b16.predict(uids, ci[:, 0], ci[:, 0] % N_CATS),
                     b16.rank(uids, ci, ci % N_CATS)),
                    (js.predict(uids, ci[:, 0], ci[:, 0] % N_CATS),
                     js.rank(uids, ci, ci % N_CATS))):
        np.testing.assert_allclose(a, np.asarray(b), atol=BF16_SCORE_TOL)
    np.testing.assert_allclose(b16.predict(uids, ci[:, 0], ci[:, 0] % N_CATS),
                               f32.predict(uids, ci[:, 0], ci[:, 0] % N_CATS),
                               atol=BF16_VS_F32_SCORE)


def test_bf16_arena_persists_f32_and_rounds_once(tmp_path):
    """A bf16 store saves f32; a bf16 store restores it with one rounding
    (the same bits), an f32 store reads the bf16 values exactly, and a
    bf16 store loading an f32 snapshot holds its bf16 rounding."""
    _, cfg = _cfgs("hpmn")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=2, device="cpu")
    feed = _requests(np.random.default_rng(8))
    b16 = UserMemoryStore(cfg, model, device="cpu", arena_dtype="bfloat16")
    f32 = UserMemoryStore(cfg, model, device="cpu")
    feed(b16)
    feed(f32)
    b16.save(str(tmp_path / "b"))
    f32.save(str(tmp_path / "f"))
    with np.load(tmp_path / "b" / "user_memory.npz") as z:
        assert z["memory"].dtype == np.float32
    back = UserMemoryStore.load(str(tmp_path / "b"), cfg, model,
                                device="cpu", arena_dtype="bfloat16")
    _assert_same_state(back, b16)
    as_f32 = UserMemoryStore.load(str(tmp_path / "b"), cfg, model,
                                  device="cpu")
    _assert_same_state(as_f32, b16)
    rounded = UserMemoryStore.load(str(tmp_path / "f"), cfg, model,
                                   device="cpu", arena_dtype="bfloat16")
    uids, m32, c32 = _state(f32)
    _, m16, c16 = _state(rounded)
    np.testing.assert_array_equal(
        m16, torch.from_numpy(m32).bfloat16().float().numpy())
    np.testing.assert_array_equal(c16, c32)
    with pytest.raises(ValueError, match="arena_dtype"):
        UserMemoryStore(cfg, model, device="cpu", arena_dtype="float16")


# ------------------------------------------------------------ config --

@pytest.mark.parametrize("name", configs.list_configs())
def test_config_dicts_match_jax(name):
    """config_from_dict reads each JAX config's to_dict() as the port's
    get_config; config_to_dict writes JAX's names and values, and reads
    back as itself."""
    j_cfg = j_get_config(name)
    cfg = configs.get_config(name)
    assert configs.config_from_dict(j_cfg.to_dict()) == cfg
    d = configs.config_to_dict(cfg)
    assert configs.config_from_dict(d) == cfg
    j_dict = j_cfg.to_dict()

    def walk(mine, theirs, path):
        for k, v in mine.items():
            assert k in theirs, f"{path}{k} is not a JAX field"
            if isinstance(v, dict):
                walk(v, theirs[k], f"{path}{k}.")
            else:
                assert v == (list(theirs[k]) if isinstance(theirs[k], tuple)
                             else theirs[k]), f"{path}{k}"

    walk(d, j_dict, "")
