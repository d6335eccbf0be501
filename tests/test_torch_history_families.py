"""``serving/history.py::HistoryStore`` for the families of
``models/extra_baselines.py`` against the JAX ``HistoryStore`` on the CPU:
BST (two blocks, the inner one chunked), SVD++ and LSTM, through ingest,
updates, predict, rank and cold users; SVD++'s uid check; BST bundles
across the two packages; an SVD++ bundle in the port; the exported BST
scoring graph against the eager store. JAX parameters reach the port
through ``hpmn_tpu_torch.convert``; histories are drawn with numpy from a
seed. Vocab 200/20, 40 users, window 12, histories of 15 (the window
slides).

Tolerances: scores against the JAX store 1e-5 abs (the encoders' 1e-5
through a sigmoid); a bundle round trip within one package bit for bit; a
bundle across the packages 1e-5; the exported graph against the eager
store 1e-6.
"""

import json

import jax
import numpy as np
import pytest

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving import HistoryStore as JHistoryStore
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import model_from_flat
from hpmn_tpu_torch.serving import HistoryStore, load_bundle
from hpmn_tpu_torch.serving.aot import load_aot_store

SERVE_TOL = 1e-5
AOT_TOL = 1e-6
N_ITEMS, N_CATS, N_USERS, W, T = 200, 20, 40, 12, 15
# family -> (config, model overrides)
CONFIGS = {"bst": ("taobao_bst", dict(bst_blocks=2, bst_attn_chunk=5)),
           "svdpp": ("amazon_hpmn", dict(name="svdpp")),
           "lstm": ("amazon_hpmn", dict(name="lstm"))}


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _pair(family, seed=9):
    """(JAX config, JAX params, port config, the port's model holding the
    same weights)."""
    name, over = CONFIGS[family]
    j_cfg = j_get_config(name)
    for k, v in over.items():
        setattr(j_cfg.model, k, v)
    cfg = configs.get_config(name).with_model(**over)
    params = j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS,
                          n_users=N_USERS)
    return j_cfg, params, cfg, model_from_flat(cfg, _flat(params),
                                               device="cpu")


def _feed(stores, seed=5):
    """The same ingests (one history mostly padded) and updates into every
    store -> (the uids to score: ingested, updated, one unknown)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(1, N_ITEMS, size=(5, T)).astype(np.int32)
    cats = (items % (N_CATS - 1) + 1).astype(np.int32)
    masks = np.ones((5, T), np.float32)
    masks[2, :T - 4] = 0.0
    ev_i = rng.integers(1, N_ITEMS, size=3)
    for s in stores:
        s.ingest_histories(np.arange(5), items, cats, masks=masks)
        s.update([0, 2, 7], ev_i, ev_i % N_CATS)
    return np.array([0, 1, 2, 3, 4, 7, 31])  # 7: updates only; 31: unknown


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    ci = rng.integers(1, N_ITEMS, size=(n, 3))
    return ci, ci % N_CATS


@pytest.mark.parametrize("family", list(CONFIGS))
def test_store_matches_jax_store(family):
    """The port's store and the JAX store on the same weights, fed the same
    ingests and updates, give the same predict and rank scores, a cold
    user included; rank's columns are predict's."""
    j_cfg, params, cfg, model = _pair(family)
    js = JHistoryStore(j_cfg, params, window=W)
    ts = HistoryStore(cfg, model, window=W, device="cpu")
    uids = _feed([js, ts])
    ci, cc = _requests(6, len(uids))
    got = ts.predict(uids, ci[:, 0], cc[:, 0])
    np.testing.assert_allclose(got, np.asarray(js.predict(uids, ci[:, 0],
                                                          cc[:, 0])),
                               atol=SERVE_TOL)
    ranked = ts.rank(uids, ci, cc)
    np.testing.assert_allclose(ranked, np.asarray(js.rank(uids, ci, cc)),
                               atol=SERVE_TOL)
    np.testing.assert_allclose(ranked[:, 0], got, atol=1e-6)
    assert np.isfinite(got).all() and ts.n_users == js.n_users == 6


def test_svdpp_uid_outside_p_u_raises():
    """SVD++ reads p_u by the request's uid: a uid outside the table raises
    ValueError before anything reaches the device (JAX's gather fills
    the row with NaN and serves a NaN score); a uid of the table that
    the store has not seen scores from its p_u row and an empty window."""
    j_cfg, params, cfg, model = _pair("svdpp")
    ts = HistoryStore(cfg, model, window=W, device="cpu")
    js = JHistoryStore(j_cfg, params, window=W)
    for bad in ([N_USERS], [-1]):
        with pytest.raises(ValueError, match="p_u"):
            ts.predict(bad, [3], [4])
        with pytest.raises(ValueError, match="p_u"):
            ts.rank(bad, [[3, 5]], [[4, 6]])
    assert np.isnan(np.asarray(js.predict([N_USERS], [3], [4]))).all()
    cold = ts.predict([10, 11], [3, 3], [4, 4])
    assert cold[0] != cold[1]  # same window, other p_u rows
    np.testing.assert_allclose(
        cold, np.asarray(js.predict([10, 11], [3, 3], [4, 4])),
        atol=SERVE_TOL)


def test_bst_bundles_across_the_packages(tmp_path):
    """A JAX-written BST bundle loads in the port and scores as the JAX
    store; the port's bundle loads in JAX and scores as the port's store."""
    j_cfg, params, cfg, model = _pair("bst")
    js = JHistoryStore(j_cfg, params, window=W)
    ts = HistoryStore(cfg, model, window=W, device="cpu")
    uids = _feed([js, ts])
    ci, cc = _requests(7, len(uids))
    (tmp_path / "j").mkdir()  # the JAX store writes into a directory
    js.save_bundle(str(tmp_path / "j"))
    ts.save_bundle(str(tmp_path / "t"))
    from_j = load_bundle(str(tmp_path / "j"), device="cpu")
    assert isinstance(from_j, HistoryStore) and from_j.window == W
    assert from_j.cfg.model.bst_attn_chunk == 5
    np.testing.assert_allclose(from_j.rank(uids, ci, cc),
                               np.asarray(js.rank(uids, ci, cc)),
                               atol=SERVE_TOL)
    from_t = JHistoryStore.load_bundle(str(tmp_path / "t"))
    np.testing.assert_allclose(np.asarray(from_t.rank(uids, ci, cc)),
                               ts.rank(uids, ci, cc), atol=SERVE_TOL)
    back = load_bundle(str(tmp_path / "t"), device="cpu")
    np.testing.assert_array_equal(back.rank(uids, ci, cc),
                                  ts.rank(uids, ci, cc))


def test_svdpp_bundle_round_trip(tmp_path):
    """An SVD++ bundle round trip in the port: p_u sizes the users
    (convert.model_from_flat reads it), the windows come back, scores bit
    for bit. The JAX loader sizes users from the user table alone, so its
    init_model raises for this bundle (ROADMAP.md)."""
    _, _, cfg, model = _pair("svdpp")
    ts = HistoryStore(cfg, model, window=W, device="cpu")
    uids = _feed([ts])
    ci, cc = _requests(8, len(uids))
    ts.save_bundle(str(tmp_path / "b"))
    back = HistoryStore.load_bundle(str(tmp_path / "b"), device="cpu")
    assert back.model.encoder.p_u.shape == (N_USERS, 32)
    assert back.n_users == ts.n_users
    np.testing.assert_array_equal(back.rank(uids, ci, cc),
                                  ts.rank(uids, ci, cc))
    with pytest.raises(ValueError, match="svdpp needs n_users"):
        JHistoryStore.load_bundle(str(tmp_path / "b"))


@pytest.mark.parametrize("family", ["bst", "svdpp"])
def test_exported_scoring_matches_eager(tmp_path, family):
    """save_bundle(export_compiled=True) on the CPU, then load_aot_store:
    the exported scoring graph (BST: the chunked inner block and the
    last-query block, b symbolic; SVD++: the p_u gather) scores as the
    eager store, in predict and in rank chunked to 5 rows a call."""
    _, _, cfg, model = _pair(family)
    ts = HistoryStore(cfg, model, window=W, device="cpu")
    uids = _feed([ts])
    ci, cc = _requests(9, len(uids))
    ts.save_bundle(str(tmp_path / "a"), export_compiled=True,
                   export_platforms=("cpu",))
    meta = json.load(open(tmp_path / "a" / "serving_config.json"))
    assert meta["exported"]["kinds"] == ["score"]
    aot = load_aot_store(str(tmp_path / "a"), device="cpu", max_score_rows=5)
    np.testing.assert_allclose(aot.predict(uids, ci[:, 0], cc[:, 0]),
                               ts.predict(uids, ci[:, 0], cc[:, 0]),
                               atol=AOT_TOL)
    np.testing.assert_allclose(aot.rank(uids, ci, cc), ts.rank(uids, ci, cc),
                               atol=AOT_TOL)
    if family == "svdpp":
        with pytest.raises(ValueError, match="p_u"):
            aot.predict([N_USERS], [3], [4])
