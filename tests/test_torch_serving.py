"""The port's UserMemoryStore against the JAX package's, built from the
same parameters (through ``hpmn_tpu_torch.convert``) and fed the same
requests: full and left-padded history ingests, updates, predict, rank,
unknown users and LRU eviction. Memories and counters are compared, and
the scores. Tolerance: atol = 1e-5 on memories and scores (f32; the JAX
store encodes with the masked oracle, the port with the hierarchy of
scans)."""

import jax
import numpy as np
import pytest
import torch

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving import UserMemoryStore as JStore
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import model_from_flat
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.serving import protocol
from hpmn_tpu_torch.serving.lifelong import UserMemoryStore

ATOL = 1e-5
N_ITEMS, N_CATS = 200, 20
T = 17  # not a multiple of any period**l below


def _stores(seed=0, max_users=None):
    j_cfg = j_get_config("xlong_hpmn")
    j_cfg.model.hpmn_layers = 3  # periods 1, 3, 9
    cfg = configs.get_config("xlong_hpmn").with_model(hpmn_layers=3)
    params = j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS)
    keys, leaves, _ = flatten_with_keys(params)
    model = model_from_flat(cfg, {k: np.asarray(v)
                                  for k, v in zip(keys, leaves)},
                            device="cpu")
    return (JStore(j_cfg, params, max_users=max_users),
            UserMemoryStore(cfg, model, max_users=max_users, device="cpu"))


def _histories(rng, B, padded):
    items = rng.integers(1, N_ITEMS, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    if padded:
        lens = rng.integers(1, T + 1, size=B)
        mask = (np.arange(T)[None, :] >= T - lens[:, None]).astype(np.float32)
        items = (items * mask).astype(np.int32)
    return items, (items % N_CATS).astype(np.int32), mask


def _assert_same_state(js, ts, uids):
    m_j, c_j = js._gather(np.asarray(uids))
    m_t, c_t = ts._gather(np.asarray(uids))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=ATOL)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_store_matches_jax_store():
    rng = np.random.default_rng(0)
    js, ts = _stores()
    full_uids, pad_uids = np.arange(4), np.arange(10, 14)
    items, cats, _ = _histories(rng, 4, padded=False)
    for s in (js, ts):
        s.ingest_histories(full_uids, items, cats)
    items, cats, mask = _histories(rng, 4, padded=True)
    for s in (js, ts):
        s.ingest_histories(pad_uids, items, cats, masks=mask)
    all_uids = np.concatenate([full_uids, pad_uids])
    _assert_same_state(js, ts, all_uids)
    for _ in range(3):  # crosses the period-3 firing grid at T + 1 = 18
        ev = rng.integers(1, N_ITEMS, size=6).astype(np.int32)
        upd = all_uids[rng.permutation(8)[:6]]
        for s in (js, ts):
            s.update(upd, ev, ev % N_CATS)
    _assert_same_state(js, ts, all_uids)
    ci = rng.integers(1, N_ITEMS, size=8).astype(np.int32)
    np.testing.assert_allclose(ts.predict(all_uids, ci, ci % N_CATS),
                               js.predict(all_uids, ci, ci % N_CATS),
                               atol=ATOL)
    cm = rng.integers(1, N_ITEMS, size=(8, 5)).astype(np.int32)
    ranked = ts.rank(all_uids, cm, cm % N_CATS)
    np.testing.assert_allclose(ranked, js.rank(all_uids, cm, cm % N_CATS),
                               atol=ATOL)
    for c in range(5):
        np.testing.assert_allclose(
            ranked[:, c], ts.predict(all_uids, cm[:, c], cm[:, c] % N_CATS),
            atol=1e-6)


def test_unknown_users_score_as_cold_start():
    js, ts = _stores(seed=1)
    ci = np.array([3, 5, 7], np.int32)
    uids = np.array([100, 101, 102])
    np.testing.assert_allclose(ts.predict(uids, ci, ci % N_CATS),
                               js.predict(uids, ci, ci % N_CATS), atol=ATOL)
    assert ts.n_users == 0  # predict creates no user


def test_ingest_of_t_plus_one_equals_ingest_then_update():
    rng = np.random.default_rng(2)
    _, ts = _stores(seed=2)
    items, cats, _ = _histories(rng, 3, padded=False)
    nxt = rng.integers(1, N_ITEMS, size=3).astype(np.int32)
    ts.ingest_histories(np.arange(3), np.concatenate([items, nxt[:, None]], 1),
                        np.concatenate([cats, nxt[:, None] % N_CATS], 1))
    ts.ingest_histories(np.arange(3, 6), items, cats)
    ts.update(np.arange(3, 6), nxt, nxt % N_CATS)
    m_a, c_a = ts._gather(np.arange(3))
    m_b, c_b = ts._gather(np.arange(3, 6))
    np.testing.assert_allclose(m_a.numpy(), m_b.numpy(), atol=ATOL)
    assert c_a.tolist() == c_b.tolist() == [T + 1] * 3


def test_lru_eviction_matches_jax_store():
    """max_users bounds the arena; the least recently touched quarter goes
    in one pass and an evicted user restarts from empty memory."""
    rng = np.random.default_rng(3)
    js, ts = _stores(seed=3, max_users=8)
    touched = set()
    for step in range(6):
        uids = rng.choice(14, size=3, replace=False)
        touched.update(uids.tolist())
        ev = rng.integers(1, N_ITEMS, size=3).astype(np.int32)
        for s in (js, ts):
            s.update(uids, ev, ev % N_CATS)
        assert set(ts._row) == set(js._row), step
        assert ts.n_users <= 8
    assert len(touched) > 8  # so eviction ran
    live = np.array(sorted(ts._row))
    _assert_same_state(js, ts, live)
    assert len(ts._row_uid) == len(js._row_uid)  # same growth


def test_arena_grows_past_its_first_capacity():
    rng = np.random.default_rng(4)
    js, ts = _stores(seed=4)
    n = UserMemoryStore._MIN_CAP + 100
    items = rng.integers(1, N_ITEMS, size=(n, 4)).astype(np.int32)
    for s in (js, ts):
        s.ingest_histories(np.arange(n), items, items % N_CATS)
    assert len(ts._row_uid) == len(js._row_uid) >= n
    _assert_same_state(js, ts, rng.choice(n, size=64, replace=False))


def test_store_refuses_a_model_on_another_device():
    cfg = configs.get_config("xlong_hpmn")
    model = init_model(cfg, N_ITEMS, N_CATS, device="cpu")
    with pytest.raises(ValueError, match="the model is on cpu"):
        UserMemoryStore(cfg, model, device="meta")


def test_other_families_raise():
    """The protocol serves O1_FAMILIES; a target-dependent family (DIEN)
    has no O(1) update, readout or batched encode."""
    assert protocol.O1_FAMILIES == ("hpmn", "gru4rec", "rum")
    with pytest.raises(ValueError, match="no O\\(1\\) update"):
        protocol.update_state("dien", None, torch.zeros(1, 1, 1),
                              torch.zeros(1), torch.zeros(1, 1), 1)
    with pytest.raises(ValueError, match="no readout"):
        protocol.read_state("dien", None, torch.zeros(1, 1, 1),
                            torch.zeros(1, 1))
    with pytest.raises(ValueError, match="no batched encode"):
        protocol.encode_full("dien", None, torch.zeros(1, 1, 1), None, 1)
