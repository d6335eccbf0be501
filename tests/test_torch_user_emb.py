"""``use_user_emb`` in the port against the JAX package on the CPU: the
user table carried across by ``convert.py``, ``apply_model``'s logits and
every ``loss_fn`` gradient (the user table's included) for hpmn on the
``use_pallas`` and the plain paths, dien, gru4rec and rum, the stores'
predict and rank, the driver's table size and the ``n_users`` error. JAX
parameters reach the port through ``hpmn_tpu_torch.convert``; inputs are
drawn with numpy from a seed. The Pallas kernels run in interpret mode.
The model size is tests/test_torch_dien.py's: T = 24, B = 8, vocab
300/30, 50 users.

Tolerances (tests/test_torch_baselines.py's): the logits 1e-4 abs; the
loss rtol 1e-5; every gradient atol 1e-5 * max(1, max |grad|) plus rtol
1e-4; the stores' scores 1e-5 of the JAX stores'.
"""

import jax
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.serving import HistoryStore as JHistoryStore
from hpmn_tpu.serving import UserMemoryStore as JStore
from hpmn_tpu.serving import load_bundle as j_load_bundle
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import flat_from_model, jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.model import build_model, init_model, loss_fn
from hpmn_tpu_torch.serving import HistoryStore, UserMemoryStore
from hpmn_tpu_torch.train import train as T

LOGIT_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
SERVE_TOL = 1e-5
N_ITEMS, N_CATS, N_USERS, B = 300, 30, 50, 8
SMALL = synthetic.DatasetSpec("small", seq_len=24, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=N_USERS)
# name: (config, use_pallas, model overrides); hpmn at three layers
# (periods 1, 3, 9), left-padded batches everywhere.
SETTINGS = {"hpmn_pallas": ("xlong_hpmn", True, dict(hpmn_layers=3)),
            "hpmn_plain": ("xlong_hpmn", False, dict(hpmn_layers=3)),
            "dien_pallas": ("taobao_dien", True, {}),
            "gru4rec_pallas": ("amazon_gru4rec", True, {}),
            "rum_plain": ("amazon_rum", False, {})}


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(setting):
    name, use_pallas, over = SETTINGS[setting]
    over = dict(over, use_pallas=use_pallas, use_user_emb=True)
    j_cfg = j_get_config(name)
    for k, v in over.items():
        setattr(j_cfg.model, k, v)
    return j_cfg, configs.get_config(name).with_model(**over)


def _pair(setting, seed):
    j_cfg, cfg = _configs(setting)
    params = j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS,
                          n_users=N_USERS)
    return j_cfg, params, cfg, model_from_flat(cfg, _flat(params),
                                               device="cpu")


def test_the_user_table_is_carried_across():
    """The JAX user table fills embedding.user; the tower takes emb_dim
    more inputs; flat_from_model gives JAX's arrays back bit for bit."""
    _, params, cfg, model = _pair("hpmn_plain", 0)
    flat = _flat(params)
    assert model.embedding.user.shape == (N_USERS, cfg.model.emb_dim)
    assert model.tower.layers[0].w.shape[0] == (3 * cfg.model.emb_dim
                                                + cfg.model.mem_dim)
    mine = flat_from_model(model)
    assert mine.keys() == flat.keys()
    assert "['embedding']['user']" in mine
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_loss_fn_gradients_match_jax(interpret, setting):
    """The logits, the loss and every parameter's gradient, the user
    table's included, == jax.value_and_grad of the JAX loss_fn from one
    JAX init and batch."""
    j_cfg, params, cfg, model = _pair(setting, 3)
    data = synthetic.make_ctr_dataset(SMALL, B, seed=3, min_len_frac=0.5)
    assert data["seq_mask"].min() == 0.0 and data["uid"].max() < N_USERS
    (j_loss, j_metrics), j_grads = jax.jit(
        lambda p, b: jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, j_cfg, b))(params, j_batch_from_numpy(data))
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    np.testing.assert_allclose(metrics["logits"].detach().numpy(),
                               np.asarray(j_metrics["logits"]),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(want)
    for name, p in model.named_parameters():
        ref = want[jax_key(name)]
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


@pytest.mark.parametrize("setting", ["hpmn_pallas", "dien_pallas"])
def test_stores_match_jax(tmp_path, interpret, setting):
    """The port's store (hpmn: UserMemoryStore, dien: HistoryStore) and the
    JAX store on the same weights and events: predict and rank within
    1e-5, the user's embedding in the tower; and a bundle of the port's
    store scores the same in JAX."""
    j_cfg, params, cfg, model = _pair(setting, 4)
    if setting == "dien_pallas":
        js = JHistoryStore(j_cfg, params, window=12)
        ts = HistoryStore(cfg, model, window=12, device="cpu")
    else:
        js = JStore(j_cfg, params)
        ts = UserMemoryStore(cfg, model, device="cpu")
    rng = np.random.default_rng(5)
    items = rng.integers(1, N_ITEMS, size=(6, 16)).astype(np.int32)
    ev = rng.integers(1, N_ITEMS, size=4).astype(np.int32)
    for s in (js, ts):
        s.ingest_histories(np.arange(6), items, items % N_CATS)
        s.update(np.array([1, 3, 7, 9]), ev, ev % N_CATS)
    uids = np.array([0, 1, 2, 3, 4, 5, 7, 9, 40])  # 40: no history
    ci = rng.integers(1, N_ITEMS, size=(len(uids), 3)).astype(np.int32)
    got = ts.predict(uids, ci[:, 0], ci[:, 0] % N_CATS)
    np.testing.assert_allclose(
        got, np.asarray(js.predict(uids, ci[:, 0], ci[:, 0] % N_CATS)),
        atol=SERVE_TOL)
    np.testing.assert_allclose(
        ts.rank(uids, ci, ci % N_CATS),
        np.asarray(js.rank(uids, ci, ci % N_CATS)), atol=SERVE_TOL)
    # the same memory under another user's embedding scores otherwise
    with torch.no_grad():
        model.embedding.user[40].add_(1.0)
    assert ts.predict(uids, ci[:, 0], ci[:, 0] % N_CATS)[-1] != got[-1]
    # a uid without a row raises on the host
    for bad in (N_USERS, -1):
        with pytest.raises(ValueError, match="user table"):
            ts.predict(np.array([0, bad]), ci[:2, 0], ci[:2, 0] % N_CATS)
    ts.save_bundle(str(tmp_path))
    back = j_load_bundle(str(tmp_path))
    np.testing.assert_allclose(
        np.asarray(back.rank(uids, ci, ci % N_CATS)),
        ts.rank(uids, ci, ci % N_CATS), atol=SERVE_TOL)


def test_n_users_must_be_positive():
    """With use_user_emb, n_users <= 0 raises as JAX's init_model does;
    without it, n_users is ignored; a JAX tree without a user table does
    not make a use_user_emb model."""
    j_cfg, cfg = _configs("hpmn_plain")
    for n in (0, -1):
        with pytest.raises(ValueError, match="n_users > 0"):
            init_model(cfg, N_ITEMS, N_CATS, device="cpu", n_users=n)
        with pytest.raises(ValueError, match="n_users > 0"):
            build_model(cfg, N_ITEMS, N_CATS, n_users=n)
        with pytest.raises(ValueError, match="n_users > 0"):
            j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS,
                         n_users=n)
    plain = cfg.with_model(use_user_emb=False)
    model = init_model(plain, N_ITEMS, N_CATS, device="cpu", n_users=9)
    assert model.embedding.user is None
    assert "embedding.user" not in dict(model.named_parameters())
    j_cfg.model.use_user_emb = False
    flat = _flat(j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS))
    with pytest.raises(ValueError, match="n_users > 0"):
        model_from_flat(cfg, flat, device="cpu")


def test_the_driver_sizes_the_table_from_the_data(monkeypatch):
    """init_model_for takes the user table's rows from the dataset spec;
    train() takes steps with it on the CPU, and the table moves."""
    monkeypatch.setitem(synthetic.SPECS, "amazon", SMALL)
    cfg = T.apply_overrides(configs.get_config("amazon_hpmn"), [
        "model.use_user_emb=true", "n_examples=200", "train.batch_size=16",
        "train.max_steps=4", "train.eval_every=4", "train.log_every=2",
        "train.steps_per_dispatch=1", "eval_batch_size=64"])
    first = T.init_model_for(cfg, SMALL, "cpu").embedding.user
    assert first.shape == (N_USERS, cfg.model.emb_dim)
    res = T.train(cfg, log=lambda s: None, device="cpu")
    user = res["params"]["embedding.user"]
    assert user.shape == first.shape
    assert not torch.equal(user, first.detach())
    assert np.isfinite(res["test"]["auc"])
    no_user = T.init_model_for(cfg.with_model(use_user_emb=False), SMALL,
                               "cpu")
    assert no_user.embedding.user is None
