"""The port's DNN, LSTM, Caser, SHAN and SVD++
(``hpmn_tpu_torch/models/extra_baselines.py``) against the JAX package on
the CPU: each encoder's state, the logits, ``loss_fn`` and every gradient,
the parameter conversion both ways, the init's shapes and scales, SVD++'s
user factors and Caser below the dataset's sequence length. JAX
parameters reach the port through ``hpmn_tpu_torch.convert``; inputs are
drawn with numpy from a seed. The size is tests/test_models.py's: B 8, T
21, vocab 300/30, 40 users, on the amazon config (T_max 100). BST is
tests/test_torch_bst.py.

Tolerances: encoder states 1e-5 abs; logits 1e-4 abs; the loss and its
parts rtol 1e-5; every gradient atol 1e-5 * max(1, max |grad|) plus rtol
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import extra_baselines as j_eb
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import flat_from_model, jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models import extra_baselines as eb
from hpmn_tpu_torch.models.model import init_model, loss_fn

STATE_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
N_ITEMS, N_CATS, N_USERS, B, T = 300, 30, 40, 8, 21
SMALL = synthetic.DatasetSpec("small", seq_len=T, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=N_USERS)
FAMILIES = ("dnn", "lstm", "caser", "shan", "svdpp")


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(family, **model):
    j_cfg = j_get_config("amazon_hpmn")
    j_cfg.model.name = family
    for k, v in model.items():
        setattr(j_cfg.model, k, v)
    cfg = configs.get_config("amazon_hpmn").with_model(name=family, **model)
    return j_cfg, cfg


def _params(j_cfg, seed=3):
    return j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS,
                        n_users=N_USERS)


def _data(seed=3, n=B):
    data = synthetic.make_ctr_dataset(SMALL, n, seed=seed, min_len_frac=0.3)
    assert data["seq_mask"].min() == 0.0  # left padding is exercised
    return data


def _grads_match(model, j_grads):
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(want)
    for name, p in model.named_parameters():
        ref = want[jax_key(name)]
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


def _loss_against_jax(j_cfg, cfg, params, data):
    (j_loss, j_metrics), j_grads = jax.jit(
        lambda p, b: jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, j_cfg, b))(params, j_batch_from_numpy(data))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    assert metrics.keys() == j_metrics.keys() == {"bce", "l2", "loss",
                                                  "logits"}
    np.testing.assert_allclose(metrics["logits"].detach().numpy(),
                               np.asarray(j_metrics["logits"]),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    for k in ("bce", "l2"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **LOSS_TOL, err_msg=k)
    _grads_match(model, j_grads)
    return model


def _encoder_inputs(seed, t=T, d=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, d)).astype(np.float32)
    lens = rng.integers(0, t + 1, size=B)
    lens[0] = t
    mask = (np.arange(t)[None, :] >= t - lens[:, None]).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    uid = rng.integers(0, N_USERS, size=B).astype(np.int32)
    return x, mask, q, uid


def _states(family, j_cfg, cfg, params, x, mask, q, uid):
    want = np.asarray(j_eb.encode(params["encoder"], family, j_cfg,
                                  jnp.asarray(x), jnp.asarray(mask),
                                  jnp.asarray(q), uid=jnp.asarray(uid)))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    with torch.no_grad():
        got = eb.encode(model.encoder, family, cfg, torch.from_numpy(x),
                        torch.from_numpy(mask), torch.from_numpy(q),
                        uid=torch.from_numpy(uid)).numpy()
    return got, want


# -------------------------------------------------------------- encoders --

@pytest.mark.parametrize("family", FAMILIES)
def test_encoder_state_matches_jax(family):
    """extra_baselines.encode == the JAX encode on the same weights and
    inputs, empty and full rows included; d_state as JAX's."""
    j_cfg, cfg = _configs(family)
    params = _params(j_cfg, seed=1)
    x, mask, q, uid = _encoder_inputs(1)
    got, want = _states(family, j_cfg, cfg, params, x, mask, q, uid)
    _, d_state = eb.build_encoder(family, cfg, 32, N_USERS)
    assert got.shape == want.shape == (B, d_state)
    np.testing.assert_allclose(got, want, atol=STATE_TOL, rtol=0)


@pytest.mark.parametrize("t", [4, 37, 100])
def test_caser_below_and_at_t_max(t):
    """Caser's vertical filters are sized to the dataset's T_max (amazon:
    100) and sliced to the batch's T: T 4 (the widest window), 37 and 100
    against JAX."""
    j_cfg, cfg = _configs("caser", caser_hfilters=3, caser_vfilters=2)
    params = _params(j_cfg, seed=2)
    assert params["encoder"]["vert"].shape == (100, 2)
    x, mask, q, uid = _encoder_inputs(2, t=t)
    got, want = _states("caser", j_cfg, cfg, params, x, mask, q, uid)
    assert got.shape == (B, 3 * 3 + 2 * 32)
    np.testing.assert_allclose(got, want, atol=STATE_TOL, rtol=0)


def test_lstm_masked_steps_keep_the_state():
    """A left-padded row's state is the state of its valid suffix alone,
    and an empty row's is zero (a masked step keeps h and c)."""
    _, cfg = _configs("lstm")
    enc = init_model(cfg, N_ITEMS, N_CATS, seed=4, device="cpu").encoder
    x, _, _, _ = _encoder_inputs(4)
    mask = np.zeros((B, T), np.float32)
    mask[0, 5:] = 1.0
    with torch.no_grad():
        h = eb.lstm_seq(enc, torch.from_numpy(x), torch.from_numpy(mask))
        h_suffix = eb.lstm_seq(enc, torch.from_numpy(x[:1, 5:]),
                               torch.ones(1, T - 5))
    np.testing.assert_allclose(h[0].numpy(), h_suffix[0].numpy(), atol=1e-6)
    assert not h[1:].any()


# ------------------------------------------------------- the loss and grads --

@pytest.mark.parametrize("family", FAMILIES)
def test_loss_fn_gradients_match_jax(family):
    """The logits, the loss, its parts and every parameter's gradient ==
    jax.value_and_grad of the JAX loss_fn, from one JAX init and batch."""
    j_cfg, cfg = _configs(family)
    _loss_against_jax(j_cfg, cfg, _params(j_cfg), _data())


def test_svdpp_with_user_emb_matches_jax():
    """SVD++'s p_u beside the use_user_emb table: both read batch.uid."""
    j_cfg, cfg = _configs("svdpp", use_user_emb=True)
    model = _loss_against_jax(j_cfg, cfg, _params(j_cfg, seed=7), _data(7))
    assert model.encoder.p_u.shape == (N_USERS, 32)
    assert model.embedding.user.shape == (N_USERS, 16)


def test_svdpp_user_factors():
    """p_u [n_users, 2 emb_dim]; its BCE gradient (L2 off) lands on the
    batch's rows and nowhere else; without n_users init_model raises
    ValueError, as JAX does; SVD++ and DNN give other logits."""
    _, cfg = _configs("svdpp")
    cfg = dataclasses.replace(cfg, loss=dataclasses.replace(
        cfg.loss, l2_weight=0.0))
    model = init_model(cfg, N_ITEMS, N_CATS, seed=0, device="cpu",
                       n_users=N_USERS)
    assert model.encoder.p_u.shape == (N_USERS, 32)
    data = _data(5)
    loss, m = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    g = model.encoder.p_u.grad.abs().sum(dim=1).numpy()
    hit = np.zeros(N_USERS, bool)
    hit[data["uid"]] = True
    assert (g[hit] > 0).all() and not g[~hit].any()
    with pytest.raises(ValueError, match="n_users"):
        init_model(cfg, N_ITEMS, N_CATS, device="cpu")
    _, cfg_d = _configs("dnn")
    dnn = init_model(cfg_d, N_ITEMS, N_CATS, seed=0, device="cpu")
    _, m_d = loss_fn(dnn, cfg_d, batch_from_numpy(data, device="cpu"))
    assert not np.allclose(m["logits"].detach().numpy(),
                           m_d["logits"].detach().numpy())


# ------------------------------------------------------------- conversion --

@pytest.mark.parametrize("family", FAMILIES)
def test_convert_round_trip_and_init_shapes(family):
    """Every key of the JAX tree fills one parameter with its values and
    ``flat_from_model`` gives back exactly the JAX key set and arrays (DNN:
    no encoder key at all); the port's own init has the JAX init's shapes
    and repeats for a seed."""
    j_cfg, cfg = _configs(family)
    j_flat = _flat(_params(j_cfg, seed=5))
    model = model_from_flat(cfg, j_flat, device="cpu")
    back = flat_from_model(model)
    assert back.keys() == j_flat.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, j_flat[k], err_msg=k)
    if family == "dnn":
        assert not any(k.startswith("['encoder']") for k in j_flat)
    a, b = (init_model(cfg, N_ITEMS, N_CATS, seed=6, device="cpu",
                       n_users=N_USERS) for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert tuple(pa.shape) == j_flat[jax_key(name)].shape, name


def test_init_draws_the_jax_scales():
    """The port's init distributions: LSTM's uniform bounds and zero bias,
    Caser's filter bounds and vert std, SVD++'s p_u std, SHAN's readouts."""
    enc = {f: init_model(_configs(f)[1], N_ITEMS, N_CATS, seed=8,
                         device="cpu", n_users=N_USERS).encoder
           for f in ("lstm", "caser", "svdpp", "shan")}
    lstm = enc["lstm"]
    assert lstm.wx.abs().max() <= (6.0 / (32 + 128)) ** 0.5
    assert lstm.wh.abs().max() <= (6.0 / (32 + 128)) ** 0.5
    assert not lstm.b.any()
    for f, w in zip(enc["caser"].hor, eb.CASER_WINDOWS):
        assert tuple(f.shape) == (w, 32, 4)
        assert f.abs().max() <= (6.0 / (w * 32 + 4)) ** 0.5
    assert abs(enc["caser"].vert.std().item() - 0.1) < 0.03
    assert abs(enc["svdpp"].p_u.std().item() - 32 ** -0.5) < 0.03
    assert not enc["shan"].attn_long.b.any()
    assert enc["shan"].attn_hybrid.wm.shape == (32, 32)


def test_config_fields_round_trip_through_a_jax_dict():
    """config_from_dict reads the new fields from a JAX cfg.to_dict()."""
    j_cfg, _ = _configs("caser", caser_hfilters=5, caser_vfilters=3,
                        shan_recent=7)
    cfg = configs.config_from_dict(j_cfg.to_dict())
    m = cfg.model
    assert (m.name, m.caser_hfilters, m.caser_vfilters, m.shan_recent) == (
        "caser", 5, 3, 7)
    assert dataclasses.asdict(configs.config_from_dict(
        configs.config_to_dict(cfg))) == dataclasses.asdict(cfg)
