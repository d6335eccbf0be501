"""The port's BST (``extra_baselines.bst_encode`` and the ``bst`` family of
``apply_model``) against the JAX package on the CPU: the loss and every
gradient for 1 to 3 blocks, dense and chunked attention; padding
invariance; the heads check; the chunked attention against the dense one;
the bf16 path against JAX's bf16 path; and a hypothesis sweep of the
encoder over random shapes, chunk sizes, heads and key masks. JAX
parameters reach the port through ``hpmn_tpu_torch.convert``; inputs are
drawn with numpy from a seed. The size is tests/test_models.py's: B 8, T
21 (S = T + 1 = 22, which a chunk of 5 does not divide), vocab 300/30, on
the amazon config (T_max 100, pos [101, 32]).

Tolerances: logits 1e-4 abs; the loss rtol 1e-5; every gradient atol
1e-5 * max(1, max |grad|) plus rtol 1e-4; the encoder sweep's values
1e-5 and gradients 3e-5 abs plus rtol 2e-4 (JAX's own sweep's); the
port's chunked attention against its dense one at 1e-5 (values) and the
gradient tolerance above; with ``bst_dtype="bfloat16"`` the logits
within 2e-2 of JAX's bf16 logits (bf16 rounds the block's matmuls to 8
bits of mantissa; measured below 1e-2 here) and the loss rtol 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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

LOGIT_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
BF16_LOGIT_TOL = 2e-2
BF16_LOSS_TOL = dict(rtol=2e-3, atol=0)
# bf16 gradients against JAX's bf16 ones, over each one's max abs: the two
# round the matmuls' outputs to bf16 in other places and orders (up to
# 0.26 at 2 blocks, dense; 0.049 chunked).
BF16_GRAD_TOL = 0.3
N_ITEMS, N_CATS, N_USERS, B, T = 300, 30, 40, 8, 21
SMALL = synthetic.DatasetSpec("small", seq_len=T, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=N_USERS)


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(**model):
    j_cfg = j_get_config("amazon_hpmn")
    j_cfg.model.name = "bst"
    for k, v in model.items():
        setattr(j_cfg.model, k, v)
    cfg = configs.get_config("amazon_hpmn").with_model(name="bst", **model)
    return j_cfg, cfg


def _data(seed=3):
    data = synthetic.make_ctr_dataset(SMALL, B, seed=seed, min_len_frac=0.3)
    assert data["seq_mask"].min() == 0.0  # left padding is exercised
    return data


def _port_loss(cfg, model, data):
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    return loss, metrics


def _jax_loss(j_cfg, params, data):
    return jax.jit(lambda p, b: jax.value_and_grad(j_loss_fn, has_aux=True)(
        p, j_cfg, b))(params, j_batch_from_numpy(data))


def _check_grads(model, j_grads):
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(want)
    for name, p in model.named_parameters():
        ref = want[jax_key(name)]
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


@pytest.mark.parametrize("blocks,chunk", [(1, 0), (1, 5), (2, 0), (3, 5)])
def test_loss_fn_gradients_match_jax(blocks, chunk):
    """The logits, the loss and every parameter's gradient == JAX's, for
    one to three blocks (the last with the target's query alone, the
    inner ones dense or chunked)."""
    j_cfg, cfg = _configs(bst_blocks=blocks, bst_attn_chunk=chunk)
    params = j_init_model(jax.random.key(blocks), j_cfg, N_ITEMS, N_CATS)
    data = _data(blocks)
    (j_loss, j_metrics), j_grads = _jax_loss(j_cfg, params, data)
    model = model_from_flat(cfg, _flat(params), device="cpu")
    assert len(model.encoder.blocks) == blocks
    loss, metrics = _port_loss(cfg, model, data)
    np.testing.assert_allclose(metrics["logits"].detach().numpy(),
                               np.asarray(j_metrics["logits"]),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    _check_grads(model, j_grads)
    back = flat_from_model(model)
    assert back.keys() == _flat(params).keys()


def test_padding_invariance():
    """The ids at masked steps do not reach the logits: only the target's
    position leaves the encoder, and padded steps are masked keys."""
    _, cfg = _configs(bst_blocks=2, bst_attn_chunk=5)
    model = init_model(cfg, N_ITEMS, N_CATS, seed=0, device="cpu")
    data = _data()
    with torch.no_grad():
        _, m1 = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
        pad = data["seq_mask"] == 0
        item, cat = data["item_seq"].copy(), data["cat_seq"].copy()
        item[pad], cat[pad] = 7, 3
        data2 = dict(data, item_seq=item, cat_seq=cat)
        _, m2 = loss_fn(model, cfg, batch_from_numpy(data2, device="cpu"))
    np.testing.assert_allclose(m1["logits"].numpy(), m2["logits"].numpy(),
                               atol=1e-5)


def test_blocks_and_heads_check():
    """bst_blocks sets the blocks; heads that do not divide 2 emb_dim raise
    ValueError at init, as JAX's init_model does."""
    j_cfg, cfg = _configs(bst_blocks=2)
    assert len(init_model(cfg, N_ITEMS, N_CATS, device="cpu").encoder
               .blocks) == 2
    j_cfg.model.bst_heads = 5
    with pytest.raises(ValueError):
        j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS)
    with pytest.raises(ValueError, match="bst_heads=5 must divide"):
        init_model(cfg.with_model(bst_heads=5), N_ITEMS, N_CATS,
                   device="cpu")


def test_chunked_attention_matches_dense():
    """The online softmax over chunks of 5 (S = 22: a ragged last chunk)
    == the dense softmax, in the loss and every gradient (2 blocks, so the
    inner block takes the chunked path)."""
    _, cfg = _configs(bst_blocks=2)
    data = _data(4)
    out = {}
    for chunk in (0, 5):
        model = init_model(cfg, N_ITEMS, N_CATS, seed=2, device="cpu")
        c = cfg.with_model(bst_attn_chunk=chunk)
        loss, m = _port_loss(c, model, data)
        out[chunk] = (loss.item(), m["logits"].detach().numpy(),
                      {n: p.grad.numpy() for n, p in model.named_parameters()})
    np.testing.assert_allclose(out[5][0], out[0][0], rtol=1e-6)
    np.testing.assert_allclose(out[5][1], out[0][1], atol=1e-5)
    for name, g in out[0][2].items():
        np.testing.assert_allclose(
            out[5][2][name], g, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(g).max())), err_msg=name)


@pytest.mark.parametrize("chunk", [0, 5])
def test_bf16_matches_jax_bf16(chunk):
    """bst_dtype="bfloat16" against JAX's bf16 path (2 blocks): the
    logits and the loss within bf16's rounding; every gradient f32,
    finite and within BF16_GRAD_TOL of JAX's max abs; the bf16 path within
    JAX's f32 bounds of the port's f32."""
    j_cfg, cfg = _configs(bst_blocks=2, bst_attn_chunk=chunk,
                          bst_dtype="bfloat16")
    params = j_init_model(jax.random.key(6), j_cfg, N_ITEMS, N_CATS)
    data = _data(6)
    (j_loss, j_metrics), j_grads = _jax_loss(j_cfg, params, data)
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, metrics = _port_loss(cfg, model, data)
    logits = metrics["logits"].detach().numpy()
    np.testing.assert_allclose(logits, np.asarray(j_metrics["logits"]),
                               atol=BF16_LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(j_loss), **BF16_LOSS_TOL)
    want = _flat(j_grads)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
        ref = want[jax_key(name)]
        assert (np.abs(p.grad.numpy() - ref).max()
                <= BF16_GRAD_TOL * np.abs(ref).max()), name
    f32 = model_from_flat(cfg.with_model(bst_dtype="float32"), _flat(params),
                          device="cpu")
    with torch.no_grad():
        l32, m32 = loss_fn(f32, cfg.with_model(bst_dtype="float32"),
                           batch_from_numpy(data, device="cpu"))
    assert abs(loss.item() - l32.item()) < 3e-2
    np.testing.assert_allclose(logits, m32["logits"].numpy(), atol=0.15)


@settings(max_examples=8, deadline=None)
@given(Bs=st.integers(1, 5), Ts=st.integers(1, 24),
       blocks=st.integers(1, 3), chunk=st.sampled_from([0, 3, 5, 8]),
       heads=st.sampled_from([1, 2, 4]), seed=st.integers(0, 5))
def test_bst_encode_sweep_matches_jax(Bs, Ts, blocks, chunk, heads, seed):
    """bst_encode == JAX's _bst_encode over random (B, T, blocks, chunk,
    heads) and random key masks (rows with no valid step included): the
    value of sum(sin(state)) and its gradients in every parameter, x and
    q."""
    j_cfg, cfg = _configs(bst_blocks=blocks)
    d = 8
    rng = np.random.default_rng(seed)
    p = j_eb._bst_init(jax.random.key(seed), j_cfg, d, jnp.float32)
    x = rng.standard_normal((Bs, Ts, d)).astype(np.float32)
    q = rng.standard_normal((Bs, d)).astype(np.float32)
    mask = (rng.random((Bs, Ts)) < 0.8).astype(np.float32)

    def out_jax(p, x, q):
        return jnp.sum(jnp.sin(j_eb._bst_encode(p, x, jnp.asarray(mask), q,
                                                heads, attn_chunk=chunk)))

    want, (gp, gx, gq) = jax.value_and_grad(out_jax, argnums=(0, 1, 2))(
        p, jnp.asarray(x), jnp.asarray(q))
    enc = eb.BSTEncoder(d, 4 * d, blocks, 100)
    flat = {k.replace("['encoder']", "", 1): v
            for k, v in _flat({"encoder": p}).items()}
    with torch.no_grad():
        for name, prm in enc.named_parameters():
            prm.copy_(torch.from_numpy(np.array(flat[jax_key(name).replace(
                "['encoder']", "", 1)])))
    xt = torch.from_numpy(x).requires_grad_()
    qt = torch.from_numpy(q).requires_grad_()
    got = torch.sin(eb.bst_encode(enc, xt, torch.from_numpy(mask), qt, heads,
                                  attn_chunk=chunk)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    g_want = {k.replace("['encoder']", "", 1): v
              for k, v in _flat({"encoder": gp}).items()}
    pairs = [(xt.grad.numpy(), np.asarray(gx), "x"),
             (qt.grad.numpy(), np.asarray(gq), "q")]
    pairs += [(prm.grad.numpy(),
               g_want[jax_key(name).replace("['encoder']", "", 1)], name)
              for name, prm in enc.named_parameters()]
    for a, b, name in pairs:
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=2e-4, err_msg=name)


def test_empty_history_attends_the_target():
    """A row with every step masked (a cold user in serving) gets a finite
    state: the appended target is always a valid key."""
    _, cfg = _configs(bst_blocks=2, bst_attn_chunk=5)
    model = init_model(cfg, N_ITEMS, N_CATS, seed=1, device="cpu")
    data = _data()
    data = dict(data, seq_mask=np.zeros_like(data["seq_mask"]))
    with torch.no_grad():
        logits, _ = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    assert torch.isfinite(logits).all()


def test_driver_configs():
    """taobao_bst and xlong_bst: the JAX configs' family, batch, chunk and
    dispatch fields (test_torch_model.py compares every field)."""
    tb, xb = configs.get_config("taobao_bst"), configs.get_config("xlong_bst")
    assert (tb.dataset, tb.model.name, tb.train.batch_size,
            tb.model.bst_attn_chunk) == ("taobao", "bst", 256, 0)
    assert (xb.dataset, xb.model.name, xb.train.batch_size,
            xb.model.bst_attn_chunk) == ("xlong", "bst", 256, 128)
    assert tb.train.steps_per_dispatch == xb.train.steps_per_dispatch == 0
    assert dataclasses.asdict(configs.config_from_dict(
        j_get_config("xlong_bst").to_dict())) == dataclasses.asdict(xb)
