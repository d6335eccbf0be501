"""The port's strided-output scan (``model.pallas_stride_outputs``) against
the JAX package on the CPU.

The JAX side is ``pallas_gru_stride_tm`` (the strided Pallas kernels in
interpret mode) and its ``jax.vjp``; the port's side is the plain
``gru_scan_stride_tm``/``gru_scan_stride_tm_bwd`` (and their bf16 forms),
which K3/K4 are held to on the card, and ``GRUStrideScan`` on CPU tensors.
Inputs, weights and cotangents are drawn with numpy from a seed.

Tolerances. f32: h at 1e-6 abs and dx and the weight gradients at 1e-5
abs, the JAX package's own for its strided kernel against its dense one
(tests/test_pallas.py); the port sums in other orders and writes sigmoid
as 1/(1+e^-v) where the TPU kernel writes it through tanh. bf16: h at 2e-2
abs and gradients within 2e-2 of their max abs, as tests/test_torch_bf16.py
(both sides round at the same places; the forward agrees bit for bit here,
the backward within about 0.6% of max abs, from XLA's own rounding on the
CPU, ROADMAP §3). The encoder and the loss: as tests/test_pallas.py's
strided cases and tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.models.hpmn import \
    encode_hierarchical_stride_tm as j_encode_stride
from hpmn_tpu.models.hpmn import init_hpmn as j_init_hpmn
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.hpmn import (HPMNEncoder,
                                        encode_hierarchical_stride_tm)
from hpmn_tpu_torch.models.model import loss_fn
from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride
from hpmn_tpu_torch.ops.gru import (GRUWeights, gru_scan_stride_tm,
                                    gru_scan_stride_tm_bf16,
                                    gru_scan_stride_tm_bwd,
                                    gru_scan_stride_tm_bwd_bf16, gru_scan_tm)

H_TOL, GRAD_TOL = 1e-6, 1e-5            # f32, abs
BF16_H_TOL, BF16_GRAD_TOL = 2e-2, 2e-2  # bf16: abs; of each max abs
BF16 = torch.bfloat16
CASES = [(18, 3), (19, 3), (8, 4), (23, 5), (5, 10)]  # test_pallas.py's
N_ITEMS, N_CATS = 200, 20


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _weights(rng, d_in, d_m):
    return dict(wx=rng.uniform(-0.5, 0.5, (d_in, 3 * d_m)).astype(np.float32),
                wh=rng.uniform(-0.5, 0.5, (d_m, 3 * d_m)).astype(np.float32),
                b=rng.uniform(-0.1, 0.1, (3 * d_m,)).astype(np.float32))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _abs(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) if got.size else 0.0


def _rel(got, want):
    return _abs(got, want) / max(float(np.abs(_f32(want)).max()), 1e-30)


def _pallas_stride(w, x, dhs, dhT, period, dtype):
    """pallas_gru_stride_tm and its vjp -> (h_stride, h_T, dx, dwx, dwh,
    db), all as float32 numpy arrays."""
    @jax.jit  # one compile instead of op-by-op interpretation: faster
    def run(p, xx, cts):
        out, vjp = jax.vjp(
            lambda q, xs: pg.pallas_gru_stride_tm(q, xs, period, dtype=dtype),
            p, xx)
        return out, vjp(cts)

    (hs, hT), (dp, dx) = run(
        JGRUParams(**{k: jnp.asarray(v) for k, v in w.items()}),
        jnp.asarray(x), (jnp.asarray(dhs, dtype), jnp.asarray(dhT, dtype)))
    return tuple(_f32(a) for a in (hs, hT, dx, dp.wx, dp.wh, dp.b))


def _case(T, period, d_m, seed):
    rng = np.random.default_rng(seed)
    B, d_in = 8, 6
    w = _weights(rng, d_in, d_m)
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    dhs = rng.standard_normal((T // period, B, d_m)).astype(np.float32)
    dhT = rng.standard_normal((B, d_m)).astype(np.float32)
    return w, x, dhs, dhT


def _check_plain_f32(T, period, d_m):
    w, x, dhs, dhT = _case(T, period, d_m, seed=T * 10 + d_m)
    want = _pallas_stride(w, x, dhs, dhT, period, jnp.float32)
    tw = GRUWeights(*(torch.from_numpy(w[k]) for k in ("wx", "wh", "b")))
    tx = torch.from_numpy(x)
    hs, hT = gru_scan_stride_tm(tw, tx, period)
    assert hs.shape == (T // period, 8, d_m)
    assert _abs(hs, want[0]) <= H_TOL and _abs(hT, want[1]) <= H_TOL
    got = gru_scan_stride_tm_bwd(tw, tx, period, torch.from_numpy(dhs),
                                 torch.from_numpy(dhT))
    for name, g, ref in zip(("dx", "dwx", "dwh", "db"), got, want[2:]):
        assert _abs(g, ref) <= GRAD_TOL, name


@pytest.mark.parametrize("T,period", CASES)
def test_plain_stride_scan_matches_pallas(interpret, T, period):
    """gru_scan_stride_tm and gru_scan_stride_tm_bwd (random cotangents on
    both h_stride and h_T) == pallas_gru_stride_tm and its jax.vjp, f32, at
    tests/test_pallas.py's d_m = 4."""
    _check_plain_f32(T, period, 4)


def test_plain_stride_scan_matches_pallas_at_kernel_width(interpret):
    """The same at the kernels' width d_m = 32, T = 19 (ragged: T % period
    and T % chunk are both nonzero), at the same tolerances."""
    _check_plain_f32(19, 3, 32)


@pytest.mark.parametrize("T,period", CASES)
def test_plain_stride_scan_bf16_matches_pallas_bf16(interpret, T, period):
    """The bf16 pair == pallas_gru_stride_tm(dtype=bfloat16) and its vjp at
    the kernels' width d_m = 32: dx bf16, the weight sums and dh0 f32; the
    worst errors printed."""
    d_m = 32
    w, x, dhs, dhT = _case(T, period, d_m, seed=T * 10 + d_m + 1)
    want = _pallas_stride(w, x, dhs, dhT, period, jnp.bfloat16)
    tw = GRUWeights(*(torch.from_numpy(w[k]).to(BF16)
                      for k in ("wx", "wh", "b")))
    tx = torch.from_numpy(x).to(BF16)
    hs, hT = gru_scan_stride_tm_bf16(tw, tx, period)
    assert hs.dtype == hT.dtype == BF16
    h_err = max(_abs(hs, want[0]), _abs(hT, want[1]))
    got = gru_scan_stride_tm_bwd_bf16(tw, tx, period,
                                      torch.from_numpy(dhs).to(BF16),
                                      torch.from_numpy(dhT).to(BF16))
    assert got[0].dtype == BF16
    assert all(t.dtype == torch.float32 for t in got[1:])
    errs = {name: _rel(g, ref) for name, g, ref in
            zip(("dx", "dwx", "dwh", "db"), got, want[2:])}
    print(f"T={T} period={period} d_m={d_m}: h max abs {h_err:.3e}; "
          f"gradients over max abs {errs}")
    assert h_err <= BF16_H_TOL
    for name, e in errs.items():
        assert e <= BF16_GRAD_TOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cotangents", ["both", "no_dhs", "no_dhT",
                                        "zero_dhs", "zero_dhT"])
@pytest.mark.parametrize("T,period", [(19, 3), (5, 10)])
def test_stride_function_on_cpu(T, period, cotangents, dtype):
    """GRUStrideScan on CPU tensors: autograd == the plain backward called
    directly, bit for bit, with either cotangent absent (None) or zero, and
    (f32) == autograd through the dense plain scan's strided rows at 1e-5.
    No kernel launches."""
    w, x, dhs, dhT = _case(T, period, 32, seed=T + len(cotangents))
    dt = torch.float32 if dtype == "float32" else BF16
    leaves = [torch.from_numpy(w[k]).to(dt).requires_grad_(True)
              for k in ("wx", "wh", "b")]
    x_leaf = torch.from_numpy(x).to(dt).requires_grad_(True)
    g_hs = None if cotangents == "no_dhs" else torch.from_numpy(dhs).to(dt)
    g_hT = None if cotangents == "no_dhT" else torch.from_numpy(dhT).to(dt)
    if cotangents == "zero_dhs":
        g_hs = torch.zeros_like(g_hs)
    if cotangents == "zero_dhT":
        g_hT = torch.zeros_like(g_hT)
    counts = (cuda_gru_stride.launches, cuda_gru_stride.bwd_launches,
              cuda_gru_stride.launches_bf16,
              cuda_gru_stride.bwd_launches_bf16)
    hs, hT = cuda_gru_stride.gru_stride_tm(GRUWeights(*leaves), x_leaf,
                                           period)
    assert hs.shape == (T // period, 8, 32) and hs.dtype == dt
    outs = [(o, g) for o, g in ((hs, g_hs), (hT, g_hT)) if g is not None]
    got = torch.autograd.grad([o for o, _ in outs], [x_leaf, *leaves],
                              [g for _, g in outs])
    assert (cuda_gru_stride.launches, cuda_gru_stride.bwd_launches,
            cuda_gru_stride.launches_bf16,
            cuda_gru_stride.bwd_launches_bf16) == counts
    plain_bwd = (gru_scan_stride_tm_bwd if dt == torch.float32
                 else gru_scan_stride_tm_bwd_bf16)
    want = plain_bwd(GRUWeights(*(t.detach() for t in leaves)),
                     x_leaf.detach(), period, g_hs, g_hT)
    for name, g, ref in zip(("dx", "dwx", "dwh", "db"), got, want):
        assert g.dtype == dt, name
        assert torch.equal(g, ref.to(dt)), name
    if dt == torch.float32:
        h_seq, h_T = gru_scan_tm(GRUWeights(*leaves), x_leaf)
        dense = [(o, g) for o, g in ((h_seq[period - 1::period], g_hs),
                                     (h_T, g_hT)) if g is not None]
        ref = torch.autograd.grad([o for o, _ in dense], [x_leaf, *leaves],
                                  [g for _, g in dense])
        for name, g, r in zip(("dx", "dwx", "dwh", "db"), got, ref):
            assert _abs(g, r) <= GRAD_TOL, name


def test_stride_function_h0_gradient_and_period_one():
    """An h0 gets its gradient (dh0 of the plain backward); period 1 is the
    dense scan, as pallas_gru_stride_tm's fallback."""
    w, x, dhs, dhT = _case(12, 3, 32, seed=3)
    tw = GRUWeights(*(torch.from_numpy(w[k]) for k in ("wx", "wh", "b")))
    tx = torch.from_numpy(x)
    h0 = torch.from_numpy(np.random.default_rng(4).uniform(
        -0.5, 0.5, (8, 32)).astype(np.float32)).requires_grad_(True)
    hs, hT = cuda_gru_stride.GRUStrideScan.apply(tx, h0, *tw, 3)
    (g_h0,) = torch.autograd.grad((hs, hT), [h0], (torch.from_numpy(dhs),
                                                   torch.from_numpy(dhT)))
    want = gru_scan_stride_tm_bwd(tw, tx, 3, torch.from_numpy(dhs),
                                  torch.from_numpy(dhT), h0.detach())[4]
    assert torch.equal(g_h0, want)
    h_seq, h_T = cuda_gru_stride.gru_stride_tm(tw, tx, 1)
    assert h_seq.shape == (12, 8, 32)
    assert torch.equal(h_seq, cuda_gru.gru_sequence_tm(tw, tx)[0])


def test_encode_hierarchical_stride_tm_matches_jax(interpret):
    """The strided hierarchy through GRUStrideScan on CPU tensors == JAX's
    encode_hierarchical_stride_tm with pallas_gru_stride_tm: T = 25, L = 3,
    period 3 (tests/test_pallas.py's case), the memory and every layer's
    gradient, f32 (the bf16 hierarchy: test_stride_loss_fn_matches_jax)."""
    B, T, d_in, d_m, L, period = 8, 25, 6, 4, 3, 3
    jp = j_init_hpmn(jax.random.key(0), d_in, d_m, L)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    g = rng.standard_normal((B, L, d_m)).astype(np.float32)

    def j_enc(p):
        return j_encode_stride(p, jnp.asarray(x), period,
                               stride_fn=pg.pallas_gru_stride_tm)

    mem_j, (g_j,) = jax.jit(lambda p, ct: (lambda o, f: (o, f(ct)))(
        *jax.vjp(j_enc, p)))(jp, jnp.asarray(g))

    enc = HPMNEncoder(d_in, d_m, L)
    with torch.no_grad():
        for l, layer in enumerate(jp["layers"]):
            for f in ("wx", "wh", "b"):
                getattr(enc.layers[l], f).copy_(torch.from_numpy(
                    np.array(getattr(layer, f))))
    mem = encode_hierarchical_stride_tm(
        enc, torch.from_numpy(x), period,
        stride_fn=cuda_gru_stride.gru_stride_tm)
    mem.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_f32(mem), _f32(mem_j), atol=1e-5)
    for l, layer in enumerate(enc.layers):
        for f in ("wx", "wh", "b"):
            assert _abs(getattr(layer, f).grad,
                        getattr(g_j["layers"][l], f)) <= 2e-5, (l, f)


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(scan_dtype, full_mask=True, stride=True):
    j_cfg = j_get_config("xlong_hpmn")
    j_cfg.model.hpmn_layers = 3
    j_cfg.model.use_pallas = True
    j_cfg.model.use_hierarchical_scan = True
    j_cfg.model.assume_full_mask = full_mask
    j_cfg.model.pallas_stride_outputs = stride
    j_cfg.model.scan_dtype = scan_dtype
    cfg = configs.get_config("xlong_hpmn").with_model(
        hpmn_layers=3, use_pallas=True, use_hierarchical_scan=True,
        assume_full_mask=full_mask, pallas_stride_outputs=stride,
        scan_dtype=scan_dtype)
    return j_cfg, cfg


def _batch(seed, full=True):
    spec = synthetic.DatasetSpec("small30", seq_len=30, n_items=N_ITEMS,
                                 n_cats=N_CATS, n_users=50)
    return synthetic.make_ctr_dataset(spec, 8, seed=seed,
                                      min_len_frac=1.0 if full else 0.5)


def _graph_nodes(loss):
    seen, stack, nodes = [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in nodes:
            continue
        nodes.add(node)
        seen.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return seen


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_stride_loss_fn_matches_jax(interpret, scan_dtype):
    """xlong_hpmn cut to 3 layers, T = 30, full sequences, use_pallas,
    assume_full_mask and pallas_stride_outputs: the loss and every
    parameter's gradient == JAX's loss_fn with the same flags, from the
    same JAX init and batch (tests/test_pallas.py's strided step). The
    port's graph holds a GRUStrideScan per layer and no GRUScan."""
    j_cfg, cfg = _configs(scan_dtype)
    params = j_init_model(jax.random.key(9), j_cfg, N_ITEMS, N_CATS)
    data = _batch(seed=9)
    (j_loss, _), j_grads = jax.jit(lambda p, b: jax.value_and_grad(
        j_loss_fn, has_aux=True)(p, j_cfg, b))(params,
                                               j_batch_from_numpy(data))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, _ = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    nodes = _graph_nodes(loss)
    assert nodes.count("GRUStrideScanBackward") == 3
    assert nodes.count("GRUScanBackward") == 0
    loss.backward()
    want = _flat(j_grads)
    if scan_dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    else:
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-3)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        ref = want[jax_key(name)]
        if scan_dtype == "float32":
            assert _abs(p.grad, ref) <= 3e-4, name
        else:
            assert _rel(p.grad, ref) <= BF16_GRAD_TOL, name


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_stride_flag_changes_nothing_with_a_mask(scan_dtype):
    """With assume_full_mask=False the masked dense path runs whatever the
    flag says (hpmn_tpu/models/model.py:162): the same loss and gradients,
    bit for bit, as without it."""
    data = _batch(seed=12, full=False)
    assert data["seq_mask"].min() == 0.0
    out = []
    for stride in (True, False):
        _, cfg = _configs(scan_dtype, full_mask=False, stride=stride)
        model = model_from_flat(
            cfg, _flat(j_init_model(jax.random.key(12), _configs(
                scan_dtype, False, stride)[0], N_ITEMS, N_CATS)),
            device="cpu")
        loss, _ = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
        assert _graph_nodes(loss).count("GRUStrideScanBackward") == 0
        loss.backward()
        out.append((loss, dict(model.named_parameters())))
    (l_s, p_s), (l_d, p_d) = out
    assert torch.equal(l_s, l_d)
    for name, p in p_s.items():
        assert torch.equal(p.grad, p_d[name].grad), name
