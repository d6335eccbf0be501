"""The port's strided-output scan (``model.pallas_stride_outputs``) at
widths other than the fixed-width kernels' d_m = 32, d_in <= 96, against
the JAX package on the CPU.

On the card those widths run K3-general and K4-general
(``csrc/gru_general_fwd.cu``, ``csrc/gru_general_bwd.cu``); on CPU tensors
``GRUStrideScan`` runs their plain versions, which take any width. The JAX
side is ``pallas_gru_stride_tm`` (the strided Pallas kernels in interpret
mode) and its ``jax.vjp`` under one ``jax.jit``, as
tests/test_torch_stride.py runs it. Inputs, weights and cotangents are
drawn with numpy from a seed and handed to both sides.

Tolerances (tests/test_torch_stride.py's and tests/test_torch_bf16.py's):
f32 values at 1e-5 abs and gradients at 1e-5 abs; bf16 values at 2e-2
abs and gradients within 2e-2 of their max abs. The strided xlong_hpmn
loss and its gradients: f32 loss rtol 1e-5 and gradients 3e-4 abs, bf16
loss rtol 1e-3 and gradients 2e-2 of max abs, as tests/test_torch_stride.py
holds the d_m = 32 loss.

Then the wrappers' C calls at a general width, through the ``_k3`` and
``_k4`` seams with stand-ins for the C entry points.
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
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.model import loss_fn
from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride
from hpmn_tpu_torch.ops.gru import GRUWeights

H_TOL, GRAD_TOL = 1e-5, 1e-5            # f32, abs
BF16_H_TOL, BF16_GRAD_TOL = 2e-2, 2e-2  # bf16: abs; of each max abs
BF16 = torch.bfloat16
# (d_in, d_m): the smallest width, one past the fixed-width d_m with d_in
# not a multiple of 32, and the wide xlong_hpmn's layer 0.
WIDTHS = [(1, 1), (40, 48), (128, 64)]
T, PERIOD, B = 19, 3, 3  # T % PERIOD and T % 16 both nonzero
NARROW = dict(mem_dim=16, readout_dim=24, emb_dim=20)
N_ITEMS, N_CATS = 200, 20


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


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
    @jax.jit
    def run(p, xx, cts):
        out, vjp = jax.vjp(
            lambda q, xs: pg.pallas_gru_stride_tm(q, xs, period, dtype=dtype),
            p, xx)
        return out, vjp(cts)

    (hs, hT), (dp, dx) = run(
        JGRUParams(**{k: jnp.asarray(v) for k, v in w.items()}),
        jnp.asarray(x), (jnp.asarray(dhs, dtype), jnp.asarray(dhT, dtype)))
    return tuple(_f32(a) for a in (hs, hT, dx, dp.wx, dp.wh, dp.b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_m", WIDTHS)
def test_stride_scan_matches_pallas_at_width(interpret, d_in, d_m, dtype):
    """h_stride, h_T and the gradients of x, wx, wh and b through
    GRUStrideScan on CPU tensors (cotangents on both outputs) ==
    pallas_gru_stride_tm and its jax.vjp; no kernel launches."""
    rng = np.random.default_rng(d_in * 7 + d_m)
    w = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 3 * d_m)).astype(np.float32),
             wh=rng.uniform(-0.5, 0.5, (d_m, 3 * d_m)).astype(np.float32),
             b=rng.uniform(-0.1, 0.1, (3 * d_m,)).astype(np.float32))
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    dhs = rng.standard_normal((T // PERIOD, B, d_m)).astype(np.float32)
    dhT = rng.standard_normal((B, d_m)).astype(np.float32)
    bf = dtype == "bfloat16"
    want = _pallas_stride(w, x, dhs, dhT, PERIOD,
                          jnp.bfloat16 if bf else jnp.float32)
    dt = BF16 if bf else torch.float32
    leaves = [torch.from_numpy(w[k]).to(dt).requires_grad_(True)
              for k in ("wx", "wh", "b")]
    x_leaf = torch.from_numpy(x).to(dt).requires_grad_(True)
    counters = ("launches", "bwd_launches", "launches_bf16",
                "bwd_launches_bf16", "gen_launches", "gen_bwd_launches",
                "gen_launches_bf16", "gen_bwd_launches_bf16")
    counts = [getattr(cuda_gru_stride, c) for c in counters]
    hs, hT = cuda_gru_stride.gru_stride_tm(GRUWeights(*leaves), x_leaf,
                                           PERIOD)
    assert hs.shape == (T // PERIOD, B, d_m) and hs.dtype == hT.dtype == dt
    got = torch.autograd.grad((hs, hT), [x_leaf, *leaves],
                              (torch.from_numpy(dhs).to(dt),
                               torch.from_numpy(dhT).to(dt)))
    assert [getattr(cuda_gru_stride, c) for c in counters] == counts
    names = ("dx", "dwx", "dwh", "db")
    if bf:
        assert max(_abs(hs, want[0]), _abs(hT, want[1])) <= BF16_H_TOL
        for name, g, ref in zip(names, got, want[2:]):
            assert _rel(g, ref) <= BF16_GRAD_TOL, name
        return
    assert _abs(hs, want[0]) <= H_TOL and _abs(hT, want[1]) <= H_TOL
    for name, g, ref in zip(names, got, want[2:]):
        assert _abs(g, ref) <= GRAD_TOL, name


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


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
def test_narrow_stride_loss_fn_matches_jax(interpret, scan_dtype):
    """xlong_hpmn at mem_dim 16, readout_dim 24, emb_dim 20 (layer 0's d_in
    40), 3 layers, T = 30, full sequences, use_pallas, assume_full_mask and
    pallas_stride_outputs: the loss and every parameter's gradient == JAX's
    loss_fn with the same flags, from one JAX init and batch. The port's
    graph holds a GRUStrideScan per layer and no GRUScan."""
    model = dict(NARROW, hpmn_layers=3, use_pallas=True,
                 use_hierarchical_scan=True, assume_full_mask=True,
                 pallas_stride_outputs=True, scan_dtype=scan_dtype)
    j_cfg = j_get_config("xlong_hpmn")
    for k, v in model.items():
        setattr(j_cfg.model, k, v)
    cfg = configs.get_config("xlong_hpmn").with_model(**model)
    params = j_init_model(jax.random.key(7), j_cfg, N_ITEMS, N_CATS)
    spec = synthetic.DatasetSpec("small30", seq_len=30, n_items=N_ITEMS,
                                 n_cats=N_CATS, n_users=50)
    data = synthetic.make_ctr_dataset(spec, 8, seed=7, min_len_frac=1.0)
    (j_loss, _), j_grads = jax.jit(lambda p, b: jax.value_and_grad(
        j_loss_fn, has_aux=True)(p, j_cfg, b))(params,
                                               j_batch_from_numpy(data))
    model_t = model_from_flat(cfg, _flat(params), device="cpu")
    loss, _ = loss_fn(model_t, cfg, batch_from_numpy(data, device="cpu"))
    nodes = _graph_nodes(loss)
    assert nodes.count("GRUStrideScanBackward") == 3
    assert nodes.count("GRUScanBackward") == 0
    loss.backward()
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model_t.named_parameters()} == set(want)
    bf = scan_dtype == "bfloat16"
    np.testing.assert_allclose(loss.item(), float(j_loss),
                               rtol=1e-3 if bf else 1e-5)
    for name, p in model_t.named_parameters():
        assert p.grad.dtype == torch.float32, name
        ref = want[jax_key(name)]
        if bf:
            assert _rel(p.grad, ref) <= BF16_GRAD_TOL, name
        else:
            assert _abs(p.grad, ref) <= 3e-4, name


def _fake(calls, ret=0):
    def make(dtype):
        def fn(*args):
            calls.append((dtype, args))
            return ret
        return fn
    return make


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_general_seams_pass_their_arguments(monkeypatch, dtype):
    """At d_in 40, d_m 48, _k3 and _k4 call K3-general's and K4-general's
    entry points (not the fixed-width ones) with their arguments in order:
    the f32 workspace of cuda_gru.workspace_steps(T, B, d_m) steps for
    K3-general; for K4-general ws [2, n, B, 3*d_m], dg [n, B, d_m, 4] and
    hprev [n, B, d_m] of n = min(t_chunk, T) steps, the partials' count,
    t_chunk, T, B, d_in, d_m and period. The partials' count divides B
    (each sums a slice of batch rows)."""
    calls = []
    monkeypatch.setattr(cuda_gru_stride, "_gen_fwd_fn", _fake(calls))
    monkeypatch.setattr(cuda_gru_stride, "_gen_bwd_fn", _fake(calls))
    monkeypatch.setattr(cuda_gru_stride, "_fwd_fn", None)
    monkeypatch.setattr(cuda_gru_stride, "_bwd_fn", None)
    d_in, d_m, T_, B_ = 40, 48, 37, 6
    assert cuda_gru_stride.gen_splits(B_, d_in, d_m) == 6
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * B_ * 3 * d_m * 4)
    w = GRUWeights(torch.zeros(d_in, 3 * d_m, dtype=dtype),
                   torch.zeros(d_m, 3 * d_m, dtype=dtype),
                   torch.zeros(3 * d_m, dtype=dtype))
    x = torch.zeros(2 * T_, B_, d_in, dtype=dtype)[::2]
    h0 = torch.zeros(B_, d_m, dtype=dtype)
    outs = tuple(torch.empty(n, B_, d_m, dtype=dtype) for n in (12, 3, 1))
    assert cuda_gru_stride._k3(w, x, h0, 3, outs, 99) == 0
    (got_dt, args), = calls
    assert got_dt == dtype and args[:2] == (x.data_ptr(), 2 * B_ * d_in)
    assert args[2:6] == (w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(),
                         h0.data_ptr())
    assert args[6:9] == tuple(t.data_ptr() for t in outs)
    assert args[10:] == (7, T_, B_, d_in, d_m, 3, 99)

    calls.clear()
    bounds = torch.empty(3, B_, d_m, dtype=dtype)
    dhs = torch.empty(12, B_, d_m, dtype=dtype)
    f32 = torch.float32
    outs = (torch.empty(T_, B_, d_in, dtype=dtype),
            torch.empty(B_, d_m, dtype=f32),
            torch.empty(6, d_in, 3 * d_m, dtype=f32),
            torch.empty(6, d_m, 3 * d_m, dtype=f32),
            torch.empty(6, 3 * d_m, dtype=f32))
    for t_chunk, n in ((16, 16), (48, 37)):
        code, dg, hprev = cuda_gru_stride._k4(w, x, 3, bounds, dhs, None,
                                              outs, 99, t_chunk=t_chunk)
        (got_dt, args), = calls
        calls.clear()
        assert code == 0 and got_dt == dtype
        assert dg.shape == (n, B_, d_m, 4) and hprev.shape == (n, B_, d_m)
        assert dg.dtype == hprev.dtype == dtype
        assert args[:8] == (x.data_ptr(), 2 * B_ * d_in, w.wx.data_ptr(),
                            w.wh.data_ptr(), w.b.data_ptr(),
                            bounds.data_ptr(), dhs.data_ptr(), None)
        assert args[8:13] == tuple(t.data_ptr() for t in outs)
        assert args[14:16] == (dg.data_ptr(), hprev.data_ptr())
        assert args[16:] == (6, t_chunk, T_, B_, d_in, d_m, 3, 99)
