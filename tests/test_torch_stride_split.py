"""The strided scan backward as two parts, the gate sweep and the dx and
weight-gradient pass, against the JAX package on the CPU.

K4 and K4-bf16 (``csrc/gru_scan_stride_bwd.cu``) run a recurrence that
replays each chunk (from K1's input projection) and sweeps it in reverse,
writing only the gate gradients and h_prev, then K2's pass
(``csrc/gru_bwd_pass.cu``). Their
plain versions are ``gru_scan_stride_tm_sweep`` (``_bf16``) and
``gru_bwd_pass``; here the two, composed by hand, are held to
``jax.vjp`` of ``pallas_gru_stride_tm`` (the Pallas stride kernels in
interpret mode), f32 and bf16, at T not a multiple of the kernels' chunk
of 16 steps, period 2 and 3, with cotangents on both outputs or on one.
Inputs, weights and cotangents are drawn with numpy from a seed; an
absent cotangent is zeros on the JAX side.

Tolerances as tests/test_torch_stride.py: f32 at 1e-5 abs, bf16 within
2e-2 of each output's max abs. The sweep's h_prev is the plain forward's
states bit for bit (the same function on the same inputs). K4's workspace
chunk (``cuda_gru_stride.bwd_workspace_steps``) is checked as K2's is in
tests/test_torch_bwd_pass.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride
from hpmn_tpu_torch.ops.gru import (GRUWeights, gru_bwd_pass,
                                    gru_scan_stride_tm,
                                    gru_scan_stride_tm_bf16,
                                    gru_scan_stride_tm_bwd,
                                    gru_scan_stride_tm_bwd_bf16,
                                    gru_scan_stride_tm_sweep,
                                    gru_scan_stride_tm_sweep_bf16,
                                    gru_scan_tm_bf16)

GRAD_TOL = 1e-5       # f32, abs
BF16_GRAD_TOL = 2e-2  # bf16, of each output's max abs
BF16 = torch.bfloat16
MIB = 1 << 20


@pytest.fixture
def interpret():
    pg._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = False


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _case(T, period, seed, d_in=6, B=5):
    rng = np.random.default_rng(seed)
    w = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 96)),
             wh=rng.uniform(-0.5, 0.5, (32, 96)),
             b=rng.uniform(-0.1, 0.1, (96,)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    dhs = rng.standard_normal((T // period, B, 32)).astype(np.float32)
    dhT = rng.standard_normal((B, 32)).astype(np.float32)
    return w, x, dhs, dhT


def _pallas_grads(w, x, dhs, dhT, period, dtype):
    """jax.vjp of pallas_gru_stride_tm -> (dx, dwx, dwh, db) as float32."""
    @jax.jit
    def run(p, xx, cts):
        _, vjp = jax.vjp(
            lambda q, xs: pg.pallas_gru_stride_tm(q, xs, period, dtype=dtype),
            p, xx)
        return vjp(cts)

    dp, dx = run(JGRUParams(**{k: jnp.asarray(v) for k, v in w.items()}),
                 jnp.asarray(x),
                 (jnp.asarray(dhs, dtype), jnp.asarray(dhT, dtype)))
    return tuple(_f32(a) for a in (dx, dp.wx, dp.wh, dp.b))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("T,period", [(21, 3), (19, 2)])
@pytest.mark.parametrize("cotangents", ["both", "strided", "last"])
def test_stride_sweep_then_pass_matches_pallas_vjp(interpret, bf16, T,
                                                   period, cotangents):
    """gru_scan_stride_tm_sweep (_bf16), then gru_bwd_pass on its gate
    gradients and h_prev == the Pallas strided backward's dx, dwx, dwh and
    db; and the composition is what gru_scan_stride_tm_bwd (_bf16)
    returns."""
    w, x, dhs, dhT = _case(T, period, seed=T + 10 * period + 100 * bf16)
    if cotangents == "last":
        dhs = np.zeros_like(dhs)
    if cotangents == "strided":
        dhT = np.zeros_like(dhT)
    want = _pallas_grads(w, x, dhs, dhT, period,
                         jnp.bfloat16 if bf16 else jnp.float32)

    dt = BF16 if bf16 else torch.float32
    tw = GRUWeights(*(torch.from_numpy(w[k]).to(dt)
                      for k in ("wx", "wh", "b")))
    tx = torch.from_numpy(x).to(dt)
    t_dhs = None if cotangents == "last" else torch.from_numpy(dhs).to(dt)
    t_dhT = None if cotangents == "strided" else torch.from_numpy(dhT).to(dt)
    sweep, bwd = ((gru_scan_stride_tm_sweep_bf16, gru_scan_stride_tm_bwd_bf16)
                  if bf16 else
                  (gru_scan_stride_tm_sweep, gru_scan_stride_tm_bwd))
    dpre_x, dpre_h, h_prev, dh0 = sweep(tw, tx, period, t_dhs, t_dhT)
    assert dpre_x.shape == dpre_h.shape == (T, 5, 96)
    assert h_prev.shape == (T, 5, 32) and dh0.shape == (5, 32)
    assert dpre_x.dtype == dpre_h.dtype == h_prev.dtype == dt
    assert dh0.dtype == torch.float32
    assert torch.equal(dpre_x[..., :64], dpre_h[..., :64])
    got = gru_bwd_pass(tx, h_prev, dpre_x, dpre_h, tw.wx)
    whole = bwd(tw, tx, period, t_dhs, t_dhT)
    for name, g, h in zip(("dx", "dwx", "dwh", "db"), got, whole):
        assert torch.equal(g, h), name
    assert torch.equal(dh0, whole[4])
    for name, g, ref in zip(("dx", "dwx", "dwh", "db"), got, want):
        err = float(np.abs(_f32(g) - ref).max())
        if bf16:
            assert err <= BF16_GRAD_TOL * float(np.abs(ref).max()), name
        else:
            assert err <= GRAD_TOL, name


@pytest.mark.parametrize("bf16", [False, True])
def test_stride_sweep_h_prev_is_the_forward_states(bf16):
    """The sweep's h_prev is h0, then the plain forward's states h_seq[:-1],
    bit for bit (K4's recurrence writes the states it replays): the strided
    rows of gru_scan_stride_tm (_bf16) among them, and in bf16 every state
    of gru_scan_tm_bf16 (the same update). With no cotangent at all every
    gate gradient and dh0 is zero."""
    w, x, _, _ = _case(37, 3, seed=5)
    dt = BF16 if bf16 else torch.float32
    tw = GRUWeights(*(torch.from_numpy(w[k]).to(dt)
                      for k in ("wx", "wh", "b")))
    tx = torch.from_numpy(x).to(dt)
    h0 = torch.linspace(-0.9, 0.9, 5 * 32).reshape(5, 32).to(dt)
    sweep = gru_scan_stride_tm_sweep_bf16 if bf16 else gru_scan_stride_tm_sweep
    dpre_x, dpre_h, h_prev, dh0 = sweep(tw, tx, 3, None, None, h0)
    fwd = gru_scan_stride_tm_bf16 if bf16 else gru_scan_stride_tm
    hs, _ = fwd(tw, tx, 3, h0)
    assert torch.equal(h_prev[0], h0)
    assert torch.equal(h_prev[3::3], hs)  # h_prev[3k] = h_seq[3k - 1]
    if bf16:
        h_seq = gru_scan_tm_bf16(tw, tx, None, h0)[0]
        assert torch.equal(h_prev, torch.cat([h0[None], h_seq[:-1]]))
    for t in (dpre_x, dpre_h, dh0):
        assert not t.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_stride_bwd_gates_wrapper_on_cpu(dtype):
    """cuda_gru_stride.stride_bwd_gates on CPU tensors is the plain sweep,
    and stride_bwd composes it with the pass (no boundaries on the CPU)."""
    w, x, dhs, dhT = _case(23, 3, seed=9)
    tw = GRUWeights(*(torch.from_numpy(w[k]).to(dtype)
                      for k in ("wx", "wh", "b")))
    tx, t_dhs, t_dhT = (torch.from_numpy(a).to(dtype) for a in (x, dhs, dhT))
    sweep = (gru_scan_stride_tm_sweep_bf16 if dtype == BF16
             else gru_scan_stride_tm_sweep)
    got = cuda_gru_stride.stride_bwd_gates(tw, tx, 3, None, t_dhs, t_dhT)
    want = sweep(tw, tx, 3, t_dhs, t_dhT)
    for g, h in zip(got, want):
        assert torch.equal(g, h)
    whole = cuda_gru_stride.stride_bwd(tw, tx, 3, None, t_dhs, t_dhT)
    parts = gru_bwd_pass(tx, want[2], want[0], want[1], tw.wx)
    for g, h in zip(whole, parts + (want[3],)):
        assert torch.equal(g, h)


def test_k4_workspace_steps(monkeypatch):
    """K4's chunk: the most steps, a multiple of the replay chunk, whose xp
    [., B, 96] in f32 and dg [., B, 128] and h_prev [., B, 32] in x's dtype
    fit the workspace cap together; at least one chunk, at most those that
    cover T."""
    steps = cuda_gru_stride.bwd_workspace_steps
    assert steps(1000, 512, torch.float32, 16) == 128
    assert steps(1000, 512, BF16, 16) == 176
    for T, B, dt in ((1000, 512, torch.float32), (1000, 512, BF16),
                     (333, 512, torch.float32), (300, 3000, BF16),
                     (4000, 37, torch.float32)):
        n = steps(T, B, dt, 16)
        es = 2 if dt == BF16 else 4
        assert n % 16 == 0 and 16 <= n <= -(-T // 16) * 16
        row = 160 * es + 384  # bytes per row-step
        assert n * B * row <= cuda_gru.WORKSPACE_BYTES == 64 * MIB
        assert (n + 16) * B * row > 64 * MIB or n >= T
    assert steps(20, 512, torch.float32, 16) == 32
    assert steps(16, 512, BF16, 16) == 16
    assert steps(5, 10 ** 6, BF16, 16) == 16  # one chunk, past the cap
    assert steps(300, 6400, BF16, 16) == 16
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 48 * 5 * 1024)
    assert steps(100, 5, torch.float32, 16) == 48
    assert steps(100, 5, BF16, 16) == 64  # 48 * 1024 // 704 = 69 steps fit
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 47 * 5 * 1024)
    assert steps(100, 5, torch.float32, 16) == 32
