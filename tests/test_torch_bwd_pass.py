"""The scan backward's dx and weight-gradient pass (``gru_bwd_pass``, the
plain version of ``csrc/gru_bwd_pass.cu``) and the backward that calls it,
against the JAX package on the CPU.

``gru_scan_tm_bwd`` and ``gru_scan_tm_bwd_bf16`` fill the gate gradients in
their reverse sweep and hand them to ``gru_bwd_pass``, as K2 and K2-bf16
hand them from their recurrence to the pass kernel. They are held to
``jax.vjp`` of ``pallas_gru_sequence_tm`` (f32, and ``dtype=bfloat16``),
whose backward is the Pallas ``_bwd_kernel`` run in interpret mode, at d_in
= 1, 32, 33 and 96 (one, two and three 32-chunks of the kernel's x rows),
mask and no mask, with an h0. Inputs and weights are drawn with numpy from
a seed and handed to both sides in f32.

Tolerances: f32 at atol = rtol = 1e-5 (tests/test_torch_ops.py's: the two
sides sum in other orders, and the Pallas GRU writes sigmoid through
tanh); bf16 at 2e-2 of each output's max abs (tests/test_torch_bf16.py's:
both round at the same places, but a flipped bf16 rounding runs on through
the recurrence as a few bf16 ulps). The CUDA wrapper ``bwd_pass`` on CPU
tensors runs ``gru_bwd_pass``; both are held to the same sums in float64
at 1e-6 of max abs (f32 sums of at most T*B = 40 products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.ops.gru import (GRUWeights, gru_bwd_pass, gru_scan_tm,
                                    gru_scan_tm_bf16, gru_scan_tm_bwd,
                                    gru_scan_tm_bwd_bf16)

TOL_F32 = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL_BF16 = 2e-2  # of each output's max abs
TOL_PASS = 1e-6       # of max abs, against float64
BF16 = torch.bfloat16


@pytest.fixture
def interpret():
    pg._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = False


def _inputs(seed, T, B, d_in, masked):
    rng = np.random.default_rng(seed)
    w = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 96)),
             wh=rng.uniform(-0.5, 0.5, (32, 96)),
             b=rng.uniform(-0.1, 0.1, (96,)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    h0 = rng.uniform(-0.9, 0.9, (B, 32)).astype(np.float32)
    dh_seq = rng.standard_normal((T, B, 32)).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(1, T + 1, size=B)
        mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return w, x, h0, dh_seq, mask


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("d_in", [1, 32, 33, 96])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_scan_backward_matches_pallas_vjp(interpret, d_in, masked, bf16):
    """dx, dwx, dwh, db and dh0 of the plain backward (its sweep, then
    gru_bwd_pass) == the Pallas backward kernel's, f32 and bf16."""
    T, B = 8, 3
    w, x, h0, dh_seq, mask = _inputs(d_in + 2 * masked + 4 * bf16, T, B,
                                     d_in, masked)
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def j_fn(p, xx, hh):
        return pg.pallas_gru_sequence_tm(
            p, xx, None if mask is None else jnp.asarray(mask), h0=hh,
            dtype=jdt)[0]

    _, vjp = jax.vjp(j_fn, JGRUParams(**w), jnp.asarray(x), jnp.asarray(h0))
    j_dp, j_dx, j_dh0 = vjp(jnp.asarray(dh_seq, jdt))
    want = (j_dx, j_dp.wx, j_dp.wh, j_dp.b, j_dh0)

    dt = BF16 if bf16 else torch.float32
    params = GRUWeights(*(torch.from_numpy(w[k]).to(dt)
                          for k in ("wx", "wh", "b")))
    x_t, h0_t = torch.from_numpy(x).to(dt), torch.from_numpy(h0).to(dt)
    m_t = None if mask is None else torch.from_numpy(mask).to(dt)
    fwd, bwd = ((gru_scan_tm_bf16, gru_scan_tm_bwd_bf16) if bf16
                else (gru_scan_tm, gru_scan_tm_bwd))
    h_seq, _ = fwd(params, x_t, m_t, h0_t)
    got = bwd(params, x_t, m_t, h_seq, torch.from_numpy(dh_seq).to(dt), h0_t)
    assert got[0].dtype == dt
    assert all(t.dtype == torch.float32 for t in got[1:])
    for name, g, ref in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert g.shape == ref.shape, name
        if bf16:
            assert _rel(g, ref) <= GRAD_TOL_BF16, name
        else:
            np.testing.assert_allclose(_f32(g), _f32(ref), **TOL_F32,
                                       err_msg=name)


def _pass_inputs(seed, T, B, d_in, dtype):
    """x on a strided time view, h_prev, and gate gradients whose r and z
    blocks dpre_x and dpre_h share, as the scan's do."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dtype)[1::3]
    h_prev = torch.rand(T, B, 32, generator=g).mul(2).sub(1).to(dtype)
    dr, dz, dc, dcr = torch.randn(4, T, B, 32, generator=g).to(dtype)
    wx = torch.rand(d_in, 96, generator=g).sub(0.5).to(dtype)
    return (x, h_prev, torch.cat([dr, dz, dc], -1),
            torch.cat([dr, dz, dcr], -1), wx)


@pytest.mark.parametrize("d_in", [1, 32, 33, 96])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_bwd_pass_wrapper_on_cpu_matches_float64(d_in, dtype):
    """cuda_gru.bwd_pass on CPU tensors runs gru_bwd_pass (no launch) and
    both give the pass's sums, computed here in float64 one by one."""
    T, B = 5, 8
    x, h_prev, dpx, dph, wx = _pass_inputs(d_in, T, B, d_in, dtype)
    n = cuda_gru.pass_launches
    got = cuda_gru.bwd_pass(wx, x, h_prev, dpx, dph)
    assert cuda_gru.pass_launches == n
    plain = gru_bwd_pass(x, h_prev, dpx, dph, wx)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    x64, hp64, dpx64, dph64, wx64 = (t.double() for t in (x, h_prev, dpx,
                                                          dph, wx))
    want = (dpx64 @ wx64.T,
            sum(x64[t].T @ dpx64[t] for t in range(T)),
            sum(hp64[t].T @ dph64[t] for t in range(T)),
            dpx64.sum(dim=(0, 1)))
    assert got[0].dtype == dtype and got[0].shape == (T, B, d_in)
    assert all(t.dtype == torch.float32 for t in got[1:])
    # dx is rounded to the stream type once: half an ulp of bf16.
    tols = (2 ** -8 if dtype == BF16 else TOL_PASS,) + (TOL_PASS,) * 3
    for name, g, ref, tol in zip(("dx", "dwx", "dwh", "db"), got, want,
                                 tols):
        assert g.shape == ref.shape, name
        assert _rel(g.double(), ref) <= tol, name


def test_k2_workspace_steps(monkeypatch):
    """K2's chunk of steps: as many rows of dg [., B, 128] in the stream
    dtype as fit the workspace cap, 1 to T."""
    assert cuda_gru.bwd_workspace_steps(1000, 512, torch.float32) == 256
    assert cuda_gru.bwd_workspace_steps(1000, 512, BF16) == 512
    assert cuda_gru.bwd_workspace_steps(300, 6400, torch.float32) == 20
    assert cuda_gru.bwd_workspace_steps(20, 512, torch.float32) == 20
    assert cuda_gru.bwd_workspace_steps(5, 10 ** 6, BF16) == 1
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * 5 * 128 * 2 + 1)
    assert cuda_gru.bwd_workspace_steps(50, 5, BF16) == 7
    assert cuda_gru.bwd_workspace_steps(50, 5, torch.float32) == 3
