"""The AUGRU scan backward as two parts, the reverse gate sweep and the dx
and weight-gradient pass, against the JAX package on the CPU.

K2-scale and K2-scale-bf16 (``csrc/gru_scan_bwd.cu``'s
``hpmn_gru_scan_bwd_scale_ws`` and ``_bf16_ws``) run, per workspace chunk
of steps from the last, K2's recurrence with the gate scale (it writes the
gate gradients, dz carrying the factor a_t, and dscale) and then K2's pass
(``csrc/gru_bwd_pass.cu``). Their plain versions are ``gru_scan_tm_sweep``
(``_bf16``) with a ``scale_tm`` and ``gru_bwd_pass``; here the two,
composed by hand, are held to ``jax.vjp`` of ``pallas_gru_sequence_tm(...,
gate_scale_tm=...)``, whose backward is the Pallas ``_bwd_kernel`` with
``has_scale`` run in interpret mode, at d_in = 1, 32, 33 and 96, mask and
no mask, f32 and bf16, with an h0: dx, dwx, dwh, db, dh0 and dscale.
Inputs, weights and the scale (in [0, 1), DIEN's attention) are drawn with
numpy from a seed and handed to both sides in f32.

Tolerances as tests/test_torch_bwd_pass.py: f32 at atol = rtol = 1e-5;
bf16 at 2e-2 of each output's max abs, which holds the known no-mask
excess-precision gap of the TPU kernel's bf16 dscale (6.03e-3 of max abs,
dx 6.68e-3). ``cuda_gru.bwd_gates`` on CPU tensors returns the plain
sweep's gate gradients in the recurrence's layout, and the pass on them
gives ``gru_scan_tm_bwd``'s outputs bit for bit. The C call's arguments
(workspaces, chunk, scale and dscale) are checked through the ``_k2`` seam
with a stand-in for the C function.
"""

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
                                    gru_scan_tm_bwd_bf16, gru_scan_tm_sweep,
                                    gru_scan_tm_sweep_bf16)

TOL_F32 = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL_BF16 = 2e-2  # of each output's max abs
BF16 = torch.bfloat16
NAMES = ("dx", "dwx", "dwh", "db", "dh0", "dscale")


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
    scale = rng.uniform(0.0, 1.0, (T, B)).astype(np.float32)
    dh_seq = rng.standard_normal((T, B, 32)).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(1, T + 1, size=B)
        mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return w, x, h0, scale, dh_seq, mask


def _torch(w, x, h0, scale, dh_seq, mask, dt):
    params = GRUWeights(*(torch.from_numpy(w[k]).to(dt)
                          for k in ("wx", "wh", "b")))
    return (params, torch.from_numpy(x).to(dt), torch.from_numpy(h0).to(dt),
            torch.from_numpy(scale).to(dt), torch.from_numpy(dh_seq).to(dt),
            None if mask is None else torch.from_numpy(mask).to(dt))


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
def test_scale_sweep_then_pass_matches_pallas_vjp(interpret, d_in, masked,
                                                  bf16):
    """The plain AUGRU sweep (the plain version of K2-scale's recurrence),
    then gru_bwd_pass (its second kernel's) == the Pallas has_scale
    backward kernel: dx, dwx, dwh, db, dh0 and dscale, f32 and bf16."""
    T, B = 9, 3
    w, x, h0, scale, dh_seq, mask = _inputs(
        40 + d_in + 2 * masked + 4 * bf16, T, B, d_in, masked)
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def j_fn(p, xx, aa, hh):
        return pg.pallas_gru_sequence_tm(
            p, xx, None if mask is None else jnp.asarray(mask), aa, h0=hh,
            dtype=jdt)[0]

    _, vjp = jax.vjp(j_fn, JGRUParams(**w), jnp.asarray(x),
                     jnp.asarray(scale), jnp.asarray(h0))
    j_dp, j_dx, j_da, j_dh0 = vjp(jnp.asarray(dh_seq, jdt))
    want = (j_dx, j_dp.wx, j_dp.wh, j_dp.b, j_dh0, j_da)

    dt = BF16 if bf16 else torch.float32
    params, x_t, h0_t, a_t, dh_t, m_t = _torch(w, x, h0, scale, dh_seq, mask,
                                               dt)
    fwd, sweep = ((gru_scan_tm_bf16, gru_scan_tm_sweep_bf16) if bf16
                  else (gru_scan_tm, gru_scan_tm_sweep))
    h_seq, _ = fwd(params, x_t, m_t, h0_t, a_t)
    dpre_x, dpre_h, h_prev, dh0, dscale = sweep(params, x_t, m_t, h_seq,
                                                dh_t, h0_t, a_t)
    assert torch.equal(h_prev[0], h0_t) and torch.equal(h_prev[1:],
                                                        h_seq[:-1])
    assert torch.equal(dpre_x[..., :64], dpre_h[..., :64])
    got = gru_bwd_pass(x_t, h_prev, dpre_x, dpre_h, params.wx) + (dh0,
                                                                  dscale)
    assert got[0].dtype == dt and got[5].dtype == dt
    assert all(t.dtype == torch.float32 for t in got[1:5])
    for name, g, ref in zip(NAMES, got, want):
        assert g.shape == ref.shape, name
        if bf16:
            assert _rel(g, ref) <= GRAD_TOL_BF16, name
        else:
            np.testing.assert_allclose(_f32(g), _f32(ref), **TOL_F32,
                                       err_msg=name)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_bwd_gates_on_cpu_is_the_plain_sweep(dtype, scaled):
    """cuda_gru.bwd_gates on CPU tensors launches nothing and returns the
    plain sweep's gate gradients in the recurrence's layout dg [T, B, 32,
    4] (lane k's dr, dz, dc, dc*r), its dh0 and dscale (None without a
    scale); the pass on that dg gives gru_scan_tm_bwd's outputs bit for
    bit, the layout's inverse the sweep's blocks."""
    T, B, d_in = 11, 4, 33
    w, x, h0, scale, dh_seq, mask = _inputs(7 + scaled, T, B, d_in, True)
    params, x_t, h0_t, a_t, dh_t, m_t = _torch(w, x, h0, scale, dh_seq, mask,
                                               dtype)
    a_t = a_t if scaled else None
    bf16 = dtype == BF16
    fwd, bwd, sweep = ((gru_scan_tm_bf16, gru_scan_tm_bwd_bf16,
                        gru_scan_tm_sweep_bf16) if bf16
                       else (gru_scan_tm, gru_scan_tm_bwd, gru_scan_tm_sweep))
    h_seq, _ = fwd(params, x_t, m_t, h0_t, a_t)
    counts = (cuda_gru.bwd_launches, cuda_gru.bwd_launches_bf16,
              cuda_gru.bwd_launches_scale, cuda_gru.bwd_launches_scale_bf16,
              cuda_gru.pass_launches)
    dg, dh0, dscale = cuda_gru.bwd_gates(params, x_t, m_t, h_seq, dh_t, h0_t,
                                         a_t)
    assert (cuda_gru.bwd_launches, cuda_gru.bwd_launches_bf16,
            cuda_gru.bwd_launches_scale, cuda_gru.bwd_launches_scale_bf16,
            cuda_gru.pass_launches) == counts
    dpre_x, dpre_h, h_prev, dh0_p, dscale_p = sweep(params, x_t, m_t, h_seq,
                                                    dh_t, h0_t, a_t)
    assert dg.shape == (T, B, 32, 4) and dg.dtype == dtype
    assert dg.is_contiguous()
    for j, (src, blk) in enumerate(((dpre_x, 0), (dpre_x, 1), (dpre_x, 2),
                                    (dpre_h, 2))):
        assert torch.equal(dg[..., j], src[..., 32 * blk:32 * (blk + 1)])
    for a, b in zip(cuda_gru.gate_blocks(dg), (dpre_x, dpre_h)):
        assert torch.equal(a, b)
    assert torch.equal(dh0, dh0_p) and dh0.dtype == torch.float32
    if scaled:
        assert dscale.shape == (T, B) and dscale.dtype == dtype
        assert torch.equal(dscale, dscale_p)
    else:
        assert dscale is None and dscale_p is None
    got = cuda_gru.bwd_pass_dg(params.wx, x_t, h_prev, dg) + (dh0,)
    want = bwd(params, x_t, m_t, h_seq, dh_t, h0_t, a_t)
    assert len(want) == 5 + scaled
    for name, a, b in zip(NAMES, got + ((dscale,) if scaled else ()), want):
        assert torch.equal(a, b), name


def test_k2_seam_passes_the_workspaces_and_the_scale(monkeypatch):
    """_k2 allocates K2's workspaces for every form (dg [t_chunk, B, 32, 4]
    in x's dtype, acc [B, (d_in_pad + 33) * 96] in f32), takes t_chunk
    from bwd_workspace_steps unless given, and passes the C entry point of
    its dtype and scale its arguments in order: with a scale_tm, the
    scale's pointer and time stride after the mask's, and dscale after the
    partials; it returns the code and dg."""
    T, B, d_in = 20, 5, 6
    calls = []

    def fake_fn(dtype, scaled=False):
        def fn(*args):
            calls.append((dtype, scaled, args))
            return 0
        return fn

    monkeypatch.setattr(cuda_gru, "_bwd_fn", fake_fn)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * B * 128 * 4)
    w, x, h0, scale, dh_seq, mask = _inputs(3, 3 * T, B, d_in, True)
    for dt in (torch.float32, BF16):
        params, x_t, h0_t, a_t, dh_t, m_t = _torch(w, x, h0, scale, dh_seq,
                                                   mask, dt)
        x_t, m_t, a_t = x_t[1::3], m_t[2::3], a_t[::3]  # time strides
        hseq, dhseq = dh_t[:T].contiguous(), dh_t[T:2 * T].contiguous()
        es = x_t.element_size()
        steps = cuda_gru.bwd_workspace_steps(T, B, dt)
        assert steps == (7 if dt == torch.float32 else 14)
        for a, h, t_chunk in ((None, None, None), (a_t, h0_t, None),
                              (a_t, None, T)):
            outs = [torch.empty(1, dtype=dt) for _ in range(5)]
            if a is not None:
                outs.append(torch.empty(T, B, dtype=dt))
            calls.clear()
            code, dg = cuda_gru._k2(params, x_t, m_t, h, hseq, dhseq,
                                    tuple(outs), 99, scale_tm=a,
                                    t_chunk=t_chunk)
            n = steps if t_chunk is None else t_chunk
            assert code == 0 and dg.shape == (n, B, 32, 4)
            assert dg.dtype == dt and dg.element_size() == es
            (dtype, scaled, args), = calls
            assert (dtype, scaled) == (dt, a is not None)
            head = [x_t.data_ptr(), x_t.stride(0), m_t.data_ptr(),
                    m_t.stride(0)]
            assert m_t.stride(0) == 3 * B and x_t.stride(0) == 3 * B * d_in
            if a is not None:
                head += [a.data_ptr(), a.stride(0)]
                assert a.stride(0) == 3 * B
            k = len(head)
            assert list(args[:k]) == head
            assert args[k:k + 6] == (params.wx.data_ptr(),
                                     params.wh.data_ptr(),
                                     params.b.data_ptr(),
                                     None if h is None else h.data_ptr(),
                                     hseq.data_ptr(), dhseq.data_ptr())
            k += 6
            assert args[k:k + len(outs)] == tuple(t.data_ptr() for t in outs)
            k += len(outs)
            assert args[k] == dg.data_ptr()
            assert args[k + 2:] == (n, T, B, d_in, 99)
    assert cuda_gru._acc_floats(6) == (32 + 33) * 96
