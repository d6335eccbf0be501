"""The port's bf16 scan chain against the JAX package's on the CPU.

``pallas_gru_sequence_tm(..., dtype=bfloat16)`` runs in interpret mode and
its ``jax.vjp`` is the Pallas backward kernel's bf16 form. The port's side
is ``GRUScan`` on CPU tensors, which runs the plain ``gru_scan_tm_bf16`` and
``gru_scan_tm_bwd_bf16`` (the versions that K1-bf16 and K2-bf16 are held to
on the card). Inputs and weights are drawn with numpy from a seed and
handed to both sides in f32; each side casts them to bf16.

Tolerances. Against the JAX bf16 path: h at 2e-2 abs, gradients at 2e-2 of
their max abs. Both sides round at the same places, so where their f32
sums agree they agree bit for bit; where an f32 sum is taken in another
order, one bf16 rounding flips and the flip runs on through the
recurrence as a few bf16 ulps (2^-8 at |h| in [0.5, 1)). Against the f32
path: h at 0.06, the bound that ``tests/test_pallas.py`` holds the JAX bf16
kernel to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.ops.gru import (GRUWeights, gru_scan_tm, gru_scan_tm_bf16,
                                    gru_scan_tm_bwd_bf16)

H_TOL = 2e-2
GRAD_TOL = 2e-2   # of each gradient's max abs
F32_TOL = 0.06
BF16 = torch.bfloat16


@pytest.fixture
def interpret():
    pg._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = False


def _weights(rng, d_in, d_m=32):
    return dict(wx=rng.uniform(-0.5, 0.5, (d_in, 3 * d_m)).astype(np.float32),
                wh=rng.uniform(-0.5, 0.5, (d_m, 3 * d_m)).astype(np.float32),
                b=rng.uniform(-0.1, 0.1, (3 * d_m,)).astype(np.float32))


def _left_pad_mask_tm(rng, T, B):
    lens = rng.integers(1, T + 1, size=B)
    return (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)


def _f32(a):
    """A torch tensor or a JAX array, as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _abs(got, want):
    return np.abs(_f32(got) - _f32(want)).max()


@pytest.mark.parametrize("use_mask,strided", [
    (False, False), (True, False), (False, True), (True, True)])
def test_bf16_scan_and_grads_match_pallas_bf16(interpret, use_mask, strided):
    """h_seq and every gradient (x, wx, wh, b) through GRUScan in bf16 on
    CPU tensors == pallas_gru_sequence_tm(dtype=bfloat16) and its jax.vjp,
    cotangents on both h_seq and h_T; the layer's input a strided time
    view (h_seq[2::3] of a layer below) where ``strided``."""
    rng = np.random.default_rng(11 + 2 * use_mask + strided)
    T, B, d_in = (13, 4, 32) if strided else (27, 4, 16)
    w = _weights(rng, d_in)
    x_all = rng.standard_normal((3 * T if strided else T, B, d_in)
                                ).astype(np.float32)
    mask = _left_pad_mask_tm(rng, T, B) if use_mask else None
    dh_seq = rng.standard_normal((T, B, 32)).astype(np.float32)
    dh_T = rng.standard_normal((B, 32)).astype(np.float32)

    def j_fn(p, xa):
        return pg.pallas_gru_sequence_tm(
            p, xa[2::3] if strided else xa,
            None if mask is None else jnp.asarray(mask), dtype=jnp.bfloat16)

    (h_j, hT_j), vjp = jax.vjp(j_fn, JGRUParams(**w), jnp.asarray(x_all))
    j_dp, j_dx = vjp((jnp.asarray(dh_seq, jnp.bfloat16),
                      jnp.asarray(dh_T, jnp.bfloat16)))

    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in w.items()}
    x_leaf = torch.from_numpy(x_all).requires_grad_(True)
    x_tm = x_leaf.to(BF16)
    h_seq, h_T = cuda_gru.gru_sequence_tm(
        GRUWeights(*(leaves[k].to(BF16) for k in ("wx", "wh", "b"))),
        x_tm[2::3] if strided else x_tm,
        None if mask is None else torch.from_numpy(mask).to(BF16))
    assert h_seq.dtype == h_T.dtype == BF16
    assert _abs(h_seq, h_j) <= H_TOL
    assert _abs(h_T, hT_j) <= H_TOL
    got = torch.autograd.grad(
        (h_seq, h_T), [x_leaf, leaves["wx"], leaves["wh"], leaves["b"]],
        (torch.from_numpy(dh_seq).to(BF16), torch.from_numpy(dh_T).to(BF16)))
    for name, g, ref in zip(("dx", "dwx", "dwh", "db"), got,
                            (j_dx, j_dp.wx, j_dp.wh, j_dp.b)):
        assert g.dtype == torch.float32, name
        assert _rel(g, ref) <= GRAD_TOL, name


@pytest.mark.parametrize("use_mask", [False, True])
def test_plain_bf16_backward_matches_pallas_vjp(interpret, use_mask):
    """gru_scan_tm_bwd_bf16 called directly (dx bf16, f32 weight sums and
    dh0) == the Pallas bf16 backward, with an h0."""
    rng = np.random.default_rng(21 + use_mask)
    T, B, d_in = 30, 4, 8
    w = _weights(rng, d_in)
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    h0 = rng.uniform(-0.9, 0.9, (B, 32)).astype(np.float32)
    mask = _left_pad_mask_tm(rng, T, B) if use_mask else None
    dh_seq = rng.standard_normal((T, B, 32)).astype(np.float32)

    def j_fn(p, xx, hh):
        return pg.pallas_gru_sequence_tm(
            p, xx, None if mask is None else jnp.asarray(mask), h0=hh,
            dtype=jnp.bfloat16)[0]

    h_j, vjp = jax.vjp(j_fn, JGRUParams(**w), jnp.asarray(x),
                       jnp.asarray(h0))
    j_dp, j_dx, j_dh0 = vjp(jnp.asarray(dh_seq, jnp.bfloat16))

    params = GRUWeights(*(torch.from_numpy(w[k]).to(BF16)
                          for k in ("wx", "wh", "b")))
    x_b = torch.from_numpy(x).to(BF16)
    m_b = None if mask is None else torch.from_numpy(mask).to(BF16)
    h0_b = torch.from_numpy(h0).to(BF16)
    h_seq, _ = gru_scan_tm_bf16(params, x_b, m_b, h0_b)
    assert _abs(h_seq, h_j) <= H_TOL
    dx, dwx, dwh, db, dh0 = gru_scan_tm_bwd_bf16(
        params, x_b, m_b, h_seq, torch.from_numpy(dh_seq).to(BF16), h0_b)
    assert dx.dtype == BF16
    assert all(t.dtype == torch.float32 for t in (dwx, dwh, db, dh0))
    for name, g, ref in zip(("dx", "dwx", "dwh", "db", "dh0"),
                            (dx, dwx, dwh, db, dh0),
                            (j_dx, j_dp.wx, j_dp.wh, j_dp.b, j_dh0)):
        assert _rel(g, ref) <= GRAD_TOL, name


@pytest.mark.parametrize("seed,T,B,d_in", [
    (0, 20, 3, 8), (1, 30, 4, 32), (2, 1, 2, 5), (3, 17, 1, 6)])
def test_plain_bf16_scan_tracks_f32(seed, T, B, d_in):
    """The bf16 chain stays within 0.06 of the f32 scan on the same
    weights, mask and no mask (tests/test_pallas.py's bound for the JAX
    bf16 kernel against its f32 oracle)."""
    rng = np.random.default_rng(seed)
    w = _weights(rng, d_in)
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    mask = _left_pad_mask_tm(rng, T, B)
    w32 = GRUWeights(*(torch.from_numpy(w[k]) for k in ("wx", "wh", "b")))
    w16 = GRUWeights(*(t.to(BF16) for t in w32))
    for m in (None, torch.from_numpy(mask)):
        h32, hT32 = gru_scan_tm(w32, torch.from_numpy(x), m)
        h16, hT16 = gru_scan_tm_bf16(w16, torch.from_numpy(x).to(BF16),
                                     None if m is None else m.to(BF16))
        assert h16.dtype == BF16
        assert _abs(h16, h32) <= F32_TOL
        assert _abs(hT16, hT32) <= F32_TOL


def test_gru_scan_function_bf16_weight_grads():
    """GRUScan on bf16 CPU tensors returns bf16 gradients for bf16 weights
    (the f32 sums rounded once, as the TPU kernel's astype after its tile
    sum), and autograd carries them unchanged into f32 parameters."""
    rng = np.random.default_rng(5)
    T, B, d_in = 9, 3, 6
    w = _weights(rng, d_in)
    x = torch.from_numpy(rng.standard_normal((T, B, d_in)).astype(np.float32))
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 32)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((T, B, 32)).astype(np.float32))
    f32 = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    b16 = {k: v.detach().to(BF16).requires_grad_(True)
           for k, v in f32.items()}
    args = (x.to(BF16), None, h0.to(BF16))
    out16 = cuda_gru.GRUScan.apply(*args, b16["wx"], b16["wh"], b16["b"])
    g16 = torch.autograd.grad(out16, list(b16.values()), dh.to(BF16))
    assert all(g.dtype == BF16 for g in g16)
    out32 = cuda_gru.GRUScan.apply(*args, *(f32[k].to(BF16)
                                            for k in ("wx", "wh", "b")))
    assert torch.equal(out32, out16)
    g32 = torch.autograd.grad(out32, list(f32.values()), dh.to(BF16))
    for a, b in zip(g32, g16):
        assert a.dtype == torch.float32
        assert torch.equal(a, b.float())
    # the weight gradients are the plain backward's f32 sums, rounded once
    ref = gru_scan_tm_bwd_bf16(GRUWeights(*(b16[k].detach()
                                            for k in ("wx", "wh", "b"))),
                               x.to(BF16), None, out16.detach(), dh.to(BF16),
                               h0.to(BF16))
    for g, r in zip(g16, ref[1:4]):
        assert torch.equal(g, r.to(BF16))
