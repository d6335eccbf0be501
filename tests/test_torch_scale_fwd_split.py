"""The AUGRU scan forward as two parts, the input projection and the
recurrence, against the JAX package on the CPU.

K1-scale and K1-scale-bf16 (``csrc/gru_scan_fwd.cu``'s
``hpmn_gru_scan_fwd_scale_ws`` and ``_bf16_ws``) run, per workspace chunk
of steps, K1's input projection (``csrc/gru_input_proj.cu``) and then K1's
recurrence with the gate scale a_t beside the mask (``kScale``). Their
plain versions are ``gru_input_proj`` (``gru_input_proj_bf16``) and
``gru_scan_tm_xp`` (``gru_scan_tm_xp_bf16``) with a ``scale_tm``; here the
two, composed by hand, are held to ``pallas_gru_sequence_tm(...,
gate_scale_tm=...)``, the Pallas ``_fwd_kernel`` with ``has_scale`` in
interpret mode, at d_in = 1, 32, 33 and 96, mask and no mask, f32 and
bf16, h0 absent and given. Inputs, weights and the scale (in [0, 1),
DIEN's attention) are drawn with numpy from a seed and handed to both
sides in f32.

Tolerances as tests/test_torch_stride_fwd_split.py: f32 at 1e-5 abs, bf16
within 2e-2 of each output's max abs. A run in chunks, each from the last
one's final state, gives one chunk's outputs bit for bit, and the plain
scans ``gru_scan_tm`` (``_bf16``) with a scale are the composed parts bit
for bit. The C call's arguments (workspace, chunk, scale pointer and time
stride) are checked through the ``_k1`` seam with a stand-in for the C
function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.ops.gru import (GRUWeights, gru_input_proj,
                                    gru_input_proj_bf16, gru_scan_tm,
                                    gru_scan_tm_bf16, gru_scan_tm_xp,
                                    gru_scan_tm_xp_bf16)

H_TOL = 1e-5       # f32, abs
BF16_H_TOL = 2e-2  # bf16, of each output's max abs
BF16 = torch.bfloat16
B = 5


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


def _case(T, seed, d_in, masked):
    rng = np.random.default_rng(seed)
    w = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 96)),
             wh=rng.uniform(-0.5, 0.5, (32, 96)),
             b=rng.uniform(-0.1, 0.1, (96,)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    h0 = rng.uniform(-0.9, 0.9, (B, 32)).astype(np.float32)
    scale = rng.uniform(0.0, 1.0, (T, B)).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(1, T + 1, size=B)
        mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return w, x, h0, scale, mask


def _torch(w, x, h0, scale, mask, bf16):
    dt = BF16 if bf16 else torch.float32
    tw = GRUWeights(*(torch.from_numpy(w[k]).to(dt)
                      for k in ("wx", "wh", "b")))
    return (tw, torch.from_numpy(x).to(dt), torch.from_numpy(h0).to(dt),
            torch.from_numpy(scale).to(dt),
            None if mask is None else torch.from_numpy(mask).to(dt))


def _parts(bf16):
    """(the projection, the recurrence) of K1-scale, or of K1-scale-bf16."""
    return ((gru_input_proj_bf16, gru_scan_tm_xp_bf16) if bf16
            else (gru_input_proj, gru_scan_tm_xp))


@pytest.mark.parametrize("d_in,with_h0", [(1, True), (32, False),
                                          (33, True), (96, False)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_scale_fwd_parts_match_pallas(interpret, d_in, with_h0, masked,
                                      bf16):
    """gru_input_proj (_bf16), then gru_scan_tm_xp (_bf16) on its xp with
    the scale == the Pallas has_scale forward kernel's h_seq and h_T."""
    T = 21
    w, x, h0, scale, mask = _case(
        T, 60 + d_in + 2 * masked + 4 * bf16, d_in, masked)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = pg.pallas_gru_sequence_tm(
        JGRUParams(**{k: jnp.asarray(v) for k, v in w.items()}),
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jnp.asarray(scale), h0=jnp.asarray(h0) if with_h0 else None,
        dtype=jdt)
    tw, tx, th0, ta, tm = _torch(w, x, h0, scale, mask, bf16)
    proj, rec = _parts(bf16)
    xp = proj(tw, tx)
    assert xp.dtype == torch.float32 and xp.shape == (T, B, 96)
    h_seq, h_T = rec(tw, xp, tm, th0 if with_h0 else None, ta)
    assert h_seq.dtype == h_T.dtype == tx.dtype
    assert h_seq.shape == (T, B, 32) and torch.equal(h_T, h_seq[-1])
    for name, got, ref in zip(("h_seq", "h_T"), (h_seq, h_T), want):
        ref = _f32(ref)
        assert got.shape == ref.shape, name
        err = float(np.abs(_f32(got) - ref).max())
        if bf16:
            assert err <= BF16_H_TOL * float(np.abs(ref).max()), name
        else:
            assert err <= H_TOL, name


@pytest.mark.parametrize("bf16", [False, True])
def test_scale_fwd_parts_are_the_plain_scan(bf16):
    """The plain scan gru_scan_tm (_bf16) with a scale is its projection
    then its recurrence, bit for bit, mask and no mask, h0 absent and
    given."""
    T = 17
    for masked in (False, True):
        w, x, h0, scale, mask = _case(T, 5 + masked, 33, masked)
        tw, tx, th0, ta, tm = _torch(w, x, h0, scale, mask, bf16)
        plain = gru_scan_tm_bf16 if bf16 else gru_scan_tm
        proj, rec = _parts(bf16)
        for h in (None, th0):
            want = plain(tw, tx, tm, h, ta)
            got = rec(tw, proj(tw, tx), tm, h, ta)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("steps", [1, 7, 16])
def test_scale_fwd_chunks_match_one_chunk(bf16, steps):
    """Chunks of `steps` steps (the last one shorter), each its own
    projection and a recurrence from the last chunk's final state, with
    the chunk's rows of the mask and the scale, give one chunk's h_seq and
    h_T bit for bit: the carry is the state itself, in the stream type."""
    T = 40
    w, x, h0, scale, mask = _case(T, 11 + steps, 32, True)
    tw, tx, th0, ta, tm = _torch(w, x, h0, scale, mask, bf16)
    proj, rec = _parts(bf16)
    whole = rec(tw, proj(tw, tx), tm, th0, ta)
    parts, h = [], th0
    for t0 in range(0, T, steps):
        sl = slice(t0, t0 + steps)
        h_seq, h = rec(tw, proj(tw, tx[sl]), tm[sl], h, ta[sl])
        parts.append(h_seq)
    assert torch.equal(torch.cat(parts), whole[0])
    assert torch.equal(h, whole[1])


def test_k1_scale_c_arguments(monkeypatch):
    """_k1 with a scale_tm allocates K1's workspace (workspace_steps) and
    passes K1-scale's C entry point its arguments in order: the scale's
    pointer and time stride after the mask's; without one, K1's entry
    point and no scale. Here the scale is a strided time view."""
    calls = []

    def fake_fn(dtype, scaled=False):
        def fn(*args):
            calls.append((dtype, scaled, args))
            return 0
        return fn

    monkeypatch.setattr(cuda_gru, "_ws_fn", fake_fn)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * B * 96 * 4)
    T, d_in = 20, 6
    assert cuda_gru.workspace_steps(T, B) == 7
    w, x, h0, scale, mask = _case(2 * T, 1, d_in, True)
    for bf16 in (False, True):
        tw, tx, th0, ta, tm = _torch(w, x[:T], h0, scale, mask[:T], bf16)
        a_view = ta[1::2]  # [T, B], time stride 2B, unit batch stride
        hseq = torch.empty(T, B, 32, dtype=tx.dtype)
        for a, m, h in ((a_view, tm, th0), (a_view, None, None),
                        (None, tm, th0)):
            calls.clear()
            assert cuda_gru._k1(tw, tx, m, h, hseq, 99, scale_tm=a) == 0
            (dtype, scaled, args), = calls
            assert dtype == tx.dtype and scaled == (a is not None)
            assert args[:2] == (tx.data_ptr(), tx.stride(0))
            assert args[2:4] == ((None, 0) if m is None
                                 else (m.data_ptr(), m.stride(0)))
            rest = args[4:]
            if a is not None:
                assert rest[:2] == (a.data_ptr(), 2 * B)
                rest = rest[2:]
            assert rest[:5] == (tw.wx.data_ptr(), tw.wh.data_ptr(),
                                tw.b.data_ptr(),
                                None if h is None else h.data_ptr(),
                                hseq.data_ptr())
            assert rest[6:] == (7, T, B, d_in, 99)  # t_chunk, T, B, ...
