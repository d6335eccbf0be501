"""The strided scan forward as two parts, the input projection and the
recurrence, against the JAX package on the CPU.

K3 and K3-bf16 (``csrc/gru_scan_fwd.cu``'s ``hpmn_gru_scan_stride_fwd_ws``
and ``_bf16_ws``) run, per workspace chunk of steps, K1's input projection
(``csrc/gru_input_proj.cu``) and then K1's recurrence with the strided
output policy, which writes the strided rows, the state at the start of
every 16-step chunk and h_T. Their plain versions are ``gru_input_proj``
(``gru_input_proj_bf16``) and ``gru_scan_stride_tm_xp`` (``_bf16``); here
the two, composed by hand, are held to ``pallas_gru_stride_tm`` (the
Pallas stride kernel in interpret mode; with an h0, the custom_vjp core it
calls), f32 and bf16, at T not a multiple of 16, period 2 and 3, h0 absent
and given. Inputs and weights are drawn with numpy from a seed.

Tolerances as tests/test_torch_stride_split.py: f32 at 1e-5 abs, bf16
within 2e-2 of each output's max abs. The boundaries are the plain
states before steps 0, 16, 32, ... bit for bit (h0 first), and a run in
chunks, each from the last one's h_T, gives one chunk's outputs bit for
bit. K3's workspace (``cuda_gru.workspace_steps``) and its C call's
arguments are checked through the ``_k3`` seam with a stand-in for the C
function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride
from hpmn_tpu_torch.ops.gru import (STRIDE_CHUNK, GRUWeights, gru_input_proj,
                                    gru_input_proj_bf16, gru_scan_stride_tm,
                                    gru_scan_stride_tm_bf16,
                                    gru_scan_stride_tm_sweep,
                                    gru_scan_stride_tm_xp,
                                    gru_scan_stride_tm_xp_bf16,
                                    gru_scan_tm_bf16)

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


def _case(T, seed, d_in=6):
    rng = np.random.default_rng(seed)
    w = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 96)),
             wh=rng.uniform(-0.5, 0.5, (32, 96)),
             b=rng.uniform(-0.1, 0.1, (96,)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    h0 = rng.uniform(-0.9, 0.9, (B, 32)).astype(np.float32)
    return w, x, h0


def _torch(w, x, h0, bf16):
    dt = BF16 if bf16 else torch.float32
    tw = GRUWeights(*(torch.from_numpy(w[k]).to(dt)
                      for k in ("wx", "wh", "b")))
    return tw, torch.from_numpy(x).to(dt), torch.from_numpy(h0).to(dt)


def _parts(bf16):
    """(the projection, the recurrence) of K3, or of K3-bf16."""
    return ((gru_input_proj_bf16, gru_scan_stride_tm_xp_bf16) if bf16
            else (gru_input_proj, gru_scan_stride_tm_xp))


def _pallas(w, x, h0, period, dtype):
    """pallas_gru_stride_tm (h0 = 0), or its custom_vjp core with h0 ->
    (h_stride, h_T) as float32."""
    p = JGRUParams(**{k: jnp.asarray(v) for k, v in w.items()})
    if h0 is None:
        out = pg.pallas_gru_stride_tm(p, jnp.asarray(x), period, dtype=dtype)
    else:
        core = pg._make_stride_core(period, jnp.dtype(dtype).name)
        out = core(jnp.asarray(x).astype(dtype), *pg._pack_weights(p, dtype),
                   jnp.asarray(h0).astype(dtype))
    return tuple(_f32(a) for a in out)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("T,period", [(21, 3), (19, 2), (37, 3)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_stride_fwd_parts_match_pallas(interpret, bf16, T, period, with_h0):
    """gru_input_proj (_bf16), then gru_scan_stride_tm_xp (_bf16) on its xp
    == the Pallas stride kernel's h_stride and h_T; and they are what the
    plain strided scan gru_scan_stride_tm (_bf16) returns, bit for bit."""
    w, x, h0 = _case(T, seed=T + 10 * period + 100 * bf16 + 1000 * with_h0)
    want = _pallas(w, x, h0 if with_h0 else None, period,
                   jnp.bfloat16 if bf16 else jnp.float32)
    tw, tx, th0 = _torch(w, x, h0, bf16)
    th0 = th0 if with_h0 else None
    proj, rec = _parts(bf16)
    xp = proj(tw, tx)
    assert xp.dtype == torch.float32 and xp.shape == (T, B, 96)
    hs, hT, bounds = rec(tw, xp, period, th0)
    dt = BF16 if bf16 else torch.float32
    assert hs.shape == (T // period, B, 32) and hT.shape == (B, 32)
    assert bounds.shape == (-(-T // STRIDE_CHUNK), B, 32)
    assert hs.dtype == hT.dtype == bounds.dtype == dt
    plain = (gru_scan_stride_tm_bf16 if bf16 else gru_scan_stride_tm)(
        tw, tx, period, th0)
    assert torch.equal(hs, plain[0]) and torch.equal(hT, plain[1])
    for name, got, ref in zip(("h_stride", "h_T"), (hs, hT), want):
        assert got.shape == ref.shape, name
        err = float(np.abs(_f32(got) - ref).max())
        if bf16:
            assert err <= BF16_H_TOL * float(np.abs(ref).max()), name
        else:
            assert err <= H_TOL, name


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_stride_fwd_boundaries_are_the_dense_states(bf16, with_h0):
    """The boundaries are the plain states before steps 0, 16, 32, ... bit
    for bit: h0 (or zeros) first, then the strided scan's states (the
    plain sweep's h_prev, which recomputes them from x); in bf16 the dense
    scan gru_scan_tm_bf16's states, the same update."""
    T = 37
    w, x, h0 = _case(T, seed=3 + with_h0)
    tw, tx, th0 = _torch(w, x, h0, bf16)
    th0 = th0 if with_h0 else None
    proj, rec = _parts(bf16)
    _, _, bounds = rec(tw, proj(tw, tx), 3, th0)
    start = torch.zeros(B, 32, dtype=tx.dtype) if th0 is None else th0
    assert bounds.shape == (3, B, 32)
    assert torch.equal(bounds[0], start)
    if bf16:
        h_seq = gru_scan_tm_bf16(tw, tx, None, th0)[0]
        h_prev = torch.cat([start[None], h_seq[:-1]])
    else:
        h_prev = gru_scan_stride_tm_sweep(tw, tx, 3, None, None, th0)[2]
    assert torch.equal(bounds, h_prev[::STRIDE_CHUNK])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("steps", [1, 7, 16, 20])
def test_stride_fwd_chunks_match_one_chunk(bf16, steps):
    """Chunks of `steps` steps (the last one shorter), each its own
    projection and a recurrence from the last chunk's h_T with the chunk's
    first step t_first, give one chunk's h_stride, h_T and boundaries when
    their rows are concatenated, bit for bit: the carry is the state
    itself, and the rows are counted from the absolute step."""
    T, period = 45, 3
    w, x, h0 = _case(T, seed=7)
    tw, tx, th0 = _torch(w, x, h0, bf16)
    proj, rec = _parts(bf16)
    whole = rec(tw, proj(tw, tx), period, th0)
    parts, h = [], th0
    for t0 in range(0, T, steps):
        out = rec(tw, proj(tw, tx[t0:t0 + steps]), period, h, t_first=t0)
        parts.append(out)
        h = out[1]
    assert torch.equal(torch.cat([o[0] for o in parts]), whole[0])
    assert torch.equal(h, whole[1])
    assert torch.equal(torch.cat([o[2] for o in parts]), whole[2])


def test_k3_workspace_steps(monkeypatch):
    """K3's workspace chunk is K1's, cuda_gru.workspace_steps: the steps of
    f32 xp [., B, 96] that fit the 64 MiB cap, at least 1, at most T. At
    the xlong layers' shapes (B = 512): 341 steps at T = 1000 (three
    chunks), the whole layer above. _k3 allocates that workspace and
    passes the C entry point its arguments in order."""
    steps = cuda_gru.workspace_steps
    assert cuda_gru.WORKSPACE_BYTES == 64 << 20
    assert [steps(T, 512) for T in (1000, 333, 111, 37, 12, 4)] == [
        341, 333, 111, 37, 12, 4]
    assert steps(1000, 1) == 1000 and steps(3, 10 ** 6) == 1

    calls = []

    def fake_fn(dtype):
        def fn(*args):
            calls.append((dtype, args))
            return 0
        return fn

    monkeypatch.setattr(cuda_gru_stride, "_fwd_fn", fake_fn)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * B * 96 * 4)
    w, x, h0 = _case(20, seed=1, d_in=6)
    for bf16 in (False, True):
        tw, tx, th0 = _torch(w, x, h0, bf16)
        outs = tuple(torch.empty(n, B, 32, dtype=tx.dtype)
                     for n in (6, 2, 1))
        for h in (None, th0):
            calls.clear()
            assert cuda_gru_stride._k3(tw, tx, h, 3, outs, 99) == 0
            (dtype, args), = calls
            assert dtype == tx.dtype
            assert args[:2] == (tx.data_ptr(), tx.stride(0))
            assert args[2:6] == (tw.wx.data_ptr(), tw.wh.data_ptr(),
                                 tw.b.data_ptr(),
                                 None if h is None else h.data_ptr())
            assert args[6:9] == tuple(t.data_ptr() for t in outs)
            assert args[10:] == (7, 20, B, 6, 3, 99)  # t_chunk, T, B, ...
