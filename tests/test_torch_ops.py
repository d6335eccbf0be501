"""The port's ops against the JAX package on the CPU: the plain GRU, the
CUDA kernels' wrappers on CPU tensors (which run their plain versions)
against the Pallas kernels in interpret mode, and the readout with a slot
mask; then the backward: the plain scan backward against autograd and
against ``jax.vjp`` of the Pallas scan (whose backward is the Pallas
backward kernel), ``gradcheck`` of the scan's autograd Function, and the
readout Function's gradients against ``jax.vjp`` of the Pallas readout.
Inputs and weights are drawn with numpy from a seed and handed to both
sides. Tolerance: atol = rtol = 1e-5 in f32 (the two sides sum in other
orders and the Pallas GRU writes sigmoid through tanh); gradients, which
sum T*B such terms, atol = rtol = 1e-5 as well at these sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.models.readout import attention_readout as j_attention_readout
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu.ops.gru import gru_input_proj as j_gru_input_proj
from hpmn_tpu.ops.gru import gru_sequence as j_gru_sequence
from hpmn_tpu_torch.models.readout import Readout, attention_readout
from hpmn_tpu_torch.ops import cuda_gru, cuda_readout
from hpmn_tpu_torch.ops.gru import (GRUParams, GRUWeights, gru_scan_tm,
                                    gru_scan_tm_bwd, gru_sequence)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret():
    """Run the Pallas kernels in interpret mode, as tests/test_pallas.py."""
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _gru(rng, d_in, d_m):
    """The same random GRU weights as a JAX GRUParams and a port module."""
    arrays = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 3 * d_m)),
                  wh=rng.uniform(-0.5, 0.5, (d_m, 3 * d_m)),
                  b=rng.uniform(-0.1, 0.1, (3 * d_m,)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    port = GRUParams(d_in, d_m).requires_grad_(False)
    for k, v in arrays.items():
        getattr(port, k).copy_(torch.from_numpy(v))
    return JGRUParams(**{k: jnp.asarray(v) for k, v in arrays.items()}), port


def _readout(rng, d_m, d_q, A):
    arrays = dict(wm=rng.uniform(-0.5, 0.5, (d_m, A)),
                  wq=rng.uniform(-0.5, 0.5, (d_q, A)),
                  b=rng.uniform(-0.1, 0.1, (A,)),
                  v=rng.uniform(-0.5, 0.5, (A,)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    port = Readout(d_m, d_q, A).requires_grad_(False)
    for k, v in arrays.items():
        getattr(port, k).copy_(torch.from_numpy(v))
    return {k: jnp.asarray(v) for k, v in arrays.items()}, port


def _left_pad_mask(rng, B, T):
    lens = rng.integers(1, T + 1, size=B)
    return (np.arange(T)[None, :] >= T - lens[:, None]).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("use_mask,use_h0", [
    (False, False), (True, False), (False, True), (True, True)])
def test_gru_sequence_matches_jax(use_mask, use_h0):
    rng = np.random.default_rng(0)
    B, T, d_in, d_m = 5, 17, 6, 4
    jp, tp = _gru(rng, d_in, d_m)
    x = rng.standard_normal((B, T, d_in)).astype(np.float32)
    mask = _left_pad_mask(rng, B, T) if use_mask else None
    h0 = rng.standard_normal((B, d_m)).astype(np.float32) if use_h0 else None
    h_j, hT_j = j_gru_sequence(jp, jnp.asarray(x),
                               h0=None if h0 is None else jnp.asarray(h0),
                               mask=None if mask is None else jnp.asarray(mask))
    h_t, hT_t = gru_sequence(tp, torch.from_numpy(x),
                             h0=None if h0 is None else torch.from_numpy(h0),
                             mask=None if mask is None
                             else torch.from_numpy(mask))
    _close(h_t, h_j)
    _close(hT_t, hT_j)


@pytest.mark.parametrize("use_mask", [False, True])
def test_cuda_gru_wrapper_on_cpu_matches_pallas(interpret, use_mask):
    rng = np.random.default_rng(1)
    B, T, d_in, d_m = 4, 13, 6, 4
    jp, tp = _gru(rng, d_in, d_m)
    x_tm = rng.standard_normal((T, B, d_in)).astype(np.float32)
    mask_tm = _left_pad_mask(rng, B, T).T.copy() if use_mask else None
    h_j, hT_j = pg.pallas_gru_sequence_tm(
        jp, jnp.asarray(x_tm),
        mask_tm=None if mask_tm is None else jnp.asarray(mask_tm))
    launches = cuda_gru.launches
    h_t, hT_t = cuda_gru.gru_sequence_tm(
        tp, torch.from_numpy(x_tm),
        None if mask_tm is None else torch.from_numpy(mask_tm))
    assert cuda_gru.launches == launches  # CPU tensors: the plain version
    _close(h_t, h_j)
    _close(hT_t, hT_j)


def test_cuda_gru_wrapper_takes_a_strided_time_view(interpret):
    """The next HPMN layer's input is h_seq[period-1::period], a view."""
    rng = np.random.default_rng(2)
    T, B, d_in, d_m = 20, 3, 5, 4
    jp, tp = _gru(rng, d_in, d_m)
    x_tm = rng.standard_normal((T, B, d_in)).astype(np.float32)
    mask_tm = _left_pad_mask(rng, B, T).T.copy()
    h_j, _ = pg.pallas_gru_sequence_tm(jp, jnp.asarray(x_tm[2::3]),
                                       mask_tm=jnp.asarray(mask_tm[2::3]))
    h_t, _ = cuda_gru.gru_sequence_tm(tp, torch.from_numpy(x_tm)[2::3],
                                      torch.from_numpy(mask_tm)[2::3])
    _close(h_t, h_j)


@pytest.mark.parametrize("d_in", [1, 6, 33])
def test_input_proj_wrapper_on_cpu_matches_jax(d_in):
    """K1's projection wrapper on CPU tensors (its plain version, on a
    strided time view) == the JAX package's hoisted projection."""
    rng = np.random.default_rng(4)
    T, B, d_m = 7, 3, 32
    jp, tp = _gru(rng, d_in, d_m)
    x_tm = rng.standard_normal((3 * T, B, d_in)).astype(np.float32)
    launches = cuda_gru.proj_launches
    xp_t = cuda_gru.input_proj(tp, torch.from_numpy(x_tm)[2::3])
    assert cuda_gru.proj_launches == launches  # CPU tensors: plain version
    assert xp_t.shape == (T, B, 3 * d_m)
    _close(xp_t, j_gru_input_proj(jp, jnp.asarray(x_tm[2::3])))


def _bf16_in_reach(got, want, delta):
    """Whether every value of got is a bf16 value between the bf16
    roundings of want - delta and want + delta: the bf16 rounding of the
    f32 sum want, moved at most by another order's sum error delta."""
    def bf16(v):
        return np.asarray(jnp.asarray(v, jnp.float32).astype(jnp.bfloat16),
                          np.float64)
    g = np.asarray(got, np.float64)
    return bool(np.all((g == bf16(g)) & (g >= bf16(want - delta))
                       & (g <= bf16(want + delta))))


@pytest.mark.parametrize("d_in", [1, 32, 33, 96])
def test_input_proj_bf16_wrapper_on_cpu_matches_jax(d_in):
    """K1-bf16's projection wrapper on bf16 CPU tensors (its plain version,
    on a strided time view) against JAX on the same bf16 values: the r and
    z blocks x @ wx without the bias, within 1e-6 of their max abs (f32
    sums in another order); the c block bf16(x @ wx_c + b_c), JAX's
    rounding up to that sum error (one bf16 ulp at most, unless the sum
    cancels far below its terms)."""
    rng = np.random.default_rng(5)
    T, B, d_m = 5, 3, 32
    _, tp = _gru(rng, d_in, d_m)
    w16 = GRUWeights(tp.wx.bfloat16(), tp.wh.bfloat16(), tp.b.bfloat16())
    x16 = torch.from_numpy(
        rng.standard_normal((3 * T, B, d_in)).astype(np.float32)).bfloat16()
    launches = cuda_gru.proj_launches
    xp = cuda_gru.input_proj(w16, x16[2::3])
    assert cuda_gru.proj_launches == launches  # CPU tensors: plain version
    assert xp.shape == (T, B, 3 * d_m) and xp.dtype == torch.float32

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    dot = np.asarray(jnp.dot(j(x16[2::3]), j(w16.wx),
                             preferred_element_type=jnp.float32))
    rz = xp[..., :2 * d_m].numpy()
    assert (np.abs(rz - dot[..., :2 * d_m]).max()
            / np.abs(dot[..., :2 * d_m]).max()) <= 1e-6
    want_c = dot[..., 2 * d_m:] + w16.b[2 * d_m:].float().numpy()
    assert _bf16_in_reach(xp[..., 2 * d_m:].numpy(), want_c,
                          1e-6 * np.abs(want_c).max())


def test_k1_workspace_steps(monkeypatch):
    """K1's chunk of steps: as many as fit the workspace cap, 1 to T."""
    assert cuda_gru.workspace_steps(1000, 512) == 341
    assert cuda_gru.workspace_steps(300, 6400) == 27
    assert cuda_gru.workspace_steps(20, 512) == 20
    assert cuda_gru.workspace_steps(5, 10 ** 6) == 1
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * 5 * 96 * 4 + 1)
    assert cuda_gru.workspace_steps(50, 5) == 7


@pytest.mark.parametrize("B,L,d_m,d_q,A", [
    pytest.param(8, 6, 8, 6, 5, id="8-6"),
    pytest.param(3, 1, 8, 6, 5, id="3-1"),
    pytest.param(5, 4, 8, 6, 5, id="5-4"),
    # the kernel's own widths: d_m = A = 32, d_q 32 (every config) and 256
    # (its widest), L from 1 to its 16
    *(pytest.param(B, L, 32, d_q, 32, id=f"{B}-{L}-d_q{d_q}")
      for B, L, d_q in ((16, 1, 32), (37, 6, 32), (16, 16, 32),
                        (16, 1, 256), (16, 6, 256), (37, 16, 256)))])
def test_cuda_readout_wrapper_on_cpu_matches_pallas(interpret, B, L, d_m,
                                                    d_q, A):
    rng = np.random.default_rng(3)
    jp, tp = _readout(rng, d_m, d_q, A)
    mem = rng.standard_normal((B, L, d_m)).astype(np.float32)
    q = rng.standard_normal((B, d_q)).astype(np.float32)
    r_j = pr.pallas_attention_readout(jp, jnp.asarray(mem), jnp.asarray(q))
    launches = cuda_readout.launches
    r_t = cuda_readout.fused_attention_readout(tp, torch.from_numpy(mem),
                                               torch.from_numpy(q))
    assert cuda_readout.launches == launches
    _close(r_t, r_j)


def test_ab_readout_refuses_without_a_tree_or_a_card(tmp_path, capsys,
                                                    monkeypatch):
    """The readout A/B exits nonzero and prints no timing where it cannot
    compare: no other tree, or no card."""
    from hpmn_tpu_torch.tools import ab_readout
    assert ab_readout.main([]) == 2
    assert ab_readout.main([str(tmp_path / "missing")]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab_readout.main([str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "FAIL no CUDA device" in out and "device time" not in out


def test_ab_readout_case_inputs_are_seeded():
    """Both trees of the readout A/B get the same inputs: each case's
    weights, memory and query come from its own seed, at the case's
    shape, with a nonzero bias."""
    from hpmn_tpu_torch.tools import ab_readout
    a, b = (ab_readout.case_inputs(37, 6, 40, 4.0, "cpu") for _ in range(2))
    other = ab_readout.case_inputs(37, 6, 40, 1.0, "cpu")
    (r_a, m_a, q_a), (r_b, m_b, q_b) = a, b
    assert m_a.shape == (37, 6, 32) and q_a.shape == (37, 40)
    assert r_a.wq.shape == (40, 32) and r_a.b.abs().max() > 0
    assert torch.equal(m_a, m_b) and torch.equal(q_a, q_b)
    for name in ("wm", "wq", "b", "v"):
        assert torch.equal(getattr(r_a, name), getattr(r_b, name))
    assert not torch.equal(m_a, other[1])


def test_attention_readout_slot_mask_matches_jax():
    rng = np.random.default_rng(4)
    B, L, d_m, d_q, A = 6, 5, 4, 3, 7
    jp, tp = _readout(rng, d_m, d_q, A)
    mem = rng.standard_normal((B, L, d_m)).astype(np.float32)
    q = rng.standard_normal((B, d_q)).astype(np.float32)
    slot_mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    slot_mask[1] = 0.0  # every slot masked: reads zeros
    slot_mask[4] = 0.0
    slot_mask[2] = 1.0
    r_j = j_attention_readout(jp, jnp.asarray(mem), jnp.asarray(q),
                              slot_mask=jnp.asarray(slot_mask))
    r_t = attention_readout(tp, torch.from_numpy(mem), torch.from_numpy(q),
                            slot_mask=torch.from_numpy(slot_mask))
    _close(r_t, r_j)
    assert not r_t[1].any() and not r_t[4].any()
    # without a mask: the plain version of the readout kernel
    _close(attention_readout(tp, torch.from_numpy(mem), torch.from_numpy(q)),
           j_attention_readout(jp, jnp.asarray(mem), jnp.asarray(q)))


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """No silent fallback: only CPU tensors take the plain version."""
    rng = np.random.default_rng(5)
    _, tp = _gru(rng, 4, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_gru.gru_sequence_tm(tp, torch.empty(3, 2, 4, device="meta"))
    _, rp = _readout(rng, 4, 3, 5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_readout.fused_attention_readout(
            rp, torch.empty(2, 3, 4, device="meta"),
            torch.empty(2, 3, device="meta"))



def _port_params(tp, dtype=torch.float32):
    """The port module's weights as fresh leaves that require grad."""
    return [getattr(tp, k).detach().to(dtype).clone().requires_grad_(True)
            for k in ("wx", "wh", "b")]


@pytest.mark.parametrize("T", [1, 7, 29])
@pytest.mark.parametrize("use_mask,strided", [
    (False, False), (True, False), (True, True)])
def test_gru_scan_tm_bwd_matches_autograd(T, use_mask, strided):
    """The plain backward (the kernel's reference) == autograd of the plain
    forward, T not a multiple of 8, with an h0, on a strided x view."""
    rng = np.random.default_rng(T)
    B, d_in, d_m = 5, 6, 4
    _, tp = _gru(rng, d_in, d_m)
    rows = 3 * T if strided else T
    x_all = torch.from_numpy(
        rng.standard_normal((rows, B, d_in)).astype(np.float32))
    x_tm = x_all[2::3] if strided else x_all
    mask = (torch.from_numpy(_left_pad_mask(rng, B, T).T.copy())
            if use_mask else None)
    h0 = torch.from_numpy(rng.standard_normal((B, d_m)).astype(np.float32))
    dh_seq = torch.from_numpy(
        rng.standard_normal((T, B, d_m)).astype(np.float32))
    wx, wh, b = _port_params(tp)
    leaves = [x_all.clone().requires_grad_(True), h0.requires_grad_(True),
              wx, wh, b]
    xv = leaves[0][2::3] if strided else leaves[0]
    w = cuda_gru.GRUWeights(wx, wh, b)
    h_seq, _ = gru_scan_tm(w, xv, mask, leaves[1])
    want = torch.autograd.grad(h_seq, leaves, dh_seq)
    with torch.no_grad():
        dx, dwx, dwh, db, dh0 = gru_scan_tm_bwd(w, x_tm, mask, h_seq, dh_seq,
                                                h0)
    want_dx = want[0][2::3] if strided else want[0]
    for got, ref in zip((dx, dh0, dwx, dwh, db), (want_dx, *want[1:])):
        _close(got, ref)


@pytest.mark.parametrize("T", [1, 7, 29])
@pytest.mark.parametrize("use_mask,strided", [
    (False, False), (True, False), (False, True)])
def test_gru_scan_grads_match_pallas_vjp(interpret, T, use_mask, strided):
    """Gradients through the scan's autograd Function on CPU tensors ==
    ``jax.vjp`` of ``pallas_gru_sequence_tm`` (the custom_vjp whose backward
    is the Pallas ``_bwd_kernel``), cotangents on both h_seq and h_T."""
    rng = np.random.default_rng(100 + T)
    B, d_in, d_m = 4, 5, 4
    jp, tp = _gru(rng, d_in, d_m)
    rows = 3 * T if strided else T
    x_all = rng.standard_normal((rows, B, d_in)).astype(np.float32)
    mask = _left_pad_mask(rng, B, T).T.copy() if use_mask else None
    dh_seq = rng.standard_normal((T, B, d_m)).astype(np.float32)
    dh_T = rng.standard_normal((B, d_m)).astype(np.float32)

    def j_fn(p, xa):
        xs = xa[2::3] if strided else xa
        return pg.pallas_gru_sequence_tm(
            p, xs, mask_tm=None if mask is None else jnp.asarray(mask))

    _, vjp = jax.vjp(j_fn, jp, jnp.asarray(x_all))
    j_dp, j_dx = vjp((jnp.asarray(dh_seq), jnp.asarray(dh_T)))

    wx, wh, b = _port_params(tp)
    x_leaf = torch.from_numpy(x_all).requires_grad_(True)
    params = cuda_gru.GRUWeights(wx, wh, b)
    h_seq, h_T = cuda_gru.gru_sequence_tm(
        params, x_leaf[2::3] if strided else x_leaf,
        None if mask is None else torch.from_numpy(mask))
    got = torch.autograd.grad((h_seq, h_T), [x_leaf, wx, wh, b],
                              (torch.from_numpy(dh_seq),
                               torch.from_numpy(dh_T)))
    for g, ref in zip(got, (j_dx, j_dp.wx, j_dp.wh, j_dp.b)):
        _close(g, ref)


@pytest.mark.parametrize("use_mask", [False, True])
def test_gru_scan_function_gradcheck(use_mask):
    """Finite differences in float64 through ``GRUScan`` (the CPU side runs
    the plain forward and the plain backward)."""
    rng = np.random.default_rng(7)
    T, B, d_in, d_m = 5, 3, 2, 3
    f64 = dict(dtype=torch.float64, requires_grad=True)
    x = torch.tensor(rng.standard_normal((T, B, d_in)), **f64)
    h0 = torch.tensor(rng.standard_normal((B, d_m)), **f64)
    wx = torch.tensor(rng.uniform(-0.5, 0.5, (d_in, 3 * d_m)), **f64)
    wh = torch.tensor(rng.uniform(-0.5, 0.5, (d_m, 3 * d_m)), **f64)
    b = torch.tensor(rng.uniform(-0.1, 0.1, (3 * d_m,)), **f64)
    mask = (torch.from_numpy(_left_pad_mask(rng, B, T).T.copy()).double()
            if use_mask else None)
    assert torch.autograd.gradcheck(
        cuda_gru.GRUScan.apply, (x, mask, h0, wx, wh, b))


@pytest.mark.parametrize("B,L", [(8, 6), (3, 1), (5, 4)])
def test_readout_function_grads_match_pallas_vjp(interpret, B, L):
    """The readout's autograd Function (plain forward on CPU tensors,
    backward by autograd of the recomputed plain readout) == ``jax.vjp`` of
    ``pallas_attention_readout`` (the JAX ``_core_bwd``)."""
    rng = np.random.default_rng(30 + B)
    d_m, d_q, A = 8, 6, 5
    jp, tp = _readout(rng, d_m, d_q, A)
    mem = rng.standard_normal((B, L, d_m)).astype(np.float32)
    q = rng.standard_normal((B, d_q)).astype(np.float32)
    g = rng.standard_normal((B, d_m)).astype(np.float32)
    _, vjp = jax.vjp(pr.pallas_attention_readout, jp, jnp.asarray(mem),
                     jnp.asarray(q))
    j_dp, j_dmem, j_dq = vjp(jnp.asarray(g))
    tp.requires_grad_(True)
    mem_t = torch.from_numpy(mem).requires_grad_(True)
    q_t = torch.from_numpy(q).requires_grad_(True)
    read = cuda_readout.fused_attention_readout(tp, mem_t, q_t)
    _close(read.detach(), attention_readout(tp, mem_t, q_t).detach())
    names = ("wm", "wq", "b", "v")
    got = torch.autograd.grad(read, [mem_t, q_t, *(getattr(tp, k)
                                                   for k in names)],
                              torch.from_numpy(g))
    for t, ref in zip(got, (j_dmem, j_dq, *(j_dp[k] for k in names))):
        _close(t, ref)


def test_cuda_scan_backward_refuses_other_devices():
    rng = np.random.default_rng(6)
    _, tp = _gru(rng, 4, 4)
    meta = torch.empty(3, 2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        cuda_gru.gru_scan_bwd(tp, meta, None, meta, meta)

