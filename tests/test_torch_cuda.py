"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped where ``torch.cuda.is_available()`` is false. This file imports no
JAX, so it also runs on a machine without it; there, skip the repo's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: 1e-4 on scans (f32, other summation order
and transcendentals, a carry that does not grow errors), 1e-5 on the
readout; the scan backward's outputs within 1e-4 of each tensor's max abs
(the weight gradients sum over T*B row-steps in another order), and so is
every parameter's gradient of a training step; TF32 off.

The bf16 chain (K1-bf16, K2-bf16) against the plain bf16 versions, in bf16
on the card, as chip_smoke.py holds it: h within 3e-2 (a few bf16 ulps at
|h| < 1: the kernel and the plain version sum in other f32 orders, so a
bf16 rounding can flip and run on through the recurrence), the backward's
outputs within 1e-2 of their max abs; the bf16 training step's loss within
1e-4 relative and its gradients within 2e-2 of their max abs.

The strided scan (K3, K4 and their bf16 forms) is held to the same
tolerances, its backward run from K3's own boundary states; K3-bf16's rows
equal K1-bf16's strided rows bit for bit (the same ops on the same
values). K3 and K3-bf16 run K1's projection and K1's recurrence with the
strided output policy, over workspace chunks: they equal their one-kernel
form (``hpmn_gru_scan_stride_fwd[_bf16]``) bit for bit, every output, and
over chunks of 1, 7 and 16 steps they equal one chunk bit for bit (each
chunk starts from h_T, the carry in the stream type). K4 and K4-bf16 run
K1's projection, a replay-and-sweep
recurrence into workspaces of gate gradients and h_prev, and K2's pass:
over workspace chunks of 16 and 48 steps they equal one chunk bit for
bit, they equal the one-kernel form (``hpmn_gru_scan_stride_bwd[_bf16]``)
bit for bit, and the recurrence's gate gradients and h_prev are held to
the plain sweep at the backward's and the forward's tolerances.

K1 and K1-bf16 run as two kernels, the input projection into a workspace
and the recurrence, over chunks of steps: the projection alone is held to
the plain projection computed in float64, within 1e-6 of its max abs (each
output is one fmaf chain over d_in <= 96 terms, about sqrt(d_in) roundings
of half an ulp; in bf16 the r and z blocks so, and the c block, rounded to
bf16, the float64 sum's rounding up to that f32 error), and K1 over
several chunks equals K1 over one chunk bit for bit (each chunk starts
from the last row of h_seq, the carry itself, f32 or bf16).

K2 and K2-bf16 run as two kernels too, the reverse recurrence into a
workspace of gate gradients and the dx and weight-gradient pass, over
chunks of steps from the last: the pass alone is held to its plain
version ``gru_bwd_pass`` (1e-4 of max abs in f32; 1e-2 in bf16, where dx
is rounded to bf16 after sums in another order), K2 over several chunks
equals K2 over one chunk bit for bit (the dh carry and each row's
weight-gradient sums cross chunks in f32), and K2 holds to the plain
backward where B is not a multiple of the rows that one weight-gradient
partial sums (4, or 2 at d_in > 64).

The AUGRU forms (K1-scale, K2-scale and their bf16 forms) are held to the
plain scaled scans at the tolerances of their unscaled forms, dscale
among the backward's outputs. K1-scale and K1-scale-bf16 run K1's two
kernels (the recurrence with the scale beside the mask): over workspace
chunks of 1 and 7 steps they equal one chunk bit for bit, the scale a
strided time view. K2-scale and K2-scale-bf16 run K2's two
kernels (the recurrence with the scale, which also writes dscale, then
the pass): over workspace chunks of 1, 7 and 64 steps they equal one
chunk bit for bit, dscale included, and the recurrence's gate gradients,
dh0 and dscale (``cuda_gru.bwd_gates``) are held to the plain sweep at
the backward's tolerances. The DIEN step's kernel path to its plain
path (``plain=True``) as the hpmn steps; the DIEN HistoryStore on the card
to the same store on the CPU at 1e-4 (scores through two scans).

The custom ops of ``ops/library.py`` (K1 in its forms, K5) launch their
kernels once per call, at the kernels' tolerances against the plain
versions and bit for bit the direct launch's; graphs exported on the card
(``serving/aot.py``) launch K5, K1 and K1-scale at run time, once per
call, and score within 1e-6 of the eager stores."""

import copy

import numpy as np
import pytest
import torch

from hpmn_tpu_torch import configs
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.model import init_model, loss_fn
from hpmn_tpu_torch.models.readout import Readout, attention_readout
from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride, cuda_readout
from hpmn_tpu_torch.ops.gru import (GRUParams, GRUWeights, gru_bwd_pass,
                                    gru_input_proj, gru_scan_stride_tm,
                                    gru_scan_stride_tm_bf16,
                                    gru_scan_stride_tm_bwd,
                                    gru_scan_stride_tm_bwd_bf16, gru_scan_tm,
                                    gru_scan_tm_bf16, gru_scan_tm_bwd,
                                    gru_scan_tm_bwd_bf16, gru_scan_tm_sweep,
                                    gru_scan_tm_sweep_bf16)
from hpmn_tpu_torch.serving.history import HistoryStore
from hpmn_tpu_torch.serving.lifelong import UserMemoryStore

pytestmark = pytest.mark.cuda

TOL_GRU, TOL_READOUT, TOL_GRAD = 1e-4, 1e-5, 1e-4
TOL_PROJ = 1e-6
TOL_GRU_BF16, TOL_GRAD_BF16 = 3e-2, 1e-2
TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16 = 1e-4, 2e-2
# bf16 BST's gradients, card against CPU: what the CPU's bf16 path meets
# against JAX's bf16 path (tests/test_torch_bst.py::BF16_GRAD_TOL).
BF16_GRAD_TOL = 0.3
BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _gru(d_in, dev, seed=0):
    p = GRUParams(d_in, 32)
    p.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        p.b.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
    return p.requires_grad_(False).to(dev)


def _mask(T, B, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    return (torch.arange(T)[:, None] >= T - lens[None, :]).float().to(dev)


@pytest.mark.parametrize("T,B,d_in,masked", [
    (1, 3, 32, False), (7, 33, 32, True), (100, 64, 32, False),
    (100, 64, 32, True), (50, 10, 70, True), (20, 5, 5, False),
    (1, 1, 1, True), (9, 5, 31, True), (12, 513, 33, False),
    (30, 513, 96, True), (6, 2, 96, False), (40, 1, 33, True)])
def test_gru_kernel_matches_plain(dev, T, B, d_in, masked):
    p = _gru(d_in, dev)
    x = torch.randn(T, B, d_in, generator=torch.Generator().manual_seed(T)
                    ).to(dev)
    mask = _mask(T, B, dev) if masked else None
    h0 = torch.randn(B, 32, device=dev) if B % 2 else None
    n = cuda_gru.launches
    h_k, hT_k = cuda_gru.gru_sequence_tm(p, x, mask, h0)
    h_p, hT_p = gru_scan_tm(p, x, mask, h0)
    torch.cuda.synchronize()
    assert cuda_gru.launches == n + 1
    assert (h_k - h_p).abs().max().item() <= TOL_GRU
    assert (hT_k - hT_p).abs().max().item() <= TOL_GRU


def test_gru_kernel_takes_strided_time_views(dev):
    for d_in, B in ((32, 16), (1, 5), (33, 513), (96, 5)):
        p = _gru(d_in, dev)
        h = torch.randn(100, B, d_in, device=dev)
        mask = _mask(100, B, dev)
        h_k, _ = cuda_gru.gru_sequence_tm(p, h[2::3], mask[2::3])
        h_p, _ = gru_scan_tm(p, h[2::3].contiguous(), mask[2::3].contiguous())
        assert (h_k - h_p).abs().max().item() <= TOL_GRU, (d_in, B)
    # K1-bf16 on a bf16 view.
    p = _bf16(_gru(33, dev))
    h = torch.randn(100, 7, 33, device=dev).to(BF16)
    mask = _mask(100, 7, dev).to(BF16)
    h_k, _ = cuda_gru.gru_sequence_tm(p, h[2::3], mask[2::3])
    h_p, _ = gru_scan_tm_bf16(p, h[2::3].contiguous(),
                              mask[2::3].contiguous())
    assert (h_k.float() - h_p.float()).abs().max().item() <= TOL_GRU_BF16


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("steps", [1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_gru_kernel_chunks_match_one_chunk(dev, monkeypatch, masked, steps,
                                           dtype, scaled):
    """K1 (K1-bf16; with `scaled` K1-scale or K1-scale-bf16, the scale a
    strided time view too) over workspace chunks of `steps` steps (the
    last one shorter) == over one chunk, bit for bit, from h0 on a strided
    time view; one call counts one launch."""
    T, B, d_in = 50, 5, 33
    p = _gru(d_in, dev)
    p = _bf16(p) if dtype == BF16 else p
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dtype)[2::3]
    mask = _mask(T, B, dev).to(dtype) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev, dtype)
    a = (torch.rand(2 * T, B, generator=g).to(dev, dtype)[1::2] if scaled
         else None)
    assert cuda_gru.workspace_steps(T, B) == T
    one = cuda_gru.gru_sequence_tm(p, x, mask, h0, scale_tm=a)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * B * 96 * 4)
    assert cuda_gru.workspace_steps(T, B) == steps
    counter = (("launches_scale" if scaled else "launches")
               + ("_bf16" if dtype == BF16 else ""))
    n = getattr(cuda_gru, counter)
    chunked = cuda_gru.gru_sequence_tm(p, x, mask, h0, scale_tm=a)
    torch.cuda.synchronize()
    assert getattr(cuda_gru, counter) == n + 1
    assert chunked[0].dtype == dtype
    assert torch.equal(chunked[0], one[0]) and torch.equal(chunked[1], one[1])


def _bf16_in_reach(got, want, delta):
    """Whether every value of got is a bf16 value between the bf16
    roundings of want - delta and want + delta (want float64): the bf16
    rounding of want, moved at most by a sum error of delta. Where delta is
    below half a bf16 ulp that is want's rounding or its neighbour."""
    lo = (want - delta).float().to(BF16).double()
    hi = (want + delta).float().to(BF16).double()
    g = got.double()
    is_bf16 = g == got.to(BF16).double()
    return bool((is_bf16 & (g >= lo) & (g <= hi)).all())


@pytest.mark.parametrize("d_in", [1, 31, 32, 33, 96])
@pytest.mark.parametrize("B", [1, 5, 513])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_input_proj_kernel_matches_plain(dev, d_in, B, dtype):
    """K1's (K1-bf16's) projection alone, on a strided time view, against
    the plain projection in float64: in bf16 the r and z blocks x @ wx
    without the bias, the c block x @ wx_c + b_c rounded to bf16: the
    rounding of the float64 sum, up to the f32 sum's error (TOL_PROJ of max
    abs, as r and z), which moves it by more than one bf16 ulp only where
    the sum cancels far below its terms."""
    p = _gru(d_in, dev)
    p = _bf16(p) if dtype == BF16 else p
    T = 9
    x = torch.randn(3 * T, B, d_in, generator=torch.Generator().manual_seed(
        d_in + B)).to(dev, dtype)[1::3]
    n = cuda_gru.proj_launches
    xp = cuda_gru.input_proj(p, x)
    want = gru_input_proj(GRUWeights(p.wx.double(), p.wh.double(),
                                     p.b.double()), x.double())
    torch.cuda.synchronize()
    assert cuda_gru.proj_launches == n + 1
    assert xp.shape == (T, B, 96) and xp.dtype == torch.float32
    if dtype == BF16:
        xw = x.double() @ p.wx.double()[:, :64]
        assert _rel_err(xp[..., :64].double(), xw) <= TOL_PROJ
        want_c = want[..., 64:]
        assert _bf16_in_reach(xp[..., 64:], want_c,
                              TOL_PROJ * want_c.abs().max())
    else:
        assert _rel_err(xp.double(), want) <= TOL_PROJ


def test_gru_kernel_rejects_what_it_does_not_take(dev):
    with pytest.raises(ValueError, match="d_m"):
        p = GRUParams(32, 257).requires_grad_(False).to(dev)
        cuda_gru.gru_sequence_tm(p, torch.zeros(4, 2, 32, device=dev))
    p = _gru(32, dev)
    with pytest.raises(ValueError, match="float32"):
        cuda_gru.gru_sequence_tm(p, torch.zeros(4, 2, 32, device=dev,
                                                dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru.gru_sequence_tm(p, torch.zeros(4, 32, 2, device=dev
                                                ).transpose(1, 2))
    x = torch.zeros(4, 2, 32, device=dev)
    h = torch.zeros(4, 2, 32, device=dev)
    with pytest.raises(ValueError, match="dh_seq"):
        cuda_gru.gru_scan_bwd(p, x, None, h, h.transpose(0, 1))


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


@pytest.mark.parametrize("T,B,d_in,masked,strided", [
    (1, 3, 32, False, False), (7, 33, 32, True, False),
    (100, 64, 32, False, True), (100, 64, 32, True, False),
    (50, 10, 70, True, False), (20, 5, 5, False, False),
    (9, 6, 96, True, True)])
def test_gru_bwd_kernel_matches_plain(dev, T, B, d_in, masked, strided):
    p = _gru(d_in, dev)
    g = torch.Generator().manual_seed(T + B)
    x_all = torch.randn(3 * T if strided else T, B, d_in, generator=g).to(dev)
    x = x_all[2::3] if strided else x_all
    mask = _mask(T, B, dev) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev) if B % 2 else None
    h_seq = cuda_gru.gru_sequence_tm(p, x, mask, h0)[0]
    dh_seq = torch.randn(T, B, 32, generator=g).to(dev)
    n = cuda_gru.bwd_launches
    got = cuda_gru.gru_scan_bwd(p, x, mask, h_seq, dh_seq, h0)
    want = gru_scan_tm_bwd(p, x, mask, h_seq, dh_seq, h0)
    torch.cuda.synchronize()
    assert cuda_gru.bwd_launches == n + 1
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= TOL_GRAD, name


def test_gradient_through_the_scan_function_on_the_card(dev):
    """autograd through GRUScan (K1 forward, K2 backward) on a strided view
    with a mask == the CPU Function (plain forward and backward)."""
    g = torch.Generator().manual_seed(3)
    x_all = torch.randn(60, 16, 32, generator=g)
    mask = _mask(20, 16, torch.device("cpu"))
    dh = torch.randn(20, 16, 32, generator=g)
    grads = []
    for d in ("cpu", dev):
        p = _gru(32, d).requires_grad_(True)
        x_leaf = x_all.to(d).requires_grad_(True)
        h_seq, h_T = cuda_gru.gru_sequence_tm(p, x_leaf[2::3], mask.to(d))
        loss = (h_seq * dh.to(d)).sum() + h_T.square().sum()
        grads.append([t.cpu() for t in torch.autograd.grad(
            loss, [x_leaf, p.wx, p.wh, p.b])])
    for a, b in zip(grads[1], grads[0]):
        assert _rel_err(a, b) <= TOL_GRAD


@pytest.mark.parametrize("full_mask", [True, False])
def test_train_step_kernel_path_matches_plain_path(dev, full_mask):
    """One loss and gradient through the kernels (use_pallas) == the plain
    hierarchy and readout on the card, from the same weights and batch."""
    cfg = configs.get_config("xlong_hpmn").with_model(
        use_pallas=True, assume_full_mask=full_mask)
    spec = synthetic.DatasetSpec("mid", seq_len=250, n_items=500, n_cats=40,
                                 n_users=50)
    data = synthetic.make_ctr_dataset(spec, 32, seed=1,
                                      min_len_frac=1.0 if full_mask else 0.3)
    batch = batch_from_numpy(data, device=dev)
    out = []
    for c in (cfg, cfg.with_model(use_pallas=False)):
        model = init_model(c, 500, 40, seed=2, device=dev)
        counts = (cuda_gru.launches, cuda_gru.bwd_launches)
        loss, _ = loss_fn(model, c, batch)
        loss.backward()
        torch.cuda.synchronize()
        ran = (cuda_gru.launches - counts[0], cuda_gru.bwd_launches - counts[1])
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    L = cfg.model.hpmn_layers
    assert ran_k == (L, L) and ran_p == (0, 0)
    assert abs(l_k - l_p) <= 1e-5 * abs(l_p)
    for name, p in p_k.items():
        assert _rel_err(p.grad, p_p[name].grad) <= TOL_GRAD, name


def _bf16(p):
    return GRUWeights(p.wx.to(BF16), p.wh.to(BF16), p.b.to(BF16))


@pytest.mark.parametrize("T,B,d_in,masked,strided", [
    (1, 3, 32, False, False), (7, 33, 32, True, False),
    (100, 64, 32, False, True), (100, 64, 32, True, True),
    (50, 10, 70, True, False), (20, 5, 5, False, False),
    (1, 1, 1, True, False), (9, 5, 31, True, True),
    (12, 513, 33, False, False), (30, 513, 96, True, False),
    (1, 5, 96, False, True)])
def test_gru_bf16_kernels_match_plain(dev, T, B, d_in, masked, strided):
    """K1-bf16 and K2-bf16 against gru_scan_tm_bf16 and
    gru_scan_tm_bwd_bf16 on the same bf16 inputs; no f32 kernel runs."""
    p = _bf16(_gru(d_in, dev))
    g = torch.Generator().manual_seed(T + B)
    x_all = torch.randn(3 * T if strided else T, B, d_in, generator=g
                        ).to(dev, BF16)
    x = x_all[2::3] if strided else x_all
    mask = _mask(T, B, dev).to(BF16) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev, BF16) if B % 2 else None
    dh_seq = torch.randn(T, B, 32, generator=g).to(dev, BF16)
    counts = (cuda_gru.launches, cuda_gru.bwd_launches,
              cuda_gru.launches_bf16, cuda_gru.bwd_launches_bf16)
    h_k, hT_k = cuda_gru.gru_sequence_tm(p, x, mask, h0)
    h_p, hT_p = gru_scan_tm_bf16(p, x, mask, h0)
    got = cuda_gru.gru_scan_bwd(p, x, mask, h_k, dh_seq, h0)
    want = gru_scan_tm_bwd_bf16(p, x, mask, h_k, dh_seq, h0)
    torch.cuda.synchronize()
    assert (cuda_gru.launches, cuda_gru.bwd_launches,
            cuda_gru.launches_bf16, cuda_gru.bwd_launches_bf16) == (
                counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert h_k.dtype == BF16
    assert (h_k.float() - h_p.float()).abs().max().item() <= TOL_GRU_BF16
    assert (hT_k.float() - hT_p.float()).abs().max().item() <= TOL_GRU_BF16
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= TOL_GRAD_BF16, name


@pytest.mark.parametrize("d_in", [1, 32, 33, 96])
@pytest.mark.parametrize("B", [1, 5, 513])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_bwd_pass_kernel_matches_plain(dev, d_in, B, dtype):
    """K2's pass alone, on a strided time view, against gru_bwd_pass."""
    T = 37  # a tile of 32 steps and a shorter one
    g = torch.Generator().manual_seed(d_in + B)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dtype)[1::3]
    h_prev = torch.rand(T, B, 32, generator=g).mul(2).sub(1).to(dev, dtype)
    dr, dz, dc, dcr = torch.randn(4, T, B, 32, generator=g).to(dev, dtype)
    wx = _gru(d_in, dev).wx.to(dtype)
    dpx, dph = torch.cat([dr, dz, dc], -1), torch.cat([dr, dz, dcr], -1)
    n = cuda_gru.pass_launches
    got = cuda_gru.bwd_pass(wx, x, h_prev, dpx, dph)
    want = gru_bwd_pass(x, h_prev, dpx, dph, wx)
    torch.cuda.synchronize()
    assert cuda_gru.pass_launches == n + 1
    tol = TOL_GRAD_BF16 if dtype == BF16 else TOL_GRAD
    for name, a, b in zip(("dx", "dwx", "dwh", "db"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= tol, name


@pytest.mark.parametrize("T,B,d_in", [(50, 5, 33), (23, 5, 96), (40, 8, 1)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("steps", [1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_gru_bwd_kernel_chunks_match_one_chunk(dev, monkeypatch, T, B, d_in,
                                               masked, steps, dtype):
    """K2 (K2-bf16) over workspace chunks of `steps` steps (the one at t = 0
    shorter) == K2 over one chunk, bit for bit, from h0 on a strided time
    view."""
    p = _gru(d_in, dev)
    w = _bf16(p) if dtype == BF16 else p
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dtype)[2::3]
    mask = _mask(T, B, dev).to(dtype) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev, dtype)
    dh_seq = torch.randn(T, B, 32, generator=g).to(dev, dtype)
    h_seq = cuda_gru.gru_sequence_tm(w, x, mask, h0)[0]
    assert cuda_gru.bwd_workspace_steps(T, B, dtype) == T
    one = cuda_gru.gru_scan_bwd(w, x, mask, h_seq, dh_seq, h0)
    es = 2 if dtype == BF16 else 4
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * B * 128 * es)
    assert cuda_gru.bwd_workspace_steps(T, B, dtype) == steps
    counter = "bwd_launches_bf16" if dtype == BF16 else "bwd_launches"
    n = getattr(cuda_gru, counter)
    chunked = cuda_gru.gru_scan_bwd(w, x, mask, h_seq, dh_seq, h0)
    torch.cuda.synchronize()
    assert getattr(cuda_gru, counter) == n + 1
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), chunked, one):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("T,B,d_in,masked", [
    (13, 5, 96, True), (13, 7, 32, False), (13, 1, 96, False),
    (300, 513, 33, True)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_gru_bwd_kernel_row_groups(dev, T, B, d_in, masked, dtype):
    """K2 and K2-bf16 against the plain backward where B is odd or not a
    multiple of the rows of a weight-gradient partial (4; 2 at d_in = 96),
    and at T = 300, B = 513, where the default workspace takes 2 chunks in
    f32."""
    p = _gru(d_in, dev)
    bf = dtype == BF16
    w = _bf16(p) if bf else p
    g = torch.Generator().manual_seed(T + B + d_in)
    x = torch.randn(T, B, d_in, generator=g).to(dev, dtype)
    mask = _mask(T, B, dev).to(dtype) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev, dtype) if B % 2 else None
    dh_seq = torch.randn(T, B, 32, generator=g).to(dev, dtype)
    h_seq = cuda_gru.gru_sequence_tm(w, x, mask, h0)[0]
    got = cuda_gru.gru_scan_bwd(w, x, mask, h_seq, dh_seq, h0)
    want = (gru_scan_tm_bwd_bf16 if bf else gru_scan_tm_bwd)(
        w, x, mask, h_seq, dh_seq, h0)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= (
            TOL_GRAD_BF16 if bf else TOL_GRAD), name


def test_gru_kernels_refuse_dtype_mixes(dev):
    p = _gru(32, dev)
    x32 = torch.zeros(4, 2, 32, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_gru.gru_sequence_tm(p, x32.to(BF16))  # f32 weights
    with pytest.raises(ValueError, match="one dtype"):
        cuda_gru.gru_sequence_tm(_bf16(p), x32)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_gru.gru_sequence_tm(p, x32, torch.ones(4, 2, device=dev,
                                                    dtype=BF16))
    x16 = x32.to(BF16)
    with pytest.raises(ValueError, match="dh_seq"):
        cuda_gru.gru_scan_bwd(_bf16(p), x16, None, x16, x32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_gru.gru_sequence_tm(p, x32.half())


@pytest.mark.parametrize("full_mask", [True, False])
def test_train_step_bf16_kernel_path_matches_plain_path(dev, full_mask):
    """scan_dtype="bfloat16": one loss and gradient through K1-bf16, K2-bf16
    and K5 == the same branch with the plain bf16 scans and the plain
    readout under autograd (``plain=True``), from the same weights and
    batch."""
    cfg = configs.get_config("xlong_hpmn").with_model(
        use_pallas=True, assume_full_mask=full_mask, scan_dtype="bfloat16")
    spec = synthetic.DatasetSpec("mid", seq_len=250, n_items=500, n_cats=40,
                                 n_users=50)
    data = synthetic.make_ctr_dataset(spec, 32, seed=1,
                                      min_len_frac=1.0 if full_mask else 0.3)
    batch = batch_from_numpy(data, device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        counts = (cuda_gru.launches, cuda_gru.bwd_launches,
                  cuda_gru.launches_bf16, cuda_gru.bwd_launches_bf16)
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = (cuda_gru.launches - counts[0], cuda_gru.bwd_launches - counts[1],
               cuda_gru.launches_bf16 - counts[2],
               cuda_gru.bwd_launches_bf16 - counts[3])
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    L = cfg.model.hpmn_layers
    assert ran_k == (0, 0, L, L) and ran_p == (0, 0, 0, 0)
    assert abs(l_k - l_p) <= TOL_STEP_LOSS_BF16 * abs(l_p)
    for name, p in p_k.items():
        assert p.grad.dtype == torch.float32, name
        assert _rel_err(p.grad, p_p[name].grad) <= TOL_STEP_GRAD_BF16, name


def _all_counts():
    return (cuda_gru.launches, cuda_gru.bwd_launches, cuda_gru.launches_bf16,
            cuda_gru.bwd_launches_bf16, cuda_gru_stride.launches,
            cuda_gru_stride.bwd_launches, cuda_gru_stride.launches_bf16,
            cuda_gru_stride.bwd_launches_bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,period,B,d_in", [
    (5, 3, 1, 32), (19, 4, 37, 32), (37, 3, 512, 32), (1000, 3, 512, 32),
    (19, 10, 37, 70), (5, 10, 512, 32), (1000, 4, 1, 32), (37, 10, 1, 5)])
def test_stride_kernels_match_plain(dev, T, period, B, d_in, dtype):
    """K3 and K4 (or their bf16 forms) against the plain strided scan and
    its backward, K4 run from K3's boundaries; ragged ends (T % period,
    T % 16), an empty h_stride (T < period), an h0 for odd B; no other
    scan kernel runs."""
    dt = torch.float32 if dtype == "float32" else BF16
    p = _gru(d_in, dev)
    p = GRUWeights(p.wx.to(dt), p.wh.to(dt), p.b.to(dt))
    g = torch.Generator().manual_seed(T + B + period)
    x = torch.randn(T, B, d_in, generator=g).to(dev, dt)
    h0 = torch.randn(B, 32, generator=g).to(dev, dt) if B % 2 else None
    dhs = torch.randn(T // period, B, 32, generator=g).to(dev, dt)
    dhT = torch.randn(B, 32, generator=g).to(dev, dt)
    counts = _all_counts()
    hs, hT, bounds = cuda_gru_stride.stride_fwd(p, x, period, h0)
    got = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, dhT)
    plain_fwd, plain_bwd = ((gru_scan_stride_tm, gru_scan_stride_tm_bwd)
                            if dt == torch.float32 else
                            (gru_scan_stride_tm_bf16,
                             gru_scan_stride_tm_bwd_bf16))
    hs_p, hT_p = plain_fwd(p, x, period, h0)
    want = plain_bwd(p, x, period, dhs, dhT, h0)
    torch.cuda.synchronize()
    k = 4 if dt == torch.float32 else 6
    ran = [b - a for a, b in zip(counts, _all_counts())]
    assert ran == [0] * k + [1, 1] + [0] * (6 - k)
    tol_h, tol_g = ((TOL_GRU, TOL_GRAD) if dt == torch.float32
                    else (TOL_GRU_BF16, TOL_GRAD_BF16))
    assert hs.shape == (T // period, B, 32) and hs.dtype == dt
    if T >= period:
        assert (hs.float() - hs_p.float()).abs().max().item() <= tol_h
    assert (hT.float() - hT_p.float()).abs().max().item() <= tol_h
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= tol_g, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stride_rows_against_the_dense_kernel(dev, dtype):
    """K3's rows against K1's h_seq[period-1::period] on the same inputs:
    bit for bit in bf16 (K1-bf16's no-mask h_cell is K3-bf16's update); in
    f32 within an ulp's worth per step (K1 writes h + 1*(h_cell - h), the
    TPU stride kernel h + z*(c - h))."""
    dt = torch.float32 if dtype == "float32" else BF16
    p = _gru(32, dev)
    p = GRUWeights(p.wx.to(dt), p.wh.to(dt), p.b.to(dt))
    x = torch.randn(1000, 64, 32, generator=torch.Generator().manual_seed(7)
                    ).to(dev, dt)
    h_seq, h_T = cuda_gru.gru_sequence_tm(p, x)
    hs, hT = cuda_gru_stride.gru_stride_tm(p, x, 3)
    if dt == BF16:
        assert torch.equal(hs, h_seq[2::3]) and torch.equal(hT, h_T)
    else:
        assert (hs - h_seq[2::3]).abs().max().item() <= TOL_GRU
        assert (hT - h_T).abs().max().item() <= TOL_GRU


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 1000])
@pytest.mark.parametrize("d_in", [32, 96])
def test_stride_fwd_matches_the_one_kernel_form(dev, monkeypatch, dtype, T,
                                                d_in):
    """K3 (K3-bf16), the projection plus the recurrence, == the one-kernel
    form (hpmn_gru_scan_stride_fwd[_bf16]) on the same inputs, h_stride,
    h_T and the boundaries bit for bit: period 2 and 3, h0 absent and
    given, a strided time view of x; at T = 1000 B = 512, three workspace
    chunks."""
    from hpmn_tpu_torch.tools.ab_scan_kernels import one_kernel_k3
    B = 512 if T == 1000 else 37
    p = _gru(d_in, dev)
    p = GRUWeights(p.wx.to(dtype), p.wh.to(dtype), p.b.to(dtype))
    g = torch.Generator().manual_seed(T + d_in)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dtype)[1::3]
    h0 = torch.randn(B, 32, generator=g).to(dev, dtype)
    for period in (2, 3):
        for h in (None, h0):
            two = cuda_gru_stride.stride_fwd(p, x, period, h)
            with monkeypatch.context() as m:
                m.setattr(cuda_gru_stride, "_k3", one_kernel_k3)
                one = cuda_gru_stride.stride_fwd(p, x, period, h)
            torch.cuda.synchronize()
            for name, a, b in zip(("h_stride", "h_T", "boundaries"), two,
                                  one):
                assert a.shape == b.shape and a.dtype == b.dtype, name
                assert torch.equal(a, b), (name, period, h is None)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("steps", [1, 7, 16])
@pytest.mark.parametrize("T,period,B,d_in", [
    (100, 3, 5, 33), (97, 2, 8, 96), (250, 3, 37, 32)])
def test_stride_fwd_chunks_match_one_chunk(dev, monkeypatch, dtype, steps,
                                           T, period, B, d_in):
    """K3 (K3-bf16) over workspace chunks of `steps` steps (the last one
    shorter) == K3 over one chunk, bit for bit, every output, on a strided
    time view of x (with an h0 for odd B); one counted launch."""
    p = _gru(d_in, dev)
    p = GRUWeights(p.wx.to(dtype), p.wh.to(dtype), p.b.to(dtype))
    g = torch.Generator().manual_seed(T + B + steps)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dtype)[1::3]
    h0 = torch.randn(B, 32, generator=g).to(dev, dtype) if B % 2 else None
    row = 96 * 4  # the f32 workspace's bytes per row-step
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", T * B * row)
    assert cuda_gru.workspace_steps(T, B) == T
    one = cuda_gru_stride.stride_fwd(p, x, period, h0)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * B * row)
    assert cuda_gru.workspace_steps(T, B) == steps
    counter = "launches_bf16" if dtype == BF16 else "launches"
    n = getattr(cuda_gru_stride, counter)
    chunked = cuda_gru_stride.stride_fwd(p, x, period, h0)
    torch.cuda.synchronize()
    assert getattr(cuda_gru_stride, counter) == n + 1
    for name, a, b in zip(("h_stride", "h_T", "boundaries"), chunked, one):
        assert torch.equal(a, b), name


def test_stride_kernels_refuse_what_they_do_not_take(dev):
    p = _gru(32, dev)
    x = torch.zeros(12, 2, 32, device=dev)
    with pytest.raises(ValueError, match="period"):
        cuda_gru_stride.stride_fwd(p, x, 1)
    with pytest.raises(ValueError, match="d_m"):
        q = GRUParams(32, 257).requires_grad_(False).to(dev)
        cuda_gru_stride.gru_stride_tm(q, x, 3)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_gru_stride.gru_stride_tm(p, x.to(BF16), 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gru_stride.gru_stride_tm(
            p, torch.zeros(12, 32, 2, device=dev).transpose(1, 2), 3)
    _, _, bounds = cuda_gru_stride.stride_fwd(p, x, 3)
    with pytest.raises(ValueError, match="dh_stride"):
        cuda_gru_stride.stride_bwd(p, x, 3, bounds,
                                   torch.zeros(3, 2, 32, device=dev), None)
    with pytest.raises(ValueError, match="boundaries"):
        cuda_gru_stride.stride_bwd(p, x, 3, bounds[:0], None, None)


def _stride_case(T, period, B, d_in, dt, dev, seed=0, cotangents="both"):
    p = _gru(d_in, dev)
    p = GRUWeights(p.wx.to(dt), p.wh.to(dt), p.b.to(dt))
    g = torch.Generator().manual_seed(T + B + period + seed)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dt)[1::3]
    h0 = torch.randn(B, 32, generator=g).to(dev, dt) if B % 2 else None
    dhs = torch.randn(T // period, B, 32, generator=g).to(dev, dt)
    dhT = torch.randn(B, 32, generator=g).to(dev, dt)
    bounds = cuda_gru_stride.stride_fwd(p, x, period, h0)[2]
    return (p, x, h0, bounds, None if cotangents == "last" else dhs,
            None if cotangents == "strided" else dhT)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("steps", [16, 48])
@pytest.mark.parametrize("T,period,B,d_in", [
    (100, 3, 5, 33), (97, 2, 8, 96), (250, 3, 37, 32)])
def test_stride_bwd_chunks_match_one_chunk(dev, monkeypatch, dtype, steps,
                                           T, period, B, d_in):
    """K4 (K4-bf16) over workspace chunks of `steps` steps (the last in time
    shorter) == K4 over one chunk, bit for bit, on a strided time view of
    x, from K3's boundaries (with an h0 for odd B)."""
    p, x, _, bounds, dhs, dhT = _stride_case(T, period, B, d_in, dtype, dev)
    row = 160 * (2 if dtype == BF16 else 4) + 384  # bytes per row-step
    whole = -(-T // 16) * 16
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", whole * B * row)
    assert cuda_gru_stride.bwd_workspace_steps(T, B, dtype, 16) == whole
    one = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, dhT)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * B * row)
    assert cuda_gru_stride.bwd_workspace_steps(T, B, dtype, 16) == steps
    counter = "bwd_launches_bf16" if dtype == BF16 else "bwd_launches"
    n = getattr(cuda_gru_stride, counter)
    chunked = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, dhT)
    torch.cuda.synchronize()
    assert getattr(cuda_gru_stride, counter) == n + 1
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), chunked, one):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("T,period,B,d_in,cotangents", [
    (1000, 3, 512, 32, "both"), (37, 3, 513, 32, "both"),
    (19, 4, 37, 70, "strided"), (23, 2, 6, 96, "last"), (5, 3, 1, 5, "both"),
    (300, 3, 7, 96, "both")])
def test_stride_bwd_matches_the_one_kernel_form(dev, monkeypatch, dtype, T,
                                                period, B, d_in, cotangents):
    """K4 (K4-bf16), the recurrence plus K2's pass, == the one-kernel form
    (hpmn_gru_scan_stride_bwd[_bf16]) on the same inputs, every output bit
    for bit: B not a multiple of the rows of a partial (4; 2 at d_in = 70,
    1 at 96), ragged T, either cotangent absent."""
    from hpmn_tpu_torch.tools.ab_scan_kernels import one_kernel_k4
    p, x, _, bounds, dhs, dhT = _stride_case(T, period, B, d_in, dtype, dev,
                                             cotangents=cotangents)
    two = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, dhT)
    monkeypatch.setattr(cuda_gru_stride, "_k4", one_kernel_k4)
    one = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, dhT)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), two, one):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("T,period,B,d_in", [
    (37, 3, 33, 32), (250, 2, 8, 96), (1000, 3, 64, 32)])
def test_stride_rec_gates_match_plain_sweep(dev, dtype, T, period, B, d_in):
    """K4's recurrence, seen whole (stride_bwd_gates): its gate gradients,
    h_prev and dh0 against the plain sweep gru_scan_stride_tm_sweep
    (_bf16): the gate gradients and dh0 within TOL_GRAD (TOL_GRAD_BF16) of
    their max abs, h_prev within TOL_GRU (TOL_GRU_BF16)."""
    p, x, h0, bounds, dhs, dhT = _stride_case(T, period, B, d_in, dtype, dev)
    n = (cuda_gru_stride.bwd_launches, cuda_gru_stride.bwd_launches_bf16)
    got = cuda_gru_stride.stride_bwd_gates(p, x, period, bounds, dhs, dhT)
    want = cuda_gru_stride.stride_bwd_gates(
        GRUWeights(*(t.cpu() for t in p)), x.cpu(), period, None, dhs.cpu(),
        dhT.cpu(), None if h0 is None else h0.cpu())
    torch.cuda.synchronize()
    bf = dtype == BF16
    assert (cuda_gru_stride.bwd_launches, cuda_gru_stride.bwd_launches_bf16
            ) == (n[0] + (not bf), n[1] + bf)
    tol_h, tol_g = ((TOL_GRU_BF16, TOL_GRAD_BF16) if bf
                    else (TOL_GRU, TOL_GRAD))
    for name, a, b in zip(("dpre_x", "dpre_h", "h_prev", "dh0"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        a, b = a.float().cpu(), b.float()
        if name == "h_prev":
            assert (a - b).abs().max().item() <= tol_h, name
        else:
            assert _rel_err(a, b) <= tol_g, name
    assert torch.equal(got[0][..., :64], got[1][..., :64])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_gradient_through_the_stride_function_on_the_card(dev, dtype):
    """autograd through GRUStrideScan (K3 forward, K4 backward) on a
    strided view with an h0 == the CPU Function (plain forward and
    backward), at the strided kernels' tolerances."""
    g = torch.Generator().manual_seed(4)
    x_all = torch.randn(3 * 200, 16, 32, generator=g)
    h0_all = torch.randn(16, 32, generator=g)
    dhs = torch.randn(200 // 3, 16, 32, generator=g)
    dhT = torch.randn(16, 32, generator=g)
    grads = []
    for d in ("cpu", dev):
        p = _gru(32, d)
        ws = [t.to(dtype).requires_grad_(True) for t in (p.wx, p.wh, p.b)]
        x_leaf = x_all.to(d, dtype).requires_grad_(True)
        h0 = h0_all.to(d, dtype).requires_grad_(True)
        hs, hT = cuda_gru_stride.GRUStrideScan.apply(x_leaf[2::3], h0, *ws,
                                                     3)
        loss = ((hs.float() * dhs.to(d)).sum()
                + (hT.float() * dhT.to(d)).sum())
        grads.append([t.float().cpu() for t in torch.autograd.grad(
            loss, [x_leaf, h0, *ws])])
    tol = TOL_GRAD_BF16 if dtype == BF16 else TOL_GRAD
    for name, a, b in zip(("dx", "dh0", "dwx", "dwh", "db"), grads[1],
                          grads[0]):
        assert _rel_err(a, b) <= tol, name


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_train_step_stride_kernel_path_matches_plain_path(dev, scan_dtype):
    """pallas_stride_outputs with full sequences: one loss and gradient
    through K3 and K4 (or their bf16 forms) and K5 == the same branch with
    the plain strided scans under autograd (``plain=True``); no dense scan
    kernel runs."""
    cfg = configs.get_config("xlong_hpmn").with_model(
        use_pallas=True, assume_full_mask=True, pallas_stride_outputs=True,
        scan_dtype=scan_dtype)
    spec = synthetic.DatasetSpec("mid", seq_len=250, n_items=500, n_cats=40,
                                 n_users=50)
    data = synthetic.make_ctr_dataset(spec, 32, seed=1, min_len_frac=1.0)
    batch = batch_from_numpy(data, device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        counts = _all_counts()
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = [b - a for a, b in zip(counts, _all_counts())]
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    L = cfg.model.hpmn_layers
    k = 4 if scan_dtype == "float32" else 6
    assert ran_k == [0] * k + [L, L] + [0] * (6 - k) and ran_p == [0] * 8
    tol_loss, tol_grad = ((1e-5, TOL_GRAD) if scan_dtype == "float32"
                          else (TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16))
    assert abs(l_k - l_p) <= tol_loss * abs(l_p)
    for name, p in p_k.items():
        assert p.grad.dtype == torch.float32, name
        assert _rel_err(p.grad, p_p[name].grad) <= tol_grad, name


@pytest.mark.parametrize("B,L,d_q", [
    (1, 1, 32), (512, 6, 32), (37, 16, 40), (6400, 6, 32),
    # every instantiation of the slot count (d_q <= 32: wq in registers)
    *((37, L, 32) for L in range(1, 17)),
    # wq in 64 registers, wq from shared memory (d_q > 64), the widest
    # query, and the most rows a predict or rank chunk takes
    (37, 6, 64), (37, 6, 65), (512, 6, 256), (37, 16, 256), (8192, 6, 32),
    (8192, 16, 256)])
def test_readout_kernel_matches_plain(dev, B, L, d_q):
    r = Readout(32, d_q, 32)
    r.reset_parameters(torch.Generator().manual_seed(B))
    r = r.requires_grad_(False).to(dev)
    g = torch.Generator().manual_seed(L)
    mem = torch.randn(B, L, 32, generator=g).to(dev)
    q = torch.randn(B, d_q, generator=g).to(dev)
    n = cuda_readout.launches
    got = cuda_readout.fused_attention_readout(r, mem, q)
    want = attention_readout(r, mem, q)
    torch.cuda.synchronize()
    assert cuda_readout.launches == n + 1
    assert (got - want).abs().max().item() <= TOL_READOUT


def test_store_on_the_card_matches_the_cpu_store(dev):
    cfg = configs.get_config("xlong_hpmn")
    rng = np.random.default_rng(0)
    T, B = 250, 16  # layer scans of 250, 83, 27, 9, 3, 1 steps
    items = rng.integers(1, 500, size=(B, T))
    lens = rng.integers(1, T + 1, size=B)
    mask = (np.arange(T)[None, :] >= T - lens[:, None]).astype(np.float32)
    stores = [UserMemoryStore(cfg, init_model(cfg, 500, 40, device=d),
                              device=d) for d in ("cpu", dev)]
    n_gru, n_ro = cuda_gru.launches, cuda_readout.launches
    for s in stores:
        s.ingest_histories(np.arange(B), items, items % 40)
        padded = (items * mask).astype(np.int64)
        s.ingest_histories(np.arange(B, 2 * B), padded, padded % 40,
                           masks=mask)
        s.update(np.arange(0, 2 * B, 3), items[:11, 0], items[:11, 1] % 40)
    assert cuda_gru.launches == n_gru + 2 * cfg.model.hpmn_layers
    uids = np.arange(2 * B)
    m_cpu, c_cpu = stores[0]._gather(uids)
    m_dev, c_dev = stores[1]._gather(uids)
    assert (m_dev.cpu() - m_cpu).abs().max().item() <= TOL_GRU
    assert torch.equal(c_dev.cpu(), c_cpu)
    ci = rng.integers(1, 500, size=(2 * B, 7))
    s_cpu = stores[0].rank(uids, ci, ci % 40)
    s_dev = stores[1].rank(uids, ci, ci % 40)
    np.testing.assert_allclose(s_dev, s_cpu, atol=TOL_GRU)
    assert cuda_readout.launches == n_ro + 1


def _scale_counts():
    return (cuda_gru.launches, cuda_gru.bwd_launches, cuda_gru.launches_bf16,
            cuda_gru.bwd_launches_bf16, cuda_gru.launches_scale,
            cuda_gru.bwd_launches_scale, cuda_gru.launches_scale_bf16,
            cuda_gru.bwd_launches_scale_bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,B,strided", [
    (1, 1, False), (1, 512, True), (17, 5, True), (17, 512, False),
    (300, 1, True), (300, 5, False), (300, 512, True)])
def test_scale_kernels_match_plain(dev, T, B, strided, masked, dtype):
    """K1-scale and K2-scale (or their bf16 forms) against gru_scan_tm and
    gru_scan_tm_bwd with the same scale (or their bf16 forms), x and the
    scale strided time views where ``strided``, an h0 for odd B; no other
    scan kernel runs. dscale is among the compared outputs."""
    dt = torch.float32 if dtype == "float32" else BF16
    p = _gru(32, dev)
    p = GRUWeights(p.wx.to(dt), p.wh.to(dt), p.b.to(dt))
    g = torch.Generator().manual_seed(T + B + masked)
    n = 3 * T if strided else T
    x_all = torch.randn(n, B, 32, generator=g).to(dev, dt)
    a_all = torch.rand(n, B, generator=g).to(dev, dt)
    x, a = (x_all[2::3], a_all[2::3]) if strided else (x_all, a_all)
    mask = _mask(T, B, dev, seed=T).to(dt) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev, dt) if B % 2 else None
    dh_seq = torch.randn(T, B, 32, generator=g).to(dev, dt)
    counts = _scale_counts()
    h_k, hT_k = cuda_gru.gru_sequence_tm(p, x, mask, h0, scale_tm=a)
    got = cuda_gru.gru_scan_bwd(p, x, mask, h_k, dh_seq, h0, scale_tm=a)
    fwd, bwd = ((gru_scan_tm, gru_scan_tm_bwd) if dt == torch.float32
                else (gru_scan_tm_bf16, gru_scan_tm_bwd_bf16))
    h_p, hT_p = fwd(p, x, mask, h0, a)
    want = bwd(p, x, mask, h_k, dh_seq, h0, a)
    torch.cuda.synchronize()
    k = 4 if dt == torch.float32 else 6
    ran = [b - a_ for a_, b in zip(counts, _scale_counts())]
    assert ran == [0] * k + [1, 1] + [0] * (6 - k)
    tol_h, tol_g = ((TOL_GRU, TOL_GRAD) if dt == torch.float32
                    else (TOL_GRU_BF16, TOL_GRAD_BF16))
    assert h_k.dtype == dt
    assert (h_k.float() - h_p.float()).abs().max().item() <= tol_h
    assert (hT_k.float() - hT_p.float()).abs().max().item() <= tol_h
    assert len(got) == len(want) == 6
    for name, u, v in zip(("dx", "dwx", "dwh", "db", "dh0", "dscale"), got,
                          want):
        assert u.shape == v.shape and u.dtype == v.dtype, name
        assert torch.isfinite(u.float()).all(), name
        assert _rel_err(u.float(), v.float()) <= tol_g, name


def _scale_case(T, B, masked, dt, dev, seed=0):
    """AUGRU weights, x and the scale on strided time views, a mask, an h0
    for odd B, dh_seq, and K1-scale's h_seq."""
    p = _gru(32, dev)
    p = GRUWeights(p.wx.to(dt), p.wh.to(dt), p.b.to(dt))
    g = torch.Generator().manual_seed(T + B + masked + seed)
    x = torch.randn(3 * T, B, 32, generator=g).to(dev, dt)[1::3]
    a = torch.rand(2 * T, B, generator=g).to(dev, dt)[1::2]
    mask = _mask(T, B, dev, seed=T).to(dt) if masked else None
    h0 = torch.randn(B, 32, generator=g).to(dev, dt) if B % 2 else None
    dh_seq = torch.randn(T, B, 32, generator=g).to(dev, dt)
    h_seq = cuda_gru.gru_sequence_tm(p, x, mask, h0, scale_tm=a)[0]
    return p, x, a, mask, h0, dh_seq, h_seq


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("steps", [1, 7, 64])
@pytest.mark.parametrize("T", [300, 1000])
def test_scale_bwd_chunks_match_one_chunk(dev, monkeypatch, T, steps,
                                          masked, dtype):
    """K2-scale (K2-scale-bf16) over workspace chunks of `steps` steps (the
    one at t = 0 shorter) == K2-scale over one chunk, bit for bit, every
    output and dscale, on strided time views of x and the scale, from an
    h0."""
    p, x, a, mask, h0, dh_seq, h_seq = _scale_case(T, 5, masked, dtype, dev)
    es = 2 if dtype == BF16 else 4
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", T * 5 * 128 * es)
    assert cuda_gru.bwd_workspace_steps(T, 5, dtype) == T
    one = cuda_gru.gru_scan_bwd(p, x, mask, h_seq, dh_seq, h0, scale_tm=a)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * 5 * 128 * es)
    assert cuda_gru.bwd_workspace_steps(T, 5, dtype) == steps
    counter = ("bwd_launches_scale_bf16" if dtype == BF16
               else "bwd_launches_scale")
    n = getattr(cuda_gru, counter)
    chunked = cuda_gru.gru_scan_bwd(p, x, mask, h_seq, dh_seq, h0,
                                    scale_tm=a)
    torch.cuda.synchronize()
    assert getattr(cuda_gru, counter) == n + 1
    assert len(chunked) == len(one) == 6
    for name, u, v in zip(("dx", "dwx", "dwh", "db", "dh0", "dscale"),
                          chunked, one):
        assert torch.equal(u, v), name


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,B", [(37, 33), (300, 512)])
def test_scale_rec_gates_match_plain_sweep(dev, T, B, masked, dtype):
    """K2-scale's (K2-scale-bf16's) recurrence, seen whole (bwd_gates):
    its gate gradients dg, dh0 and dscale against the plain sweep
    gru_scan_tm_sweep (_bf16) within TOL_GRAD (TOL_GRAD_BF16) of their max
    abs; the pass on the kernel's dg against gru_bwd_pass likewise."""
    p, x, a, mask, h0, dh_seq, h_seq = _scale_case(T, B, masked, dtype, dev)
    bf = dtype == BF16
    counter = "bwd_launches_scale_bf16" if bf else "bwd_launches_scale"
    n = getattr(cuda_gru, counter)
    got = cuda_gru.bwd_gates(p, x, mask, h_seq, dh_seq, h0, scale_tm=a)
    sweep = gru_scan_tm_sweep_bf16 if bf else gru_scan_tm_sweep
    dpx, dph, h_prev, dh0, dscale = sweep(p, x, mask, h_seq, dh_seq, h0, a)
    want = (cuda_gru.gate_layout(dpx, dph), dh0, dscale)
    got_pass = cuda_gru.bwd_pass_dg(p.wx, x, h_prev, got[0])
    want_pass = gru_bwd_pass(x, h_prev, *cuda_gru.gate_blocks(got[0]), p.wx)
    torch.cuda.synchronize()
    assert getattr(cuda_gru, counter) == n + 1
    tol = TOL_GRAD_BF16 if bf else TOL_GRAD
    for name, u, v in zip(("dg", "dh0", "dscale", "dx", "dwx", "dwh", "db"),
                          got + got_pass, want + want_pass):
        assert u.shape == v.shape and u.dtype == v.dtype, name
        assert torch.isfinite(u.float()).all(), name
        assert _rel_err(u.float(), v.float()) <= tol, name


def test_scale_kernels_refuse_what_they_do_not_take(dev):
    p = _gru(32, dev)
    x = torch.zeros(4, 2, 32, device=dev)
    h = torch.zeros(4, 2, 32, device=dev)
    with pytest.raises(ValueError, match="scale_tm"):
        cuda_gru.gru_sequence_tm(p, x, scale_tm=torch.ones(4, 3, device=dev))
    with pytest.raises(ValueError, match="scale_tm"):
        cuda_gru.gru_sequence_tm(p, x, scale_tm=torch.ones(2, 4, device=dev).T)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_gru.gru_sequence_tm(p, x, scale_tm=torch.ones(4, 2, device=dev,
                                                           dtype=BF16))
    with pytest.raises(ValueError, match="scale_tm"):
        cuda_gru.gru_scan_bwd(p, x, None, h, h,
                              scale_tm=torch.ones(4, 3, device=dev))
    with pytest.raises(ValueError, match="dh_seq"):
        cuda_gru.gru_scan_bwd(p, x, None, h, h.transpose(0, 1),
                              scale_tm=torch.ones(4, 2, device=dev))


def _dien_data(full_mask, n=32, T=300):
    spec = synthetic.DatasetSpec("mid", seq_len=T, n_items=500, n_cats=40,
                                 n_users=50)
    return synthetic.make_ctr_dataset(spec, n, seed=1,
                                      min_len_frac=1.0 if full_mask else 0.3)


@pytest.mark.parametrize("scan_dtype,full_mask", [("float32", False),
                                                  ("bfloat16", True)])
def test_dien_step_kernel_path_matches_plain_path(dev, scan_dtype, full_mask):
    """taobao_dien with use_pallas: one loss and gradient through K1, K2,
    K1-scale and K2-scale (or their bf16 forms) == the same branch with the
    plain scans under autograd (``plain=True``), from the same weights and
    batch: f32 on left-padded histories, bf16 on full ones."""
    cfg = configs.get_config("taobao_dien").with_model(
        use_pallas=True, assume_full_mask=full_mask, scan_dtype=scan_dtype)
    batch = batch_from_numpy(_dien_data(full_mask), device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        counts = _scale_counts()
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = [b - a for a, b in zip(counts, _scale_counts())]
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    if scan_dtype == "float32":
        assert ran_k == [1, 1, 0, 0, 1, 1, 0, 0]
        tol_loss, tol_grad = 1e-5, TOL_GRAD
    else:
        assert ran_k == [0, 0, 1, 1, 0, 0, 1, 1]
        tol_loss, tol_grad = TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16
    assert ran_p == [0] * 8
    assert abs(l_k - l_p) <= tol_loss * abs(l_p)
    for name, p in p_k.items():
        assert p.grad.dtype == torch.float32, name
        assert _rel_err(p.grad, p_p[name].grad) <= tol_grad, name


def test_history_store_on_the_card_matches_the_cpu_store(dev):
    cfg = configs.get_config("taobao_dien").with_model(use_pallas=True)
    data = _dien_data(False, n=48, T=300)
    stores = [HistoryStore(cfg, init_model(cfg, 500, 40, device=d),
                           max_score_rows=40, device=d)
              for d in ("cpu", dev)]
    uids = np.arange(48)
    ci = data["item_seq"][:, -7:] % 499 + 1
    counts = _scale_counts()
    scores = []
    for s in stores:
        s.ingest_histories(uids[:40], data["item_seq"][:40],
                           data["cat_seq"][:40], masks=data["seq_mask"][:40])
        s.update(uids[::5], data["target_item"][::5], data["target_cat"][::5])
        scores.append((s.predict(uids, data["target_item"],
                                 data["target_cat"]),
                       s.rank(uids[:8], ci[:8], ci[:8] % 40)))
    ran = [b - a for a, b in zip(counts, _scale_counts())]
    # predict: 48 rows in chunks of 40 (2 calls); rank: 56 rows (2 calls)
    assert ran == [4, 0, 0, 0, 4, 0, 0, 0]
    (p_cpu, r_cpu), (p_dev, r_dev) = scores
    np.testing.assert_allclose(p_dev, p_cpu, atol=TOL_GRU)
    np.testing.assert_allclose(r_dev, r_cpu, atol=TOL_GRU)


def test_kernels_run_on_the_tensors_card(dev):
    """K1, K2 and K5 on cuda:1 while cuda:0 is current == their plain
    versions on the CPU: each wrapper makes its tensors' card current
    around the launch (a kernel launched on cuda:0 with cuda:1's stream
    and pointers would fail or read the wrong memory), and the SM count
    that sizes K1's projection and K5 is cuda:1's own."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(40, 24, 32, generator=g)
    mask = _mask(40, 24, torch.device("cpu"))
    dh = torch.randn(40, 24, 32, generator=g)
    outs = []
    counts = (cuda_gru.launches, cuda_gru.bwd_launches)
    for d in ("cpu", other):
        p = _gru(32, d).requires_grad_(True)
        x_leaf = x.to(d).requires_grad_(True)
        h_seq, _ = cuda_gru.gru_sequence_tm(p, x_leaf, mask.to(d))
        grads = torch.autograd.grad((h_seq * dh.to(d)).sum(),
                                    [x_leaf, p.wx, p.wh, p.b])
        outs.append([h_seq.detach().cpu()] + [t.cpu() for t in grads])
    assert (cuda_gru.launches - counts[0], cuda_gru.bwd_launches
            - counts[1]) == (1, 1)
    assert (outs[1][0] - outs[0][0]).abs().max().item() <= TOL_GRU
    for a, b in zip(outs[1][1:], outs[0][1:]):
        assert _rel_err(a, b) <= TOL_GRAD
    r = Readout(32, 32, 32)
    r.reset_parameters(torch.Generator().manual_seed(12))
    mem = torch.randn(600, 6, 32, generator=g)
    q = torch.randn(600, 32, generator=g)
    want = attention_readout(r, mem, q)
    n = cuda_readout.launches
    got = cuda_readout.fused_attention_readout(
        r.requires_grad_(False).to(other), mem.to(other), q.to(other))
    torch.cuda.synchronize(other)
    assert cuda_readout.launches == n + 1 and got.device == other
    assert (got.cpu() - want).abs().max().item() <= TOL_READOUT
    assert torch.cuda.current_device() == 0


def _amazon_data(n=64, T=100, full_mask=False):
    spec = synthetic.DatasetSpec("amazon", seq_len=T, n_items=500, n_cats=40,
                                 n_users=50)
    return synthetic.make_ctr_dataset(spec, n, seed=3,
                                      min_len_frac=1.0 if full_mask else 0.3)


@pytest.mark.parametrize("full_mask", [False, True])
def test_gru4rec_step_kernel_path_matches_plain_path(dev, full_mask):
    """amazon_gru4rec with use_pallas: one loss and gradient through K1 and
    K2 (one launch each) == the same branch with the plain scan under
    autograd (``plain=True``), from the same weights and batch."""
    cfg = configs.get_config("amazon_gru4rec").with_model(
        use_pallas=True, assume_full_mask=full_mask)
    batch = batch_from_numpy(_amazon_data(full_mask=full_mask), device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=4, device=dev)
        counts = (cuda_gru.launches, cuda_gru.bwd_launches)
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = (cuda_gru.launches - counts[0], cuda_gru.bwd_launches
               - counts[1])
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    assert ran_k == (1, 1) and ran_p == (0, 0)
    assert abs(l_k - l_p) <= 1e-5 * abs(l_p)
    for name, p in p_k.items():
        assert _rel_err(p.grad, p_p[name].grad) <= TOL_GRAD, name


@pytest.mark.parametrize("family", ["gru4rec", "rum"])
def test_baseline_store_on_the_card_matches_the_cpu_store(dev, family):
    """The gru4rec and rum UserMemoryStores on the card == the same stores
    on the CPU: full and left-padded ingests (gru4rec: K1 once per ingest),
    updates, states, counters and rank's scores."""
    cfg = configs.get_config(f"amazon_{family}").with_model(use_pallas=True)
    data = _amazon_data(n=40)
    items, cats, mask = data["item_seq"], data["cat_seq"], data["seq_mask"]
    stores = [UserMemoryStore(cfg, init_model(cfg, 500, 40, device=d),
                              device=d) for d in ("cpu", dev)]
    n_gru = cuda_gru.launches
    for s in stores:
        s.ingest_histories(np.arange(20), items[:20], cats[:20])
        s.ingest_histories(np.arange(20, 40), items[20:], cats[20:],
                           masks=mask[20:])
        s.update(np.arange(0, 40, 3), data["target_item"][::3],
                 data["target_cat"][::3])
    assert cuda_gru.launches == n_gru + 2 * (family == "gru4rec")
    uids = np.arange(40)
    m_cpu, c_cpu = stores[0]._gather(uids)
    m_dev, c_dev = stores[1]._gather(uids)
    assert (m_dev.cpu() - m_cpu).abs().max().item() <= TOL_GRU
    assert torch.equal(c_dev.cpu(), c_cpu)
    ci = data["item_seq"][:, -7:] % 499 + 1
    np.testing.assert_allclose(stores[1].rank(uids, ci, ci % 40),
                               stores[0].rank(uids, ci, ci % 40),
                               atol=TOL_GRU)


def test_native_batch_on_the_card_equals_numpy(dev):
    """A batch the native gather assembles, placed on the card, == numpy's
    rows of the same indices, field by field."""
    from hpmn_tpu_torch.data import native_batcher

    data = _amazon_data(n=300)
    idx = np.random.default_rng(5).integers(0, 300, 128)
    before = native_batcher.gathers
    batch = batch_from_numpy(data, idx, device=dev)
    assert native_batcher.gathers == before + 1
    for name, a in data.items():
        got = getattr(batch, name)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), torch.from_numpy(a[idx])), name


@pytest.mark.parametrize("arena_dtype", ["float32", "bfloat16"])
def test_bundle_from_the_card_serves_on_both(dev, tmp_path, arena_dtype):
    """A store on the card (xlong_hpmn with use_user_emb, 3 layers) saves a
    bundle; restored on the card it scores bit for bit as before, restored
    on the CPU its memories are the card's (f32 on disk; a bf16 arena
    rounds them once on load) and its scores within 1e-4 of the card's."""
    cfg = configs.get_config("xlong_hpmn").with_model(hpmn_layers=3,
                                                       use_user_emb=True)
    model = init_model(cfg, 500, 40, device=dev, n_users=64)
    store = UserMemoryStore(cfg, model, device=dev, arena_dtype=arena_dtype)
    rng = np.random.default_rng(1)
    items = rng.integers(1, 500, size=(32, 40))
    store.ingest_histories(np.arange(32), items, items % 40)
    store.update(np.arange(0, 32, 2), items[:16, 0], items[:16, 1] % 40)
    uids = np.arange(40)  # 32 known, 8 unknown
    ci = rng.integers(1, 500, size=(40, 5))
    want = store.rank(uids, ci, ci % 40)
    store.save_bundle(str(tmp_path), quantize_embeddings=False)
    on_card = UserMemoryStore.load_bundle(str(tmp_path), device=dev,
                                          arena_dtype=arena_dtype)
    n_ro = cuda_readout.launches
    np.testing.assert_array_equal(on_card.rank(uids, ci, ci % 40), want)
    assert cuda_readout.launches == n_ro + 1
    on_cpu = UserMemoryStore.load_bundle(str(tmp_path), device="cpu",
                                         arena_dtype=arena_dtype)
    assert torch.equal(on_cpu._gather(uids)[0], store._gather(uids)[0].cpu())
    np.testing.assert_allclose(on_cpu.rank(uids, ci, ci % 40), want,
                               atol=TOL_GRU)


@pytest.mark.parametrize("form", ["f32", "mask_h0", "scale_strided", "bf16"])
def test_scan_op_matches_plain(dev, form):
    """hpmn::gru_scan_fwd on the card launches K1 (the form's counter
    rises by one per call) and holds to the plain scan at the kernels'
    tolerances; its output is the direct launch's bit for bit."""
    from hpmn_tpu_torch.ops import library

    T, B, d_in = 40, 33, 32
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2 * T if form == "scale_strided" else T, B, d_in,
                    generator=g).to(dev)
    if form == "scale_strided":
        x = x[1::2]
    p = _gru(d_in, dev)
    w = [p.wx, p.wh, p.b]
    mask = _mask(T, B, dev) if form != "f32" else None
    h0 = torch.randn(B, 32, generator=g).to(dev) if form == "mask_h0" \
        else None
    scale = (torch.rand(T, B, generator=g).to(dev)
             if form == "scale_strided" else None)
    args = [x, mask, h0, *w, scale]
    if form == "bf16":
        args = [None if a is None else a.to(BF16) for a in args]
    counter = {"f32": "launches", "mask_h0": "launches",
               "scale_strided": "launches_scale", "bf16": "launches_bf16"}
    n = getattr(cuda_gru, counter[form])
    got = library.gru_scan_fwd(*args)
    torch.cuda.synchronize()
    assert getattr(cuda_gru, counter[form]) == n + 1
    plain = gru_scan_tm_bf16 if form == "bf16" else gru_scan_tm
    want = plain(GRUWeights(*args[3:6]), args[0], args[1], args[2],
                 args[6])[0]
    tol = TOL_GRU_BF16 if form == "bf16" else TOL_GRU
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, cuda_gru.scan_by_device(*args))


def test_readout_op_matches_plain(dev):
    """hpmn::readout_fwd on the card launches K5 once per call and holds to
    the plain readout at 1e-5."""
    from hpmn_tpu_torch.ops import library

    g = torch.Generator().manual_seed(6)
    ro = Readout(32, 32, 32)
    ro.reset_parameters(g)
    ro = ro.requires_grad_(False).to(dev)
    mem = torch.randn(300, 6, 32, generator=g).to(dev)
    q = torch.randn(300, 32, generator=g).to(dev)
    n = cuda_readout.launches
    got = library.readout_fwd(mem, q, ro.wm, ro.wq, ro.b, ro.v)
    torch.cuda.synchronize()
    assert cuda_readout.launches == n + 1
    assert (got - attention_readout(ro, mem, q)).abs().max().item() \
        <= TOL_READOUT


def test_exported_graphs_launch_the_kernels(dev, tmp_path):
    """Graphs exported on the card (serving/aot.py) launch K5 once per
    predict and rank call and K1 and K1-scale once per DIEN scoring call,
    at run time, and give the eager stores' scores within 1e-6."""
    from hpmn_tpu_torch.serving.aot import load_aot_store

    cfg = configs.get_config("taobao_hpmn")
    model = init_model(cfg, 200, 20, seed=0, device=dev)
    store = UserMemoryStore(cfg, model, device=dev)
    rng = np.random.default_rng(0)
    hist = rng.integers(1, 200, size=(16, 13)).astype(np.int32)
    store.ingest_histories(np.arange(16), hist, hist % 20)
    store.save_bundle(str(tmp_path / "m"), export_compiled=True,
                      export_platforms=("cuda",))
    aot = load_aot_store(str(tmp_path / "m"), device=dev)
    uids = np.arange(16)
    ci = rng.integers(1, 200, size=(16, 4)).astype(np.int32)
    for rep in range(2):
        n = cuda_readout.launches
        got_p = aot.predict(uids, ci[:, 0], ci[:, 0] % 20)
        got_r = aot.rank(uids, ci, ci % 20)
        assert cuda_readout.launches == n + 2
    assert np.abs(got_p - store.predict(uids, ci[:, 0], ci[:, 0] % 20)
                  ).max() <= 1e-6
    assert np.abs(got_r - store.rank(uids, ci, ci % 20)).max() <= 1e-6

    cfg_d = configs.get_config("taobao_dien").with_model(use_pallas=True)
    md = init_model(cfg_d, 200, 20, seed=0, device=dev)
    sd = HistoryStore(cfg_d, md, window=20, device=dev)
    sd.ingest_histories(np.arange(16), hist, hist % 20)
    sd.save_bundle(str(tmp_path / "d"), export_compiled=True,
                   export_platforms=("cuda",))
    ad = load_aot_store(str(tmp_path / "d"), device=dev)
    for rep in range(2):
        n = (cuda_gru.launches, cuda_gru.launches_scale)
        got = ad.predict(uids, ci[:, 0], ci[:, 0] % 20)
        assert (cuda_gru.launches, cuda_gru.launches_scale) == (n[0] + 1,
                                                                n[1] + 1)
    assert np.abs(got - sd.predict(uids, ci[:, 0], ci[:, 0] % 20)
                  ).max() <= 1e-6


def test_history_store_scores_one_user_on_the_card(dev):
    """A one-row scoring batch (the daemon's warm-up bucket of 1) runs K1
    and K1-scale on the card: the [T, 1] mask transposed from [1, T]
    keeps a batch stride that K1 never reads. Scores within 1e-4 of the
    CPU store's (two scans)."""
    cfg = configs.get_config("taobao_dien").with_model(use_pallas=True)
    model = init_model(cfg, 300, 30, seed=2, device="cpu")
    hist = np.random.default_rng(3).integers(1, 300, size=(2, 40))
    stores = [HistoryStore(cfg, model, window=30, device="cpu"),
              HistoryStore(cfg, copy.deepcopy(model).to(dev), window=30,
                           device=dev)]
    for s in stores:
        s.ingest_histories(np.arange(2), hist, hist % 30)
    n = (cuda_gru.launches, cuda_gru.launches_scale)
    got = [s.predict([1], [7], [7]) for s in stores]
    assert (cuda_gru.launches, cuda_gru.launches_scale) == (n[0] + 1,
                                                            n[1] + 1)
    assert np.abs(got[0] - got[1]).max() <= 1e-4


@pytest.mark.parametrize("family,over", [
    ("bst", dict(bst_blocks=2, bst_attn_chunk=5)),
    ("bst", dict(bst_blocks=2, bst_dtype="bfloat16")),
    ("lstm", {}), ("caser", {}), ("shan", {}), ("svdpp", {}), ("dnn", {})])
def test_extra_family_step_on_the_card_matches_the_cpu(dev, family, over):
    """A loss and backward of the families of models/extra_baselines.py on
    the card == the same weights and batch on the CPU (loss 1e-5
    relative, every gradient TOL_GRAD of its max abs), with no
    hand-kernel launch. bf16 BST is held as tests/test_torch_bst.py holds
    it to JAX's bf16 path: logits 2e-2, loss 2e-3 relative, every
    gradient f32, finite and within BF16_GRAD_TOL of its max abs (bf16
    rounds the matmuls' outputs, and the card's and the CPU's bf16
    products round in other places: the embedding gradient differed by
    5.4e-2 of its max abs; the CPU's bf16 gradients meet JAX's bf16 ones
    within 0.26 of their max abs, the bound's origin)."""
    cfg = configs.get_config("amazon_hpmn").with_model(name=family, **over)
    data = _amazon_data(n=24)
    counted = (cuda_gru.launches, cuda_gru.bwd_launches,
               cuda_readout.launches)
    out = []
    for d in ("cpu", dev):
        model = init_model(cfg, 500, 40, seed=3, device=d, n_users=600)
        loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device=d))
        loss.backward()
        out.append((loss.item(), metrics["logits"].detach().cpu(),
                    dict(model.named_parameters())))
    assert (cuda_gru.launches, cuda_gru.bwd_launches,
            cuda_readout.launches) == counted
    (l_c, lg_c, p_c), (l_k, lg_k, p_k) = out
    if over.get("bst_dtype") == "bfloat16":
        assert abs(l_k - l_c) <= 2e-3 * abs(l_c)
        assert (lg_k - lg_c).abs().max().item() <= 2e-2
        for name, p in p_k.items():
            assert p.grad.dtype == torch.float32, name
            assert torch.isfinite(p.grad).all(), name
            assert _rel_err(p.grad.cpu(), p_c[name].grad) <= BF16_GRAD_TOL, \
                name
        return
    assert abs(l_k - l_c) <= 1e-5 * abs(l_c)
    for name, p in p_k.items():
        assert _rel_err(p.grad.cpu(), p_c[name].grad) <= TOL_GRAD, name


def test_caser_step_on_the_card_with_default_flags_matches_the_cpu():
    """Caser's loss and gradients on the card with the process's TF32
    flags at PyTorch's defaults (cuDNN may take TF32, cuBLAS may not) ==
    the CPU's at the f32 tolerances of the test above: its convolutions
    run in f32 whatever the flags say, and leave the flags as they
    were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = configs.get_config("amazon_hpmn").with_model(name="caser")
        data = _amazon_data(n=24)
        out = []
        for d in ("cpu", torch.device("cuda", 0)):
            model = init_model(cfg, 500, 40, seed=3, device=d)
            loss, _ = loss_fn(model, cfg, batch_from_numpy(data, device=d))
            loss.backward()
            out.append((loss.item(), dict(model.named_parameters())))
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (False, True)
        (l_c, p_c), (l_k, p_k) = out
        assert abs(l_k - l_c) <= 1e-5 * abs(l_c)
        for name, p in p_k.items():
            assert _rel_err(p.grad.cpu(), p_c[name].grad) <= TOL_GRAD, name
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_history_store_serves_bst_and_svdpp_on_the_card(dev):
    """taobao_bst's and SVD++'s HistoryStores on the card == on the CPU
    (1e-5); a uid outside SVD++'s p_u raises before reaching the card."""
    for cfg in (configs.get_config("taobao_bst").with_model(bst_blocks=2,
                                                            bst_attn_chunk=7),
                configs.get_config("amazon_hpmn").with_model(name="svdpp")):
        model = init_model(cfg, 300, 30, seed=2, device="cpu", n_users=50)
        hist = np.random.default_rng(3).integers(1, 300, size=(6, 40))
        stores = [HistoryStore(cfg, model, window=30, device="cpu"),
                  HistoryStore(cfg, copy.deepcopy(model).to(dev), window=30,
                               device=dev)]
        for s in stores:
            s.ingest_histories(np.arange(6), hist, hist % 30)
        ci = hist[:, :4] % 299 + 1
        uids = np.array([0, 1, 2, 3, 4, 40])  # 40: no history
        got = [s.rank(uids, ci, ci % 30) for s in stores]
        assert np.abs(got[0] - got[1]).max() <= 1e-5
        if cfg.model.name == "svdpp":
            with pytest.raises(ValueError, match="p_u"):
                stores[1].predict([50], [3], [3])


def test_sharded_step_on_four_ranks_of_the_card_matches_one_process():
    """chip_smoke.py phase 15 (a) and (b) at a smaller size: 4 ranks on
    the card over gloo (CUDA tensors), a (2, 2) grid, xlong_hpmn's six
    layers at T = 300, the a2a exchange with the batch over data and
    model: 2 SGD steps against one process (losses 1e-5 relative,
    parameters 1e-4 of max abs, the first step's table gradients 1e-4 and
    the tables' change 1e-2 of their own max abs), K1 x 6, K2 x 6 and K5
    per rank and step, the dense parameters the same on every rank; the
    psum step; the forced fallback (overflow 1, the a2a step's parameters
    within 1e-6 of max abs); train() on the ranks against one process
    (AUC 0.02, log-loss 1e-5, parameters 1e-4 of max abs), rank 0 alone
    writing, its best checkpoint the returned parameters bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from hpmn_tpu_torch.tools import parallel_check

    # capacity factor 2: each rank's 16 targets get 16 slots an owner, so
    # the a2a steps take the exchange, not its (exact) fallback
    res = parallel_check.run(["--seq_len", "300", "--items", "4000",
                              "--cats", "100", "--batch", "64", "--steps",
                              "2", "--train_examples", "1600",
                              "--eval_batch", "64", "--capacity_factor",
                              "2.0"])
    c = res["compare"]
    for r in res["ranks"]:
        assert [tuple(n) for n in r["launches"]] == [(6, 6, 1)] * 2
        assert r["overflow"] == [0.0, 0.0]
    assert c["loss_rel"] <= 1e-5
    assert c["params_err"] <= 1e-4 * c["params_max"]
    assert c["table_grad_rel"] <= 1e-4 and c["table_delta_rel"] <= 1e-2
    assert c["dense_identical"]
    assert c["psum_loss_rel"] <= 1e-5
    assert c["psum_params_err"] <= 1e-4 * c["psum_params_max"]
    assert c["psum_table_delta_rel"] <= 1e-2
    assert c["fallback_overflow"] == [1.0] * 4
    assert c["fallback_params_err"] <= 1e-6 * c["fallback_params_max"]
    assert c["fallback_table_delta_rel"] <= 1e-2
    assert c["train_auc_gap"] < 0.02 and c["train_log_loss_gap"] < 1e-5
    assert c["train_params_err"] <= 1e-4 * c["train_params_max"]
    assert c["writes"][0] and not any(c["writes"][1:])
    assert c["checkpoint_matches"]


def test_sp_step_on_two_ranks_of_the_card_matches_one_process():
    """chip_smoke.py phase 16 (a), (c) and (d) at a smaller size: 2 ranks
    on the card over gloo, a (1, 2, 1) grid, xlong_hpmn's six layers at
    T = 300 (layers 0 and 1, T 300 and 100, in chunks through K1-scale and
    K2-scale in 4 microbatches each, the four upper layers whole through
    K1 and K2, no K5): 2 SGD
    steps against one process with the kernels (losses 1e-5 relative,
    parameters 1e-4 of max abs, the first step's table gradients 1e-4 of
    their max abs); layer 0's SP scan with the kernels against the plain
    SP scan (h 1e-4, gradients 1e-4 of max abs); taobao_dien's SP step
    (both scans in chunks, K1-scale and K2-scale only); train() on the
    ranks against one process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from hpmn_tpu_torch.tools import parallel_check

    res = parallel_check.run(["--ranks", "2", "--seq_parallel", "2",
                              "--model_parallel", "1", "--seq_len", "300",
                              "--items", "4000", "--cats", "100", "--batch",
                              "64", "--steps", "2", "--train_examples",
                              "1600", "--eval_batch", "64"])
    c = res["compare"]
    for r in res["ranks"]:
        assert [(*n, *s) for n, s in zip(r["launches"],
                                         r["launches_scale"])] \
            == [(4, 4, 0, 8, 8)] * 2
        assert [tuple(n) for n in r["dien"]["launches_scale"]] \
            == [(8, 8)] * 2
        sc = r["sp_scan"]
        assert sc["h_err"] <= 1e-4 and sc["grad_rel"] <= 1e-4
    assert c["loss_rel"] <= 1e-5 and c["dien_loss_rel"] <= 1e-5
    assert c["params_err"] <= 1e-4 * c["params_max"]
    assert c["dien_params_err"] <= 1e-4 * c["dien_params_max"]
    assert c["table_grad_rel"] <= 1e-4 and c["dense_identical"]
    assert c["train_auc_gap"] < 0.02 and c["train_log_loss_gap"] < 1e-5
    assert c["train_params_err"] <= 1e-4 * c["train_params_max"]
    assert c["writes"][0] and not any(c["writes"][1:])


def test_amazon_rum_train_repeats_bit_for_bit_on_the_card(dev):
    """Two train() runs of amazon_rum (60 steps with evals, the config's
    400 categories repeated within every batch) from the same seeded
    weights end with identical parameters: the gather's backward sums a
    repeated row in one order on the card (``models/embedding.py``)."""
    from hpmn_tpu_torch.train import train as T

    cfg = T.apply_overrides(configs.get_config("amazon_rum"), [
        "n_examples=4000", "train.max_steps=60", "train.eval_every=30",
        "train.log_every=30", "train.steps_per_dispatch=1",
        "eval_steps_per_dispatch=1", "train.early_stop_patience=100"])
    runs = [T.train(cfg, log=lambda s: None, device=dev)["params"]
            for _ in range(2)]
    assert runs[0].keys() == runs[1].keys()
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_bf16_model_step_kernel_path_matches_plain_path(dev, scan_dtype):
    """model.dtype="bfloat16": one loss and gradient through the scan
    kernels (f32 or bf16 scans) and K5 == the same branch with the plain
    scans and the plain readout under autograd, from the same bf16
    weights and batch; every gradient is bf16, each within
    TOL_STEP_GRAD_BF16 of its max abs (the two paths' f32 values differ by
    ulps, and a bf16 rounding may flip: 2^-8 of a value)."""
    cfg = configs.get_config("xlong_hpmn").with_model(
        use_pallas=True, assume_full_mask=True, dtype="bfloat16",
        scan_dtype=scan_dtype)
    spec = synthetic.DatasetSpec("mid", seq_len=250, n_items=500, n_cats=40,
                                 n_users=50)
    batch = batch_from_numpy(synthetic.make_ctr_dataset(
        spec, 32, seed=1, min_len_frac=1.0), device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        counts = (cuda_gru.launches, cuda_gru.bwd_launches,
                  cuda_gru.launches_bf16, cuda_gru.bwd_launches_bf16,
                  cuda_readout.launches)
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = tuple(a - b for a, b in zip(
            (cuda_gru.launches, cuda_gru.bwd_launches,
             cuda_gru.launches_bf16, cuda_gru.bwd_launches_bf16,
             cuda_readout.launches), counts))
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    L = cfg.model.hpmn_layers
    want = (0, 0, L, L) if scan_dtype == "bfloat16" else (L, L, 0, 0)
    assert ran_k == want + (1,) and ran_p == (0,) * 5
    assert abs(l_k - l_p) <= TOL_STEP_LOSS_BF16 * abs(l_p)
    for name, p in p_k.items():
        assert p.dtype == BF16 and p.grad.dtype == BF16, name
        assert _rel_err(p.grad.float(), p_p[name].grad.float()) \
            <= TOL_STEP_GRAD_BF16, name


# ---- The width-general forms (csrc/gru_general_*.cu, csrc/readout_general.cu):
# every width but the fixed-width kernels' d_m = 32, d_in <= 96 (and A =
# d_m = 32, L <= 16, d_q <= 256), against the plain versions on the card.
GEN_GRU_SHAPES = [(1, 1), (3, 4), (16, 16), (40, 48), (128, 64), (64, 128),
                  (256, 256), (127, 43), (129, 43), (512, 43)]
GEN_READOUT_SHAPES = [(16, 24, 3, 8), (64, 64, 6, 128), (48, 96, 20, 300),
                      (32, 32, 40, 32), (1, 1, 1, 1), (256, 256, 64, 512)]


def _gen_counts():
    return tuple(getattr(cuda_gru, "gen_" + name) for name in (
        "launches", "bwd_launches", "launches_bf16", "bwd_launches_bf16",
        "launches_scale", "bwd_launches_scale", "launches_scale_bf16",
        "bwd_launches_scale_bf16"))


def _gen_gru(d_in, d_m, dev, dtype, seed=0):
    p = GRUParams(d_in, d_m)
    p.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        p.b.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
    p = p.requires_grad_(False).to(dev)
    return GRUWeights(p.wx.to(dtype), p.wh.to(dtype), p.b.to(dtype))


@pytest.mark.parametrize("T,B", [(23, 7), (40, 33)])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d_in,d_m", GEN_GRU_SHAPES)
def test_general_gru_kernels_match_plain(dev, d_in, d_m, dtype, masked,
                                         scaled, T, B):
    """K1-general and K2-general (each dtype, mask and scale form) against
    the plain scan and its backward on the same inputs on the card: h
    within TOL_GRU (TOL_GRU_BF16), every gradient within TOL_GRAD
    (TOL_GRAD_BF16) of its max abs; x a strided time view when masked.
    The widths and T*B rows (161, 1320) leave ragged edges on the
    products' tiles (128 rows by 64 columns; 32 rows by 32 units)."""
    p = _gen_gru(d_in, d_m, dev, dtype)
    g = torch.Generator().manual_seed(d_in + d_m)
    x_all = torch.randn(2 * T, B, d_in, generator=g).to(dev, dtype)
    x = x_all[1::2] if masked else x_all[:T]
    mask = _mask(T, B, dev).to(dtype) if masked else None
    scale = (torch.rand(T, B, generator=g).to(dev, dtype) if scaled
             else None)
    h0 = torch.randn(B, d_m, generator=g).to(dev, dtype)
    dh_seq = torch.randn(T, B, d_m, generator=g).to(dev, dtype)
    bf16 = dtype == BF16
    plain_fwd = gru_scan_tm_bf16 if bf16 else gru_scan_tm
    plain_bwd = gru_scan_tm_bwd_bf16 if bf16 else gru_scan_tm_bwd
    fixed, counts = _scale_counts(), _gen_counts()
    h_k = cuda_gru.scan_fwd(x, mask, h0, p.wx, p.wh, p.b, scale)
    h_p = plain_fwd(p, x, mask, h0, scale)[0]
    got = cuda_gru.gru_scan_bwd(p, x, mask, h_k, dh_seq, h0, scale)
    want = plain_bwd(p, x, mask, h_k, dh_seq, h0, scale)
    torch.cuda.synchronize()
    assert _scale_counts() == fixed
    slot = (4 if scaled else 0) + (2 if bf16 else 0)
    ran = [b - a for a, b in zip(counts, _gen_counts())]
    assert ran == [int(i in (slot, slot + 1)) for i in range(8)]
    assert h_k.shape == (T, B, d_m) and h_k.dtype == dtype
    tol_h, tol_g = (TOL_GRU_BF16, TOL_GRAD_BF16) if bf16 else (TOL_GRU,
                                                               TOL_GRAD)
    assert (h_k.float() - h_p.float()).abs().max().item() <= tol_h
    names = ("dx", "dwx", "dwh", "db", "dh0", "dscale")
    assert len(got) == len(want) == 5 + scaled
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= tol_g, name


@pytest.mark.parametrize("B,d_in,d_m", [(5, 40, 48), (33, 129, 43)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("scaled", [False, True])
def test_general_gru_chunks_match_one_chunk(dev, monkeypatch, dtype, scaled,
                                            B, d_in, d_m):
    """Workspace chunks of a few steps: h_seq, dx, dh0 and dscale bit for
    bit one chunk's; the weight gradients, whose partials slice each
    chunk's rows, within TOL_GRAD (TOL_GRAD_BF16) of one chunk's. At B =
    33 a chunk's 132 rows end inside a 128-row tile of the products."""
    T = 29
    p = _gen_gru(d_in, d_m, dev, dtype)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(T, B, d_in, generator=g).to(dev, dtype)
    mask = _mask(T, B, dev).to(dtype)
    scale = (torch.rand(T, B, generator=g).to(dev, dtype) if scaled
             else None)
    dh_seq = torch.randn(T, B, d_m, generator=g).to(dev, dtype)
    runs = []
    for steps in (T, 4):
        per_step = B * d_m * (24 + 4 * x.element_size())
        monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * per_step)
        assert cuda_gru.gen_bwd_workspace_steps(T, B, d_m, dtype) == steps
        h = cuda_gru.scan_fwd(x, mask, None, p.wx, p.wh, p.b, scale)
        runs.append((h, cuda_gru.gru_scan_bwd(p, x, mask, h, dh_seq, None,
                                              scale)))
    torch.cuda.synchronize()
    (h1, g1), (hc, gc) = runs
    tol = TOL_GRAD_BF16 if dtype == BF16 else TOL_GRAD
    assert torch.equal(h1, hc)
    for i, (a, b) in enumerate(zip(g1, gc)):
        if i in (1, 2, 3):
            assert _rel_err(b.float(), a.float()) <= tol, i
        else:
            assert torch.equal(a, b), i


@pytest.mark.parametrize("B", [1, 37, 512])
@pytest.mark.parametrize("d_m,A,L,d_q", GEN_READOUT_SHAPES)
def test_general_readout_kernel_matches_plain(dev, d_m, A, L, d_q, B):
    r = Readout(d_m, d_q, A)
    r.reset_parameters(torch.Generator().manual_seed(B))
    r = r.requires_grad_(False).to(dev)
    g = torch.Generator().manual_seed(L)
    mem = torch.randn(B, L, d_m, generator=g).to(dev)
    q = torch.randn(B, d_q, generator=g).to(dev)
    n, n_gen = cuda_readout.launches, cuda_readout.gen_launches
    got = cuda_readout.fused_attention_readout(r, mem, q)
    want = attention_readout(r, mem, q)
    torch.cuda.synchronize()
    assert (cuda_readout.launches, cuda_readout.gen_launches) == (
        n, n_gen + 1)
    assert (got - want).abs().max().item() <= TOL_READOUT


def test_general_forms_refuse_past_their_limits(dev):
    for d_in, d_m in ((32, 257), (513, 32)):
        p = GRUParams(d_in, d_m).requires_grad_(False).to(dev)
        with pytest.raises(ValueError, match="d_m <= 256 and d_in <= 512"):
            cuda_gru.gru_sequence_tm(p, torch.zeros(4, 2, d_in, device=dev))
    for d_m, A, L, d_q in ((257, 8, 2, 8), (8, 257, 2, 8), (8, 8, 65, 8),
                           (8, 8, 2, 513)):
        r = Readout(d_m, d_q, A).requires_grad_(False).to(dev)
        with pytest.raises(ValueError, match="L <= 64"):
            cuda_readout.fused_attention_readout(
                r, torch.zeros(3, L, d_m, device=dev),
                torch.zeros(3, d_q, device=dev))
    for d_in, d_m in ((32, 257), (513, 32)):
        p = GRUParams(d_in, d_m).requires_grad_(False).to(dev)
        with pytest.raises(ValueError, match="d_m <= 256 and d_in <= 512"):
            cuda_gru_stride.gru_stride_tm(
                p, torch.zeros(6, 2, d_in, device=dev), 3)


# ---- K3-general and K4-general (the strided forms at every other width).
GEN_STRIDE_SHAPES = [(1, 1), (3, 4), (16, 16), (40, 48), (128, 64),
                     (64, 128), (128, 32), (512, 256), (127, 43), (129, 43),
                     (512, 43)]


def _gen_stride_counts():
    return tuple(getattr(cuda_gru_stride, name) for name in (
        "gen_launches", "gen_bwd_launches", "gen_launches_bf16",
        "gen_bwd_launches_bf16"))


def _gen_stride_case(T, period, B, d_in, d_m, dtype, dev, seed=0):
    p = _gen_gru(d_in, d_m, dev, dtype, seed)
    g = torch.Generator().manual_seed(T + B + period + d_m + seed)
    x = torch.randn(3 * T, B, d_in, generator=g).to(dev, dtype)[1::3]
    h0 = torch.randn(B, d_m, generator=g).to(dev, dtype) if B % 2 else None
    dhs = torch.randn(T // period, B, d_m, generator=g).to(dev, dtype)
    dhT = torch.randn(B, d_m, generator=g).to(dev, dtype)
    return p, x, h0, dhs, dhT


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("T,period,B", [(37, 3, 7), (2, 3, 5), (50, 4, 6),
                                        (40, 3, 33)])
@pytest.mark.parametrize("d_in,d_m", GEN_STRIDE_SHAPES)
def test_general_stride_kernels_match_plain(dev, d_in, d_m, T, period, B,
                                            dtype):
    """K3-general and K4-general (or their bf16 forms) against the plain
    strided scan and its backward on a strided time view of x, K4-general
    run from K3-general's boundaries: ragged T (against the period and the
    16-step boundaries), an empty h_stride (T < period), odd B with an h0;
    each launched once and no other scan kernel."""
    p, x, h0, dhs, dhT = _gen_stride_case(T, period, B, d_in, d_m, dtype,
                                          dev)
    bf16 = dtype == BF16
    fixed, counts = _all_counts() + _gen_counts(), _gen_stride_counts()
    hs, hT, bounds = cuda_gru_stride.stride_fwd(p, x, period, h0)
    got = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, dhT, h0)
    plain_fwd, plain_bwd = ((gru_scan_stride_tm_bf16,
                             gru_scan_stride_tm_bwd_bf16) if bf16 else
                            (gru_scan_stride_tm, gru_scan_stride_tm_bwd))
    hs_p, hT_p = plain_fwd(p, x, period, h0)
    want = plain_bwd(p, x, period, dhs, dhT, h0)
    torch.cuda.synchronize()
    assert _all_counts() + _gen_counts() == fixed
    ran = [b - a for a, b in zip(counts, _gen_stride_counts())]
    assert ran == ([0, 0, 1, 1] if bf16 else [1, 1, 0, 0])
    assert hs.shape == (T // period, B, d_m) and hs.dtype == dtype
    assert bounds.shape == (-(-T // 16), B, d_m)
    tol_h, tol_g = (TOL_GRU_BF16, TOL_GRAD_BF16) if bf16 else (TOL_GRU,
                                                               TOL_GRAD)
    if T >= period:
        assert (hs.float() - hs_p.float()).abs().max().item() <= tol_h
    assert (hT.float() - hT_p.float()).abs().max().item() <= tol_h
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel_err(a.float(), b.float()) <= tol_g, name


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("cotangents", ["strided", "last"])
def test_general_stride_bwd_with_one_cotangent(dev, cotangents, dtype):
    """K4-general with dhs or dhT absent (None: zero) == the plain backward
    given that cotangent as zeros, at the backward's tolerances."""
    T, period, B, d_in, d_m = 45, 3, 9, 40, 48
    p, x, h0, dhs, dhT = _gen_stride_case(T, period, B, d_in, d_m, dtype,
                                          dev)
    bounds = cuda_gru_stride.stride_fwd(p, x, period, h0)[2]
    if cotangents == "strided":
        got = cuda_gru_stride.stride_bwd(p, x, period, bounds, dhs, None)
        dhT = torch.zeros_like(dhT)
    else:
        got = cuda_gru_stride.stride_bwd(p, x, period, bounds, None, dhT)
        dhs = torch.zeros_like(dhs)
    want = (gru_scan_stride_tm_bwd_bf16 if dtype == BF16 else
            gru_scan_stride_tm_bwd)(p, x, period, dhs, dhT, h0)
    torch.cuda.synchronize()
    tol = TOL_GRAD_BF16 if dtype == BF16 else TOL_GRAD
    for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, want):
        assert _rel_err(a.float(), b.float()) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("T,B,d_in,d_m", [(100, 5, 40, 48),
                                          (250, 8, 128, 64),
                                          (100, 33, 129, 43)])
def test_general_stride_chunks_match_one_chunk(dev, monkeypatch, dtype, T, B,
                                               d_in, d_m):
    """K3-general over workspace chunks of 7 steps and K4-general over
    chunks of 16 and 48 steps == one chunk, every output bit for bit (the
    weight gradients' partials are batch slices, each summed over the
    steps from the last to the first, whatever the chunk)."""
    period = 3
    p, x, h0, dhs, dhT = _gen_stride_case(T, period, B, d_in, d_m, dtype,
                                          dev)
    fwd_row = 3 * d_m * 4
    bwd_row = d_m * (24 + 5 * x.element_size())
    whole = -(-T // 16) * 16
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", whole * B * bwd_row)
    assert cuda_gru.workspace_steps(T, B, d_m) == T
    assert cuda_gru_stride.bwd_workspace_steps(T, B, dtype, 16, d_m,
                                               d_in) == whole
    one = cuda_gru_stride.stride_fwd(p, x, period, h0)
    one_b = cuda_gru_stride.stride_bwd(p, x, period, one[2], dhs, dhT)
    monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", 7 * B * fwd_row)
    assert cuda_gru.workspace_steps(T, B, d_m) == 7
    chunked = cuda_gru_stride.stride_fwd(p, x, period, h0)
    for name, a, b in zip(("h_stride", "h_T", "boundaries"), chunked, one):
        assert torch.equal(a, b), name
    for steps in (16, 48):
        monkeypatch.setattr(cuda_gru, "WORKSPACE_BYTES", steps * B * bwd_row)
        assert cuda_gru_stride.bwd_workspace_steps(T, B, dtype, 16, d_m,
                                                   d_in) == steps
        got = cuda_gru_stride.stride_bwd(p, x, period, one[2], dhs, dhT)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got, one_b):
            assert torch.equal(a, b), (name, steps)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("d_in,d_m", [(64, 64), (40, 48)])
def test_general_stride_rows_against_the_dense_kernel(dev, dtype, d_in, d_m):
    """K3-general's rows against K1-general's h_seq[period-1::period] on
    the same inputs (T = 1000, B = 64): bit for bit in bf16 (K1-general's
    no-mask h_cell is the stride update), within TOL_GRU in f32 (K1-general
    writes h + 1*(h_cell - h), the TPU stride kernel h + z*(c - h))."""
    p = _gen_gru(d_in, d_m, dev, dtype)
    x = torch.randn(1000, 64, d_in, generator=torch.Generator().manual_seed(
        7)).to(dev, dtype)
    n = _gen_counts()[0] + _gen_counts()[2]
    h_seq, h_T = cuda_gru.gru_sequence_tm(p, x)
    hs, hT = cuda_gru_stride.gru_stride_tm(p, x, 3)
    torch.cuda.synchronize()
    assert _gen_counts()[0] + _gen_counts()[2] == n + 1
    if dtype == BF16:
        assert torch.equal(hs, h_seq[2::3]) and torch.equal(hT, h_T)
    else:
        assert (hs - h_seq[2::3]).abs().max().item() <= TOL_GRU
        assert (hT - h_T).abs().max().item() <= TOL_GRU


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("T,period,B,d_in,d_m", [
    (37, 3, 33, 40, 48), (250, 2, 8, 128, 64)])
def test_general_stride_rec_gates_match_plain_sweep(dev, dtype, T, period, B,
                                                    d_in, d_m):
    """K4-general's replay and sweep, seen whole (stride_bwd_gates): the
    gate gradients and dh0 within TOL_GRAD (TOL_GRAD_BF16) of their max abs
    of the plain sweep's, h_prev within TOL_GRU (TOL_GRU_BF16) and, in the
    replay's bf16 chain, K3-general's boundaries bit for bit."""
    p, x, h0, dhs, dhT = _gen_stride_case(T, period, B, d_in, d_m, dtype,
                                          dev)
    _, _, bounds = cuda_gru_stride.stride_fwd(p, x, period, h0)
    got = cuda_gru_stride.stride_bwd_gates(p, x, period, bounds, dhs, dhT)
    want = cuda_gru_stride.stride_bwd_gates(
        GRUWeights(*(t.cpu() for t in p)), x.cpu(), period, None, dhs.cpu(),
        dhT.cpu(), None if h0 is None else h0.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got[2][::16], bounds)
    bf = dtype == BF16
    tol_h, tol_g = ((TOL_GRU_BF16, TOL_GRAD_BF16) if bf
                    else (TOL_GRU, TOL_GRAD))
    for name, a, b in zip(("dpre_x", "dpre_h", "h_prev", "dh0"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        a, b = a.float().cpu(), b.float()
        if name == "h_prev":
            assert (a - b).abs().max().item() <= tol_h, name
        else:
            assert _rel_err(a, b) <= tol_g, name


def _wide(name, **extra):
    return configs.get_config(name).with_model(
        use_pallas=True, mem_dim=64, readout_dim=64, emb_dim=64, **extra)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_wide_train_step_kernel_path_matches_plain_path(dev, scan_dtype):
    """xlong_hpmn at mem_dim = readout_dim = emb_dim = 64 (layer 0's d_in
    128, K5's A = d_m = 64 and d_q = 128): one loss and gradient through
    K1-general, K2-general (or their bf16 forms) and K5-general == the same
    branch with the plain scans and readout (``plain=True``)."""
    cfg = _wide("xlong_hpmn", assume_full_mask=True, scan_dtype=scan_dtype)
    spec = synthetic.DatasetSpec("mid", seq_len=250, n_items=500, n_cats=40,
                                 n_users=50)
    batch = batch_from_numpy(synthetic.make_ctr_dataset(
        spec, 32, seed=1, min_len_frac=1.0), device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        counts = _gen_counts() + (cuda_readout.gen_launches,)
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = [b - a for a, b in zip(
            counts, _gen_counts() + (cuda_readout.gen_launches,))]
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    L = cfg.model.hpmn_layers
    bf16 = scan_dtype == "bfloat16"
    assert ran_k == ([0, 0, L, L] if bf16 else [L, L, 0, 0]) + [0] * 4 + [1]
    assert ran_p == [0] * 9
    tol_loss, tol_grad = ((TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16) if bf16
                          else (1e-5, TOL_GRAD))
    assert abs(l_k - l_p) <= tol_loss * abs(l_p)
    for name, p in p_k.items():
        assert _rel_err(p.grad, p_p[name].grad) <= tol_grad, name


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_wide_stride_train_step_kernel_path_matches_plain_path(dev,
                                                               scan_dtype):
    """xlong_hpmn at mem_dim = readout_dim = emb_dim = 64 with
    pallas_stride_outputs: one loss and gradient through K3-general and
    K4-general (or their bf16 forms) and K5-general == the same branch with
    the plain strided scans (``plain=True``); no dense or fixed-width scan
    kernel runs."""
    cfg = _wide("xlong_hpmn", assume_full_mask=True,
                pallas_stride_outputs=True, scan_dtype=scan_dtype)
    spec = synthetic.DatasetSpec("mid", seq_len=250, n_items=500, n_cats=40,
                                 n_users=50)
    batch = batch_from_numpy(synthetic.make_ctr_dataset(
        spec, 32, seed=1, min_len_frac=1.0), device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        others = _all_counts() + _gen_counts()
        counts = _gen_stride_counts() + (cuda_readout.gen_launches,)
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        assert _all_counts() + _gen_counts() == others
        ran = [b - a for a, b in zip(
            counts, _gen_stride_counts() + (cuda_readout.gen_launches,))]
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    L = cfg.model.hpmn_layers
    bf16 = scan_dtype == "bfloat16"
    assert ran_k == ([0, 0, L, L] if bf16 else [L, L, 0, 0]) + [1]
    assert ran_p == [0] * 5
    tol_loss, tol_grad = ((TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16) if bf16
                          else (1e-5, TOL_GRAD))
    assert abs(l_k - l_p) <= tol_loss * abs(l_p)
    for name, p in p_k.items():
        assert _rel_err(p.grad, p_p[name].grad) <= tol_grad, name


@pytest.mark.parametrize("scan_dtype,full_mask", [("float32", False),
                                                  ("bfloat16", True)])
def test_wide_dien_step_kernel_path_matches_plain_path(dev, scan_dtype,
                                                       full_mask):
    """taobao_dien at mem_dim = 64: K1-general, K2-general and their scale
    forms (f32 left-padded, bf16 full) against the plain path."""
    cfg = configs.get_config("taobao_dien").with_model(
        use_pallas=True, mem_dim=64, assume_full_mask=full_mask,
        scan_dtype=scan_dtype)
    batch = batch_from_numpy(_dien_data(full_mask), device=dev)
    out = []
    for plain in (False, True):
        model = init_model(cfg, 500, 40, seed=2, device=dev)
        counts = _gen_counts()
        loss, _ = loss_fn(model, cfg, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        ran = [b - a for a, b in zip(counts, _gen_counts())]
        out.append((loss.item(), dict(model.named_parameters()), ran))
    (l_k, p_k, ran_k), (l_p, p_p, ran_p) = out
    if scan_dtype == "float32":
        assert ran_k == [1, 1, 0, 0, 1, 1, 0, 0]
        tol_loss, tol_grad = 1e-5, TOL_GRAD
    else:
        assert ran_k == [0, 0, 1, 1, 0, 0, 1, 1]
        tol_loss, tol_grad = TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16
    assert ran_p == [0] * 8
    assert abs(l_k - l_p) <= tol_loss * abs(l_p)
    for name, p in p_k.items():
        assert _rel_err(p.grad, p_p[name].grad) <= tol_grad, name


def test_narrow_store_on_the_card_matches_the_cpu_store(dev):
    """UserMemoryStore of xlong_hpmn at mem_dim = 16, readout_dim = 24,
    emb_dim = 20: ingest (K1-general), update and rank (K5-general) on the
    card against the same store on the CPU."""
    cfg = configs.get_config("xlong_hpmn").with_model(
        mem_dim=16, readout_dim=24, emb_dim=20)
    rng = np.random.default_rng(0)
    T, B = 250, 16
    items = rng.integers(1, 500, size=(B, T))
    stores = [UserMemoryStore(cfg, init_model(cfg, 500, 40, device=d),
                              device=d) for d in ("cpu", dev)]
    n_gru, n_ro = cuda_gru.gen_launches, cuda_readout.gen_launches
    for s in stores:
        s.ingest_histories(np.arange(B), items, items % 40)
        s.update(np.arange(0, B, 3), items[:6, 0], items[:6, 1] % 40)
    assert cuda_gru.gen_launches == n_gru + cfg.model.hpmn_layers
    uids = np.arange(B)
    m_cpu, _ = stores[0]._gather(uids)
    m_dev, _ = stores[1]._gather(uids)
    assert (m_dev.cpu() - m_cpu).abs().max().item() <= TOL_GRU
    ci = rng.integers(1, 500, size=(B, 7))
    np.testing.assert_allclose(stores[1].rank(uids, ci, ci % 40),
                               stores[0].rank(uids, ci, ci % 40),
                               atol=TOL_GRU)
    assert cuda_readout.gen_launches == n_ro + 1
