"""Strided-output GRU scan through the hand-written CUDA kernels, forward
and backward: the full-sequence path of ``model.pallas_stride_outputs``.

Replaces ``hpmn_tpu/ops/pallas_gru.py``'s ``_fwd_stride_kernel`` (K3) and
``_bwd_stride_kernel`` (K4), reached there through ``pallas_gru_stride_tm``
and the ``jax.custom_vjp`` of ``_make_stride_core``, in the f32 chain and
in the bf16 one (``dtype=bfloat16``: K3-bf16 and K4-bf16, chosen by the
tensors' dtype). A layer emits only the rows the next HPMN layer reads,
h_seq[period-1::period], and h_T; the forward keeps the state at the
start of every chunk of 16 steps for the backward, which replays each
chunk from it and then sweeps it in reverse. No dense h_seq is written or
read. K3 and K3-bf16 run K1's two kernels per chunk of steps: the input
projection (``csrc/gru_input_proj.cu``) into an f32 workspace of
``cuda_gru.workspace_steps`` steps, then K1's recurrence
(``csrc/gru_scan_fwd.cu``) with a strided output policy, which writes the
strided rows, the boundaries and h_T; one C call runs every chunk, one
counted launch (``csrc/gru_scan_stride_fwd.cu`` keeps their one-kernel
form for comparisons, which ``_k3`` is the seam for). K4 and K4-bf16 run,
per chunk of steps, K1's input projection into a workspace, then a replay
and reverse sweep that write each step's gate gradients and h_prev into
two more, then K2's ``csrc/gru_bwd_pass.cu`` computes dx and the weight
gradients from them; the workspaces, which this module allocates, share
``cuda_gru.WORKSPACE_BYTES`` (:func:`bwd_workspace_steps`). One C call,
one counted launch. See the sources' headers for the design.

K3 and K4 take d_m = 32 and d_in <= 96, as K1 and K2 do. Every other width,
up to d_m = 256 and d_in = 512, runs their width-general forms (K3-general
and K4-general, f32 and bf16: ``csrc/gru_general_fwd.cu`` and
``csrc/gru_general_bwd.cu``, with ``csrc/gru_general_gemm.cu``'s tiled
products), which count in the ``gen_`` counters below. K3-general is
K1-general's projection and recurrence with a strided output policy;
K4-general runs, per workspace chunk (a multiple of the boundaries'
chunk), the projection, a replay from the chunk's boundary with
K3-general's recurrence (h_prev and h @ wh into workspaces), K2-general's
reverse recurrence on the strided cotangents, then dx and the weight
gradients as tiled products. Neither writes or reads a dense h_seq or
dh_seq.

:class:`GRUStrideScan` is the ``torch.autograd.Function`` that mirrors the
custom_vjp: on CUDA tensors its forward launches K3 and its backward K4; on
CPU tensors they are the plain versions ``ops.gru.gru_scan_stride_tm`` and
``ops.gru.gru_scan_stride_tm_bwd`` (their ``_bf16`` forms in bf16). On a
CUDA tensor a wrapper launches its kernel or raises on what it does not
take (as ``cuda_gru``'s, and period < 2); nothing falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, cuda_gru
from .gru import (GRUParams, GRUWeights, gru_scan_stride_tm,
                  gru_scan_stride_tm_bf16, gru_scan_stride_tm_bwd,
                  gru_scan_stride_tm_bwd_bf16, gru_scan_stride_tm_sweep,
                  gru_scan_stride_tm_sweep_bf16)

# K3's (and K3-bf16's) recurrence and C entry points, after K1's projection.
SOURCE = cuda_gru.SOURCE
REPLACES = "hpmn_tpu/ops/pallas_gru.py:434"
BWD_SOURCE = "hpmn_tpu_torch/csrc/gru_scan_stride_bwd.cu"
BWD_REPLACES = "hpmn_tpu/ops/pallas_gru.py:465"
# K3's and K4's (and their bf16 forms') other kernels: K1's input
# projection and K2's dx and weight-gradient pass.
PROJ_SOURCE = cuda_gru.PROJ_SOURCE
PASS_SOURCE = cuda_gru.PASS_SOURCE
# K3-general's and K4-general's entry points (f32 and bf16), beside
# K1-general's and K2-general's; both run the tiled products, and
# K4-general's replay is GEN_SOURCE's recurrence.
GEN_SOURCE = cuda_gru.GEN_SOURCE
GEN_BWD_SOURCE = cuda_gru.GEN_BWD_SOURCE

#: Kernel launches so far in this process: K3, K4, K3-bf16 and K4-bf16,
#: and their width-general forms (d_m != 32 or d_in > 96). Callers may
#: reset them to 0.
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0
gen_launches = 0
gen_bwd_launches = 0
gen_launches_bf16 = 0
gen_bwd_launches_bf16 = 0

_D_M = cuda_gru._D_M
_FWD_ENTRY = {torch.float32: "hpmn_gru_scan_stride_fwd_ws",
              torch.bfloat16: "hpmn_gru_scan_stride_fwd_bf16_ws"}
_BWD_ENTRY = {torch.float32: "hpmn_gru_scan_stride_bwd_ws",
              torch.bfloat16: "hpmn_gru_scan_stride_bwd_bf16_ws"}
_GEN_FWD_ENTRY = {torch.float32: "hpmn_gru_gen_stride_fwd",
                  torch.bfloat16: "hpmn_gru_gen_stride_fwd_bf16"}
_GEN_BWD_ENTRY = {torch.float32: "hpmn_gru_gen_stride_bwd",
                  torch.bfloat16: "hpmn_gru_gen_stride_bwd_bf16"}


@functools.lru_cache(maxsize=None)
def chunk() -> int:
    """The kernels' chunk length in steps, a compile-time constant of
    ``csrc/gru_scan_stride_fwd.cu``: K3 keeps one boundary state per chunk
    (``ceil(T / chunk())`` of them) and K4 replays one chunk at a time."""
    fn = _build.load_library().hpmn_gru_scan_stride_chunk
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


@functools.lru_cache(maxsize=None)
def _fwd_fn(dtype: torch.dtype):
    """K3's (K3-bf16's) C entry point."""
    fn = getattr(_build.load_library(), _FWD_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rows_fn():
    """d_in -> the batch rows that one of K4's weight-gradient partials
    sums."""
    fn = _build.load_library().hpmn_gru_scan_stride_bwd_rows_per_block
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn(dtype: torch.dtype):
    """K4's (K4-bf16's) C entry point."""
    fn = getattr(_build.load_library(), _BWD_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gen_fwd_fn(dtype: torch.dtype):
    """K3-general's (K3-general-bf16's) C entry point."""
    fn = getattr(_build.load_library(), _GEN_FWD_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gen_bwd_fn(dtype: torch.dtype):
    """K4-general's (K4-general-bf16's) C entry point."""
    fn = getattr(_build.load_library(), _GEN_BWD_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bwd_workspace_steps(T: int, B: int, dtype: torch.dtype,
                        chunk_steps: int, d_m: int = _D_M,
                        d_in: int = _D_M) -> int:
    """K4's workspace chunk: the most steps, a multiple of ``chunk_steps``
    (:func:`chunk`, so that no replayed chunk straddles two), whose input
    projection xp [., B, 3*d_m] in float32 (K4-general: and the replay's h
    @ wh [., B, 3*d_m] in float32) and gate gradients dg [., B, 4*d_m] and
    h_prev [., B, d_m] in ``dtype`` fit ``cuda_gru.WORKSPACE_BYTES``
    together; at least one chunk, at most the chunks that cover T. (d_in,
    d_m) chooses K4 or K4-general, as ``cuda_gru.fixed_width``."""
    es = torch.empty(0, dtype=dtype).element_size()
    f32_blocks = 1 if cuda_gru.fixed_width(d_in, d_m) else 2
    fit = cuda_gru.WORKSPACE_BYTES // (B * d_m * (5 * es + 12 * f32_blocks))
    whole = -(-T // chunk_steps) * chunk_steps
    return max(chunk_steps, min(whole, fit // chunk_steps * chunk_steps))


def gen_splits(B: int, d_in: int, d_m: int) -> int:
    """K4-general's weight-gradient partials: batch slices of B / splits
    rows, each summed over the steps from the last to the first, so that
    the sums do not depend on the workspace chunk. The smallest divisor of
    B, up to 64, that reaches K2-general's count (``cuda_gru.gen_splits``,
    at most B), so that the products run as many blocks; the largest
    divisor below that count where none does."""
    want = min(cuda_gru.gen_splits(d_in, d_m), B)
    divisors = [s for s in range(1, min(B, 64) + 1) if B % s == 0]
    return min((s for s in divisors if s >= want),
               default=max(s for s in divisors if s <= want))


def _kernel_name(dtype: torch.dtype, bwd: bool, general: bool) -> str:
    return (("gru_stride_gen_" if general else "gru_scan_stride_")
            + ("bwd" if bwd else "fwd")
            + ("_bf16" if dtype == torch.bfloat16 else ""))


def _count(dtype: torch.dtype, bwd: bool, general: bool) -> None:
    var = (("gen_" if general else "") + ("bwd_launches" if bwd
                                          else "launches")
           + ("_bf16" if dtype == torch.bfloat16 else ""))
    globals()[var] += 1


def _check_args(w, x_tm, h0, period, name):
    """What K3 and K4 (or their general forms) take: ``cuda_gru``'s limits
    (d_m <= 256, d_in <= 512, one dtype, contiguous rows), period >= 2."""
    cuda_gru._check_cuda_args(w, x_tm, None, h0, name)
    if period < 2:
        raise ValueError(f"{name} takes period >= 2; got {period}")


def _check_rows(name, t, shape, x_tm):
    if t.shape != shape or t.dtype != x_tm.dtype \
            or t.device != x_tm.device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {list(shape)} tensor "
                         "of x's dtype on x's device")


def _k3(w, x_tm, h0, period, outs, stream) -> int:
    """K3's (K3-bf16's; at other widths K3-general's) C call: the f32
    workspace of ``cuda_gru.workspace_steps`` steps, then every chunk's
    projection and recurrence; outs = (h_stride, boundaries, h_T) -> the
    cudaError_t code."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    t_chunk = cuda_gru.workspace_steps(T, B, d_m)
    ws = torch.empty(t_chunk, B, 3 * d_m, dtype=torch.float32,
                     device=x_tm.device)
    if cuda_gru.fixed_width(d_in, d_m):
        fn, dims = _fwd_fn(x_tm.dtype), (T, B, d_in, period)
    else:
        fn, dims = _gen_fwd_fn(x_tm.dtype), (T, B, d_in, d_m, period)
    with _build.on_device(x_tm):
        return fn(x_tm.data_ptr(), x_tm.stride(0), w.wx.data_ptr(),
                  w.wh.data_ptr(), w.b.data_ptr(), cuda_gru._ptr(h0),
                  *(t.data_ptr() for t in outs), ws.data_ptr(), t_chunk,
                  *dims, stream)


def _launch(w, x_tm, h0, period):
    """K3 (float32) or K3-bf16 (bfloat16), or their width-general forms:
    -> (h_stride [T // period, B, d_m], h_T [B, d_m], boundaries
    [ceil(T / chunk), B, d_m]), x's dtype."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    general = not cuda_gru.fixed_width(d_in, d_m)
    name = _kernel_name(x_tm.dtype, False, general)
    _check_args(w, x_tm, h0, period, name)
    new = functools.partial(torch.empty, dtype=x_tm.dtype, device=x_tm.device)
    hs, h_T = new(T // period, B, d_m), new(B, d_m)
    bounds = new(-(-T // chunk()), B, d_m)
    code = _k3(w, x_tm, h0, period, (hs, bounds, h_T),
               torch.cuda.current_stream(x_tm.device).cuda_stream)
    _build.check_launch(code, name)
    _count(x_tm.dtype, False, general)
    return hs, h_T, bounds


def _k4(w, x_tm, period, bounds, dhs, dhT, outs, stream, t_chunk=None):
    """K4's (K4-bf16's; at other widths K4-general's) C call: the
    workspaces of t_chunk steps (default :func:`bwd_workspace_steps`), then
    every chunk's projection, recurrence and pass (K4-general: projection,
    replay, recurrence and products), then the partials; outs = (dx, dh0,
    dwx, dwh, db) -> (the cudaError_t code, dg [n, B, d_m, 4], h_prev [n,
    B, d_m]): the gate gradients and h_prev of the first n = min(t_chunk,
    T) steps."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    if t_chunk is None:
        t_chunk = bwd_workspace_steps(T, B, x_tm.dtype, chunk(), d_m, d_in)
    n = min(t_chunk, T)
    dev = x_tm.device
    dg = torch.empty(n, B, d_m, 4, dtype=x_tm.dtype, device=dev)
    hprev = torch.empty(n, B, d_m, dtype=x_tm.dtype, device=dev)
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    if not cuda_gru.fixed_width(d_in, d_m):
        ws = f32(2, n, B, 3 * d_m)
        with _build.on_device(x_tm):
            code = _gen_bwd_fn(x_tm.dtype)(
                x_tm.data_ptr(), x_tm.stride(0), w.wx.data_ptr(),
                w.wh.data_ptr(), w.b.data_ptr(), bounds.data_ptr(),
                cuda_gru._ptr(dhs), cuda_gru._ptr(dhT),
                *(t.data_ptr() for t in outs), ws.data_ptr(),
                dg.data_ptr(), hprev.data_ptr(), outs[2].shape[0], t_chunk,
                T, B, d_in, d_m, period, stream)
        return code, dg, hprev
    xp, acc = f32(n, B, 3 * _D_M), f32(B, cuda_gru._acc_floats(d_in))
    with _build.on_device(x_tm):
        code = _bwd_fn(x_tm.dtype)(
            x_tm.data_ptr(), x_tm.stride(0), w.wx.data_ptr(),
            w.wh.data_ptr(), w.b.data_ptr(), bounds.data_ptr(),
            cuda_gru._ptr(dhs), cuda_gru._ptr(dhT),
            *(t.data_ptr() for t in outs), dg.data_ptr(), hprev.data_ptr(),
            xp.data_ptr(), acc.data_ptr(), t_chunk, T, B, d_in, period,
            stream)
    return code, dg, hprev


def _launch_bwd(w, x_tm, period, bounds, dhs, dhT, t_chunk=None):
    """K4 (float32) or K4-bf16 (bfloat16), or their width-general forms: ->
    (dx in x's dtype, dwx, dwh, db, dh0 in float32), the weight gradients
    summed over the kernel's partials (per group of batch rows;
    K4-general's :func:`gen_splits`), then the workspaces (dg, h_prev) of
    :func:`_k4`."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    general = not cuda_gru.fixed_width(d_in, d_m)
    name = _kernel_name(x_tm.dtype, True, general)
    _check_args(w, x_tm, None, period, name)
    _check_rows("the boundaries", bounds, (-(-T // chunk()), B, d_m), x_tm)
    if dhs is not None:
        _check_rows("dh_stride", dhs, (T // period, B, d_m), x_tm)
    if dhT is not None:
        _check_rows("dh_T", dhT, (B, d_m), x_tm)
    n_blocks = (gen_splits(B, d_in, d_m) if general
                else -(-B // _rows_fn()(d_in)))
    dev = x_tm.device
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    dx = torch.empty(T, B, d_in, dtype=x_tm.dtype, device=dev)
    dh0 = f32(B, d_m)
    dwx, dwh = f32(n_blocks, d_in, 3 * d_m), f32(n_blocks, d_m, 3 * d_m)
    db = f32(n_blocks, 3 * d_m)
    code, dg, hprev = _k4(w, x_tm, period, bounds, dhs, dhT,
                          (dx, dh0, dwx, dwh, db),
                          torch.cuda.current_stream(dev).cuda_stream, t_chunk)
    _build.check_launch(code, name)
    _count(x_tm.dtype, True, general)
    return (dx, dwx.sum(0), dwh.sum(0), db.sum(0), dh0), (dg, hprev)


def stride_fwd(params: GRUParams, x_tm: torch.Tensor, period: int,
               h0: Optional[torch.Tensor] = None):
    """The strided scan forward: K3 (K3-bf16 on bfloat16 tensors; at other
    widths their general forms) on CUDA tensors, -> (h_stride, h_T,
    boundaries for :func:`stride_bwd`); ``gru_scan_stride_tm`` (``_bf16``)
    on CPU tensors, with no boundaries (None)."""
    if cuda_gru._on(x_tm, "stride_fwd") == "cpu":
        plain = (gru_scan_stride_tm_bf16 if x_tm.dtype == torch.bfloat16
                 else gru_scan_stride_tm)
        return (*plain(params, x_tm, period, h0), None)
    return _launch(params, x_tm, h0, period)


def stride_bwd(params: GRUParams, x_tm: torch.Tensor, period: int,
               bounds: Optional[torch.Tensor], dhs: Optional[torch.Tensor],
               dhT: Optional[torch.Tensor],
               h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The strided scan backward: K4 (K4-bf16, or their general forms) on
    CUDA tensors, from K3's boundaries (which hold h0);
    ``gru_scan_stride_tm_bwd`` (``_bf16``) on CPU tensors, from h0. dhs and
    dhT may be None (zero). -> (dx in x's dtype, dwx, dwh, db, dh0 in
    float32)."""
    if cuda_gru._on(x_tm, "stride_bwd") == "cpu":
        plain = (gru_scan_stride_tm_bwd_bf16 if x_tm.dtype == torch.bfloat16
                 else gru_scan_stride_tm_bwd)
        return plain(params, x_tm, period, dhs, dhT, h0)
    return _launch_bwd(params, x_tm, period, bounds,
                       None if dhs is None else dhs.contiguous(),
                       None if dhT is None else dhT.contiguous())[0]


def stride_bwd_gates(params: GRUParams, x_tm: torch.Tensor, period: int,
                     bounds: Optional[torch.Tensor],
                     dhs: Optional[torch.Tensor], dhT: Optional[torch.Tensor],
                     h0: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, ...]:
    """K4's (K4-bf16's, or their general forms') recurrence, seen whole: its
    gate gradients and h_prev over all T steps (K4 run in one workspace
    chunk, on CUDA tensors) or those of the plain sweep
    ``gru_scan_stride_tm_sweep`` (``_bf16``) on CPU tensors -> (dpre_x =
    [dr|dz|dc], dpre_h = [dr|dz|dc*r] [T, B, 3*d_m] and h_prev [T, B, d_m]
    in x's dtype, dh0 in float32)."""
    if cuda_gru._on(x_tm, "stride_bwd_gates") == "cpu":
        plain = (gru_scan_stride_tm_sweep_bf16
                 if x_tm.dtype == torch.bfloat16
                 else gru_scan_stride_tm_sweep)
        return plain(params, x_tm, period, dhs, dhT, h0)
    T = x_tm.shape[0]
    outs, (dg, hprev) = _launch_bwd(
        params, x_tm, period, bounds,
        None if dhs is None else dhs.contiguous(),
        None if dhT is None else dhT.contiguous(),
        t_chunk=-(-T // chunk()) * chunk())
    return (*cuda_gru.gate_blocks(dg), hprev, outs[4])


class GRUStrideScan(torch.autograd.Function):
    """(h_stride, h_T) = strided scan(x_tm, h0; wx, wh, b), time-major, no
    mask. Forward K3 and backward K4 (their general forms at other widths)
    on CUDA tensors; the plain versions on CPU tensors. All tensors
    float32, or all bfloat16. Either output's cotangent may be absent (the
    top layer's h_stride feeds nothing); h0 gets a gradient when it is
    given. The weight gradients, summed in float32, come back in the
    weights' dtype, as :class:`cuda_gru.GRUScan`'s do."""

    @staticmethod
    def forward(ctx, x_tm, h0, wx, wh, b, period):
        w = GRUWeights(wx, wh, b)
        h_stride, h_T, bounds = stride_fwd(w, x_tm, period, h0)
        ctx.period = period
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x_tm, h0, wx, wh, b, bounds)
        return h_stride, h_T

    @staticmethod
    def backward(ctx, dhs, dhT):
        x_tm, h0, wx, wh, b, bounds = ctx.saved_tensors
        dx, dwx, dwh, db, dh0 = stride_bwd(
            GRUWeights(wx, wh, b), x_tm, ctx.period, bounds, dhs, dhT, h0)
        return (dx, None if h0 is None else dh0.to(h0.dtype),
                dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(b.dtype), None)


def gru_stride_tm(params: GRUParams, x_tm: torch.Tensor, period: int,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strided-output time-major scan, h0 = 0 (``pallas_gru_stride_tm``):
    x_tm [T, B, d_in] -> (h_stride [T // period, B, d_m] ==
    h_seq[period-1::period], h_T [B, d_m]), differentiable through
    :class:`GRUStrideScan`. ``period <= 1`` is the dense scan
    (``cuda_gru.gru_sequence_tm``), as in JAX; T < period gives an empty
    h_stride."""
    if period <= 1:
        return cuda_gru.gru_sequence_tm(params, x_tm)
    cuda_gru._on(x_tm, "gru_stride_tm")
    return GRUStrideScan.apply(x_tm, None, params.wx, params.wh, params.b,
                               period)
