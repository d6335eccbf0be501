"""GRU scan through the hand-written CUDA kernels, forward and backward.

Replaces ``hpmn_tpu/ops/pallas_gru.py``'s ``_fwd_kernel`` (K1) and
``_bwd_kernel`` (K2), reached there through ``pallas_gru_sequence_tm`` and
its ``jax.custom_vjp``, in their mask and no-mask forms, in the f32 chain
and in the bf16 one (``dtype=bfloat16``: K1-bf16 and K2-bf16, chosen by the
tensors' dtype), with and without the AUGRU gate scale (``has_scale``:
K1-scale and K2-scale and their bf16 forms, chosen by a ``scale_tm``; the
backward then also returns dscale). The kernels are
``csrc/gru_scan_fwd.cu`` and
``csrc/gru_scan_bwd.cu``, each one template for both chains: a
recurrence launch scans its steps (forward, or backward in reverse) with
the time loop inside the kernel and the carry in registers, one warp per
batch row with lane j owning hidden unit j. The recurrence bounds both
(each step waits for the last); keeping the loop in one launch, with no
barrier or device-memory round trip between steps, is what the design
does about that. K1 and K1-bf16, and their scale forms, are two kernels:
``csrc/gru_input_proj.cu`` computes the x half of the products for a
chunk of steps into an f32 workspace this module allocates (at most
:data:`WORKSPACE_BYTES`; in bf16 in the chain's layout,
:func:`input_proj`), then the recurrence reads it (with the scale, a_t
beside the mask); one C call runs every chunk, and one K1 call counts one
launch. K2 and
K2-bf16, and their scale forms, are two kernels too, run from the last
chunk of steps to the first: the reverse recurrence writes each step's
gate gradients (and, with the scale, dscale) into a workspace (at most
:data:`WORKSPACE_BYTES`), then ``csrc/gru_bwd_pass.cu`` computes dx and
the weight gradients from them; one C call, one counted launch
(:func:`bwd_gates` runs it in one chunk and returns the workspace). See
the sources' headers for the rest.

:class:`GRUScan` is the ``torch.autograd.Function`` that mirrors the
custom_vjp: on CUDA tensors its forward launches K1 and its backward K2;
on CPU tensors they are the plain versions ``ops.gru.gru_scan_tm`` and
``ops.gru.gru_scan_tm_bwd`` (``gru_scan_tm_bf16``/``gru_scan_tm_bwd_bf16``
in bf16), so the CPU tests run the same plumbing (saved tensors, strided
views, the mask).

The kernels above take d_m = 32 and d_in <= 96, the width of every
shipped config. Every other width, up to d_m = 256 and d_in = 512, runs
their width-general forms (K1-general and K2-general, every dtype, mask
and scale form alike: ``csrc/gru_general_*.cu``): the input projection
and, in the backward, the recompute h_prev @ wh, dx and the weight
gradients as tiled products, and the recurrences with hidden unit j on
thread j of a row's warps and wh in shared memory where it fits. They
count in their own counters (``gen_launches`` and the others below). On a
CUDA tensor a wrapper launches its kernel or raises on what it does not
take (d_m > 256, d_in > 512, dtypes other than float32 and bfloat16, a
mix of the two, a scale that is not [T, B] with a unit batch stride);
nothing falls back to the plain version. Where nothing
needs a gradient :func:`gru_sequence_tm` skips the autograd.Function.
While ``torch.export`` traces, K1 is the custom op ``hpmn::gru_scan_fwd``
(``ops/library.py``), whose CUDA implementation is :func:`_launch`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build, library
from .gru import (GRUParams, GRUWeights, gru_bwd_pass, gru_input_proj,
                  gru_input_proj_bf16, gru_scan_tm, gru_scan_tm_bf16,
                  gru_scan_tm_bwd, gru_scan_tm_bwd_bf16, gru_scan_tm_sweep,
                  gru_scan_tm_sweep_bf16)

SOURCE = "hpmn_tpu_torch/csrc/gru_scan_fwd.cu"
REPLACES = "hpmn_tpu/ops/pallas_gru.py:127"
# The first kernel of K1, K1-bf16, K1-scale and K1-scale-bf16, the input
# projection (with SOURCE's recurrence).
PROJ_SOURCE = "hpmn_tpu_torch/csrc/gru_input_proj.cu"
BWD_SOURCE = "hpmn_tpu_torch/csrc/gru_scan_bwd.cu"
BWD_REPLACES = "hpmn_tpu/ops/pallas_gru.py:209"
# K2's (and K2-bf16's, K2-scale's and K2-scale-bf16's) second kernel, dx
# and the weight gradients.
PASS_SOURCE = "hpmn_tpu_torch/csrc/gru_bwd_pass.cu"
# K1-bf16 and K2-bf16: the same sources' bf16 instantiations, in place of
# the same Pallas kernels run with dtype=bfloat16; K1-scale and K2-scale
# (and their bf16 forms): their has_scale instantiations.
SOURCE_BF16, REPLACES_BF16 = SOURCE, REPLACES
BWD_SOURCE_BF16, BWD_REPLACES_BF16 = BWD_SOURCE, BWD_REPLACES
SOURCE_SCALE, REPLACES_SCALE = SOURCE, REPLACES
BWD_SOURCE_SCALE, BWD_REPLACES_SCALE = BWD_SOURCE, BWD_REPLACES
# Every form of K1 is two sources: the projection, then its recurrence;
# every form of K2 two: its recurrence, then the pass.
FWD_SOURCES = (PROJ_SOURCE, SOURCE)
BWD_SOURCES = (BWD_SOURCE, PASS_SOURCE)
# K1-general's and K2-general's recurrences and entry points (every dtype,
# mask and scale form); both run gru_general_gemm.cu's tiled products.
GEN_SOURCE = "hpmn_tpu_torch/csrc/gru_general_fwd.cu"
GEN_BWD_SOURCE = "hpmn_tpu_torch/csrc/gru_general_bwd.cu"
GEN_SOURCES = ("hpmn_tpu_torch/csrc/gru_general_gemm.cu", GEN_SOURCE,
               GEN_BWD_SOURCE)

#: Kernel launches so far in this process (a run's proof that it went
#: through the kernels): K1, K2, K1-bf16, K2-bf16, and the scale forms
#: K1-scale, K2-scale, K1-scale-bf16 and K2-scale-bf16. Callers may reset
#: them to 0.
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0
launches_scale = 0
bwd_launches_scale = 0
launches_scale_bf16 = 0
bwd_launches_scale_bf16 = 0
#: Launches of the projection on its own (:func:`input_proj`, either dtype)
#: and of K2's pass on its own (:func:`bwd_pass`, :func:`bwd_pass_dg`); K1's
#: and K2's own count in ``launches`` and ``bwd_launches`` (and their other
#: forms').
proj_launches = 0
pass_launches = 0
#: Launches of the width-general forms (d_m != 32 or d_in > 96): K1-general
#: and K2-general, their bf16, scale and scale-bf16 forms.
gen_launches = 0
gen_bwd_launches = 0
gen_launches_bf16 = 0
gen_bwd_launches_bf16 = 0
gen_launches_scale = 0
gen_bwd_launches_scale = 0
gen_launches_scale_bf16 = 0
gen_bwd_launches_scale_bf16 = 0

#: The cap on the f32 workspace xp [Tc, B, 3*d_m] of K1 (every form, and
#: K1-general), on the gate gradients dg [Tc, B, 128] of K2 (every form) in
#: x's dtype, and on K2-general's xp and h_prev @ wh [Tc, B, 3*d_m] (f32)
#: and dg [Tc, B, 4*d_m] together: Tc is the most steps that fit (at least
#: 1), and the kernel runs ceil(T / Tc) chunks in one C call.
#: 64 MiB: K1's Tc = 341 at B = 512 (DIEN's T = 300 is 1 chunk), 27 at
#: B = 6400, 21 at B = 8192; K2's 256 at B = 512 (512 in bf16: DIEN's T =
#: 300 is 2 chunks in f32, 1 in bf16).
WORKSPACE_BYTES = 64 << 20

# The fixed-width kernels' widths: d_m = 32 (one lane per hidden unit),
# d_in <= 96 (x_t in up to three 32-chunks).
_D_M = 32
_MAX_D_IN = 96
# The width-general forms' limits (csrc/gru_general.cuh): a row's threads
# (d_m rounded up to 32) fit a block of 512 beside another row.
_GEN_MAX_D_M = 256
_GEN_MAX_D_IN = 512
# The C entry points by stream dtype (the f32 chain and the bf16 one) and
# AUGRU scale: K1's (projection and recurrence over a workspace) and K2's;
# and the projection alone's by dtype.
_WS_ENTRY = {(torch.float32, False): "hpmn_gru_scan_fwd_ws",
             (torch.bfloat16, False): "hpmn_gru_scan_fwd_bf16_ws",
             (torch.float32, True): "hpmn_gru_scan_fwd_scale_ws",
             (torch.bfloat16, True): "hpmn_gru_scan_fwd_scale_bf16_ws"}
_PROJ_ENTRY = {torch.float32: "hpmn_gru_input_proj",
               torch.bfloat16: "hpmn_gru_input_proj_bf16"}
_BWD_ENTRY = {(torch.float32, False): "hpmn_gru_scan_bwd_ws",
              (torch.bfloat16, False): "hpmn_gru_scan_bwd_bf16_ws",
              (torch.float32, True): "hpmn_gru_scan_bwd_scale_ws",
              (torch.bfloat16, True): "hpmn_gru_scan_bwd_scale_bf16_ws"}
_GEN_ENTRY = {torch.float32: "hpmn_gru_gen_fwd",
              torch.bfloat16: "hpmn_gru_gen_fwd_bf16"}
_GEN_BWD_ENTRY = {torch.float32: "hpmn_gru_gen_bwd",
                  torch.bfloat16: "hpmn_gru_gen_bwd_bf16"}
_DTYPES = (torch.float32, torch.bfloat16)


def fixed_width(d_in: int, d_m: int) -> bool:
    """Whether (d_in, d_m) runs the fixed-width kernels (d_m = 32, d_in
    <= 96); every other width in range runs the width-general forms."""
    return d_m == _D_M and 1 <= d_in <= _MAX_D_IN


def _kernel_name(dtype: torch.dtype, scaled: bool, bwd: bool,
                 general: bool = False) -> str:
    return (("gru_gen_" if general else "gru_scan_")
            + ("bwd" if bwd else "fwd")
            + ("_scale" if scaled else "")
            + ("_bf16" if dtype == torch.bfloat16 else ""))


@functools.lru_cache(maxsize=None)
def _ws_fn(dtype: torch.dtype, scaled: bool = False):
    """K1's C entry point by dtype and scale (the scale forms: the scale
    after the mask)."""
    fn = getattr(_build.load_library(), _WS_ENTRY[dtype, scaled])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * (3 if scaled else 2)
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _proj_fn(dtype: torch.dtype):
    fn = getattr(_build.load_library(), _PROJ_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def workspace_steps(T: int, B: int, d_m: int = _D_M) -> int:
    """K1's chunk (every form's, K1-general's too): the steps of xp [., B,
    3*d_m] in f32 that fit :data:`WORKSPACE_BYTES`, at least 1 and at most
    T."""
    return max(1, min(T, WORKSPACE_BYTES // (B * 3 * d_m * 4)))


def bwd_workspace_steps(T: int, B: int, dtype: torch.dtype) -> int:
    """K2's chunk (every form's): the steps of dg [., B, 128] in ``dtype`` that fit
    :data:`WORKSPACE_BYTES`, at least 1 and at most T."""
    es = torch.empty(0, dtype=dtype).element_size()
    return max(1, min(T, WORKSPACE_BYTES // (B * 4 * _D_M * es)))


def gen_bwd_workspace_steps(T: int, B: int, d_m: int,
                            dtype: torch.dtype) -> int:
    """K2-general's chunk: the steps whose xp and h_prev @ wh [., B,
    3*d_m] (f32) and dg [., B, 4*d_m] in ``dtype`` fit
    :data:`WORKSPACE_BYTES` together, at least 1 and at most T."""
    es = torch.empty(0, dtype=dtype).element_size()
    return max(1, min(T, WORKSPACE_BYTES // (B * d_m * (2 * 3 * 4
                                                        + 4 * es))))


def gen_splits(d_in: int, d_m: int) -> int:
    """K2-general's weight-gradient partials: how many slices of a chunk's
    rows the products sum apart, each into an f32 partial, 1 to 64. The
    count is part of the result: each slice is one fmaf chain per output,
    so another count gives other bits. It is 256 over the 64 x 64 output
    tiles of the x half (d_in + 1 rows, db's among them, by 3*d_m columns),
    the tiles of the products' first form, and stays so whatever tiles
    the products run."""
    tiles = -(-(d_in + 1) // 64) * -(-(3 * d_m) // 64)
    return max(1, min(64, 256 // tiles))


def _acc_floats(d_in: int) -> int:
    """The pass's f32 sums per batch row: [x rows padded to 32 | 32 h
    rows][96], then db [96]."""
    return (-(-d_in // 32) * 32 + _D_M + 1) * 3 * _D_M


@functools.lru_cache(maxsize=None)
def _rows_fn():
    """d_in -> the batch rows that one weight-gradient partial sums."""
    fn = _build.load_library().hpmn_gru_scan_bwd_rows_per_block
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn(dtype: torch.dtype, scaled: bool = False):
    """K2's C entry point by dtype and scale (the scale forms: the scale
    after the mask, dscale after the partials)."""
    fn = getattr(_build.load_library(), _BWD_ENTRY[dtype, scaled])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * (3 if scaled else 2)
                   + [ctypes.c_void_p] * (14 if scaled else 13)
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _pass_fn(dtype: torch.dtype):
    lib = _build.load_library()
    fn = getattr(lib, "hpmn_gru_bwd_pass" + (
        "_bf16" if dtype == torch.bfloat16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gen_fwd_fn(dtype: torch.dtype):
    """K1-general's C entry point by dtype (the scale null without one)."""
    fn = getattr(_build.load_library(), _GEN_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gen_bwd_fn(dtype: torch.dtype):
    """K2-general's C entry point by dtype."""
    fn = getattr(_build.load_library(), _GEN_BWD_ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(w, x_tm, mask_tm, h0, name, scale_tm=None):
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    if not 1 <= d_m <= _GEN_MAX_D_M or not 1 <= d_in <= _GEN_MAX_D_IN:
        raise ValueError(f"{name} takes d_m <= {_GEN_MAX_D_M} and d_in <= "
                         f"{_GEN_MAX_D_IN}; got d_m={d_m}, d_in={d_in}")
    if x_tm.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 tensors; got "
                         f"{x_tm.dtype}")
    tensors = [x_tm, w.wx, w.wh, w.b]
    tensors += [t for t in (mask_tm, h0, scale_tm) if t is not None]
    for t in tensors:
        if t.dtype != x_tm.dtype or t.device != x_tm.device:
            raise ValueError(f"{name} takes tensors of one dtype (float32 "
                             f"or bfloat16) on one device; got {t.dtype} on "
                             f"{t.device} beside x's {x_tm.dtype} on "
                             f"{x_tm.device}")
    # A stride of a size-1 dim is never read (a [T, 1] mask transposed from
    # [1, T] keeps the stride T), so it is not checked.
    if (d_in > 1 and x_tm.stride(2) != 1) or (B > 1
                                              and x_tm.stride(1) != d_in):
        raise ValueError("x_tm rows must be contiguous (any time stride)")
    for arg, t in (("mask_tm", mask_tm), ("scale_tm", scale_tm)):
        if t is not None and (t.shape != (T, B)
                              or (B > 1 and t.stride(1) != 1)):
            raise ValueError(f"{arg} must be [T, B] with a unit batch stride")
    for t in (w.wx, w.wh, w.b):
        if not t.is_contiguous():
            raise ValueError("GRU weights must be contiguous")
    if h0 is not None and (h0.shape != (B, d_m) or not h0.is_contiguous()):
        raise ValueError("h0 must be a contiguous [B, d_m] tensor")


def _count(name: str) -> None:
    """One more launch of the kernel ``name`` (the counter of that name
    without its ``gru_scan_`` prefix; ``gru_gen_`` names count in the
    ``gen_`` counters)."""
    counter = {"fwd": "launches", "bwd": "bwd_launches"}
    general = name.startswith("gru_gen_")
    kind, _, form = name[len("gru_gen_" if general else "gru_scan_"):
                         ].partition("_")
    var = (("gen_" if general else "") + counter[kind]
           + ("_" + form if form else ""))
    globals()[var] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _tstride(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.stride(0)


def _k1(w, x_tm, mask_tm, h0, hseq, stream, scale_tm=None) -> int:
    """K1's (K1-bf16's; with a scale_tm K1-scale's or K1-scale-bf16's) C
    call: the f32 workspace, then every chunk's projection and recurrence;
    -> the cudaError_t code."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    t_chunk = workspace_steps(T, B, d_m)
    ws = torch.empty(t_chunk, B, 3 * d_m, dtype=torch.float32,
                     device=x_tm.device)
    if not fixed_width(d_in, d_m):
        with _build.on_device(x_tm):
            return _gen_fwd_fn(x_tm.dtype)(
                x_tm.data_ptr(), x_tm.stride(0), _ptr(mask_tm),
                _tstride(mask_tm), _ptr(scale_tm), _tstride(scale_tm),
                w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(), _ptr(h0),
                hseq.data_ptr(), ws.data_ptr(), t_chunk, T, B, d_in, d_m,
                stream)
    scale = (() if scale_tm is None
             else (scale_tm.data_ptr(), scale_tm.stride(0)))
    with _build.on_device(x_tm):
        return _ws_fn(x_tm.dtype, scale_tm is not None)(
            x_tm.data_ptr(), x_tm.stride(0), _ptr(mask_tm),
            _tstride(mask_tm), *scale, w.wx.data_ptr(), w.wh.data_ptr(),
            w.b.data_ptr(), _ptr(h0), hseq.data_ptr(), ws.data_ptr(),
            t_chunk, T, B, d_in, stream)


def _launch(w, x_tm, mask_tm, h0, scale_tm=None) -> torch.Tensor:
    """K1 (float32) or K1-bf16 (bfloat16), K1-scale or K1-scale-bf16 with
    a scale_tm, or their width-general forms: -> h_seq [T, B, d_m], x's
    dtype."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    scaled = scale_tm is not None
    name = _kernel_name(x_tm.dtype, scaled, bwd=False,
                        general=not fixed_width(d_in, d_m))
    _check_cuda_args(w, x_tm, mask_tm, h0, name, scale_tm)
    hseq = torch.empty(T, B, d_m, dtype=x_tm.dtype, device=x_tm.device)
    code = _k1(w, x_tm, mask_tm, h0, hseq,
               torch.cuda.current_stream(x_tm.device).cuda_stream,
               scale_tm=scale_tm)
    _build.check_launch(code, name)
    _count(name)
    return hseq


def _k2(w, x_tm, mask_tm, h0, hseq, dhseq, outs, stream, scale_tm=None,
        t_chunk=None):
    """K2's (K2-bf16's; with a scale_tm K2-scale's or K2-scale-bf16's) C
    call: the workspaces of t_chunk steps (default
    :func:`bwd_workspace_steps`), then every chunk's recurrence and pass,
    then the partials; outs = (dx, dh0, dwx, dwh, db), and dscale after
    them with a scale_tm -> (the cudaError_t code, dg [n, B, 32, 4]): the
    gate gradients of the first n = min(t_chunk, T) steps."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    dev = x_tm.device
    if not fixed_width(d_in, d_m):
        return _k2_general(w, x_tm, mask_tm, h0, hseq, dhseq, outs, stream,
                           scale_tm, t_chunk)
    if t_chunk is None:
        t_chunk = bwd_workspace_steps(T, B, x_tm.dtype)
    dg = torch.empty(min(t_chunk, T), B, _D_M, 4, dtype=x_tm.dtype,
                     device=dev)
    acc = torch.empty(B, _acc_floats(d_in), dtype=torch.float32, device=dev)
    scale = (() if scale_tm is None
             else (scale_tm.data_ptr(), scale_tm.stride(0)))
    with _build.on_device(x_tm):
        code = _bwd_fn(x_tm.dtype, scale_tm is not None)(
            x_tm.data_ptr(), x_tm.stride(0), _ptr(mask_tm),
            _tstride(mask_tm), *scale, w.wx.data_ptr(), w.wh.data_ptr(),
            w.b.data_ptr(), _ptr(h0), hseq.data_ptr(), dhseq.data_ptr(),
            *(t.data_ptr() for t in outs), dg.data_ptr(), acc.data_ptr(),
            t_chunk, T, B, d_in, stream)
    return code, dg


def _k2_general(w, x_tm, mask_tm, h0, hseq, dhseq, outs, stream,
                scale_tm=None, t_chunk=None):
    """K2-general's C call (every dtype and scale form): the workspaces
    of t_chunk steps (default :func:`gen_bwd_workspace_steps`), then every
    chunk's products and recurrence; outs = (dx, dh0, dwx, dwh, db), the
    last three :func:`gen_splits` partials, and dscale after them with a
    scale_tm -> (the cudaError_t code, dg [n, B, d_m, 4])."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    if t_chunk is None:
        t_chunk = gen_bwd_workspace_steps(T, B, d_m, x_tm.dtype)
    n = min(t_chunk, T)
    dev = x_tm.device
    dg = torch.empty(n, B, d_m, 4, dtype=x_tm.dtype, device=dev)
    ws = torch.empty(2, n, B, 3 * d_m, dtype=torch.float32, device=dev)
    dx, dh0, dwx, dwh, db, *dscale = outs
    with _build.on_device(x_tm):
        code = _gen_bwd_fn(x_tm.dtype)(
            x_tm.data_ptr(), x_tm.stride(0), _ptr(mask_tm),
            _tstride(mask_tm), _ptr(scale_tm), _tstride(scale_tm),
            w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(), _ptr(h0),
            hseq.data_ptr(), dhseq.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
            dwx.data_ptr(), dwh.data_ptr(), db.data_ptr(),
            dscale[0].data_ptr() if dscale else None, ws.data_ptr(),
            dg.data_ptr(), dwx.shape[0], t_chunk, T, B, d_in, d_m, stream)
    return code, dg


def _launch_bwd(w, x_tm, mask_tm, h0, hseq, dhseq, scale_tm=None,
                t_chunk=None):
    """K2 (float32) or K2-bf16 (bfloat16), K2-scale or K2-scale-bf16 with a
    scale_tm: -> ((dx in x's dtype, dwx, dwh, db, dh0 in float32, and
    dscale [T, B] in x's dtype after them with a scale_tm), the workspace
    dg of :func:`_k2`); the weight gradients summed over the kernel's
    per-group partials."""
    T, B, d_in = x_tm.shape
    d_m = w.wh.shape[0]
    scaled = scale_tm is not None
    general = not fixed_width(d_in, d_m)
    name = _kernel_name(x_tm.dtype, scaled, bwd=True, general=general)
    _check_cuda_args(w, x_tm, mask_tm, h0, name, scale_tm)
    for t in (hseq, dhseq):
        if t.shape != (T, B, d_m) or t.dtype != x_tm.dtype \
                or t.device != x_tm.device or not t.is_contiguous():
            raise ValueError("h_seq and dh_seq must be contiguous "
                             f"[T, B, {d_m}] tensors of x's dtype on x's "
                             "device")
    n_blocks = (gen_splits(d_in, d_m) if general
                else -(-B // _rows_fn()(d_in)))
    dev = x_tm.device
    dx = torch.empty(T, B, d_in, dtype=x_tm.dtype, device=dev)
    dscale = (torch.empty(T, B, dtype=x_tm.dtype, device=dev),) if scaled \
        else ()
    dh0 = torch.empty(B, d_m, dtype=torch.float32, device=dev)
    dwx = torch.empty(n_blocks, d_in, 3 * d_m, dtype=torch.float32,
                      device=dev)
    dwh = torch.empty(n_blocks, d_m, 3 * d_m, dtype=torch.float32,
                      device=dev)
    db = torch.empty(n_blocks, 3 * d_m, dtype=torch.float32, device=dev)
    code, dg = _k2(w, x_tm, mask_tm, h0, hseq, dhseq,
                   (dx, dh0, dwx, dwh, db) + dscale,
                   torch.cuda.current_stream(dev).cuda_stream,
                   scale_tm=scale_tm, t_chunk=t_chunk)
    _build.check_launch(code, name)
    _count(name)
    return (dx, dwx.sum(0), dwh.sum(0), db.sum(0), dh0) + dscale, dg


def input_proj(params: GRUParams, x_tm: torch.Tensor) -> torch.Tensor:
    """The input projection alone of K1 or K1-bf16 (and of their scale
    forms): x_tm [T, B, d_in] (any
    time stride, rows contiguous) -> xp [T, B, 96] in float32, by the
    kernel on CUDA tensors, by the plain version on CPU tensors. Float32
    tensors give x_tm @ wx + b (``gru_input_proj``). Bfloat16 tensors give
    the bf16 chain's layout (``gru_input_proj_bf16``): the r and z blocks
    x_tm @ wx summed in f32, without the bias, and the c block x_tm @ wx_c
    + b_c rounded to bf16, held as f32."""
    bf16 = x_tm.dtype == torch.bfloat16
    if x_tm.device.type == "cpu":
        plain = gru_input_proj_bf16 if bf16 else gru_input_proj
        return plain(params, x_tm)
    if x_tm.device.type != "cuda":
        raise ValueError(f"input_proj runs on cpu or cuda, not "
                         f"{x_tm.device}")
    global proj_launches
    name = "gru_input_proj" + ("_bf16" if bf16 else "")
    T, B, d_in = x_tm.shape
    if not fixed_width(d_in, params.wh.shape[0]):
        raise ValueError(f"{name} (the fixed-width projection alone) takes "
                         f"d_m == {_D_M} and d_in <= {_MAX_D_IN}")
    _check_cuda_args(params, x_tm, None, None, name)
    xp = torch.empty(T, B, 3 * _D_M, dtype=torch.float32, device=x_tm.device)
    with _build.on_device(x_tm):
        code = _proj_fn(x_tm.dtype)(
            x_tm.data_ptr(), x_tm.stride(0), params.wx.data_ptr(),
            params.b.data_ptr(), xp.data_ptr(), T, B, d_in,
            torch.cuda.current_stream(x_tm.device).cuda_stream)
    _build.check_launch(code, name)
    proj_launches += 1
    return xp


def gate_layout(dpre_x: torch.Tensor, dpre_h: torch.Tensor) -> torch.Tensor:
    """The gate gradients dpre_x = [dr|dz|dc] and dpre_h = [dr|dz|dc*r]
    [T, B, 3*d_m] in the recurrence's layout dg [T, B, d_m, 4]: unit k's
    dr, dz, dc and dc*r side by side (contiguous)."""
    d = dpre_x.shape[-1] // 3
    return torch.stack([dpre_x[..., :d], dpre_x[..., d:2 * d],
                        dpre_x[..., 2 * d:], dpre_h[..., 2 * d:]], -1
                       ).contiguous()


def gate_blocks(dg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gate_layout`'s inverse: dg [T, B, d_m, 4] -> (dpre_x,
    dpre_h) [T, B, 3*d_m]."""
    return (torch.cat([dg[..., 0], dg[..., 1], dg[..., 2]], -1),
            torch.cat([dg[..., 0], dg[..., 1], dg[..., 3]], -1))


def bwd_pass(wx: torch.Tensor, x_tm: torch.Tensor, h_prev: torch.Tensor,
             dpre_x: torch.Tensor, dpre_h: torch.Tensor,
             ) -> Tuple[torch.Tensor, ...]:
    """K2's pass alone: x_tm [T, B, d_in] (any time stride, rows
    contiguous), h_prev [T, B, 32] (the state before each step), the gate
    gradients dpre_x = [dr|dz|dc] and dpre_h = [dr|dz|dc*r] [T, B, 96]
    (their r and z blocks the same, as the scan's are: the kernel reads
    them once) -> (dx in x's dtype, dwx, dwh, db in float32), by the kernel
    on CUDA tensors (float32 or bfloat16, one dtype; :func:`bwd_pass_dg`
    on :func:`gate_layout`), by ``gru_bwd_pass`` on CPU tensors. The pass
    kernel is the fixed-width K2's (d_m = 32, d_in <= 96); K2-general's
    dx and weight gradients run inside it and have no entry of their
    own."""
    if x_tm.device.type == "cpu":
        return gru_bwd_pass(x_tm, h_prev, dpre_x, dpre_h, wx)
    T, B, _ = x_tm.shape
    if dpre_x.shape != (T, B, 3 * _D_M) or dpre_h.shape != dpre_x.shape:
        raise ValueError("gru_bwd_pass: dpre_x and dpre_h [T, B, 96]")
    return bwd_pass_dg(wx, x_tm, h_prev, gate_layout(dpre_x, dpre_h))


def bwd_pass_dg(wx: torch.Tensor, x_tm: torch.Tensor, h_prev: torch.Tensor,
                dg: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """:func:`bwd_pass` from the gate gradients in the recurrence's own
    layout dg [T, B, 32, 4] (:func:`gate_layout`; what :func:`bwd_gates`
    returns), which the kernel reads as they are."""
    if x_tm.device.type == "cpu":
        return gru_bwd_pass(x_tm, h_prev, *gate_blocks(dg), wx)
    if x_tm.device.type != "cuda":
        raise ValueError(f"bwd_pass runs on cpu or cuda, not {x_tm.device}")
    global pass_launches
    T, B, d_in = x_tm.shape
    if not 1 <= d_in <= _MAX_D_IN or x_tm.dtype not in _DTYPES:
        raise ValueError(f"gru_bwd_pass takes d_in <= {_MAX_D_IN} and "
                         f"float32 or bfloat16; got d_in={d_in}, "
                         f"{x_tm.dtype}")
    for t in (wx, h_prev, dg):
        if t.dtype != x_tm.dtype or t.device != x_tm.device:
            raise ValueError("gru_bwd_pass takes tensors of one dtype on one "
                             "device")
    if x_tm.stride(2) != 1 or x_tm.stride(1) != d_in:
        raise ValueError("x_tm rows must be contiguous (any time stride)")
    g = 3 * _D_M
    if (wx.shape != (d_in, g) or h_prev.shape != (T, B, _D_M)
            or dg.shape != (T, B, _D_M, 4)):
        raise ValueError("gru_bwd_pass: wx [d_in, 96], h_prev [T, B, 32], "
                         "dg [T, B, 32, 4]")
    dev = x_tm.device
    wx, h_prev, dg = wx.contiguous(), h_prev.contiguous(), dg.contiguous()
    rows = _rows_fn()(d_in)
    n_blocks = -(-B // rows)
    dx = torch.empty(T, B, d_in, dtype=x_tm.dtype, device=dev)
    acc = torch.empty(B, _acc_floats(d_in), dtype=torch.float32, device=dev)
    dwx = torch.empty(n_blocks, d_in, g, dtype=torch.float32, device=dev)
    dwh = torch.empty(n_blocks, _D_M, g, dtype=torch.float32, device=dev)
    db = torch.empty(n_blocks, g, dtype=torch.float32, device=dev)
    # h_prev[t] is hseq[t-1] for t >= 1 (hseq = h_prev[1:]) and h0 at t = 0.
    hseq = h_prev[1:] if T > 1 else h_prev
    with _build.on_device(x_tm):
        code = _pass_fn(x_tm.dtype)(
            x_tm.data_ptr(), x_tm.stride(0), wx.data_ptr(),
            h_prev[0].data_ptr(), hseq.data_ptr(), dg.data_ptr(),
            dx.data_ptr(), acc.data_ptr(), dwx.data_ptr(), dwh.data_ptr(),
            db.data_ptr(), rows, T, B, d_in,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(code, "gru_bwd_pass")
    pass_launches += 1
    return dx, dwx.sum(0), dwh.sum(0), db.sum(0)


def _on(x_tm, name):
    if x_tm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x_tm.device}")
    return x_tm.device.type


def gru_scan_bwd(params: GRUParams, x_tm: torch.Tensor,
                 mask_tm: Optional[torch.Tensor], h_seq: torch.Tensor,
                 dh_seq: torch.Tensor, h0: Optional[torch.Tensor] = None,
                 scale_tm: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, ...]:
    """The scan backward: K2 (K2-bf16 on bfloat16 tensors; K2-scale or
    K2-scale-bf16 with a scale_tm) on CUDA tensors, ``gru_scan_tm_bwd``
    (``gru_scan_tm_bwd_bf16``; same arguments and results) on CPU tensors.
    The weight gradients and dh0 come back in float32, dx (and dscale
    [T, B], after dh0, with a scale_tm) in x's dtype."""
    if _on(x_tm, "gru_scan_bwd") == "cpu":
        plain = (gru_scan_tm_bwd_bf16 if x_tm.dtype == torch.bfloat16
                 else gru_scan_tm_bwd)
        return plain(params, x_tm, mask_tm, h_seq, dh_seq, h0, scale_tm)
    return _launch_bwd(params, x_tm, mask_tm, h0, h_seq, dh_seq.contiguous(),
                       scale_tm)[0]


def bwd_gates(params: GRUParams, x_tm: torch.Tensor,
              mask_tm: Optional[torch.Tensor], h_seq: torch.Tensor,
              dh_seq: torch.Tensor, h0: Optional[torch.Tensor] = None,
              scale_tm: Optional[torch.Tensor] = None,
              ) -> Tuple[Optional[torch.Tensor], ...]:
    """K2's recurrence (of whichever form :func:`gru_scan_bwd` runs), seen
    whole: its gate gradients over all T steps (K2 run in one workspace
    chunk, on CUDA tensors) or those of the plain sweep
    ``gru_scan_tm_sweep`` (``_bf16``) on CPU tensors -> (dg [T, B, 32, 4]
    in x's dtype (:func:`gate_layout`), dh0 in float32, dscale [T, B] in
    x's dtype or None without a scale_tm)."""
    if _on(x_tm, "bwd_gates") == "cpu":
        sweep = (gru_scan_tm_sweep_bf16 if x_tm.dtype == torch.bfloat16
                 else gru_scan_tm_sweep)
        dpre_x, dpre_h, _, dh0, dscale = sweep(params, x_tm, mask_tm, h_seq,
                                               dh_seq, h0, scale_tm)
        return gate_layout(dpre_x, dpre_h), dh0, dscale
    out, dg = _launch_bwd(params, x_tm, mask_tm, h0, h_seq,
                          dh_seq.contiguous(), scale_tm,
                          t_chunk=x_tm.shape[0])
    return dg, out[4], out[5] if scale_tm is not None else None


def scan_by_device(x_tm, mask_tm, h0, wx, wh, b, scale_tm=None):
    """K1's forward by the tensors' device: the plain scan
    (``gru_scan_tm``, ``gru_scan_tm_bf16``) on CPU tensors, :func:`_launch`
    on CUDA tensors -> h_seq. The implementations of the op
    ``hpmn::gru_scan_fwd`` (``ops/library.py``)."""
    w = GRUWeights(wx, wh, b)
    if x_tm.device.type == "cpu":
        plain = (gru_scan_tm_bf16 if x_tm.dtype == torch.bfloat16
                 else gru_scan_tm)
        return plain(w, x_tm, mask_tm, h0, scale_tm)[0]
    return _launch(w, x_tm, mask_tm, h0, scale_tm)


def scan_fwd(x_tm, mask_tm, h0, wx, wh, b, scale_tm=None):
    """K1's forward: through the op ``hpmn::gru_scan_fwd`` while
    ``torch.compiler`` traces (``torch.export``), so that the graph holds
    the kernel as one node; else :func:`scan_by_device` directly, which
    spares an eager call the op's dispatch."""
    if torch.compiler.is_compiling():
        return library.gru_scan_fwd(x_tm, mask_tm, h0, wx, wh, b, scale_tm)
    return scan_by_device(x_tm, mask_tm, h0, wx, wh, b, scale_tm)


class GRUScan(torch.autograd.Function):
    """h_seq = scan(x_tm, mask_tm, h0, scale_tm; wx, wh, b), time-major.
    Forward K1 and backward K2 (or their scale forms, given a scale_tm) on
    CUDA tensors; the plain versions on CPU tensors. All tensors float32,
    or all bfloat16 (the bf16 chain). The mask gets no gradient; h0 gets one
    when it is given, and so does the scale (dscale, in its dtype). The
    weight gradients, summed in float32, come back in the weights' dtype:
    in bf16 that rounding is the TPU kernel's ``astype(wx4.dtype)`` after
    its tile sum."""

    @staticmethod
    def forward(ctx, x_tm, mask_tm, h0, wx, wh, b, scale_tm=None):
        h_seq = scan_fwd(x_tm, mask_tm, h0, wx, wh, b, scale_tm)
        ctx.save_for_backward(x_tm, mask_tm, h0, wx, wh, b, scale_tm, h_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        x_tm, mask_tm, h0, wx, wh, b, scale_tm, h_seq = ctx.saved_tensors
        dx, dwx, dwh, db, dh0, *dscale = gru_scan_bwd(
            GRUWeights(wx, wh, b), x_tm, mask_tm, h_seq, dh_seq, h0,
            scale_tm)
        return (dx, None, None if h0 is None else dh0.to(h0.dtype),
                dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(b.dtype),
                dscale[0] if dscale else None)


def gru_sequence_tm(params: GRUParams, x_tm: torch.Tensor,
                    mask_tm: Optional[torch.Tensor] = None,
                    h0: Optional[torch.Tensor] = None,
                    scale_tm: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major scan: x_tm [T, B, d_in], mask_tm [T, B] or None (full
    sequences), h0 [B, d_m] or None, scale_tm [T, B] or None (the AUGRU
    gate scale: DIEN's attention) -> (h_seq [T, B, d_m], h_T [B, d_m]),
    differentiable through :class:`GRUScan`, the scale included. Where no
    input needs a gradient (serving, under ``no_grad``) it runs
    :func:`scan_fwd` without the autograd.Function.

    x_tm may be a leading-axis strided view (``h_seq[period-1::period]`` of
    the layer below): both kernels take the time stride, so nothing is
    copied. Likewise mask_tm and scale_tm."""
    _on(x_tm, "gru_sequence_tm")
    T, B, _ = x_tm.shape
    if T == 0:
        d_m = params.wh.shape[0]
        h = x_tm.new_zeros(B, d_m) if h0 is None else h0
        return x_tm.new_zeros(0, B, d_m), h
    args = (x_tm, mask_tm, h0, params.wx, params.wh, params.b, scale_tm)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        h_seq = GRUScan.apply(*args)
    else:
        h_seq = scan_fwd(*args)
    return h_seq, h_seq[-1]


def gru_sequence(params: GRUParams, x: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 gate_scale: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major scan through :func:`gru_sequence_tm` (the JAX
    ``pallas_gru_sequence``): x [B, T, d_in], h0 [B, d_m] or None, mask and
    gate_scale [B, T] or None -> (h_seq [B, T, d_m], h_T [B, d_m]). x, the
    mask and the scale are copied time-major and contiguous (the layout
    the kernels check); h0 is made contiguous and gets its gradient."""
    def tm(t):
        return None if t is None else t.transpose(0, 1).contiguous()

    h_seq, h_T = gru_sequence_tm(
        params, tm(x), tm(mask), None if h0 is None else h0.contiguous(),
        tm(gate_scale))
    return h_seq.transpose(0, 1), h_T
