"""GRU scan forward through the hand-written CUDA kernel.

Replaces ``hpmn_tpu/ops/pallas_gru.py::_fwd_kernel`` (reached there through
``pallas_gru_sequence_tm``) in its mask and no-mask forms, f32 chain, for
the serving and forward path. The kernel is ``csrc/gru_scan_fwd.cu``: one
launch scans a whole layer, the time loop inside the kernel and the carry in
registers, one warp per batch row with lane j owning hidden unit j. The
recurrence bounds it (each step waits for the last); keeping the whole loop
in one launch, with no barrier or device-memory round trip between steps, is
what the design does about that. See the source's header for the rest.

:func:`gru_sequence_tm` launches the kernel for CUDA tensors and raises on
what it does not take (d_m != 32, d_in > 96, other dtypes); for CPU tensors
it runs the plain version, ``ops.gru.gru_scan_tm``. Forward only: the
backward kernel is still to port (ROADMAP.md), so a CUDA call that would
need a gradient raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .gru import GRUParams, gru_scan_tm

SOURCE = "hpmn_tpu_torch/csrc/gru_scan_fwd.cu"
REPLACES = "hpmn_tpu/ops/pallas_gru.py:127"

#: Kernel launches so far in this process (a run's proof that it went
#: through the kernel). Callers may reset it to 0.
launches = 0

_D_M = 32
_MAX_D_IN = 96


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load_library().hpmn_gru_scan_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(params, x_tm, mask_tm, h0):
    T, B, d_in = x_tm.shape
    d_m = params.wh.shape[0]
    if d_m != _D_M or not 1 <= d_in <= _MAX_D_IN:
        raise ValueError(f"gru_scan_fwd takes d_m == {_D_M} and d_in <= "
                         f"{_MAX_D_IN}; got d_m={d_m}, d_in={d_in}")
    tensors = [x_tm, params.wx, params.wh, params.b]
    tensors += [t for t in (mask_tm, h0) if t is not None]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != x_tm.device:
            raise ValueError("gru_scan_fwd takes float32 tensors on one "
                             f"device; got {t.dtype} on {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "gru_scan_fwd is forward only (the backward kernel is still to "
            "port, ROADMAP.md); call it under torch.no_grad()")
    if x_tm.stride(2) != 1 or x_tm.stride(1) != d_in:
        raise ValueError("x_tm rows must be contiguous (any time stride)")
    if mask_tm is not None and (mask_tm.shape != (T, B)
                                or mask_tm.stride(1) != 1):
        raise ValueError("mask_tm must be [T, B] with a unit batch stride")
    for w in (params.wx, params.wh, params.b):
        if not w.is_contiguous():
            raise ValueError("GRU weights must be contiguous")
    if h0 is not None and (h0.shape != (B, d_m) or not h0.is_contiguous()):
        raise ValueError("h0 must be a contiguous [B, d_m] tensor")


def _launch(params: GRUParams, x_tm, mask_tm, h0) -> torch.Tensor:
    global launches
    T, B, d_in = x_tm.shape
    _check_cuda_args(params, x_tm, mask_tm, h0)
    hseq = torch.empty(T, B, _D_M, dtype=torch.float32, device=x_tm.device)
    stream = torch.cuda.current_stream(x_tm.device).cuda_stream
    code = _kernel_fn()(
        x_tm.data_ptr(), x_tm.stride(0),
        None if mask_tm is None else mask_tm.data_ptr(),
        0 if mask_tm is None else mask_tm.stride(0),
        params.wx.data_ptr(), params.wh.data_ptr(), params.b.data_ptr(),
        None if h0 is None else h0.data_ptr(), hseq.data_ptr(),
        T, B, d_in, stream)
    _build.check_launch(code, "gru_scan_fwd")
    launches += 1
    return hseq


def gru_sequence_tm(params: GRUParams, x_tm: torch.Tensor,
                    mask_tm: Optional[torch.Tensor] = None,
                    h0: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major scan: x_tm [T, B, d_in], mask_tm [T, B] or None (full
    sequences), h0 [B, d_m] or None -> (h_seq [T, B, d_m], h_T [B, d_m]).

    x_tm may be a leading-axis strided view (``h_seq[period-1::period]`` of
    the layer below): the kernel takes the time stride, so nothing is
    copied. Likewise mask_tm."""
    if x_tm.device.type == "cpu":
        return gru_scan_tm(params, x_tm, mask_tm, h0)
    if x_tm.device.type != "cuda":
        raise ValueError(f"gru_sequence_tm runs on cpu or cuda, not "
                         f"{x_tm.device}")
    T, B, _ = x_tm.shape
    if T == 0:
        h = (torch.zeros(B, _D_M, device=x_tm.device) if h0 is None else h0)
        return x_tm.new_zeros(0, B, _D_M), h
    hseq = _launch(params, x_tm, mask_tm, h0)
    return hseq, hseq[-1]
