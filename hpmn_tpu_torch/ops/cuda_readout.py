"""Attention readout forward through the hand-written CUDA kernel.

Replaces ``hpmn_tpu/ops/pallas_readout.py::_kernel`` (reached there through
``pallas_attention_readout``): f32, no slot mask. The kernel is
``csrc/readout_fwd.cu``: one warp per row, lane a owning attention unit a,
the scores a warp sum, the max-subtracted softmax over the L slots in
registers. Bytes bound it (about 16 FLOP per byte read); one pass that keeps
the [B, L, A] activations out of device memory is what the design does
about that. See the source's header for the rest.

:func:`fused_attention_readout` launches the kernel for CUDA tensors and
raises on what it does not take (readout width or d_m other than 32,
L > 16, d_q > 256, other dtypes); for CPU tensors it runs the plain
version, ``models.readout.attention_readout`` with no slot mask. Forward
only, like the TPU kernel's own forward: a CUDA call that would need a
gradient raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.readout import attention_readout
from . import _build

SOURCE = "hpmn_tpu_torch/csrc/readout_fwd.cu"
REPLACES = "hpmn_tpu/ops/pallas_readout.py:42"

#: Kernel launches so far in this process. Callers may reset it to 0.
launches = 0

_WIDTH = 32  # readout width A and memory width d_m: one lane each
_MAX_L = 16
_MAX_D_Q = 256


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load_library().hpmn_readout_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(module, memory: torch.Tensor, query: torch.Tensor):
    global launches
    B, L, d_m = memory.shape
    d_q = query.shape[1]
    A = module.wm.shape[1]
    if d_m != _WIDTH or A != _WIDTH or not 1 <= L <= _MAX_L \
            or not 1 <= d_q <= _MAX_D_Q or query.shape[0] != B:
        raise ValueError(
            f"readout_fwd takes d_m == A == {_WIDTH}, L <= {_MAX_L}, d_q <= "
            f"{_MAX_D_Q}; got memory {tuple(memory.shape)}, query "
            f"{tuple(query.shape)}, A={A}")
    tensors = [memory, query, module.wm, module.wq, module.b, module.v]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != memory.device \
                or not t.is_contiguous():
            raise ValueError("readout_fwd takes contiguous float32 tensors "
                             f"on one device; got {t.dtype} on {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "readout_fwd is forward only; call it under torch.no_grad()")
    out = torch.empty(B, d_m, dtype=torch.float32, device=memory.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(memory.device).cuda_stream
    code = _kernel_fn()(memory.data_ptr(), query.data_ptr(),
                        module.wm.data_ptr(), module.wq.data_ptr(),
                        module.b.data_ptr(), module.v.data_ptr(),
                        out.data_ptr(), B, L, d_q, stream)
    _build.check_launch(code, "readout_fwd")
    launches += 1
    return out


def fused_attention_readout(module, memory: torch.Tensor,
                            query: torch.Tensor) -> torch.Tensor:
    """memory [B, L, d_m], query [B, d_q] -> read [B, d_m], with the
    readout weights of ``module`` (a ``models.readout.Readout``)."""
    if memory.device.type == "cpu":
        return attention_readout(module, memory, query)
    if memory.device.type != "cuda":
        raise ValueError(f"fused_attention_readout runs on cpu or cuda, not "
                         f"{memory.device}")
    return _launch(module, memory, query)
