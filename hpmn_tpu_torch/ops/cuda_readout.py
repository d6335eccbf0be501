"""Attention readout forward through the hand-written CUDA kernel.

Replaces ``hpmn_tpu/ops/pallas_readout.py::_kernel`` (reached there through
``pallas_attention_readout``): f32, no slot mask. The kernel is
``csrc/readout_fwd.cu``: one warp per row, lane a owning attention unit a,
the scores a warp sum, the max-subtracted softmax over the L slots in
registers. L is a template argument (1 to 16); each lane holds its columns
of the weights in registers and reads the row, staged in shared memory by
``cp.async``, as broadcast float4s; persistent blocks stage the weights
once. Bytes bound it in the limit (about 16 FLOP per byte read), the launch
and the instructions per row at the paths' sizes. See the source's header
for the rest.

:func:`fused_attention_readout` goes through :class:`AttentionReadout`,
a ``torch.autograd.Function``: its forward launches the kernel for CUDA
tensors and raises on what it does not take (readout width or d_m other
than 32, L > 16, d_q > 256, other dtypes); for CPU tensors it runs the
plain version, ``models.readout.attention_readout`` with no slot mask. Its
backward is autograd of that plain version, recomputed from the saved
memory, query and weights: what the JAX ``_core_bwd`` does (``jax.vjp`` of
the jnp oracle; the TPU package has no backward kernel for the readout).
Where nothing needs a gradient it skips the autograd.Function. While
``torch.export`` traces, the forward is the custom op
``hpmn::readout_fwd`` (``ops/library.py``), whose CUDA implementation is
this module's launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..models.readout import attention_readout
from . import _build, library

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


class ReadoutWeights(NamedTuple):
    """Bare weight tensors with ``Readout``'s field names."""

    wm: torch.Tensor
    wq: torch.Tensor
    b: torch.Tensor
    v: torch.Tensor


def _k5(w, memory, query, out, stream) -> int:
    """K5's C call, on memory's device -> the cudaError_t code."""
    B, L, _ = memory.shape
    with _build.on_device(memory):
        return _kernel_fn()(memory.data_ptr(), query.data_ptr(),
                            w.wm.data_ptr(), w.wq.data_ptr(), w.b.data_ptr(),
                            w.v.data_ptr(), out.data_ptr(), B, L,
                            query.shape[1], stream)


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
    out = torch.empty(B, d_m, dtype=torch.float32, device=memory.device)
    if B == 0:
        return out
    code = _k5(module, memory, query, out,
               torch.cuda.current_stream(memory.device).cuda_stream)
    _build.check_launch(code, "readout_fwd")
    launches += 1
    return out


def readout_by_device(memory, query, wm, wq, b, v):
    """K5 by the tensors' device: ``attention_readout`` on CPU tensors,
    :func:`_launch` on CUDA tensors -> read. The implementations of the op
    ``hpmn::readout_fwd`` (``ops/library.py``)."""
    w = ReadoutWeights(wm, wq, b, v)
    if memory.device.type == "cpu":
        return attention_readout(w, memory, query)
    return _launch(w, memory, query)


def readout_fwd(memory, query, wm, wq, b, v):
    """K5's forward: through the op ``hpmn::readout_fwd`` while
    ``torch.compiler`` traces (``torch.export``), so that the graph holds
    the kernel as one node; else :func:`readout_by_device` directly, which
    spares an eager call the op's dispatch."""
    if torch.compiler.is_compiling():
        return library.readout_fwd(memory, query, wm, wq, b, v)
    return readout_by_device(memory, query, wm, wq, b, v)


class AttentionReadout(torch.autograd.Function):
    """read = readout(memory, query; wm, wq, b, v). Forward:
    :func:`readout_fwd` (the kernel on CUDA tensors, the plain version on
    CPU tensors). Backward: autograd of the plain version, recomputed."""

    @staticmethod
    def forward(ctx, memory, query, wm, wq, b, v):
        ctx.save_for_backward(memory, query, wm, wq, b, v)
        return readout_fwd(memory, query, wm, wq, b, v)

    @staticmethod
    def backward(ctx, d_read):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            read = attention_readout(ReadoutWeights(*inputs[2:]), inputs[0],
                                     inputs[1])
        return torch.autograd.grad(read, inputs, d_read)


def _f32_args(module, memory, query):
    """(memory, query, wm, wq, b, v) in float32, cast differentiably where
    they are not (a bf16 model's weights and query), as the JAX
    ``pallas_attention_readout`` casts them for its kernel."""
    return tuple(t.float() for t in (memory, query, module.wm, module.wq,
                                     module.b, module.v))


def plain_attention_readout(module, memory: torch.Tensor,
                            query: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`fused_attention_readout` on any device:
    the same float32 casts, then ``attention_readout`` under autograd."""
    memory, query, *w = _f32_args(module, memory, query)
    return attention_readout(ReadoutWeights(*w), memory, query)


def fused_attention_readout(module, memory: torch.Tensor,
                            query: torch.Tensor) -> torch.Tensor:
    """memory [B, L, d_m], query [B, d_q] -> read [B, d_m] float32, with
    the readout weights of ``module`` (a ``models.readout.Readout``),
    differentiable through :class:`AttentionReadout`; where nothing needs
    a gradient (serving, under ``no_grad``), :func:`readout_fwd` without
    the autograd.Function. The six operands are cast to float32 first
    (no-ops for a float32 model; a bf16 model's gradients come back in
    bf16 through the casts)."""
    if memory.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention_readout runs on cpu or cuda, not "
                         f"{memory.device}")
    args = _f32_args(module, memory, query)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return AttentionReadout.apply(*args)
    return readout_fwd(*args)
