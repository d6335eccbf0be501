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
for the rest. That kernel takes A = d_m = 32, L <= 16 and d_q <= 256, the
shapes of every shipped config; every other shape up to d_m = A = 256, L =
64 and d_q = 512 runs its width-general form, K5-general
(``csrc/readout_general.cu``: one warp per row, lane i owning attention
units and output features i, i + 32, ..., L a runtime loop), counted in
``gen_launches``.

:func:`fused_attention_readout` goes through :class:`AttentionReadout`,
a ``torch.autograd.Function``: its forward launches the kernel for CUDA
tensors and raises on what it does not take (readout width or d_m past
256, L > 64, d_q > 512, other dtypes); for CPU tensors it runs the
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
GEN_SOURCE = "hpmn_tpu_torch/csrc/readout_general.cu"

#: Kernel launches so far in this process: K5, and K5-general (every other
#: shape). Callers may reset them to 0.
launches = 0
gen_launches = 0

# The fixed-width kernel's shapes: readout width A and memory width d_m 32
# (one lane each), L a template argument of at most 16, d_q <= 256 (wq in
# registers or shared memory).
_WIDTH = 32
_MAX_L = 16
_MAX_D_Q = 256
# K5-general's limits: at most 8 attention units and 8 output features a
# lane, the row's L scores in shared memory.
_GEN_MAX_WIDTH = 256
_GEN_MAX_L = 64
_GEN_MAX_D_Q = 512


def fixed_width(d_m: int, A: int, L: int, d_q: int) -> bool:
    """Whether a readout of these widths runs K5 (else K5-general)."""
    return (d_m == _WIDTH and A == _WIDTH and 1 <= L <= _MAX_L
            and 1 <= d_q <= _MAX_D_Q)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load_library().hpmn_readout_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _gen_kernel_fn():
    fn = _build.load_library().hpmn_readout_gen_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
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
    """K5's (or, at other widths, K5-general's) C call, on memory's device
    -> the cudaError_t code."""
    B, L, d_m = memory.shape
    A, d_q = w.wm.shape[1], query.shape[1]
    with _build.on_device(memory):
        if not fixed_width(d_m, A, L, d_q):
            return _gen_kernel_fn()(
                memory.data_ptr(), query.data_ptr(), w.wm.data_ptr(),
                w.wq.data_ptr(), w.b.data_ptr(), w.v.data_ptr(),
                out.data_ptr(), B, L, d_m, A, d_q, stream)
        return _kernel_fn()(memory.data_ptr(), query.data_ptr(),
                            w.wm.data_ptr(), w.wq.data_ptr(), w.b.data_ptr(),
                            w.v.data_ptr(), out.data_ptr(), B, L, d_q,
                            stream)


def check_shapes(d_m: int, A: int, L: int, d_q: int, name: str) -> None:
    """Raise ValueError past K5-general's limits."""
    if not (1 <= d_m <= _GEN_MAX_WIDTH and 1 <= A <= _GEN_MAX_WIDTH
            and 1 <= L <= _GEN_MAX_L and 1 <= d_q <= _GEN_MAX_D_Q):
        raise ValueError(
            f"{name} takes d_m <= {_GEN_MAX_WIDTH}, A <= {_GEN_MAX_WIDTH}, "
            f"L <= {_GEN_MAX_L}, d_q <= {_GEN_MAX_D_Q}; got d_m={d_m}, "
            f"A={A}, L={L}, d_q={d_q}")


def _launch(module, memory: torch.Tensor, query: torch.Tensor):
    global launches, gen_launches
    B, L, d_m = memory.shape
    d_q = query.shape[1]
    A = module.wm.shape[1]
    general = not fixed_width(d_m, A, L, d_q)
    name = "readout_gen_fwd" if general else "readout_fwd"
    check_shapes(d_m, A, L, d_q, name)
    if query.shape[0] != B or module.wm.shape[0] != d_m \
            or module.wq.shape != (d_q, A) or module.b.numel() != A \
            or module.v.numel() != A:
        raise ValueError(
            f"{name}: memory [B, L, d_m], query [B, d_q], wm [d_m, A], wq "
            f"[d_q, A], b [A], v [A]; got memory {tuple(memory.shape)}, "
            f"query {tuple(query.shape)}, wm {tuple(module.wm.shape)}, wq "
            f"{tuple(module.wq.shape)}")
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
    _build.check_launch(code, name)
    if general:
        gen_launches += 1
    else:
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
