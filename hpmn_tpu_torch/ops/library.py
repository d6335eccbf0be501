"""K1 and K5 as ``torch.library`` custom ops: the form of the hand-written
kernels that ``torch.export`` can trace, the port's counterpart of what
lets ``jax.export`` trace a Pallas call.

    hpmn::gru_scan_fwd(Tensor x_tm, Tensor? mask_tm, Tensor? h0, Tensor wx,
                       Tensor wh, Tensor b, Tensor? scale_tm) -> Tensor
    hpmn::readout_fwd(Tensor memory, Tensor query, Tensor wm, Tensor wq,
                      Tensor b, Tensor v) -> Tensor

``gru_scan_fwd`` is K1 in every form (f32 or bf16 by the tensors' dtype,
with or without a mask or an h0, with the AUGRU scale: K1-scale), at any
width the kernels take (K1-general past d_m = 32, d_in <= 96) -> h_seq
[T, B, d_m] in x's dtype. Its CUDA implementation is
``cuda_gru._launch``, its CPU implementation the plain scan
(``gru_scan_tm``, ``gru_scan_tm_bf16``). ``readout_fwd`` is K5 (or
K5-general) -> read [B, d_m] float32: CUDA ``cuda_readout._launch``, CPU
``attention_readout``. One implementation per op picks by the tensors'
device (``cuda_gru.scan_by_device``, ``cuda_readout.readout_by_device``),
which eager code calls too. Each has a fake implementation that gives the
output's shape and dtype from the inputs', the batch symbolic included,
so a traced graph holds the op as one node. x_tm may be a strided view
along time (``h_seq[period-1::period]``): both implementations take it
as it is, and ``cuda_gru._check_cuda_args`` raises on a layout K1
cannot take.

The ops run where a graph runs them: an exported program
(``serving/aot.py``) calls them, and the CUDA implementations count their
launches (``cuda_gru.launches`` and the other forms' counters,
``cuda_readout.launches``) each time they run. Eager code reaches the
same implementations without the op's dispatch (``cuda_gru.GRUScan``,
``cuda_readout.fused_attention_readout``), which costs host time per
call (PERF.md); it takes the op only while ``torch.compiler`` traces.

Nothing is built at import: the CUDA implementations load the kernels'
library at their first launch.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


@torch.library.custom_op("hpmn::gru_scan_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def gru_scan_fwd(x_tm: Tensor, mask_tm: Optional[Tensor],
                 h0: Optional[Tensor], wx: Tensor, wh: Tensor, b: Tensor,
                 scale_tm: Optional[Tensor]) -> Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors
    (``cuda_gru.scan_by_device``)."""
    from .cuda_gru import scan_by_device

    return scan_by_device(x_tm, mask_tm, h0, wx, wh, b, scale_tm)


@gru_scan_fwd.register_fake
def _gru_scan_fwd_fake(x_tm, mask_tm, h0, wx, wh, b, scale_tm):
    T, B, _ = x_tm.shape
    return x_tm.new_empty(T, B, wh.shape[0])


@torch.library.custom_op("hpmn::readout_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def readout_fwd(memory: Tensor, query: Tensor, wm: Tensor, wq: Tensor,
                b: Tensor, v: Tensor) -> Tensor:
    """K5 on CUDA tensors, its plain version on CPU tensors
    (``cuda_readout.readout_by_device``)."""
    from .cuda_readout import readout_by_device

    return readout_by_device(memory, query, wm, wq, b, v)


@readout_fwd.register_fake
def _readout_fwd_fake(memory, query, wm, wq, b, v):
    return memory.new_empty(memory.shape[0], memory.shape[2],
                            dtype=torch.float32)
