"""GRU4Rec, the RNN baseline — counterpart of ``hpmn_tpu/models/gru4rec.py``:
one GRU over the behaviour sequence; its final state and the target feed
the tower (a CTR form of GRU4Rec, trained on the log-loss).

:func:`encode` is the batch-major plain form. The ``use_pallas`` path of
``model.apply_model`` runs the same GRU time-major through the CUDA scan
kernels (K1 forward, K2 backward; ``ops/cuda_gru.py::gru_sequence_tm``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.gru import GRUParams, gru_sequence


class GRU4RecEncoder(nn.Module):
    """One GRU, ``gru`` (in_dim -> mem_dim)."""

    def __init__(self, in_dim: int, mem_dim: int):
        super().__init__()
        self.gru = GRUParams(in_dim, mem_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gru.reset_parameters(generator)


def encode(enc: GRU4RecEncoder, x: torch.Tensor, mask: torch.Tensor,
           gru_seq_fn: Optional[Callable] = None) -> torch.Tensor:
    """x [B, T, d_in], mask [B, T] -> the user state [B, mem_dim].
    gru_seq_fn: (params, x, mask) -> (h_seq, h_T); default the plain
    ``gru_sequence`` (the sequence-parallel scan passes its own)."""
    if gru_seq_fn is None:
        gru_seq_fn = lambda p, xs, m: gru_sequence(p, xs, mask=m)  # noqa: E731
    _, h_T = gru_seq_fn(enc.gru, x, mask)
    return h_T
