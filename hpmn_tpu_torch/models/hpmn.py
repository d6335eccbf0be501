"""HPMN — Hierarchical Periodic Memory Network encoder; counterpart of
``hpmn_tpu/models/hpmn.py``.

Layer 0 is a GRU over every event; layer l fires every ``period**l`` steps
and consumes layer l-1's memory. Four realizations of the same function:

- :func:`encode_oracle` — one masked scan over all T steps that carries every
  layer's slot and fires layer l where ``(t+1) % period**l == 0``. The
  reference the other two are held to.
- :func:`encode_hierarchical` — batch-major hierarchy of scans: layer l scans
  only the stride-sampled outputs ``h_seq[:, period-1::period]`` of layer l-1.
- :func:`encode_hierarchical_tm` — the same, time-major, the path of the
  CUDA scan kernel (stride sampling is a leading-axis view, so nothing is
  transposed or copied between layers).
- :func:`encode_hierarchical_stride_tm` — time-major, full sequences, each
  layer's scan emitting only the strided rows the next layer reads and its
  final state (``model.pallas_stride_outputs``: the CUDA strided scan
  kernels, ``ops/cuda_gru_stride.py``).

Each returns memory [B, L, d_m]: slot l is layer l's final carry.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.gru import GRUParams, gru_input_proj, gru_sequence, gru_step


def layer_period(period: int, layer_idx: int) -> int:
    """Update period of 0-indexed layer l: period**l."""
    return period ** layer_idx


class HPMNEncoder(nn.Module):
    """Per-layer GRUs: layer 0 reads behaviour embeddings (in_dim), the
    others the layer below's memory (mem_dim)."""

    def __init__(self, in_dim: int, mem_dim: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            GRUParams(in_dim if l == 0 else mem_dim, mem_dim)
            for l in range(n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)


def encode_oracle(enc: HPMNEncoder, x: torch.Tensor, mask: torch.Tensor,
                  period: int) -> torch.Tensor:
    """Masked single-scan HPMN: x [B, T, d_in], mask [B, T] -> memory
    [B, L, d_m]."""
    layers = enc.layers
    B, T, _ = x.shape
    d_m = layers[0].wh.shape[0]
    xp0 = gru_input_proj(layers[0], x)
    ms = [x.new_zeros(B, d_m) for _ in layers]
    for t in range(T):
        m_t = mask[:, t]
        ms[0] = gru_step(layers[0], xp0[:, t], ms[0], m_t)
        for l in range(1, len(layers)):
            fires = float((t + 1) % layer_period(period, l) == 0)
            xp_l = gru_input_proj(layers[l], ms[l - 1])
            ms[l] = gru_step(layers[l], xp_l, ms[l], m_t * fires)
    return torch.stack(ms, dim=1)


def encode_hierarchical(enc: HPMNEncoder, x: torch.Tensor,
                        mask: torch.Tensor, period: int,
                        gru_seq_fn: Optional[Callable] = None) -> torch.Tensor:
    """Batch-major hierarchy of scans. gru_seq_fn: (params, x [B,T,d],
    mask [B,T]) -> (h_seq, h_T); default the plain ``gru_sequence``."""
    if gru_seq_fn is None:
        gru_seq_fn = lambda p, xs, m: gru_sequence(p, xs, mask=m)  # noqa: E731
    L = len(enc.layers)
    B = x.shape[0]
    d_m = enc.layers[0].wh.shape[0]
    slots = []
    seq, m = x, mask
    for l in range(L):
        if seq.shape[1] == 0:
            # Layer never fires for this (T, period): its slot stays zero,
            # as in the oracle.
            slots.extend([x.new_zeros(B, d_m)] * (L - l))
            break
        h_seq, h_T = gru_seq_fn(enc.layers[l], seq, m)
        slots.append(h_T)
        seq = h_seq[:, period - 1::period]
        m = m[:, period - 1::period]
    return torch.stack(slots, dim=1)


def encode_hierarchical_tm(enc: HPMNEncoder, x_tm: torch.Tensor,
                           mask_tm: Optional[torch.Tensor], period: int,
                           gru_seq_tm_fn: Callable) -> torch.Tensor:
    """Time-major hierarchy of scans: x_tm [T, B, d_in], mask_tm [T, B] or
    None (full sequences). gru_seq_tm_fn: (params, x_tm, mask_tm) ->
    (h_seq_tm [T, B, d_m], h_T), e.g. ``ops.cuda_gru.gru_sequence_tm``."""
    L = len(enc.layers)
    B = x_tm.shape[1]
    d_m = enc.layers[0].wh.shape[0]
    slots = []
    seq, m = x_tm, mask_tm
    for l in range(L):
        if seq.shape[0] == 0:
            slots.extend([x_tm.new_zeros(B, d_m)] * (L - l))
            break
        h_seq, h_T = gru_seq_tm_fn(enc.layers[l], seq, m)
        slots.append(h_T)
        seq = h_seq[period - 1::period]
        m = None if m is None else m[period - 1::period]
    return torch.stack(slots, dim=1)


def encode_hierarchical_stride_tm(enc: HPMNEncoder, x_tm: torch.Tensor,
                                  period: int,
                                  stride_fn: Callable) -> torch.Tensor:
    """Time-major hierarchy of strided-output scans, full sequences:
    x_tm [T, B, d_in] -> memory [B, L, d_m]. stride_fn: (params, x_tm,
    period) -> (h_stride [T // period, B, d_m], h_T), e.g.
    ``ops.cuda_gru_stride.gru_stride_tm``. A layer whose input has no rows
    keeps a zero slot, as in the oracle."""
    L = len(enc.layers)
    B = x_tm.shape[1]
    d_m = enc.layers[0].wh.shape[0]
    slots = []
    seq = x_tm
    for l in range(L):
        if seq.shape[0] == 0:
            slots.extend([x_tm.new_zeros(B, d_m)] * (L - l))
            break
        seq, h_T = stride_fn(enc.layers[l], seq, period)
        slots.append(h_T)
    return torch.stack(slots, dim=1)
