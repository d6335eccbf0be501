"""Additive-attention memory readout — counterpart of
``hpmn_tpu/models/readout.py``:

    s_l = v . tanh(m_l @ wm + q @ wq + b);  alpha = softmax_l(s);
    read = sum_l alpha_l * m_l

This plain form is the version the CUDA readout kernel
(``ops/cuda_readout.py``) is held against. DIEN's batch-major encoder
takes the weights alpha from it (``return_weights=True``) for its AUGRU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Readout(nn.Module):
    """wm [mem_dim, A], wq [query_dim, A], b [A], v [A] (JAX layout)."""

    def __init__(self, mem_dim: int, query_dim: int, attn_dim: int):
        super().__init__()
        self.wm = nn.Parameter(torch.empty(mem_dim, attn_dim))
        self.wq = nn.Parameter(torch.empty(query_dim, attn_dim))
        self.b = nn.Parameter(torch.empty(attn_dim))
        self.v = nn.Parameter(torch.empty(attn_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform wm and wq, zero b, uniform v (as ``init_readout``)."""
        (mem_dim, attn_dim), query_dim = self.wm.shape, self.wq.shape[0]
        s_m = (6.0 / (mem_dim + attn_dim)) ** 0.5
        s_q = (6.0 / (query_dim + attn_dim)) ** 0.5
        s_v = (3.0 / attn_dim) ** 0.5
        self.wm.uniform_(-s_m, s_m, generator=generator)
        self.wq.uniform_(-s_q, s_q, generator=generator)
        self.b.zero_()
        self.v.uniform_(-s_v, s_v, generator=generator)


def attention_readout(module: Readout, memory: torch.Tensor,
                      query: torch.Tensor,
                      slot_mask: Optional[torch.Tensor] = None,
                      return_weights: bool = False):
    """memory [B, L, d_m], query [B, d_q] -> read [B, d_m], or (read,
    alpha [B, L]) with ``return_weights``.

    slot_mask [B, L] (optional): 1.0 for valid slots; a row with every slot
    masked reads zeros (its alpha is 0, not NaN)."""
    e = torch.tanh(memory @ module.wm
                   + (query @ module.wq + module.b)[:, None, :])
    scores = e @ module.v  # [B, L]
    if slot_mask is not None:
        scores = torch.where(slot_mask > 0, scores,
                             torch.finfo(scores.dtype).min)
    alpha = torch.softmax(scores, dim=-1)
    if slot_mask is not None:
        alpha = torch.where(slot_mask.sum(-1, keepdim=True) > 0, alpha, 0.0)
    read = torch.einsum("bl,bld->bd", alpha, memory)
    return (read, alpha) if return_weights else read
