"""DIEN, the Deep Interest Evolution Network encoder — counterpart of
``hpmn_tpu/models/dien.py``.

Two stages over the behaviour embeddings x:

1. interest extraction: a GRU (``gru1``) over x gives h_t, with an optional
   auxiliary loss that pushes h_t to predict the next behaviour against a
   sampled negative (the batch's ``neg_item_seq``);
2. interest evolution: the AUGRU (``augru``), a GRU over h_t whose update
   gate is scaled by a_t, the additive attention of h_t against the target
   item (``attn``), softmax over time.

:func:`encode` is the batch-major plain form. :func:`encode_tm` is the
time-major form of the ``use_pallas`` path, where both scans are one
``gru_seq_tm_fn`` (``ops/cuda_gru.py::gru_sequence_tm``: K1 and K2 for
``gru1``, K1-scale and K2-scale for the AUGRU, or their bf16 forms).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.gru import GRUParams, gru_sequence
from .dtypes import matmul
from .readout import Readout, attention_readout


class DIENEncoder(nn.Module):
    """gru1 (in_dim -> mem_dim), augru (mem_dim -> mem_dim), the attention
    ``attn`` (a Readout over the interest states with the target as query)
    and aux_w [mem_dim, in_dim], which projects interest states into the
    embedding space for the auxiliary loss."""

    def __init__(self, in_dim: int, mem_dim: int, attn_dim: int):
        super().__init__()
        self.gru1 = GRUParams(in_dim, mem_dim)
        self.augru = GRUParams(mem_dim, mem_dim)
        self.attn = Readout(mem_dim, in_dim, attn_dim)
        self.aux_w = nn.Parameter(torch.empty(mem_dim, in_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init_dien`` distributions: the GRUs' and the readout's
        own, aux_w uniform in +-sqrt(6 / (mem_dim + in_dim))."""
        self.gru1.reset_parameters(generator)
        self.augru.reset_parameters(generator)
        self.attn.reset_parameters(generator)
        mem_dim, in_dim = self.aux_w.shape
        s = (6.0 / (mem_dim + in_dim)) ** 0.5
        self.aux_w.uniform_(-s, s, generator=generator)


def _aux_terms(hp: torch.Tensor, x_next: torch.Tensor,
               x_neg_next: torch.Tensor) -> torch.Tensor:
    """BCE(sigmoid(hp . e_{t+1}), 1) + BCE(sigmoid(hp . e-_{t+1}), 0) per
    position, the logits' stable forms."""
    pos = (hp * x_next).sum(-1)
    neg = (hp * x_neg_next).sum(-1)
    return (torch.clamp(pos, min=0) - pos + torch.log1p(torch.exp(-pos.abs()))
            + torch.clamp(neg, min=0) + torch.log1p(torch.exp(-neg.abs())))


def auxiliary_loss(enc: DIENEncoder, h_seq: torch.Tensor, x: torch.Tensor,
                   x_neg: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batch-major: h_seq [B, T, d_m], x and x_neg [B, T, d], mask [B, T]
    -> the mean over positions where both t and t+1 are valid."""
    per = _aux_terms(h_seq[:, :-1] @ enc.aux_w, x[:, 1:], x_neg[:, 1:])
    m = mask[:, :-1] * mask[:, 1:]
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def encode(enc: DIENEncoder, x: torch.Tensor, mask: torch.Tensor,
           target: torch.Tensor, x_neg: Optional[torch.Tensor] = None,
           use_aux_loss: bool = True, gru_seq_fn: Optional[Callable] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major plain DIEN: x [B, T, d], mask [B, T], target [B, d] ->
    (the final evolved interest [B, d_m], the aux loss, a scalar).
    gru_seq_fn: (params, x, mask, gate_scale=None) -> (h_seq, h_T) runs
    both scans, the attention as the AUGRU's gate scale; default the plain
    ``gru_sequence`` (the sequence-parallel scan passes its own)."""
    if gru_seq_fn is None:
        gru_seq_fn = lambda p, xs, m, a=None: gru_sequence(  # noqa: E731
            p, xs, mask=m, gate_scale=a)
    h_seq, _ = gru_seq_fn(enc.gru1, x, mask)
    aux = x.new_zeros(())
    if use_aux_loss and x_neg is not None:
        aux = auxiliary_loss(enc, h_seq, x, x_neg, mask)
    _, alpha = attention_readout(enc.attn, h_seq, target, slot_mask=mask,
                                 return_weights=True)
    _, h_T = gru_seq_fn(enc.augru, h_seq, mask, alpha)
    return h_T, aux


def encode_tm(enc: DIENEncoder, x_tm: torch.Tensor,
              mask_tm: Optional[torch.Tensor], target: torch.Tensor,
              x_neg_tm: Optional[torch.Tensor], use_aux_loss: bool,
              gru_seq_tm_fn: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major DIEN, the JAX ``encode_tm`` step for step: x_tm [T, B, d],
    mask_tm [T, B] or None (full sequences), target [B, d], x_neg_tm
    [T, B, d] or None. gru_seq_tm_fn(params, x_tm, mask_tm, scale_tm=None)
    -> (h_seq_tm, h_T) runs both scans in the scan dtype.

    The aux loss and the attention read h_seq in float32 (with a bf16
    model, each product in its operands' promoted dtype, as in JAX: the
    target's projection in bf16, the rest in float32); the AUGRU is fed
    h_seq as the first scan returned it (bf16 in the bf16 chain) and alpha,
    which the scan casts to its dtype. alpha is a softmax over T of scores
    set to float32's min (not -inf) at padded steps, and 0 on rows with no
    valid step, so an empty history evolves nothing and gives no NaN."""
    f32 = torch.float32
    h_seq_tm, _ = gru_seq_tm_fn(enc.gru1, x_tm, mask_tm)
    hs = h_seq_tm.to(f32)
    aux = hs.new_zeros(())
    if use_aux_loss and x_neg_tm is not None:
        per = _aux_terms(matmul(hs[:-1], enc.aux_w), x_tm[1:].to(f32),
                         x_neg_tm[1:].to(f32))
        if mask_tm is None:
            aux = per.mean()
        else:
            m = mask_tm[:-1] * mask_tm[1:]
            aux = (per * m).sum() / torch.clamp(m.sum(), min=1.0)
    att = enc.attn
    e = torch.tanh(matmul(hs, att.wm)
                   + (target @ att.wq + att.b)[None, :, :])
    scores = matmul(e, att.v)  # [T, B]
    if mask_tm is not None:
        scores = torch.where(mask_tm > 0, scores, torch.finfo(f32).min)
    alpha = torch.softmax(scores, dim=0)
    if mask_tm is not None:
        alpha = torch.where(mask_tm.sum(0, keepdim=True) > 0, alpha, 0.0)
    _, h_T = gru_seq_tm_fn(enc.augru, h_seq_tm, mask_tm, scale_tm=alpha)
    return h_T, aux
