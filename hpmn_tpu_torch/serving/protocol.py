"""Incremental encoder-state protocol for O(1) lifelong serving —
counterpart of ``hpmn_tpu/serving/protocol.py``, hpmn family only.

    state', counter' = update_state(family, encoder, state, counter, x, period)
    read             = read_state(family, model, state, q)
    state, counter   = encode_full(family, model, x_tm, mask_tm, period)

Feeding a user's T events one at a time through ``update_state`` gives the
state ``encode_full`` computes for the whole length-T history; ``read_state``
is the training forward's readout, so serving scores match its logits.
The gru4rec and rum families wait (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.hpmn import encode_hierarchical_tm, layer_period
from ..ops.cuda_gru import gru_sequence_tm
from ..ops.cuda_readout import fused_attention_readout
from ..ops.gru import gru_cell, gru_input_proj


def _only_hpmn(family: str) -> None:
    if family != "hpmn":
        raise NotImplementedError(
            f"serving family {family!r} is not ported yet; only hpmn is "
            "(ROADMAP.md)")


def update_state(family: str, encoder, state: torch.Tensor,
                 counter: torch.Tensor, x: torch.Tensor,
                 period: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One behaviour per user: state [B, L, d_m], counter [B] (events so
    far), x [B, d_in] -> (new state, counter + 1). Layer l fires iff
    (counter+1) % period**l == 0, the training oracle's firing grid."""
    _only_hpmn(family)
    t1 = counter + 1
    new_slots = []
    lower = x
    for l, lp in enumerate(encoder.layers):
        m_l = state[:, l, :]
        fires = ((t1 % layer_period(period, l)) == 0).to(x.dtype)[:, None]
        upd = gru_cell(lp, gru_input_proj(lp, lower), m_l)
        m_new = fires * upd + (1.0 - fires) * m_l
        new_slots.append(m_new)
        lower = m_new  # layer l+1 reads layer l's post-update memory
    return torch.stack(new_slots, dim=1), t1


def read_state(family: str, model, state: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """state [B, L, d_m], candidate embedding q [B, 2d] -> the tower's
    state input [B, d_m], through the CUDA readout kernel on the card."""
    _only_hpmn(family)
    return fused_attention_readout(model.readout, state, q)


def encode_full(family: str, model, x_tm: torch.Tensor,
                mask_tm: Optional[torch.Tensor],
                period: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched encode of whole histories: x_tm [T, B, 2d] (time-major, the
    scan kernel's layout), mask_tm [T, B] or None for full histories ->
    (state [B, L, d_m], counter [B] int64).

    The hierarchy of scans runs through the CUDA scan kernel on the card;
    it computes what the JAX package's masked oracle does. The counter
    continues from T: layers fire on the array-position grid of the
    left-padded window, so later updates stay on that grid."""
    _only_hpmn(family)
    T, B, _ = x_tm.shape
    state = encode_hierarchical_tm(model.encoder, x_tm, mask_tm, period,
                                   gru_seq_tm_fn=gru_sequence_tm)
    return state, torch.full((B,), T, dtype=torch.int64, device=x_tm.device)
