"""Incremental encoder-state protocol for O(1) lifelong serving —
counterpart of ``hpmn_tpu/serving/protocol.py``.

It serves every family whose encoder is a target-independent recurrence
(the state update reads only the events; the candidate enters at the
read), :data:`O1_FAMILIES`:

- **hpmn**: L slots of hierarchical periodic GRU memory, layer l firing
  at its period;
- **gru4rec**: one GRU state; every event is one ``gru_cell`` step;
- **rum**: K slots of erase/add memory; every event is one write, whose
  address comes from the event, not the target.

Every other family is served by ``serving.history.HistoryStore``: DIEN
(its AUGRU gate needs the target's attention over the whole history), BST
and SHAN (they attend over the history from the target), and DNN, LSTM,
Caser and SVD++, which the JAX package serves the same way.

    state', counter' = update_state(family, encoder, state, counter, x, period)
    read             = read_state(family, model, state, q)
    state, counter   = encode_full(family, model, x_tm, mask_tm, period)

Feeding a user's T events one at a time through ``update_state`` gives the
state ``encode_full`` computes for the whole length-T history; ``read_state``
is the training forward's readout, so serving scores match its logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import rum as rum_mod
from ..models.hpmn import encode_hierarchical_tm, layer_period
from ..ops.cuda_gru import gru_sequence_tm
from ..ops.cuda_readout import fused_attention_readout
from ..ops.gru import gru_cell, gru_input_proj

#: The families whose encoder is a target-independent recurrence: the ones
#: ``UserMemoryStore`` serves with O(1) work per event.
O1_FAMILIES = ("hpmn", "gru4rec", "rum")


def n_state_slots(cfg) -> int:
    """Rows of the per-user state [n_slots, d_m]: hpmn's layers, gru4rec's
    one state, rum's slots."""
    name = cfg.model.name
    if name == "hpmn":
        return int(cfg.model.hpmn_layers)
    if name == "gru4rec":
        return 1
    if name == "rum":
        return int(cfg.model.rum_slots)
    raise ValueError(
        f"model family {name!r} has no target-independent encoder "
        f"recurrence (families {O1_FAMILIES} qualify); serve it with "
        f"serving.history.HistoryStore")


def update_state(family: str, encoder, state: torch.Tensor,
                 counter: torch.Tensor, x: torch.Tensor,
                 period: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One behaviour per user: state [B, K, d_m], counter [B] (events so
    far), x [B, d_in] -> (new state, counter + 1).

    hpmn: layer l fires iff (counter+1) % period**l == 0, the training
    oracle's firing grid. gru4rec and rum: every event fires."""
    t1 = counter + 1
    if family == "hpmn":
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
    if family == "gru4rec":
        gp = encoder.gru
        h = gru_cell(gp, gru_input_proj(gp, x), state[:, 0, :])
        return h[:, None, :], t1
    if family == "rum":
        xh = x @ encoder.proj  # [B, d_m]
        e = torch.sigmoid(xh @ encoder.erase)
        a = torch.tanh(xh @ encoder.add)
        w = rum_mod.address(encoder.keys, xh, encoder.beta)[:, :, None]
        return state * (1.0 - w * e[:, None, :]) + w * a[:, None, :], t1
    raise ValueError(f"no O(1) update for family {family!r}")


def read_state(family: str, model, state: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """state [B, K, d_m], candidate embedding q [B, 2d] -> the tower's
    state input [B, d_m], the training encoder's readout (hpmn: through
    the CUDA readout kernel on the card)."""
    if family == "hpmn":
        return fused_attention_readout(model.readout, state, q)
    if family == "gru4rec":
        return state[:, 0, :]
    if family == "rum":
        return rum_mod.read_memory(model.encoder, state, q)
    raise ValueError(f"no readout for family {family!r}")


def encode_full(family: str, model, x_tm: torch.Tensor,
                mask_tm: Optional[torch.Tensor],
                period: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched encode of whole histories: x_tm [T, B, 2d] (time-major, the
    scan kernel's layout), mask_tm [T, B] or None for full histories ->
    (state [B, K, d_m], counter [B] int64).

    hpmn runs its hierarchy of scans, and gru4rec its GRU, through the CUDA
    scan kernel (K1) on the card. hpmn's counter continues from T: its
    layers fire on the array-position grid of the left-padded window, so
    later updates stay on that grid. gru4rec and rum do not depend on the
    position, so theirs is the count of valid events."""
    T, B, _ = x_tm.shape
    if family == "hpmn":
        state = encode_hierarchical_tm(model.encoder, x_tm, mask_tm, period,
                                       gru_seq_tm_fn=gru_sequence_tm)
        return state, torch.full((B,), T, dtype=torch.int64,
                                 device=x_tm.device)
    if mask_tm is None:
        n_valid = torch.full((B,), T, dtype=torch.int64, device=x_tm.device)
    else:
        n_valid = mask_tm.sum(0).to(torch.int64)
    if family == "gru4rec":
        _, h_T = gru_sequence_tm(model.encoder.gru, x_tm, mask_tm)
        return h_T[:, None, :], n_valid
    if family == "rum":
        mask = (x_tm.new_ones(B, T) if mask_tm is None
                else mask_tm.transpose(0, 1))
        return rum_mod.write_memory(model.encoder, x_tm.transpose(0, 1),
                                    mask), n_valid
    raise ValueError(f"no batched encode for family {family!r}")
