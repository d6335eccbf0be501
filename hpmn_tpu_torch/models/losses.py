"""Losses: BCE, the HPMN covariance regularizer, L2 — counterpart of
``hpmn_tpu/models/losses.py``, with ``l2_parts``, the table/dense split
that the sharded step rebuilds its l2 metric from.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable mean binary cross-entropy; with ``weights``, the
    weighted sum over max(sum(weights), 1)."""
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    if weights is None:
        return per.mean()
    return (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def covariance_regularizer(memory: torch.Tensor) -> torch.Tensor:
    """Off-diagonal covariance penalty over HPMN's L memory slots.

    memory [B, L, d]. Per example C = (1/d) Mc Mc^T with Mc the
    feature-centred slots; the loss is the mean over examples of the summed
    squared off-diagonal entries."""
    _, L, d = memory.shape
    mc = memory - memory.mean(dim=-1, keepdim=True)
    cov = torch.einsum("bld,bmd->blm", mc, mc) / d
    off = cov * (1.0 - torch.eye(L, dtype=memory.dtype, device=memory.device))
    return (off ** 2).sum(dim=(-1, -2)).mean()


def l2_regularizer(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of squares over every parameter with >= 2 dims (both embedding
    tables included; biases and PReLU slopes skipped), as the JAX
    ``l2_regularizer`` over the param tree's leaves."""
    terms = [p.float().square().sum() for p in params if p.dim() >= 2]
    return torch.stack(terms).sum()


def l2_parts(named_params: Iterable[Tuple[str, torch.Tensor]]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``l2_regularizer`` split into (the embedding tables', everything
    else's): in the sharded step the table rows are sharded over the model
    group (their part is summed over it) and the dense parameters are
    replicated (their part is already whole). ``named_params`` as
    ``model.named_parameters()``; a table is a >= 2-D parameter under
    ``embedding``."""
    table, dense, device = [], [], None
    for name, p in named_params:
        device = p.device
        if p.dim() >= 2:
            part = table if "embedding" in name.split(".") else dense
            part.append(p.float().square().sum())

    def total(terms):
        return (torch.stack(terms).sum() if terms
                else torch.zeros((), device=device))

    return total(table), total(dense)
