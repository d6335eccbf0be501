"""PReLU MLP prediction tower — counterpart of ``hpmn_tpu/models/tower.py``.
Returns logits."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .dtypes import matmul


class TowerLayer(nn.Module):
    """w [a, b], bias b [b], and a PReLU slope alpha [b] (None on the final
    logit layer), as in the JAX layout."""

    def __init__(self, a: int, b: int, has_alpha: bool):
        super().__init__()
        self.w = nn.Parameter(torch.empty(a, b))
        self.b = nn.Parameter(torch.empty(b))
        self.alpha = nn.Parameter(torch.empty(b)) if has_alpha else None


class Tower(nn.Module):
    def __init__(self, d_in: int, hidden: Sequence[int]):
        super().__init__()
        dims = [d_in, *hidden, 1]
        self.layers = nn.ModuleList(
            TowerLayer(a, b, has_alpha=i < len(dims) - 2)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform w, zero b, alpha 0.25 (as ``init_tower``)."""
        for layer in self.layers:
            a, b = layer.w.shape
            s = (6.0 / (a + b)) ** 0.5
            layer.w.uniform_(-s, s, generator=generator)
            layer.b.zero_()
            if layer.alpha is not None:
                layer.alpha.fill_(0.25)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with a learned per-feature slope."""
    return torch.where(x >= 0, x, alpha * x)


def apply_tower(tower: Tower, x: torch.Tensor) -> torch.Tensor:
    """x [B, d_in] -> logits [B], in the promoted dtype of x and the
    weights (a bf16 tower on a float32 state computes in float32, as in
    JAX)."""
    h = x
    for layer in tower.layers:
        h = matmul(h, layer.w) + layer.b
        if layer.alpha is not None:
            h = prelu(h, layer.alpha)
    return h[..., 0]
