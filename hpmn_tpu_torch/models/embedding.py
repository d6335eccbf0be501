"""Item and category embedding tables, and the optional user table
(``use_user_emb``) — counterpart of ``hpmn_tpu/models/embedding.py``.

The behaviour embedding is concat(item emb, cat emb). The forward is a plain
row gather (``hpmn_tpu/ops/embedding_agg.py::take_rows``'s forward) through
``F.embedding``, whose backward sums each table row's gradients in a fixed
order, so that a training run repeats bit for bit (and a resumed run
continues the interrupted one). Indexing the table instead
(``table[ids]``) would give the index backward, whose scatter-add on the
CPU adds a repeated row's gradients in its threads' order.

Not ported: the one-hot matmul aggregation of ``take_rows``' backward
(``hpmn_tpu/ops/embedding_agg.py``). It works around XLA's sort-based
scatter on the TPU; it is jnp, not a Pallas kernel, and the card has a
scatter-add of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Embedding(nn.Module):
    """item [n_items, emb_dim] and cat [n_cats, emb_dim] tables, and with
    ``n_users > 0`` a user table [n_users, emb_dim] (else ``user`` is
    None)."""

    def __init__(self, n_items: int, n_cats: int, emb_dim: int,
                 n_users: int = 0):
        super().__init__()
        self.item = nn.Parameter(torch.empty(n_items, emb_dim))
        self.cat = nn.Parameter(torch.empty(n_cats, emb_dim))
        self.user = (nn.Parameter(torch.empty(n_users, emb_dim))
                     if n_users > 0 else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal(0, 1/emb_dim) entries (as ``init_embedding``), drawn
        item, cat, then user."""
        scale = self.item.shape[1] ** -0.5
        for table in (self.item, self.cat, self.user):
            if table is not None:
                table.normal_(0.0, scale, generator=generator)


def dense_lookup(emb: Embedding, item_ids: torch.Tensor,
                 cat_ids: torch.Tensor) -> torch.Tensor:
    """ids [...] (int32 or int64) -> behaviour embedding [..., 2*emb_dim]."""
    return torch.cat([F.embedding(item_ids.long(), emb.item),
                      F.embedding(cat_ids.long(), emb.cat)], dim=-1)


def user_lookup(emb: Embedding, uid: torch.Tensor) -> torch.Tensor:
    """uid [B] -> the user table's rows [B, emb_dim]."""
    return F.embedding(uid.long(), emb.user)
