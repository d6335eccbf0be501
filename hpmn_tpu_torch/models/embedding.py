"""Item and category embedding tables, and the optional user table
(``use_user_emb``) — counterpart of ``hpmn_tpu/models/embedding.py``.

The behaviour embedding is concat(item emb, cat emb). The forward is a plain
row gather (``hpmn_tpu/ops/embedding_agg.py::take_rows``'s forward),
:func:`gather_rows`. Its backward is ``F.embedding``'s,
``embedding_dense_backward``, which sums each table row's gradients in a
fixed order on the CPU, so that a training run repeats bit for bit (and a
resumed run continues the interrupted one). On the card that op sums a
row that many ids repeat (the category table's) in another order from
call to call unless PyTorch's deterministic algorithms are on, so
:func:`rows_backward` runs it with them on there, and only there. That
switch is process-wide (see :func:`_deterministic`). On phase 5's xlong
step of ``chip_smoke.py`` the two forms' device times are printed side
by side (PERF.md §5).
Indexing the table instead (``table[ids]``) would give the index
backward, whose scatter-add adds a repeated row's gradients in its
threads' order.

Not ported: the one-hot matmul aggregation of ``take_rows``' backward
(``hpmn_tpu/ops/embedding_agg.py``). It works around XLA's sort-based
scatter on the TPU; it is jnp, not a Pallas kernel, and the card has a
scatter-add of its own.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def _deterministic(on: bool):
    """PyTorch's deterministic algorithms on within the block when ``on``,
    the process's setting restored after it. The setting is the
    process's, not the thread's, and the block runs on the autograd
    engine's device thread: while it lasts, a CUDA op of another thread
    that has no deterministic form raises, a cuBLAS call there needs
    ``CUBLAS_WORKSPACE_CONFIG``, and ``torch.empty`` there fills its
    memory. In the port's training no other thread issues CUDA work
    during a backward (the checkpoint writer writes host copies); a
    program that runs other CUDA work beside a training step on threads
    of its own has to keep it out of the backward."""
    if not on:
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def rows_backward(grad: torch.Tensor, ids: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """The table gradient [rows, d] of a row gather: grad [..., d] summed
    into the rows of ids [...] (``F.embedding``'s backward), in the same
    order on every call, on the card as on the CPU."""
    with _deterministic(grad.is_cuda):
        return torch.ops.aten.embedding_dense_backward(
            grad.contiguous(), ids.long(), rows, -1, False)


class _GatherRows(torch.autograd.Function):
    """table[ids], differentiable in the table through :func:`rows_backward`."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        return rows_backward(grad, ids, ctx.rows), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] (int32 or int64) -> the table's rows [..., d]; where the
    table needs no gradient, ``F.embedding`` alone."""
    ids = ids.long()
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, ids)
    return F.embedding(ids, table)


def dense_lookup(emb: Embedding, item_ids: torch.Tensor,
                 cat_ids: torch.Tensor) -> torch.Tensor:
    """ids [...] (int32 or int64) -> behaviour embedding [..., 2*emb_dim]."""
    return torch.cat([gather_rows(emb.item, item_ids),
                      gather_rows(emb.cat, cat_ids)], dim=-1)


def user_lookup(emb: Embedding, uid: torch.Tensor) -> torch.Tensor:
    """uid [B] -> the user table's rows [B, emb_dim]."""
    return gather_rows(emb.user, uid)
