"""Row-sharded embedding lookups over the mesh's model group — counterpart
of ``hpmn_tpu/parallel/embedding_sharding.py``.

Each rank of a model group holds rows ``[s*R, (s+1)*R)`` of every table
(``R = ceil(V / S)``, tables padded to ``S*R`` rows by :func:`pad_vocab`),
ids keep their global values, and the looked-up rows travel by
``torch.distributed`` collectives on the model group. Two exchanges, as
in JAX:

- ``psum``: every rank gathers the rows it owns for the whole
  (model-replicated) id list, zeros elsewhere, and one ``all_reduce`` sums
  the complete rows (one non-zero term per row: exact);
- ``a2a``: the sort-by-owner bucketed exchange (:func:`bucketed_gather`):
  a rank sorts its own queries by id, gives each distinct id one slot of
  an [S, C] send buffer (C per owner, :func:`_capacity`), sends the
  buckets to their owners with ``all_to_all_single``, which answer with
  their rows by a second ``all_to_all_single``. When any rank's bucket
  overflows (the flag is summed over the group, so every rank agrees),
  the whole lookup takes the exact fallback instead: ``all_gather`` of
  the ids, a masked gather and an ``all_reduce``.

Every backward is written out, never autograd through a collective: the
cotangent rows return to the owner by the inverse exchange (``add``, not
``set``, into a slot that duplicate ids share) and are summed into its
table rows; the replicated-ids lookups (:func:`local_lookup_fn`) sum the
cotangent rows of the ids a rank owns locally, with no collective. The
sums are the single-device table gradient
(``models.embedding.rows_backward``, ``F.embedding``'s backward), which
adds a row's terms in a fixed order.
JAX's one-hot matmul for tables of at most 4096 rows is the same sum in
another order.

All functions here run on one rank; ``mesh`` names its groups. Each
collective of a lookup runs under a profiler span, ``embedding_exchange``
(:func:`_exchange`), and spans never nest.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.embedding import rows_backward
from .mesh import Mesh


def pad_vocab(n: int, n_shards: int) -> int:
    return -(-n // n_shards) * n_shards


# --- collectives on a group (skipped without one: a 1 x 1 mesh) ---------

def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[N, ...] from each of the group's n ranks -> [n*N, ...], rank
    order (JAX's ``all_gather(tiled=True)``)."""
    if group is None:
        return t
    # The list form: gloo takes it for CUDA tensors as well as NCCL does.
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal splits of dim 0 to each rank of the group, in rank order
    (JAX's ``all_to_all(split_axis=0, concat_axis=0)``)."""
    if group is None:
        return t
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _exchange(collective: Callable, t: torch.Tensor, group, *args,
              span: str = "embedding_exchange",
              wait_span: str = "exchange_queue_wait"):
    """``collective(t, group, *args)``, one collective of a lookup, under
    the profiler span ``span``. Under gloo a CUDA tensor is staged through
    the host, so the collective first waits for the stream's queued
    kernels: that wait is made explicit before the span, under its own
    span ``wait_span``, and the collective's span holds the copies, the
    transfer and the wait for the group's other ranks. The sequence-
    parallel scan's collectives pass their own span names."""
    if group is not None and t.is_cuda and dist.get_backend(group) == "gloo":
        with torch.profiler.record_function(wait_span):
            torch.cuda.current_stream(t.device).synchronize()
    with torch.profiler.record_function(span):
        return collective(t, group, *args)


def _scatter_rows(g: torch.Tensor, idx: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """sum of g's rows into a [rows, d] table at idx (the backward of a row
    gather, ``F.embedding``'s)."""
    return rows_backward(g, idx, rows)


def _owned(ids: torch.Tensor, shard: int, rows_per: int):
    local = ids.long() - shard * rows_per
    mine = (local >= 0) & (local < rows_per)
    return local.clamp(0, rows_per - 1), mine


def _owned_gather_psum(table: torch.Tensor, ids: torch.Tensor,
                       mesh: Mesh) -> torch.Tensor:
    """table [V/S, d] this rank's shard; ids [N] global ids, the same on
    every rank of the model group -> [N, d] complete rows on each."""
    local, mine = _owned(ids, mesh.model_index, table.shape[0])
    rows = torch.where(mine[:, None], table[local], 0.0)
    return _exchange(_all_reduce, rows, mesh.model_group)


def _capacity(n_local: int, n_shards: int, factor: float) -> int:
    """Per-owner bucket capacity: factor x the balanced load, at least 1,
    never above n_local."""
    return max(1, min(n_local, math.ceil(-(-n_local // n_shards) * factor)))


def _bucket_slots(ids: torch.Tensor, n_shards: int, rows_per: int,
                  cap: int):
    """Sort local ids, dedup'd -> (perm, slot, overflow).

    perm [N]: the stable sort permutation (ids_sorted = ids[perm]). slot
    [N]: each sorted query's position in the flat [S*cap] send buffer,
    owner*cap + the rank of its id among the owner's distinct ids (equal
    ids share their first one's slot), or the sentinel S*cap when that
    rank is past the capacity. overflow: a 0-d bool tensor, this rank
    only."""
    n = ids.shape[0]
    ids_sorted, perm = torch.sort(ids, stable=True)
    owner = torch.div(ids_sorted, rows_per, rounding_mode="floor")
    is_first = torch.ones(n, dtype=torch.int64, device=ids.device)
    is_first[1:] = (ids_sorted[1:] != ids_sorted[:-1]).long()
    incl = torch.cumsum(is_first, 0)  # leaders at positions <= i
    ex = torch.cat([incl.new_zeros(1), incl])  # leaders before p
    starts = torch.searchsorted(
        owner.contiguous(),
        torch.arange(n_shards, dtype=owner.dtype, device=ids.device))
    urank = (incl - 1) - ex[starts[owner.clamp(0, n_shards - 1)]]
    over = urank >= cap
    slot = torch.where(over, n_shards * cap, owner * cap + urank)
    return perm, slot, over.any()


def _group_flag(over: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """int32 [] 1 iff any rank of the model group set ``over``."""
    count = _exchange(_all_reduce, over.to(torch.int32).reshape(1),
                      mesh.model_group)
    return (count > 0).to(torch.int32).reshape(())


def _gather_all_psum(table: torch.Tensor, ids: torch.Tensor,
                     mesh: Mesh) -> torch.Tensor:
    """The exact lookup of this rank's own queries: all_gather of the
    group's ids, the masked gather, all_reduce, this rank's slice (the
    overflow fallback; wire about S*N*d)."""
    n = ids.shape[0]
    gids = _exchange(_all_gather, ids, mesh.model_group, mesh.n_model)
    full = _owned_gather_psum(table, gids, mesh)
    return full[mesh.model_index * n:(mesh.model_index + 1) * n]


def exchange_overflow(ids: torch.Tensor, *, mesh: Mesh, rows_per: int,
                      capacity: int) -> torch.Tensor:
    """int32 [] 1 iff any rank's per-owner bucket for its ``ids`` exceeds
    ``capacity``: the lookup that :func:`bucketed_gather` routes through
    the fallback."""
    _, _, over = _bucket_slots(ids, mesh.n_model, rows_per, capacity)
    return _group_flag(over, mesh)


def derive_capacity_factor(tables, n_shards: int, slice_sizes,
                           n_draws: int = 16, margin: float = 1.25,
                           f_min: float = 1.1, seed: int = 0) -> float:
    """``mesh.a2a_capacity_factor`` from the id distribution (the
    config's 0 = auto). ``tables``: [(ids, rows_per)], a sample of the ids
    one table is queried with (sequences flattened row-major) and its rows
    per shard; ``slice_sizes``: the per-rank query counts of one exchange.
    Per (table, size), ``n_draws`` contiguous windows: the most distinct
    ids one owner gets over the balanced load; -> ``margin`` x the worst
    ratio, at least ``f_min`` (2.0 without ids). Seeded numpy: every rank
    derives the same value from the same arrays."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for ids, rows_per in tables:
        ids = np.asarray(ids).reshape(-1)
        ids = ids[ids >= 0]
        if not len(ids):
            continue
        for n in slice_sizes:
            n = int(min(n, len(ids)))
            if n < 1:
                continue
            balanced = -(-n // n_shards)
            for _ in range(n_draws):
                start = int(rng.integers(0, len(ids) - n + 1)) \
                    if len(ids) > n else 0
                u = np.unique(ids[start:start + n])
                top = np.bincount(u // rows_per, minlength=n_shards).max()
                worst = max(worst, top / balanced)
    return max(f_min, margin * worst) if worst else 2.0


class _BucketedGather(torch.autograd.Function):
    """The bucketed exchange of this rank's own queries; see
    :func:`bucketed_gather`."""

    @staticmethod
    def forward(ctx, table, ids, mesh, cap, scale, sink):
        s, rows_per = mesh.n_model, table.shape[0]
        group = mesh.model_group
        perm, slot, over = _bucket_slots(ids, s, rows_per, cap)
        flag = _group_flag(over, mesh)
        if sink is not None:
            sink.append(flag)
        ctx.mesh, ctx.scale, ctx.rows_per = mesh, scale, rows_per
        ctx.fallback = bool(flag)  # the same on every rank of the group
        if ctx.fallback:
            ctx.save_for_backward(ids)
            return _gather_all_psum(table, ids, mesh)
        ids_sorted = ids[perm]
        # Slot k of owner o's bucket is padded with row 0 of owner o: in
        # range there, answered, never read back.
        send = (torch.arange(s * cap, device=ids.device, dtype=ids.dtype)
                // cap) * rows_per
        keep = slot < s * cap
        send[slot[keep]] = ids_sorted[keep]
        recv = _exchange(_all_to_all, send, group)  # [S*cap] queries
        local = (recv.long() - mesh.model_index * rows_per).clamp(
            0, rows_per - 1)
        back = _exchange(_all_to_all, table[local], group)  # [S*cap, d]
        back = torch.cat([back, back.new_zeros(1, back.shape[1])])
        out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                          device=table.device)
        out[perm] = back[slot]  # the sentinel slot reads zeros
        ctx.save_for_backward(perm, slot, local)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, rows_per = ctx.mesh, ctx.rows_per
        if ctx.fallback:
            (ids,) = ctx.saved_tensors
            g_all = _exchange(_all_gather, g, mesh.model_group, mesh.n_model)
            gids = _exchange(_all_gather, ids, mesh.model_group,
                             mesh.n_model)
            local, mine = _owned(gids, mesh.model_index, rows_per)
            dt = _scatter_rows(torch.where(mine[:, None], g_all, 0.0),
                               local, rows_per)
        else:
            perm, slot, local = ctx.saved_tensors
            n_slots = local.shape[0]
            # ADD: duplicate queries share their first one's slot, so their
            # cotangents sum there before the inverse exchange.
            g_send = g.new_zeros(n_slots + 1, g.shape[1]).index_add_(
                0, slot, g[perm])[:n_slots]
            g_back = _exchange(_all_to_all, g_send,
                               mesh.model_group)  # at the owner
            dt = _scatter_rows(g_back, local, rows_per)
        if ctx.scale != 1.0:
            dt = dt * ctx.scale
        return dt, None, None, None, None, None


def bucketed_gather(table: torch.Tensor, ids: torch.Tensor, *, mesh: Mesh,
                    capacity: int, table_grad_scale: float = 1.0,
                    sink: Optional[List] = None) -> torch.Tensor:
    """This rank's own queries ``ids`` [N] (any content, any N) -> their
    complete rows [N, d], through the bucketed exchange on the model group,
    or through the exact fallback when any rank's bucket overflows
    ``capacity``. The backward sends the cotangent rows to their owners by
    the inverse exchange and sums them into the table shard, times
    ``table_grad_scale`` (batch-over-model steps pass 1/n_model, so that
    the sum over the S sources and the data-group mean make the global
    mean). The exchange's overflow flag (int32 [], the same on the whole
    group) is appended to ``sink`` when one is given."""
    return _BucketedGather.apply(table, ids, mesh, capacity,
                                 float(table_grad_scale), sink)


def _owned_gather_a2a(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                      capacity_factor: float = 2.0,
                      sink: Optional[List] = None) -> torch.Tensor:
    """Replicated-ids lookup through the bucketed exchange: each rank
    takes its 1/S slice of the group's id list (N % S == 0), exchanges it,
    and an all_gather replicates the rows again."""
    s = mesh.n_model
    chunk = ids.shape[0] // s
    mine = ids[mesh.model_index * chunk:(mesh.model_index + 1) * chunk]
    rows = bucketed_gather(table, mine, mesh=mesh,
                           capacity=_capacity(chunk, s, capacity_factor),
                           sink=sink)
    return _exchange(_all_gather, rows, mesh.model_group, s)


def _padded(flat: torch.Tensor, n_shards: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % n_shards
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def replicated_ids_overflow(table: torch.Tensor, flat: torch.Tensor, *,
                            mesh: Mesh, capacity_factor: float
                            ) -> torch.Tensor:
    """The overflow flag of one replicated-ids a2a lookup: the same pad,
    slice and bucketing as :func:`_owned_gather_a2a`."""
    s = mesh.n_model
    padded = _padded(flat, s)
    chunk = padded.shape[0] // s
    mine = padded[mesh.model_index * chunk:(mesh.model_index + 1) * chunk]
    return exchange_overflow(mine, mesh=mesh, rows_per=table.shape[0],
                             capacity=_capacity(chunk, s, capacity_factor))


def _make_lookup(one_table: Callable) -> Callable:
    """``one_table(table, ids, sink)`` -> [..., d] -> ``lookup(emb,
    item_ids, cat_ids)`` -> [..., 2d], with ``lookup.user(emb, uid)`` and
    the list ``lookup.overflow_sink`` that ``one_table`` appends overflow
    flags to and ``apply_model`` drains into aux["a2a_overflow"]."""
    sink: List = []

    def lookup(emb, item_ids, cat_ids):
        return torch.cat([one_table(emb.item, item_ids, sink),
                          one_table(emb.cat, cat_ids, sink)], dim=-1)

    lookup.user = lambda emb, uid: one_table(emb.user, uid, sink)
    lookup.overflow_sink = sink
    return lookup


def local_bucketed_lookup_fn(mesh: Mesh, capacity_factor: float = 2.0,
                             table_grad_scale: float = 1.0) -> Callable:
    """The lookup of batch-over-model steps: ids are this rank's own
    queries (the batch sharded over data and model), the rows stay on this
    rank (:func:`_make_lookup`); every exchange appends its overflow flag
    to ``lookup.overflow_sink``."""
    s = mesh.n_model

    def one_table(table, ids, sink):
        flat = ids.reshape(-1)
        out = bucketed_gather(
            table, flat, mesh=mesh,
            capacity=_capacity(flat.shape[0], s, capacity_factor),
            table_grad_scale=table_grad_scale, sink=sink)
        return out.reshape(*ids.shape, table.shape[-1])

    return _make_lookup(one_table)


class _ReplicatedLookup(torch.autograd.Function):
    """Rows of the model-replicated ids ``flat``; the backward sums the
    cotangent rows of the ids this rank owns into its shard, locally."""

    @staticmethod
    def forward(ctx, table, flat, mesh, mode, capacity_factor, sink):
        ctx.mesh, ctx.rows_per = mesh, table.shape[0]
        ctx.save_for_backward(flat)
        if mode == "psum":
            return _owned_gather_psum(table, flat, mesh)
        padded = _padded(flat, mesh.n_model)
        out = _owned_gather_a2a(table, padded, mesh, capacity_factor, sink)
        return out[:flat.shape[0]]

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        local, mine = _owned(flat, ctx.mesh.model_index, ctx.rows_per)
        dt = _scatter_rows(torch.where(mine[:, None], g, 0.0), local,
                           ctx.rows_per)
        return dt, None, None, None, None, None


def local_lookup_fn(mesh: Mesh, mode: str = "psum",
                    capacity_factor: float = 2.0) -> Callable:
    """The lookup of replicated-batch steps: every rank of a model group
    holds the same ids (the batch sharded over data only) and gets the
    complete rows, through ``psum`` or the replicated-ids ``a2a``. The
    backward is local (see :class:`_ReplicatedLookup`): each rank's
    cotangent is already the whole group's, so a collective transpose
    would count it n_model times. ``a2a`` exchanges append their overflow
    flag to ``lookup.overflow_sink``."""
    if mode not in ("psum", "a2a"):
        raise ValueError(f"unknown embedding mode {mode!r}")

    def one_table(table, ids, sink):
        flat = ids.reshape(-1)
        out = _ReplicatedLookup.apply(table, flat, mesh, mode,
                                      capacity_factor,
                                      sink if mode == "a2a" else None)
        return out.reshape(*ids.shape, table.shape[-1])

    return _make_lookup(one_table)


def make_sharded_lookup(mesh: Mesh, mode: str = "psum",
                        capacity_factor: float = 2.0) -> Callable:
    """JAX's drop-in for ``dense_lookup`` over a mesh: the ids of this
    rank's data shard (replicated over the model group) -> their complete
    rows. Without GSPMD this is :func:`local_lookup_fn`; the step averages
    the table gradients over the table group."""
    return local_lookup_fn(mesh, mode, capacity_factor)


def local_queries_lookup_fn(mesh: Mesh, mode: str = "psum",
                            capacity_factor: float = 2.0) -> Callable:
    """The eval lookup, for ids that differ on every rank (each rank
    scores its own rows): ``a2a`` is the bucketed exchange, ``psum`` the
    all_gather + psum pass. Both return the table's rows exactly, like
    every other lookup here."""
    if mode == "a2a":
        return local_bucketed_lookup_fn(mesh, capacity_factor)

    def one_table(table, ids, sink):
        out = _gather_all_psum(table, ids.reshape(-1), mesh)
        return out.reshape(*ids.shape, table.shape[-1])

    return _make_lookup(one_table)
