"""Sequence parallelism — counterpart of
``hpmn_tpu/parallel/seq_parallel.py``: the T axis of the long GRU scans
sharded over the seq group of ranks, with a microbatch-pipelined carry
handoff.

Every rank of a seq group (``mesh.py``: the ranks of one (data, model)
cell) holds the same examples and owns one contiguous chunk of ``T_loc = T
/ n_seq`` steps. A GRU is sequential in T, so chunk s cannot start before
chunk s-1's final carry exists; the batch is split into MB microbatches
(MB the largest divisor of B not above ``microbatches``) and at pipeline
tick k rank s scans microbatch ``j = k - s`` over its chunk from the carry
it received, then hands its exit carry to rank s+1. Rank 0 receives
zeros, the carry at the start of every sequence. After MB + n_seq - 1
ticks every microbatch has crossed every chunk (bubble (n_seq-1)/(MB +
n_seq - 1)); a rank skips the compute of its bubble ticks but takes part
in every handoff. The chunks' outputs are gathered along T in rank order,
and h_T is the last rank's exit states summed over the group (zeros
elsewhere). A scan whose T does not split (``T % n_seq``) or whose chunks
would be shorter than ``min_local_steps`` runs whole on every rank, as in
JAX: replicated, exact.

**Gradients.** Each rank's backward seeds its own replica of the loss, and
the collectives transpose as JAX's do under ``shard_map(...,
check_vma=False)``: the handoff (a shift to s+1, zeros into rank 0) to a
shift of the cotangent to s-1 (zeros into the last rank); the gather
along T to a reduce-scatter (chunk s's cotangent summed over the group);
the h_T sum to a sum. Every sequence-sharded part of the graph then
carries the factor n_seq and every replicated part 1, so that a uniform
mean of the gradients over seq (``make_sp_steps``,
``train_step.make_shardmap_steps``) is exact on both. The three
``torch.autograd.Function``s: :class:`PipelinedScan` (the ticks with
their handoffs, whose backward runs the ticks in reverse with the
transposed handoffs), :class:`SeqGather` and :class:`SeqSum`. The
handoffs live inside one Function because autograd runs only the nodes
that reach the loss: a rank whose bubble leaves a received carry unused
would skip that handoff's transpose, and the group's collectives would
fall out of step; written out, every rank calls the same collectives in
the same order, forward and backward.

**Transport.** Every collective runs on CUDA tensors over NCCL and over
gloo (several ranks on one card), as the lookups' do: the handoff is the
list form of ``all_gather`` on the seq group (each rank keeps its
neighbour's carry: at Bm = 128, 16 KiB), the gather the same along T, its
transpose an ``all_to_all_single`` and the sum an ``all_reduce``. Each
runs under a profiler span, ``seq_handoff`` or ``seq_gather``, after the
wait for the rank's queued kernels under ``seq_queue_wait`` (gloo with
CUDA tensors, ``embedding_sharding._exchange``).

**The chunk scan.** ``mesh.sp_inner`` (:func:`resolve_sp_fn`): ``jnp``,
the plain ``ops/gru.py::gru_sequence`` under autograd; ``pallas``, the
CUDA scan kernels through ``ops/cuda_gru.py::gru_sequence`` (K1 and K2;
with the all-ones gate scale that the T-sharded chunks carry, as JAX
fills one in, K1-scale and K2-scale, from the received h0 and returning
dh0), their plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import cuda_gru
from ..ops.gru import GRUParams, GRUWeights, gru_sequence
from .embedding_sharding import _all_reduce, _all_to_all, _exchange
from .mesh import SEQ_AXIS, Mesh, make_mesh

__all__ = ["SEQ_AXIS", "make_sp_mesh", "sp_gru_sequence", "sp_gru_seq_fn",
           "resolve_sp_fn", "make_sp_steps"]


def make_sp_mesh(seq_parallel: int = 1) -> Mesh:
    """The (data, seq) grid of the process group's ranks, seq innermost
    (neighbouring time chunks on neighbouring ranks): ``make_mesh(1,
    seq_parallel)``. Collective: every rank calls it."""
    return make_mesh(1, seq_parallel)


# --- the seq group's collectives ----------------------------------------

def _run(span: str, collective: Callable, t: torch.Tensor, mesh: Mesh,
         *args):
    return _exchange(collective, t, mesh.seq_group, *args, span=span,
                     wait_span="seq_queue_wait")


def _gather_parts(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    """Every rank's t, in rank order (the list form of ``all_gather``,
    which gloo takes for CUDA tensors)."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _shift(t: torch.Tensor, mesh: Mesh, step: int) -> torch.Tensor:
    """The handoff: rank s gets rank (s - step)'s t, zeros where there is
    no such rank (step +1 forward: into rank 0; -1, the transpose: into
    the last rank)."""
    parts = _run("seq_handoff", _gather_parts, t, mesh, mesh.n_seq)
    src = mesh.seq_index - step
    return parts[src] if 0 <= src < mesh.n_seq else torch.zeros_like(t)


def _gather_time(chunk: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return torch.cat(_run("seq_gather", _gather_parts, chunk, mesh,
                          mesh.n_seq), dim=1)


def _sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _run("seq_gather", _all_reduce, t.clone(), mesh)


class SeqGather(torch.autograd.Function):
    """[B, T_loc, d] chunks -> [B, n_seq * T_loc, d] in rank order (JAX's
    tiled ``all_gather`` along T); backward: the reduce-scatter, each
    rank's cotangent of chunk s summed over the group into rank s."""

    @staticmethod
    def forward(ctx, chunk, mesh):
        ctx.mesh = mesh
        return _gather_time(chunk, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        B, T, d = g.shape
        by_chunk = g.reshape(B, mesh.n_seq, T // mesh.n_seq, d) \
            .transpose(0, 1).contiguous()
        return _run("seq_gather", _all_to_all, by_chunk, mesh).sum(0), None


class SeqSum(torch.autograd.Function):
    """The sum over the seq group (JAX's ``psum``), and its transpose."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _sum(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


class _Schedule:
    """One call's constants: the mesh, the chunk scan, MB microbatches of
    Bm rows."""

    def __init__(self, mesh: Mesh, inner: Callable, mb: int, bm: int):
        self.mesh, self.inner, self.mb, self.bm = mesh, inner, mb, bm

    @property
    def ticks(self) -> int:
        return self.mb + self.mesh.n_seq - 1

    def rows(self, k: int) -> Optional[slice]:
        """The rows of the microbatch this rank scans at tick k, None at
        a bubble tick."""
        j = k - self.mesh.seq_index
        return slice(j * self.bm, (j + 1) * self.bm) \
            if 0 <= j < self.mb else None


def _pipeline(sc: _Schedule, xc, mc, ac, w, saved=None):
    """The forward ticks over this rank's chunk (xc [B, T_loc, d_in], mc
    and ac [B, T_loc]) -> (the chunk's states [B, T_loc, d_m], the exit
    states [B, d_m]: the last rank's, zeros elsewhere). With ``saved`` (a
    dict), each active tick's scan runs on leaves that require grad and
    its graph is kept there, by tick, for the backward."""
    mesh = sc.mesh
    d_m = w.wh.shape[0]
    last = mesh.seq_index == mesh.n_seq - 1
    h_in = xc.new_zeros(sc.bm, d_m)
    outs = [None] * sc.mb
    exits = [xc.new_zeros(sc.bm, d_m)] * sc.mb
    for k in range(sc.ticks):
        rows = sc.rows(k)
        if rows is None:
            send = xc.new_zeros(sc.bm, d_m)
        else:
            if saved is None:
                h_seq, h_out = sc.inner(w, xc[rows], h0=h_in, mask=mc[rows],
                                        gate_scale=ac[rows])
            else:
                with torch.enable_grad():
                    wl = GRUWeights(*(t.detach().requires_grad_(
                        t.requires_grad) for t in w))
                    x_l = xc[rows].detach().requires_grad_(xc.requires_grad)
                    h_l = h_in.detach().requires_grad_()
                    a_l = ac[rows].detach().requires_grad_(ac.requires_grad)
                    h_seq, h_out = sc.inner(wl, x_l, h0=h_l, mask=mc[rows],
                                            gate_scale=a_l)
                saved[k] = (h_seq, h_out, wl, x_l, h_l, a_l)
                h_seq, h_out = h_seq.detach(), h_out.detach()
            outs[rows.start // sc.bm] = h_seq
            if last:
                exits[rows.start // sc.bm] = h_out
            send = h_out
        if k < sc.ticks - 1:
            h_in = _shift(send, mesh, +1)
    return torch.cat(outs), torch.cat(exits)


class PipelinedScan(torch.autograd.Function):
    """The ticks of :func:`_pipeline` with their handoffs. Backward runs
    the ticks in reverse: an active tick's cotangents (its rows of the
    chunk's, and for its exit carry the cotangent handed back by rank s+1,
    plus the exit states' on the last rank) through its kept graph give
    its rows of dx and dscale, its weight gradients and the cotangent of
    the carry it received, which the transposed handoff gives to rank
    s-1."""

    @staticmethod
    def forward(ctx, sc, xc, mc, ac, wx, wh, b):
        ctx.sc, ctx.saved = sc, {}
        return _pipeline(sc, xc, mc, ac, GRUWeights(wx, wh, b), ctx.saved)

    @staticmethod
    def backward(ctx, d_out, d_exit):
        sc, saved = ctx.sc, ctx.saved
        mesh = sc.mesh
        last = mesh.seq_index == mesh.n_seq - 1
        need_x, need_a = ctx.needs_input_grad[1], ctx.needs_input_grad[3]
        dx = da = dw = None
        d_send = None
        for k in reversed(range(sc.ticks)):
            rows = sc.rows(k)
            if d_send is None:  # no handoff after the last tick
                d_send = d_out.new_zeros(sc.bm, d_out.shape[-1])
            if rows is None:
                d_h_in = torch.zeros_like(d_send)
            else:
                h_seq, h_out, wl, x_l, h_l, a_l = saved.pop(k)
                g_exit = d_send + d_exit[rows] if last else d_send
                leaves = [*wl, x_l, h_l, a_l]
                want = [t for t in leaves if t.requires_grad]
                grads = dict(zip(map(id, want), torch.autograd.grad(
                    (h_seq, h_out), want, (d_out[rows], g_exit),
                    allow_unused=True)))
                got = [grads.get(id(t)) for t in leaves]
                got = [torch.zeros_like(t) if g is None and t.requires_grad
                       else g for g, t in zip(got, leaves)]
                dw = got[:3] if dw is None else [
                    a if g is None else a + g for a, g in zip(dw, got[:3])]
                if need_x:
                    if dx is None:
                        dx = d_out.new_zeros(*d_out.shape[:2],
                                             x_l.shape[-1])
                    dx[rows] = got[3]
                if need_a:
                    if da is None:
                        da = d_out.new_zeros(d_out.shape[:2])
                    da[rows] = got[5]
                d_h_in = got[4]
            d_send = _shift(d_h_in, mesh, -1) if k > 0 else None
        ctx.saved = None
        return (None, dx, None, da, *[g if n else None for g, n in
                                      zip(dw, ctx.needs_input_grad[4:])])


def _microbatches(B: int, microbatches: int) -> int:
    """The largest divisor of B not above ``microbatches`` (at least 1)."""
    mb = max(1, min(microbatches, B))
    while B % mb:
        mb -= 1
    return mb


def sp_gru_sequence(params: GRUParams, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    gate_scale: Optional[torch.Tensor] = None, *,
                    n_shards: int, mesh: Optional[Mesh] = None,
                    microbatches: int = 4, min_local_steps: int = 8,
                    inner: Optional[Callable] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The T-sharded scan on this rank of ``mesh``'s seq group (JAX's
    ``axis_name``; ``n_shards`` = its ``n_seq``). x [B, T, d_in], the same
    on every rank of the group -> (h_seq [B, T, d_m], h_T [B, d_m]), the
    same on every rank. Every rank of the group calls it, in the same
    order as its other collectives. Falls back to ``inner`` on the whole
    sequence when T does not split or the chunks would be under
    ``min_local_steps``.

    inner: the chunk scan, ``gru_sequence``'s signature (params, x, h0=,
    mask=, gate_scale=) -> (h_seq, h_T); default the plain scan. The
    chunks get the mask (all ones when None) and the gate scale (all ones
    when None), as in JAX."""
    if inner is None:
        inner = gru_sequence
    B, T, _ = x.shape
    T_loc = T // n_shards
    if n_shards == 1 or T % n_shards or T_loc < min_local_steps:
        return inner(params, x, mask=mask, gate_scale=gate_scale)
    if mesh is None or mesh.n_seq != n_shards:
        raise ValueError(f"n_shards={n_shards} needs a mesh with that many "
                         "seq ranks")
    if mask is None:
        mask = x.new_ones(B, T)
    if gate_scale is None:
        gate_scale = x.new_ones(B, T)
    mb = _microbatches(B, microbatches)
    sc = _Schedule(mesh, inner, mb, B // mb)
    lo = mesh.seq_index * T_loc
    xc, mc, ac = (t[:, lo:lo + T_loc] for t in (x, mask, gate_scale))
    w = (params.wx, params.wh, params.b)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, ac, *w)):
        out, exits = PipelinedScan.apply(sc, xc, mc, ac, *w)
        return SeqGather.apply(out, mesh), SeqSum.apply(exits, mesh)
    out, exits = _pipeline(sc, xc, mc, ac, GRUWeights(*w))
    return _gather_time(out, mesh), _sum(exits, mesh)


def sp_gru_seq_fn(n_shards: int, microbatches: int = 4,
                  min_local_steps: int = 8, inner: Optional[Callable] = None,
                  mesh: Optional[Mesh] = None) -> Callable:
    """A ``gru_seq_fn`` ((params, x, mask, gate_scale=None) -> (h_seq,
    h_T)) for ``apply_model`` on the ranks of ``mesh``: every batch-major
    scan through :func:`sp_gru_sequence`."""
    def fn(p, xs, m, a=None):
        return sp_gru_sequence(p, xs, mask=m, gate_scale=a,
                               n_shards=n_shards, mesh=mesh,
                               microbatches=microbatches,
                               min_local_steps=min_local_steps, inner=inner)
    return fn


def resolve_sp_fn(cfg, n_shards: int, mesh: Optional[Mesh] = None
                  ) -> Callable:
    """The SP ``gru_seq_fn`` of the config: the one place
    ``mesh.sp_inner`` is read, so that an unknown value raises on every
    path. ``pallas``: the CUDA scan kernels (``cuda_gru.gru_sequence``,
    batch-major over time-major copies); ``jnp``: the plain scan."""
    sp_inner = cfg.mesh.sp_inner
    if sp_inner == "pallas":
        inner = cuda_gru.gru_sequence
    elif sp_inner == "jnp":
        inner = None
    else:
        raise ValueError(f"unknown mesh.sp_inner {sp_inner!r}")
    return sp_gru_seq_fn(n_shards, microbatches=cfg.mesh.sp_microbatches,
                         min_local_steps=cfg.mesh.sp_min_local_steps,
                         inner=inner, mesh=mesh)


def make_sp_steps(cfg, model, opt, mesh: Mesh):
    """-> (train_step, eval_step) of this rank of a (data, seq) grid
    (:func:`make_sp_mesh`), as JAX's ``make_sp_steps``: every parameter
    replicated, the batch sharded over data and replicated over seq (each
    rank takes its data row's rows, ``mesh.shard_batch``), the long scans
    T-sharded over the seq group; gradients and metrics meaned over every
    rank. ``train_step`` takes one batch or a list of k (``fuse_steps``);
    ``eval_step(model, batch)`` -> the logits of the data row's rows.
    The step is ``train_step.make_shardmap_steps`` on this grid."""
    from .train_step import make_shardmap_steps

    if cfg.mesh.embedding_mode != "replicated":
        raise ValueError("make_sp_steps requires replicated embedding "
                         "tables (mesh axes are (data, seq))")
    if cfg.model.use_pallas:
        raise ValueError("make_sp_steps drives the scans via gru_seq_fn; "
                         "the use_pallas time-major path ignores gru_seq_fn "
                         "— set model.use_pallas=False and pick the kernel "
                         "with mesh.sp_inner='pallas' instead")
    if mesh.n_model != 1:
        raise ValueError("make_sp_steps takes a (data, seq) grid "
                         "(make_sp_mesh); tables sharded over a model "
                         "group take make_shardmap_steps")
    return make_shardmap_steps(cfg, model, opt, mesh)
