"""The sharded training step — counterpart of
``hpmn_tpu/parallel/train_step.py``.

JAX maps the whole step over the mesh with ``shard_map``: every device
runs the model on its local batch shard and its local table shard, the
embedding exchange is the in-map collective lookup, dense gradients are
averaged over ("data", "model") and the row-sharded table gradients over
"data" only. Here every rank is one of those devices and the step is
written out:

1. forward and backward on this rank's rows (``loss_fn`` with the sharded
   lookup; with ``use_pallas`` the scans and the readout are the CUDA
   kernels on this rank's shard, as in a single-device step);
2. dense gradients summed over every rank and divided by their number,
   table gradients likewise over the table group (the ranks of the model
   column: JAX's ``table_axes``, "data", with a seq axis "data" and
   "seq");
3. ``a2a_overflow`` max-reduced over every rank; with ``l2_weight > 0``
   and a model group of more than one rank the l2 metric (and the loss
   metric) rebuilt from ``l2_parts``, the table part summed over the model
   group;
4. the optimizer's update; with clipping, the global norm sums the table
   shards' squares over the model group (GSPMD's clip, not the shard_map
   step's per-shard one);
5. the metrics averaged over every rank.

Not ``DistributedDataParallel``: it would average the table shards over
every rank. With ``batch_over_model`` (a2a only) the batch is sharded over
data and model, the lookup is the bucketed exchange and its backward
scales the table gradient by 1/n_model, so that the exchange's sum over
the model group's sources and the data-group mean make the global mean.

On a (data, seq, model) grid (``make_mesh(model_parallel, seq_parallel)``)
the seq axis owns the scans: the batch-major scans run T-sharded over the
seq group (``seq_parallel.resolve_sp_fn``, ``mesh.sp_inner``), and the
means over every rank and over the table group take in the seq ranks,
which is exact for the sequence-sharded and the replicated parts of the
graph alike (``seq_parallel.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..configs import Config
from ..data.schema import Batch
from ..models.losses import l2_parts
from ..models.model import apply_model, init_model, loss_fn
from .embedding_sharding import (_all_gather, _all_reduce,
                                 local_bucketed_lookup_fn, local_lookup_fn,
                                 local_queries_lookup_fn, pad_vocab)
from .mesh import Mesh, is_row_sharded


def batch_over_model(cfg: Config, mesh: Mesh) -> bool:
    """Whether the step shards the batch over data and model: the config
    asks for it, the tables are sharded, and the exchange is a2a (psum
    needs the ids replicated over the model group)."""
    return (cfg.mesh.batch_over_model and mesh.n_model > 1
            and cfg.mesh.embedding_mode == "a2a")


def table_names(model: nn.Module) -> List[str]:
    return [n for n, p in model.named_parameters() if is_row_sharded(n, p)]


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's rows of every row-sharded table (their row counts
    divisible by n_model), in place."""
    s, m = mesh.n_model, mesh.model_index
    for name in table_names(model):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        full = getattr(mod, attr)
        if full.shape[0] % s:
            raise ValueError(f"{name} has {full.shape[0]} rows, not a "
                             f"multiple of model_parallel={s} (pad_vocab)")
        rows = full.shape[0] // s
        setattr(mod, attr, nn.Parameter(full[m * rows:(m + 1) * rows]
                                        .clone()))
    return model


def init_sharded_model(cfg: Config, n_items: int, n_cats: int, mesh: Mesh,
                       n_users: int = 0, seed: Optional[int] = None,
                       device="cuda") -> nn.Module:
    """``init_model`` with the vocab padded to a multiple of n_model (the
    user table's too), drawn whole on the CPU from the seed (the same on
    every rank), then this rank's table rows kept (:func:`shard_model`)
    and moved to ``device``."""
    s = mesh.n_model
    model = init_model(cfg, pad_vocab(n_items, s), pad_vocab(n_cats, s),
                       seed=seed, device="cpu",
                       n_users=pad_vocab(n_users, s))
    return shard_model(model, mesh).to(device)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A table shard [R, ...] -> the whole table [n_model*R, ...] on every
    rank of the model group."""
    return _all_gather(t, mesh.model_group, mesh.n_model)


def _row_slice(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    rows = t.shape[0] // mesh.n_model
    return t[mesh.model_index * rows:(mesh.model_index + 1) * rows].clone()


def gather_params(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """{name: the whole parameter} (tables gathered) on every rank."""
    tables = set(table_names(model))
    return {n: (gather_rows(p.detach(), mesh) if n in tables
                else p.detach()) for n, p in model.named_parameters()}


def _map_tables(model: nn.Module, model_state: Dict, opt_state: Dict,
                fn: Callable) -> Tuple[Dict, Dict]:
    """Apply ``fn`` to every table-shaped tensor of a model state_dict and
    an ``Optimizer.state_dict()`` (the inner Adam moments, the accumulator
    and the EMA shadow of each table), others kept."""
    tables = set(table_names(model))
    model_state = {n: fn(t) if n in tables else t
                   for n, t in model_state.items()}
    if opt_state is None:
        return model_state, None
    idx = [i for i, (n, _) in enumerate(model.named_parameters())
           if n in tables]
    inner = dict(opt_state["inner"])
    state = dict(inner["state"])
    for i in idx:
        if i in state:
            state[i] = {k: fn(v) if isinstance(v, torch.Tensor)
                        and v.dim() >= 2 else v for k, v in state[i].items()}
    inner["state"] = state
    out = dict(opt_state, inner=inner)
    for key in ("acc", "ema"):
        if out.get(key) is not None:
            out[key] = [fn(t) if i in idx else t
                        for i, t in enumerate(out[key])]
    return model_state, out


def gather_state(model: nn.Module, opt, mesh: Mesh) -> Tuple[Dict, Dict]:
    """(model state_dict, optimizer state_dict) with every table whole:
    the single-device checkpoint format (padded rows). Collective: every
    rank calls it."""
    return _map_tables(model, model.state_dict(),
                       None if opt is None else opt.state_dict(),
                       lambda t: gather_rows(t, mesh))


def shard_state(model: nn.Module, model_state: Dict, opt_state: Dict,
                mesh: Mesh) -> Tuple[Dict, Dict]:
    """The inverse of :func:`gather_state`: this rank's rows of every
    table of a whole-table checkpoint."""
    return _map_tables(model, model_state, opt_state,
                       lambda t: _row_slice(t, mesh))


def sharded_grad_sq_norm(model: nn.Module, mesh: Mesh) -> Callable:
    """() -> the squared global norm of the model's gradients: the dense
    parameters' squares (replicated) plus the table shards' summed over
    the model group."""
    tables = set(table_names(model))
    named = list(model.named_parameters())

    def sq_norm():
        dense = [p.grad.square().sum() for n, p in named
                 if n not in tables and p.grad is not None]
        table = [p.grad.square().sum() for n, p in named
                 if n in tables and p.grad is not None]
        t = (torch.stack(table).sum() if table
             else torch.zeros((), device=named[0][1].device))
        t = _all_reduce(t.reshape(1), mesh.model_group).reshape(())
        return (torch.stack(dense).sum() if dense else 0.0) + t

    return sq_norm


def _mean_(tensors: Sequence[torch.Tensor], group, n: int) -> None:
    """pmean in place: one flat buffer summed over ``group``, / n."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_shardmap_steps(cfg: Config, model: nn.Module, opt, mesh: Mesh,
                        gru_seq_fn: Optional[Callable] = None,
                        ) -> Tuple[Callable, Callable]:
    """-> (train_step, eval_step) of this rank (see the module docstring).

    ``train_step(batch)`` takes this rank's rows (``mesh.shard_batch``) and
    runs one step; ``train_step([b1, ..., bk])`` runs k, and returns the
    last step's metrics with ``a2a_overflow`` summed over the k steps (JAX's
    ``fuse_steps``). ``opt`` has ``zero_grad()`` and ``step()`` (the
    port's ``Optimizer``, or a ``torch.optim`` optimizer over
    ``model.parameters()``). ``eval_step(model, batch)`` -> this rank's
    logits for its own rows (each rank scores different rows, so the
    eval lookup takes each rank's own queries; the ranks of a seq group
    score the same rows). ``gru_seq_fn`` as for ``loss_fn``; on a grid
    with a seq axis the seq group owns it, and one given raises, as does
    ``use_pallas`` (its time-major scans would not take it). With
    ``train.debug_nans`` the step checks what ``make_train_step`` checks,
    each check's flags merged over every rank, so that all raise together;
    the eval step checks this rank's logits."""
    from ..train.train import check_nans, fuse_steps
    from .seq_parallel import resolve_sp_fn

    n_model, world = mesh.n_model, mesh.size
    if mesh.n_seq > 1:
        if cfg.model.use_pallas:
            raise ValueError(
                "seq axis in the mesh drives the scans via gru_seq_fn; the "
                "use_pallas time-major path ignores it — set "
                "model.use_pallas=False (mesh.sp_inner='pallas' still runs "
                "the CUDA scan kernels inside the SP schedule)")
        if gru_seq_fn is not None:
            raise ValueError("gru_seq_fn is owned by the seq axis here")
        gru_seq_fn = resolve_sp_fn(cfg, mesh.n_seq, mesh)
    n_table = mesh.n_data * mesh.n_seq
    mode = cfg.mesh.embedding_mode
    cap_f = float(cfg.mesh.a2a_capacity_factor) or 2.0
    bom = batch_over_model(cfg, mesh)
    if bom:
        lookup = local_bucketed_lookup_fn(mesh, cap_f,
                                          table_grad_scale=1.0 / n_model)
    else:
        lookup = local_lookup_fn(mesh, mode, cap_f) if n_model > 1 else None
    eval_lookup = (local_queries_lookup_fn(mesh, mode, cap_f)
                   if n_model > 1 else None)
    tables = set(table_names(model))
    params = list(model.named_parameters())
    dense = [p for n, p in params if n not in tables]
    table = [p for n, p in params if n in tables]
    if n_model > 1 and cfg.train.grad_clip_norm > 0 \
            and hasattr(opt, "grad_sq_norm"):
        opt.grad_sq_norm = sharded_grad_sq_norm(model, mesh)
    l2_fix = cfg.loss.l2_weight > 0 and n_model > 1
    debug = cfg.train.debug_nans

    def any_rank(flags: torch.Tensor) -> torch.Tensor:
        return _all_reduce(flags, mesh.world_group, dist.ReduceOp.MAX)

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, cfg, batch, lookup=lookup,
                                gru_seq_fn=gru_seq_fn)
        if debug:
            check_nans("the forward's", [("loss", loss),
                                         ("logits", metrics["logits"])],
                       any_rank)
        loss.backward()
        del metrics["logits"]
        metrics = {k: v.detach() for k, v in metrics.items()}
        if "a2a_overflow" in metrics:
            # summed over the model group in the lookup; data rows run
            # their own exchanges: 1.0 iff any row fell back
            metrics["a2a_overflow"] = _all_reduce(
                metrics["a2a_overflow"].reshape(1), mesh.world_group,
                dist.ReduceOp.MAX).reshape(())
        if l2_fix:
            with torch.no_grad():  # the pre-update parameters', as loss_fn
                t_l2, d_l2 = l2_parts(model.named_parameters())
                l2 = d_l2 + _all_reduce(t_l2.reshape(1),
                                        mesh.model_group).reshape(())
            metrics["loss"] = metrics["loss"] + cfg.loss.l2_weight * (
                l2 - metrics["l2"])
            metrics["l2"] = l2
        for p in dense + table:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            _mean_([p.grad for p in dense], mesh.world_group, world)
            if n_table > 1:
                _mean_([p.grad for p in table], mesh.table_group, n_table)
        if debug:
            check_nans("the gradient of", ((n, p.grad) for n, p in params),
                       any_rank)
        opt.step()
        if debug:
            check_nans("the updated parameter", params, any_rank)
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        _mean_([vals], mesh.world_group, world)
        return dict(zip(keys, vals.unbind()))

    multistep = fuse_steps(step)

    def train_step(batches) -> Dict[str, torch.Tensor]:
        if isinstance(batches, Batch):
            return step(batches)
        return multistep(batches)

    def eval_step(model_: nn.Module, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = apply_model(model_, cfg, batch, lookup=eval_lookup,
                                    gru_seq_fn=gru_seq_fn)
        if debug:
            check_nans("the eval batch's", [("logits", logits)])
        return logits

    return train_step, eval_step


def make_sharded_steps(cfg: Config, model: nn.Module, opt, mesh: Mesh,
                       ) -> Tuple[Callable, Callable]:
    """JAX's GSPMD step. Torch has no GSPMD; the same explicit step as
    :func:`make_shardmap_steps`, which clips by the true global norm as the
    GSPMD step does."""
    return make_shardmap_steps(cfg, model, opt, mesh)
