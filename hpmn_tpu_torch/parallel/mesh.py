"""The grid of ranks and its sharding rules — counterpart of
``hpmn_tpu/parallel/mesh.py``.

JAX lays its devices out as a ``Mesh`` with axes ("data", "model"), or
("data", "seq", "model") with sequence parallelism; here the ranks of the
process group are that grid, data-major with model innermost and seq
between: rank ``(d * n_seq + s) * n_model + m`` sits at data row ``d``,
seq index ``s``, model column ``m``. A :class:`Mesh` holds the process
groups the steps need:

- the **model group**: the ranks of this rank's (data, seq) cell, over
  which the embedding tables are row-sharded (JAX's "model" axis);
- the **seq group**: the ranks of this rank's (data, model) cell, which
  hold the same examples and split the long scans' T axis
  (``seq_parallel.py``; JAX's "seq" axis);
- the **table group**: the ranks of this rank's model column, which hold
  the same table rows and average their gradients (JAX's "data" axis,
  with sequence parallelism its ("data", "seq") axes).

Dense parameters are replicated on every rank; the rule for which
parameters are row-sharded is JAX's: every 2-D table under ``embedding``
(:func:`param_shardings`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..data.schema import Batch
from . import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
# JAX's PartitionSpecs, as tuples: the table rows over "model", the rest
# replicated.
ROW_SHARDED = (MODEL_AXIS, None)
REPLICATED = ()


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, seq, model) grid and its groups.
    Without a process group (one process) the groups are None and every
    collective of the port is skipped: the mesh is 1 x 1."""

    n_data: int
    n_model: int
    rank: int
    model_group: Any = None
    world_group: Any = None
    # A gloo group over every rank, for host-side merges (the eval merge,
    # barriers) whatever the step's backend is.
    cpu_group: Any = None
    n_seq: int = 1
    seq_group: Any = None
    table_group: Any = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_seq * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // (self.n_seq * self.n_model)

    @property
    def seq_index(self) -> int:
        return self.rank // self.n_model % self.n_seq

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        """JAX's ``mesh.shape``: (data, model), (data, seq) with sequence
        parallelism alone (``make_sp_mesh``), else (data, seq, model)."""
        if self.n_seq == 1:
            return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}
        if self.n_model == 1:
            return {DATA_AXIS: self.n_data, SEQ_AXIS: self.n_seq}
        return {DATA_AXIS: self.n_data, SEQ_AXIS: self.n_seq,
                MODEL_AXIS: self.n_model}


def make_mesh(model_parallel: int = 1, seq_parallel: int = 1) -> Mesh:
    """The ranks as a [world / (seq_parallel * model_parallel),
    seq_parallel, model_parallel] grid with its groups (see the module
    docstring). Every rank must call it, in the same order as its other
    group creations (``new_group`` is collective)."""
    world = distributed.process_count()
    per = model_parallel * seq_parallel
    if world % per:
        raise ValueError(f"{world} ranks not divisible by model_parallel*"
                         f"seq_parallel={per}")
    n_data = world // per
    rank = distributed.process_index()
    if not dist.is_initialized():
        return Mesh(n_data, model_parallel, rank, n_seq=seq_parallel)
    n_seq, n_model = seq_parallel, model_parallel

    def at(d, s, m):
        return (d * n_seq + s) * n_model + m

    def mine(cells):  # every rank creates every group, in order
        out = None
        for ranks in cells:
            g = dist.new_group(ranks)
            if rank in ranks:
                out = g
        return out

    model = mine([[at(d, s, m) for m in range(n_model)]
                  for d in range(n_data) for s in range(n_seq)])
    table = mine([list(range(m, world, n_model)) for m in range(n_model)])
    seq = None
    if n_seq > 1:
        seq = mine([[at(d, s, m) for s in range(n_seq)]
                    for d in range(n_data) for m in range(n_model)])
    cpu = (dist.group.WORLD if dist.get_backend() == "gloo"
           else dist.new_group(backend="gloo"))
    return Mesh(n_data, n_model, rank, model_group=model,
                world_group=dist.group.WORLD, cpu_group=cpu, n_seq=n_seq,
                seq_group=seq, table_group=table)


def is_row_sharded(name: str, param: torch.Tensor) -> bool:
    """JAX's rule (``mesh.py::param_shardings``): a 2-D leaf under
    ``embedding`` is row-sharded over the model group."""
    return "embedding" in name.split(".") and param.dim() == 2


def param_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, tuple]:
    """{parameter name: ROW_SHARDED or REPLICATED}."""
    return {n: ROW_SHARDED if is_row_sharded(n, p) else REPLICATED
            for n, p in model.named_parameters()}


def replicated(mesh: Mesh) -> tuple:
    return REPLICATED


def _shard_of(mesh: Mesh, over: Sequence[str]):
    """(shards, this rank's shard) of the example axis over ``over``; the
    seq ranks of a cell hold the same shard (the batch is replicated over
    seq)."""
    over = tuple(over)
    if over == (DATA_AXIS,):
        return mesh.n_data, mesh.data_index
    if over == (DATA_AXIS, MODEL_AXIS):
        return (mesh.n_data * mesh.n_model,
                mesh.data_index * mesh.n_model + mesh.model_index)
    raise ValueError(f"batches shard over ('data',) or ('data', 'model'), "
                     f"not {over}")


def batch_sharding(mesh: Mesh, stacked: bool = False,
                   over: Sequence[str] = (DATA_AXIS,)) -> Dict[str, tuple]:
    """Every Batch field's spec, as JAX's PartitionSpec entries: the
    example axis over ``over`` (after the k axis when ``stacked``), the
    time axis of the [B, T] fields unsharded."""
    lead = (None,) if stacked else ()
    ax = over[0] if len(over) == 1 else tuple(over)

    def spec(name):
        two_d = name.endswith("_seq") or name == "seq_mask"
        return lead + (ax,) + ((None,) if two_d else ())

    return {f.name: spec(f.name) for f in dataclasses.fields(Batch)}


def shard_batch(mesh: Mesh, batch, stacked: bool = False,
                over: Sequence[str] = (DATA_AXIS,)):
    """This rank's rows of its host's batch: the rows that JAX's
    ``P(("data",))`` (or ``P(("data", "model"))``) places on this device
    when every host contributes a batch of the same size (the global batch
    is the hosts' batches in host order); every rank of a seq group gets
    the same rows. ``stacked``: the fields carry a
    leading k axis, which is kept. A list of batches is sharded batch by
    batch."""
    if isinstance(batch, (list, tuple)):
        return [shard_batch(mesh, b, stacked, over) for b in batch]
    n_shards, index = _shard_of(mesh, over)
    axis = 1 if stacked else 0
    b_host = batch.item_seq.shape[axis]
    b_glob = b_host * distributed.host_count()
    if b_glob % n_shards:
        raise ValueError(f"global batch {b_glob} not divisible by the "
                         f"{n_shards} shards of {tuple(over)}")
    per = b_glob // n_shards
    lo = index * per - distributed.host_index() * b_host
    if lo < 0 or lo + per > b_host:
        raise ValueError(f"rank {mesh.rank}'s rows [{lo}, {lo + per}) lie "
                         f"outside its host's batch of {b_host}")
    return Batch(**{f.name: getattr(batch, f.name).narrow(axis, lo, per)
                    for f in dataclasses.fields(Batch)})
