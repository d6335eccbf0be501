"""Data, model and sequence parallelism over ``torch.distributed`` ranks
— counterpart of ``hpmn_tpu/parallel``: the bootstrap, the (data, model)
and (data, seq, model) grids of ranks, the row-sharded lookups, the
T-sharded pipelined scan and the sharded steps."""

from .distributed import initialize, is_primary
from .embedding_sharding import (bucketed_gather, local_bucketed_lookup_fn,
                                 local_lookup_fn, make_sharded_lookup,
                                 pad_vocab)
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, batch_sharding,
                   make_mesh, param_shardings, replicated, shard_batch)
from .seq_parallel import make_sp_mesh, make_sp_steps, sp_gru_sequence
from .train_step import (init_sharded_model, make_sharded_steps,
                         make_shardmap_steps)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "batch_sharding",
           "make_mesh", "param_shardings", "replicated", "shard_batch",
           "make_sharded_lookup", "local_lookup_fn", "pad_vocab",
           "bucketed_gather", "local_bucketed_lookup_fn",
           "init_sharded_model", "make_sharded_steps",
           "make_shardmap_steps", "make_sp_mesh", "make_sp_steps",
           "sp_gru_sequence", "initialize", "is_primary"]
