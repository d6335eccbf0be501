"""Data and model parallelism over ``torch.distributed`` ranks —
counterpart of ``hpmn_tpu/parallel`` (all but ``seq_parallel.py``, the
next slice): the bootstrap, the (data, model) grid of ranks, the
row-sharded lookups and the sharded step."""

from .distributed import initialize, is_primary
from .embedding_sharding import (bucketed_gather, local_bucketed_lookup_fn,
                                 local_lookup_fn, make_sharded_lookup,
                                 pad_vocab)
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh,
                   param_shardings, replicated, shard_batch)
from .train_step import (init_sharded_model, make_sharded_steps,
                         make_shardmap_steps)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "batch_sharding", "make_mesh",
           "param_shardings", "replicated", "shard_batch",
           "make_sharded_lookup", "local_lookup_fn", "pad_vocab",
           "bucketed_gather", "local_bucketed_lookup_fn",
           "init_sharded_model", "make_sharded_steps",
           "make_shardmap_steps", "initialize", "is_primary"]
