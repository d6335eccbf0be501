"""The configs the port serves and trains (every family of the JAX
package's: hpmn, dien, gru4rec, rum and bst among the driver configs, and
dnn, lstm, caser, shan and svdpp through ``model.name``), as frozen
dataclasses.

Counterpart of ``hpmn_tpu/configs/base.py``, which builds
``ml_collections.ConfigDict``s. Only the fields the forward, serving,
training-step and training-driver paths read are carried; their names and
values are the JAX config's, so a config dict saved by the JAX package maps
onto these one to one. ``train.train.apply_overrides`` applies the JAX
CLI's dotted ``key=value`` overrides to them, and :func:`config_to_dict`
and :func:`config_from_dict` carry them to and from the dict a serving
bundle's ``serving_config.json`` holds (JAX's ``cfg.to_dict()``).
``data_dir`` names a
directory of preprocessed ``<dataset>.npz`` files (the ``process_*`` CLIs
write them); empty, the driver trains on the synthetic task.

``model.dtype`` is float32 or bfloat16 (the parameters' dtype; float16,
which the JAX package also takes, raises ``NotImplementedError`` in
``models.model.check_supported``). Not carried: ``train.compilation_cache_dir`` (no compile cache to keep)
and ``train.compact_transfer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "hpmn"
    emb_dim: int = 16  # per id field; behaviour embedding = 2*emb_dim
    mem_dim: int = 32  # GRU memory/hidden width
    dtype: str = "float32"  # the parameters': float32 or bfloat16
    # Layer l (0-indexed) updates every hpmn_period**l steps.
    hpmn_layers: int = 3
    hpmn_period: int = 2
    use_hierarchical_scan: bool = True  # False = masked single-scan oracle
    # Name kept from the JAX config: selects the fused kernels, which here
    # are the hand-written CUDA ones (ops/cuda_gru.py, ops/cuda_readout.py).
    use_pallas: bool = False
    # The use_pallas scans' chain: "float32" or "bfloat16" (bf16 streams,
    # carry and gate ops, f32 sums; the JAX bench headline). The plain
    # paths ignore it, as in JAX.
    scan_dtype: str = "float32"
    assume_full_mask: bool = False  # no padding: the scan skips the mask
    # With assume_full_mask and hpmn_period > 1 on the use_pallas path: the
    # strided-output scan kernels (ops/cuda_gru_stride.py), off as in JAX.
    pallas_stride_outputs: bool = False
    readout_dim: int = 32
    tower_hidden: Tuple[int, ...] = (200, 80)
    # DIEN: the auxiliary next-behaviour loss and its weight in the total.
    dien_use_aux_loss: bool = True
    aux_weight: float = 1.0
    rum_slots: int = 8  # RUM's external memory slots
    # Caser: horizontal filters per window (2, 3, 4) and vertical filters.
    caser_hfilters: int = 4
    caser_vfilters: int = 4
    shan_recent: int = 10  # SHAN's short-term window
    # BST: post-LN blocks over [behaviours; target]; bst_heads must divide
    # 2*emb_dim. bst_attn_chunk > 0: the inner blocks' attention is an
    # online softmax over key chunks of that size (O(S*chunk) memory
    # instead of the dense O(S^2) scores); 0 is dense. bst_dtype
    # "bfloat16": bf16 matmul operands (f32 parameters, softmax and
    # layer-norm statistics, f32 sums in attention).
    bst_blocks: int = 1
    bst_heads: int = 2
    bst_ffn_mult: int = 4
    bst_attn_chunk: int = 0
    bst_dtype: str = "float32"
    # A [n_users, emb_dim] user table whose row of batch.uid the tower
    # reads after [target embedding; state].
    use_user_emb: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    cov_weight: float = 0.1  # HPMN slot decorrelation
    l2_weight: float = 1e-4  # sum of squares of every >=2-D parameter


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    lr: float = 1e-3
    # Optimizer options (train/optim.py); the defaults are plain Adam.
    lr_schedule: str = "constant"  # constant | cosine | exponential
    warmup_steps: int = 0  # linear 0 -> lr over this many updates
    decay_steps: int = 0  # schedule horizon; 0 = max_steps
    lr_min_ratio: float = 0.0  # end-of-decay lr as a fraction of lr
    grad_clip_norm: float = 0.0  # global-norm clip; 0 = off
    weight_decay: float = 0.0  # decoupled (adamw)
    grad_accum: int = 1  # micro-batches per parameter update
    ema_decay: float = 0.0  # >0: evaluate with an EMA shadow of the params
    max_steps: int = 2000
    eval_every: int = 200
    early_stop_patience: int = 5  # evals without a val-AUC improvement
    log_every: int = 50
    ckpt_dir: str = ""
    log_dir: str = ""  # tensorboard event files (train/events.py)
    keep_best_k: int = 3
    async_checkpoint: bool = False  # write snapshots on a thread
    profile_steps: int = 0  # >0: a torch.profiler trace of that many steps
    debug_nans: bool = False  # raise FloatingPointError at the first NaN
    # Train steps per driver dispatch. 0 is the JAX driver's startup probe,
    # which the port reads as 1. The port's multistep is a Python loop, so
    # k changes only the grouping of steps (log and eval boundaries).
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX mesh fields the driver reads (``parallel/``). A run of
    several ranks (``python -m torch.distributed.run``) trains over a
    (data, model) grid of them, with the embedding tables row-sharded over
    ``model_parallel`` ranks, or with ``seq_parallel > 1`` over a (data,
    seq) or (data, seq, model) grid, the long scans' T axis sharded over
    ``seq_parallel`` ranks (``parallel/seq_parallel.py``); one process
    trains on one device whatever these say, as the JAX driver on one
    device."""

    enable: bool = True
    model_parallel: int = 1
    # replicated | psum | a2a; the driver resolves replicated to a2a (with
    # batch_over_model) or psum when model_parallel > 1.
    embedding_mode: str = "replicated"
    # a2a only: shard the batch over data and model, not data alone.
    batch_over_model: bool = True
    # The a2a buckets' capacity factor; 0 = derived from the training ids
    # at startup (train.resolve_capacity_factor).
    a2a_capacity_factor: float = 0.0
    seq_parallel: int = 1
    # The SP pipeline's microbatches (bubble (S-1)/(MB+S-1)), the chunk
    # below which a scan runs whole on every seq rank, and the chunk scan:
    # jnp (the plain scan) or pallas (the CUDA scan kernels).
    sp_microbatches: int = 4
    sp_min_local_steps: int = 8
    sp_inner: str = "jnp"


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 0
    dataset: str = "amazon"  # amazon | taobao | xlong
    synthetic_task: str = "ctr"  # ctr | periodic (planted long-range task)
    n_examples: int = 20000  # synthetic dataset size
    data_dir: str = ""  # if set, load preprocessed real arrays from here
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    eval_batch_size: int = 256
    # Eval batches per call in the JAX driver; the port scores batch by
    # batch for any value, with the same numbers.
    eval_steps_per_dispatch: int = 0
    eval_streaming_bins: int = 0  # >0: bounded-memory histogram AUC/GAUC
    eval_gauc_bins: int = 256  # streaming GAUC's per-user bins; 0 = off
    eval_gauc_max_users: int = 0  # >0: hash-cap the streaming GAUC's users

    def with_model(self, **changes) -> "Config":
        """A copy with ``model`` fields replaced."""
        return dataclasses.replace(
            self, model=dataclasses.replace(self.model, **changes))


def amazon_hpmn() -> Config:
    """T=100, one memory layer (hpmn_tpu configs/base.py amazon_hpmn)."""
    return Config(dataset="amazon",
                  model=ModelConfig(hpmn_layers=1, hpmn_period=4),
                  loss=LossConfig(l2_weight=1e-4),
                  train=TrainConfig(steps_per_dispatch=0))


def taobao_hpmn() -> Config:
    """T=300, three layers of period 10 (hpmn_tpu taobao_hpmn)."""
    return Config(dataset="taobao",
                  model=ModelConfig(hpmn_layers=3, hpmn_period=10),
                  loss=LossConfig(l2_weight=1e-5),
                  train=TrainConfig(batch_size=512, steps_per_dispatch=0))


def xlong_hpmn() -> Config:
    """T=1000, six layers of period 3: scans of 1000, 333, 111, 37, 12 and
    4 steps (hpmn_tpu xlong_hpmn)."""
    return Config(dataset="xlong",
                  model=ModelConfig(hpmn_layers=6, hpmn_period=3),
                  loss=LossConfig(l2_weight=1e-5),
                  train=TrainConfig(batch_size=512, steps_per_dispatch=0))


def taobao_dien() -> Config:
    """DIEN (GRU, then the attention-gated AUGRU) on Taobao, T=300
    (hpmn_tpu taobao_dien: the taobao base keeps its hpmn_layers 5 and
    period 3, which DIEN does not read)."""
    return Config(dataset="taobao",
                  model=ModelConfig(name="dien", hpmn_layers=5,
                                    hpmn_period=3),
                  loss=LossConfig(l2_weight=1e-5),
                  train=TrainConfig(batch_size=512, steps_per_dispatch=0))


def taobao_bst() -> Config:
    """BST, one post-LN block with dense attention, on Taobao, T=300, B 256
    (hpmn_tpu taobao_bst: the taobao base keeps its hpmn_layers 5 and
    period 3, which BST does not read)."""
    return Config(dataset="taobao",
                  model=ModelConfig(name="bst", hpmn_layers=5,
                                    hpmn_period=3),
                  loss=LossConfig(l2_weight=1e-5),
                  train=TrainConfig(batch_size=256, steps_per_dispatch=0))


def xlong_bst() -> Config:
    """BST on XLong, T=1000, B 256 (hpmn_tpu xlong_bst): the final block
    attends from the target position alone (O(T)), and the inner blocks,
    with bst_blocks > 1, through the online softmax over key chunks of
    128."""
    return Config(dataset="xlong",
                  model=ModelConfig(name="bst", hpmn_layers=6, hpmn_period=3,
                                    bst_attn_chunk=128),
                  loss=LossConfig(l2_weight=1e-5),
                  train=TrainConfig(batch_size=256, steps_per_dispatch=0))


def _amazon_baseline(name: str) -> Config:
    """A target-independent baseline on Amazon, T=100 (hpmn_tpu
    amazon_rum and amazon_gru4rec: the amazon base keeps its hpmn_layers 4
    and period 4, which neither reads)."""
    return Config(dataset="amazon",
                  model=ModelConfig(name=name, hpmn_layers=4, hpmn_period=4),
                  loss=LossConfig(l2_weight=1e-4),
                  train=TrainConfig(steps_per_dispatch=0))


def amazon_rum() -> Config:
    """RUM, the external-memory baseline, on Amazon (hpmn_tpu amazon_rum)."""
    return _amazon_baseline("rum")


def amazon_gru4rec() -> Config:
    """GRU4Rec, the RNN baseline, on Amazon (hpmn_tpu amazon_gru4rec)."""
    return _amazon_baseline("gru4rec")


_CONFIGS = {
    "amazon_hpmn": amazon_hpmn,
    "taobao_hpmn": taobao_hpmn,
    "xlong_hpmn": xlong_hpmn,
    "taobao_dien": taobao_dien,
    "amazon_rum": amazon_rum,
    "amazon_gru4rec": amazon_gru4rec,
    "taobao_bst": taobao_bst,
    "xlong_bst": xlong_bst,
}


def list_configs():
    return sorted(_CONFIGS)


def get_config(name: str) -> Config:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {list_configs()}")
    return _CONFIGS[name]()


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    """The config as nested dicts of the JAX field names, tuples as lists:
    what ``serving_config.json`` holds, and what the JAX package's
    ``ml_collections.ConfigDict`` reads back."""

    def plain(v):
        if dataclasses.is_dataclass(v):
            return {f.name: plain(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        return list(v) if isinstance(v, tuple) else v

    return plain(cfg)


def _from_dict(cls, d: Dict[str, Any]):
    """An instance of the dataclass ``cls`` from the fields of ``d`` it
    carries, each cast to its default's type; the others are dropped."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        default, v = getattr(cls(), f.name), d[f.name]
        if dataclasses.is_dataclass(default):
            v = _from_dict(type(default), v)
        elif isinstance(default, tuple):
            v = tuple(int(x) for x in v)
        elif isinstance(default, (bool, int, float, str)):
            v = type(default)(v)
        kw[f.name] = v
    return cls(**kw)


def config_from_dict(d: Dict[str, Any]) -> Config:
    """A Config from a JAX ``cfg.to_dict()`` (or :func:`config_to_dict`):
    the fields the port carries, each at its default where ``d`` lacks it;
    the JAX fields the port does not carry are dropped."""
    return _from_dict(Config, d)
