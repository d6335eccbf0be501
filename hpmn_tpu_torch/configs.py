"""The hpmn configs the port serves, as frozen dataclasses.

Counterpart of ``hpmn_tpu/configs/base.py``, which builds
``ml_collections.ConfigDict``s. Only the fields the forward and serving path
read are carried; their names and values are the JAX config's, so a config
dict saved by the JAX package maps onto these one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "hpmn"
    emb_dim: int = 16  # per id field; behaviour embedding = 2*emb_dim
    mem_dim: int = 32  # GRU memory/hidden width
    dtype: str = "float32"
    # Layer l (0-indexed) updates every hpmn_period**l steps.
    hpmn_layers: int = 3
    hpmn_period: int = 2
    use_hierarchical_scan: bool = True  # False = masked single-scan oracle
    # Name kept from the JAX config: selects the fused kernels, which here
    # are the hand-written CUDA ones (ops/cuda_gru.py, ops/cuda_readout.py).
    use_pallas: bool = False
    scan_dtype: str = "float32"  # only float32 is ported
    assume_full_mask: bool = False  # no padding: the scan skips the mask
    pallas_stride_outputs: bool = False  # strided-output kernel: not ported
    readout_dim: int = 32
    tower_hidden: Tuple[int, ...] = (200, 80)
    use_user_emb: bool = False  # not ported


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 0
    dataset: str = "amazon"
    model: ModelConfig = ModelConfig()

    def with_model(self, **changes) -> "Config":
        """A copy with ``model`` fields replaced."""
        return dataclasses.replace(
            self, model=dataclasses.replace(self.model, **changes))


def amazon_hpmn() -> Config:
    """T=100, one memory layer (hpmn_tpu configs/base.py amazon_hpmn)."""
    return Config(dataset="amazon",
                  model=ModelConfig(hpmn_layers=1, hpmn_period=4))


def taobao_hpmn() -> Config:
    """T=300, three layers of period 10 (hpmn_tpu taobao_hpmn)."""
    return Config(dataset="taobao",
                  model=ModelConfig(hpmn_layers=3, hpmn_period=10))


def xlong_hpmn() -> Config:
    """T=1000, six layers of period 3: scans of 1000, 333, 111, 37, 12 and
    4 steps (hpmn_tpu xlong_hpmn)."""
    return Config(dataset="xlong",
                  model=ModelConfig(hpmn_layers=6, hpmn_period=3))


_CONFIGS = {
    "amazon_hpmn": amazon_hpmn,
    "taobao_hpmn": taobao_hpmn,
    "xlong_hpmn": xlong_hpmn,
}


def list_configs():
    return sorted(_CONFIGS)


def get_config(name: str) -> Config:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {list_configs()}"
                       " (the other families wait, see ROADMAP.md)")
    return _CONFIGS[name]()
