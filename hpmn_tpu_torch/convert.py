"""JAX parameters -> the port's modules.

The input is the flat ``{keystr: np.ndarray}`` mapping of the JAX param tree
that ``hpmn_tpu/serving/lifelong.py::flatten_with_keys`` produces, which is
also what a serving bundle's ``params.npz`` holds. Keys and the port's
parameter names correspond one to one:

    ['embedding']['item']           embedding.item
    ['encoder']['layers'][0].wx     encoder.layers.0.wx   (GRUParams fields)
    ['readout']['wm']               readout.wm
    ['tower']['layers'][0]['w']     tower.layers.0.w

Every key must be consumed and every parameter filled, at its shape, or
:func:`model_from_flat` raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .configs import Config
from .models.model import HPMNModel, check_supported

_GRU_FIELDS = ("wx", "wh", "b")


def jax_key(name: str) -> str:
    """Port parameter name -> the JAX keystr of the same leaf."""
    parts = name.split(".")
    out = []
    for i, p in enumerate(parts):
        if p.isdigit():
            out.append(f"[{p}]")
        elif parts[0] == "encoder" and i == len(parts) - 1 \
                and p in _GRU_FIELDS:
            out.append(f".{p}")  # GRUParams is a NamedTuple: attribute keys
        else:
            out.append(f"['{p}']")
    return "".join(out)


def model_from_flat(cfg: Config, flat: Mapping[str, np.ndarray],
                    device="cuda") -> HPMNModel:
    """Build an ``HPMNModel`` for ``cfg`` holding the JAX arrays of
    ``flat``; the vocab sizes are read from the embedding tables."""
    check_supported(cfg)
    n_items = np.shape(flat["['embedding']['item']"])[0]
    n_cats = np.shape(flat["['embedding']['cat']"])[0]
    model = HPMNModel(cfg, n_items, n_cats)
    left = dict(flat)
    with torch.no_grad():
        for name, param in model.named_parameters():
            key = jax_key(name)
            if key not in left:
                raise KeyError(f"no JAX array for {name} (key {key})")
            arr = np.array(left.pop(key), dtype=np.float32)  # a writable copy
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{key}: shape {arr.shape}, the port's "
                                 f"{name} is {tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
    if left:
        raise KeyError(f"JAX arrays the port has no parameter for: "
                       f"{sorted(left)}")
    return model.to(device)
