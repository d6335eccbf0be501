"""JAX parameters <-> the port's modules.

The input is the flat ``{keystr: np.ndarray}`` mapping of the JAX param tree
that ``hpmn_tpu/serving/lifelong.py::flatten_with_keys`` produces, which is
also what a serving bundle's ``params.npz`` holds. Keys and the port's
parameter names correspond one to one:

    ['embedding']['item']           embedding.item
    ['embedding']['user']           embedding.user        (use_user_emb)
    ['encoder']['layers'][0].wx     encoder.layers.0.wx   (GRUParams fields)
    ['encoder']['augru'].b          encoder.augru.b       (DIEN's GRUs)
    ['encoder']['gru'].wh           encoder.gru.wh        (GRU4Rec's GRU)
    ['encoder']['beta']             encoder.beta          (RUM's, 0-d)
    ['encoder']['attn']['b']        encoder.attn.b        (a dict entry)
    ['encoder']['wx']               encoder.wx            (LSTM's, a dict)
    ['encoder']['hor'][0]           encoder.hor.0         (Caser's filters)
    ['encoder']['attn_long']['wm']  encoder.attn_long.wm  (SHAN's readouts)
    ['encoder']['p_u']              encoder.p_u           (SVD++'s users)
    ['encoder']['blocks'][0]['ln1']['g']  encoder.blocks.0.ln1.g  (BST)
    ['readout']['wm']               readout.wm
    ['tower']['layers'][0]['w']     tower.layers.0.w

A GRU's weights are fields of the NamedTuple ``GRUParams``, so their keys
are attributes; every other leaf is a dict entry, whatever its name.

Every key must be consumed and every parameter filled, at its shape, or
:func:`model_from_flat` raises. :func:`flat_from_model` is its inverse.

A parameter keeps its array's dtype: bfloat16 (a bf16 model's, JAX's
``ml_dtypes.bfloat16`` arrays, or the ``|V2`` bytes that ``np.save``
writes for them and ``np.load`` gives back) moves as its 16 bits, without
``ml_dtypes``, which the card's machine does not have; any other array
becomes float32. :func:`flat_from_model` gives a bf16 parameter as those
``|V2`` bytes, the form JAX's ``np.savez`` of a bf16 array writes
(``array.view(ml_dtypes.bfloat16)`` turns it back into JAX's).
On a grid of ranks, :func:`sharded_model_from_flat` keeps the rows of
each table a rank owns and :func:`flat_from_sharded_model` gathers them
back.
"""

from __future__ import annotations

from typing import Dict, Mapping

import re

import numpy as np
import torch
from torch import nn

from .configs import Config
from .models.model import build_model

#: The numpy form of a bf16 array here: its 16 bits as one void field.
BF16_BYTES = np.dtype("V2")

# The port's GRU modules (GRUParams in JAX): HPMN's layers, DIEN's two
# GRUs, GRU4Rec's one.
_GRU_MODULE = re.compile(r"encoder\.(layers\.\d+|gru1|augru|gru)")


def jax_key(name: str) -> str:
    """Port parameter name -> the JAX keystr of the same leaf."""
    parts = name.split(".")
    gru = _GRU_MODULE.fullmatch(".".join(parts[:-1])) is not None
    out = []
    for i, p in enumerate(parts):
        if p.isdigit():
            out.append(f"[{p}]")
        elif gru and i == len(parts) - 1:
            out.append(f".{p}")  # GRUParams is a NamedTuple: attribute keys
        else:
            out.append(f"['{p}']")
    return "".join(out)


def is_bf16(a: np.ndarray) -> bool:
    """Whether a numpy array holds bfloat16: ``ml_dtypes.bfloat16``, or 2-byte
    void (:data:`BF16_BYTES`)."""
    dt = np.asarray(a).dtype
    return dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2)


def tensor_from_array(a: np.ndarray) -> torch.Tensor:
    """A JAX parameter array as a CPU tensor of its own: bf16 from its bits
    (:func:`is_bf16`), any other array as a float32 copy."""
    a = np.asarray(a)
    if is_bf16(a):
        bits = np.array(a).view(np.int16)  # a copy, 0-d kept
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A parameter as a host numpy copy: a bf16 one as its bits
    (:data:`BF16_BYTES`), any other in its dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy().view(BF16_BYTES)
    return t.numpy().copy()


def model_from_flat(cfg: Config, flat: Mapping[str, np.ndarray],
                    device="cuda") -> nn.Module:
    """Build the model of ``cfg`` (``build_model``) holding the JAX arrays
    of ``flat``, each parameter in its array's dtype (bf16 or float32, see
    above); the vocab sizes are read from the embedding tables, the users
    from the user table or, without one, SVD++'s ``p_u``."""
    n_items = np.shape(flat["['embedding']['item']"])[0]
    n_cats = np.shape(flat["['embedding']['cat']"])[0]
    user = flat.get("['embedding']['user']",
                    flat.get("['encoder']['p_u']"))
    n_users = 0 if user is None else np.shape(user)[0]
    model = build_model(cfg, n_items, n_cats, n_users)
    left = dict(flat)
    with torch.no_grad():
        for name, param in model.named_parameters():
            key = jax_key(name)
            if key not in left:
                raise KeyError(f"no JAX array for {name} (key {key})")
            value = tensor_from_array(left.pop(key))
            if value.shape != param.shape:
                raise ValueError(f"{key}: shape {tuple(value.shape)}, the "
                                 f"port's {name} is {tuple(param.shape)}")
            param.data = value
    if left:
        raise KeyError(f"JAX arrays the port has no parameter for: "
                       f"{sorted(left)}")
    return model.to(device)


def flat_from_model(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters as the flat ``{keystr: np.ndarray}`` mapping
    of the JAX param tree (``flatten_with_keys``'s keys, host copies in the
    parameters' dtype, bf16 as :data:`BF16_BYTES`): the inverse of
    :func:`model_from_flat`."""
    return {jax_key(name): array_from_tensor(p)
            for name, p in model.named_parameters()}


def sharded_model_from_flat(cfg: Config, flat: Mapping[str, np.ndarray],
                            mesh, device="cuda") -> nn.Module:
    """:func:`model_from_flat`, keeping this rank's rows of every
    row-sharded table (``parallel.mesh.is_row_sharded``; the JAX tree's
    tables padded to a multiple of the model group, as
    ``hpmn_tpu.parallel.init_sharded_model`` pads them): the rows the JAX
    mesh places on the device at this rank's place in the grid."""
    from .parallel.train_step import shard_model

    return shard_model(model_from_flat(cfg, flat, device="cpu"),
                       mesh).to(device)


def flat_from_sharded_model(model: nn.Module, mesh) -> Dict[str, np.ndarray]:
    """The inverse of :func:`sharded_model_from_flat`: the JAX mapping
    with every table whole (gathered over the model group: every rank of
    the group calls it)."""
    from .parallel.train_step import gather_params

    return {jax_key(name): array_from_tensor(p)
            for name, p in gather_params(model, mesh).items()}
