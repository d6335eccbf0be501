"""The Batch contract as plain checks — counterpart of
``hpmn_tpu/utils/asserts.py``, which asserts it with chex at trace time.
Here it runs on the host, once per batch, before the batch goes to the
card; it reads shapes and dtypes only, never the data."""

from __future__ import annotations

import numpy as np
import torch

from ..data.schema import Batch

_INT_FIELDS = ("item_seq", "cat_seq", "target_item", "target_cat",
               "neg_item_seq", "neg_cat_seq", "uid")


def _is_int32(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.int32
    return np.asarray(a).dtype == np.int32


def validate_batch(batch: Batch) -> None:
    """Raise ValueError unless every field has its shape ([B, T] sequences
    and mask, [B] the rest) and the ids are int32. The fields may be numpy
    arrays or tensors."""
    B, T = tuple(batch.item_seq.shape)
    for name in ("item_seq", "cat_seq", "seq_mask", "neg_item_seq",
                 "neg_cat_seq"):
        shape = tuple(getattr(batch, name).shape)
        if shape != (B, T):
            raise ValueError(f"batch.{name} has shape {shape}, not {(B, T)}")
    for name in ("target_item", "target_cat", "label", "uid"):
        shape = tuple(getattr(batch, name).shape)
        if shape != (B,):
            raise ValueError(f"batch.{name} has shape {shape}, not {(B,)}")
    for name in _INT_FIELDS:
        a = getattr(batch, name)
        if not _is_int32(a):
            raise ValueError(f"batch.{name} is {a.dtype}, not int32")
