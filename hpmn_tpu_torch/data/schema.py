"""Batch schema — counterpart of ``hpmn_tpu/data/schema.py``.

Same fields and layout: sequences are left-padded (the most recent event at
index T-1), ``seq_mask`` is 1.0 at valid positions, ids are int32 and labels
and masks float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import native_batcher


@dataclasses.dataclass(frozen=True)
class Batch:
    """One batch of tensors. B = batch, T = max sequence length."""

    uid: torch.Tensor  # int32 [B]
    item_seq: torch.Tensor  # int32 [B, T], left-padded with 0
    cat_seq: torch.Tensor  # int32 [B, T], left-padded with 0
    seq_mask: torch.Tensor  # float32 [B, T], 1.0 where valid
    target_item: torch.Tensor  # int32 [B]
    target_cat: torch.Tensor  # int32 [B]
    label: torch.Tensor  # float32 [B]
    neg_item_seq: torch.Tensor  # int32 [B, T] (DIEN's auxiliary negatives)
    neg_cat_seq: torch.Tensor  # int32 [B, T]

    @property
    def batch_size(self) -> int:
        return self.item_seq.shape[0]

    @property
    def seq_len(self) -> int:
        return self.item_seq.shape[1]


def batch_from_numpy(arrays: dict, indices: Optional[np.ndarray] = None,
                     device="cuda") -> Batch:
    """Build a Batch on ``device`` from a dict of numpy arrays, optionally
    row-sliced. Rows are taken by the native threaded gather
    (``native_batcher.gather``: one GIL-releasing call for every field)
    where it is built, as in ``hpmn_tpu/data/schema.py``; by numpy's fancy
    indexing, its oracle, otherwise."""
    names = [f.name for f in dataclasses.fields(Batch)]
    if indices is None:
        rows = {n: arrays[n] for n in names}
    elif native_batcher.available() and all(
            isinstance(arrays[n], np.ndarray) for n in names):
        rows = native_batcher.gather({n: arrays[n] for n in names}, indices)
    else:
        rows = {n: arrays[n][indices] for n in names}
    return Batch(**{n: torch.from_numpy(np.ascontiguousarray(rows[n])).to(
        device) for n in names})
