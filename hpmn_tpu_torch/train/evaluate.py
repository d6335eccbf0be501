"""Held-out evaluation: AUC, GAUC, log-loss and calibration over an eval
split — counterpart of ``hpmn_tpu/train/evaluate.py``, one process.

The multi-host merges of the JAX function (an all-gather of the scores, or
of the streaming counts) wait with the port's multi-device path
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..data.loader import DataLoader
from ..data.schema import Batch
from . import metrics as M


def evaluate(eval_step: Callable, model, loader: DataLoader,
             streaming_bins: int = 0, gauc_bins: int = 256,
             gauc_max_users: int = 0,
             steps_per_dispatch: int = 1) -> Dict[str, float]:
    """eval_step(model, batch) -> logits [B] (a tensor on any device, or
    an array). Scores every example of ``loader.one_epoch()`` once: the
    padded rows of the last batch are scored and dropped.

    ``steps_per_dispatch`` is taken for the JAX signature's sake: the
    port scores each batch and pulls its logits before the next, for any
    k, and the JAX function's numbers do not depend on k either.

    ``streaming_bins > 0`` switches to the bounded-memory histogram
    estimators (:class:`metrics.StreamingAUC` and
    :class:`metrics.StreamingGAUC`); ``gauc_bins = 0`` then drops the
    per-user state (gauc nan) and ``gauc_max_users`` hash-caps it."""
    if streaming_bins:
        acc = M.StreamingAUC(streaming_bins)
        gacc = (M.StreamingGAUC(gauc_bins, gauc_max_users)
                if gauc_bins else None)
        for logits, batch, n_valid in _scored_batches(eval_step, model,
                                                      loader):
            labels = batch.label.numpy()[:n_valid]
            acc.update(logits[:n_valid], labels)
            if gacc is not None:
                gacc.update(logits[:n_valid], labels,
                            batch.uid.numpy()[:n_valid])
        out = acc.result()
        out["gauc"] = gacc.result() if gacc is not None else float("nan")
        return out
    all_logits, all_labels, all_uids = [], [], []
    for logits, batch, n_valid in _scored_batches(eval_step, model, loader):
        all_logits.append(logits[:n_valid])
        all_labels.append(batch.label.numpy()[:n_valid])
        all_uids.append(batch.uid.numpy()[:n_valid])
    logits = np.concatenate(all_logits) if all_logits else np.zeros((0,))
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0,))
    uids = np.concatenate(all_uids) if all_uids else np.zeros((0,))
    return {
        "auc": M.auc(logits, labels),
        "gauc": M.gauc(logits, labels, uids),
        "log_loss": M.log_loss(logits, labels),
        "calib": M.calibration(logits, labels),
        "n": float(len(labels)),
    }


def _scored_batches(eval_step: Callable, model, loader: DataLoader,
                    ) -> Iterator[Tuple[np.ndarray, Batch, int]]:
    """Yield (host logits [B], host batch, n_valid) per eval batch."""
    for batch, n_valid in loader.one_epoch():
        logits = eval_step(model, batch)
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().float().cpu().numpy()
        yield np.asarray(logits), batch, n_valid
