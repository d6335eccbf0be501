"""Held-out evaluation: AUC, GAUC, log-loss and calibration over an eval
split — counterpart of ``hpmn_tpu/train/evaluate.py``.

Several ranks: each scores its own ``DataLoader(process_index=rank,
process_count=world)`` rows, and the scores (or, streaming, the
histograms) are merged over every rank before the metrics, so that every
rank reports the same global numbers (``_merge_across_hosts``,
``_merge_gauc_across_hosts``, JAX's). The merges gather over ``group``
(default the whole process group), through gloo on the host. Ranks that
score the same rows as another (the seq ranks of a cell, which run the
T-sharded scans together) pass ``counted=False`` but one, so that each
example counts once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import DataLoader
from ..data.schema import Batch
from . import metrics as M


def _world(group) -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def evaluate(eval_step: Callable, model, loader: DataLoader,
             streaming_bins: int = 0, gauc_bins: int = 256,
             gauc_max_users: int = 0,
             steps_per_dispatch: int = 1, group=None,
             counted: bool = True) -> Dict[str, float]:
    """eval_step(model, batch) -> logits [B] (a tensor on any device, or
    an array). Scores every example of ``loader.one_epoch()`` once: the
    padded rows of the last batch are scored and dropped. In a process
    group of several ranks every rank calls it with its own loader shard
    (every rank runs ``loader.epoch_batches()`` eval steps, so collective
    eval steps line up) and gets the metrics of all the shards; ``group``
    is a gloo group for the merge (the default group when None).

    ``steps_per_dispatch`` is taken for the JAX signature's sake: the
    port scores each batch and pulls its logits before the next, for any
    k, and the JAX function's numbers do not depend on k either.

    ``counted=False``: this rank scores its batches (its eval steps may be
    collective) and adds nothing to the merge.

    ``streaming_bins > 0`` switches to the bounded-memory histogram
    estimators (:class:`metrics.StreamingAUC` and
    :class:`metrics.StreamingGAUC`); ``gauc_bins = 0`` then drops the
    per-user state (gauc nan) and ``gauc_max_users`` hash-caps it."""
    merge = _world(group) > 1
    if streaming_bins:
        acc = M.StreamingAUC(streaming_bins)
        gacc = (M.StreamingGAUC(gauc_bins, gauc_max_users)
                if gauc_bins else None)
        for logits, batch, n_valid in _scored_batches(eval_step, model,
                                                      loader, counted):
            labels = batch.label.numpy()[:n_valid]
            acc.update(logits[:n_valid], labels)
            if gacc is not None:
                gacc.update(logits[:n_valid], labels,
                            batch.uid.numpy()[:n_valid])
        if merge:
            acc = _merge_streaming_across_hosts(acc, streaming_bins, group)
            if gacc is not None:
                gacc = _merge_gauc_across_hosts(gacc, gauc_bins,
                                                gauc_max_users, group)
        out = acc.result()
        out["gauc"] = gacc.result() if gacc is not None else float("nan")
        return out
    all_logits, all_labels, all_uids = [], [], []
    for logits, batch, n_valid in _scored_batches(eval_step, model, loader,
                                                  counted):
        all_logits.append(logits[:n_valid])
        all_labels.append(batch.label.numpy()[:n_valid])
        all_uids.append(batch.uid.numpy()[:n_valid])
    logits = np.concatenate(all_logits) if all_logits else np.zeros((0,))
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0,))
    uids = np.concatenate(all_uids) if all_uids else np.zeros((0,))
    if merge:
        logits, labels, uids = _merge_across_hosts(logits, labels, uids,
                                                   group)
    return {
        "auc": M.auc(logits, labels),
        "gauc": M.gauc(logits, labels, uids),
        "log_loss": M.log_loss(logits, labels),
        "calib": M.calibration(logits, labels),
        "n": float(len(labels)),
    }


def _scored_batches(eval_step: Callable, model, loader: DataLoader,
                    counted: bool = True,
                    ) -> Iterator[Tuple[np.ndarray, Batch, int]]:
    """Yield (host logits [B], host batch, n_valid) per eval batch; with
    ``counted=False`` score every batch and yield none."""
    for batch, n_valid in loader.one_epoch():
        logits = eval_step(model, batch)
        if not counted:
            continue
        if isinstance(logits, torch.Tensor):
            logits = logits.detach().float().cpu().numpy()
        yield np.asarray(logits), batch, n_valid


def _allgather_bits64(x: np.ndarray, group=None) -> np.ndarray:
    """Exact all-gather of a 64-bit array of the same shape on every rank
    -> [n_ranks, *x.shape] in x.dtype: the bits travel as int64 through
    gloo (uids above 2^24, counts above 2^31 and float64 logits survive,
    as the JAX function's uint32-pair transport makes them)."""
    x = np.ascontiguousarray(x)
    assert x.dtype.itemsize == 8, x.dtype
    t = torch.from_numpy(x.view(np.int64).reshape(-1).copy())
    out = [torch.empty_like(t) for _ in range(_world(group))]
    dist.all_gather(out, t, group=group)
    g = torch.stack(out).numpy()
    return np.ascontiguousarray(g).view(x.dtype).reshape(
        (g.shape[0],) + x.shape)


def _merge_across_hosts(logits: np.ndarray, labels: np.ndarray,
                        uids: np.ndarray, group=None):
    """Every rank's (logits, labels, uids), padded to the longest shard
    (ragged shards when the eval set does not divide), gathered bit for
    bit and concatenated in rank order. The uids travel too, so GAUC
    groups a user whose examples lie on several ranks."""
    n_all = _allgather_bits64(np.asarray([len(logits)], np.int64),
                              group)[:, 0]
    pad = int(n_all.max()) - len(logits)
    packed = np.stack([
        np.pad(np.asarray(logits, np.float64), (0, pad)),
        np.pad(np.asarray(labels, np.float64), (0, pad)),
        np.pad(np.asarray(uids, np.int64), (0, pad)).view(np.float64),
    ])
    gathered = _allgather_bits64(packed, group)  # [P, 3, n_max]
    outs = [[], [], []]
    for p in range(gathered.shape[0]):
        k = int(n_all[p])
        for i in range(3):
            outs[i].append(np.ascontiguousarray(gathered[p, i, :k]))
    merged = [np.concatenate(o) for o in outs]
    merged[2] = merged[2].view(np.int64)
    return tuple(merged)


def _merge_streaming_across_hosts(acc, n_bins: int, group=None):
    """The ranks' StreamingAUC states (int64 counts, the float64 log-loss
    sum) summed into one accumulator, bit for bit on every rank."""
    pos, neg, ll, n = acc.state
    ints = np.concatenate([pos, neg, [n]]).astype(np.int64)
    gathered = _allgather_bits64(ints, group)  # [P, 2b+1]
    ll_all = _allgather_bits64(np.asarray([ll], np.float64), group)[:, 0]
    merged = M.StreamingAUC(n_bins)
    for p in range(gathered.shape[0]):
        row = gathered[p]
        merged.merge_counts(row[:n_bins], row[n_bins:2 * n_bins],
                            float(ll_all[p]), int(row[-1]))
    return merged


def _merge_gauc_across_hosts(gacc, gauc_bins: int, gauc_max_users: int,
                             group=None):
    """The ranks' StreamingGAUC states (ragged user counts, padded to the
    most) folded into one accumulator by per-uid histogram addition."""
    uids, hists = gacc.state  # [U] int64, [U, 2, gauc_bins] int32
    u_all = _allgather_bits64(np.asarray([len(uids)], np.int64),
                              group)[:, 0]
    pad = int(u_all.max()) - len(uids)
    g_uids = _allgather_bits64(np.pad(uids.astype(np.int64), (0, pad)),
                               group)
    hist = torch.from_numpy(np.pad(
        hists.reshape(len(uids), 2 * gauc_bins).astype(np.int32),
        ((0, pad), (0, 0))))
    out = [torch.empty_like(hist) for _ in range(_world(group))]
    dist.all_gather(out, hist, group=group)
    merged = type(gacc)(gauc_bins, gauc_max_users)
    for p in range(g_uids.shape[0]):
        k = int(u_all[p])
        merged.merge_state(g_uids[p, :k],
                           out[p].numpy()[:k].reshape(k, 2, gauc_bins))
    return merged
