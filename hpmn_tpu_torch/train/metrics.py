"""Evaluation metrics — a numpy copy of ``hpmn_tpu/train/metrics.py``:
exact AUC (the rank statistic with tie-averaged ranks, sklearn's value),
its bounded-memory histogram form, GAUC and its histogram form,
calibration and log-loss.

Copied rather than imported: the port runs where JAX is absent, and the
JAX package's modules import it. The arithmetic is the same line for line,
so the same arrays give the same numbers (tests/test_torch_driver_data.py).
"""

from __future__ import annotations

import numpy as np


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact ROC-AUC via the Mann-Whitney U statistic with tie-averaged
    ranks. scores: [N] real-valued; labels: [N] in {0, 1}."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel() > 0.5
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # Average rank within tied groups (1-indexed ranks).
    ranks = np.empty(labels.size, np.float64)
    idx = np.arange(1, labels.size + 1, dtype=np.float64)
    # Vectorized tie handling: group boundaries where the score changes.
    boundaries = np.flatnonzero(np.diff(sorted_scores)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [labels.size]])
    avg = (idx[starts.astype(int)] + idx[ends.astype(int) - 1]) / 2.0
    group_of = np.repeat(np.arange(len(starts)), ends - starts)
    ranks[order] = avg[group_of]
    rank_sum_pos = ranks[labels].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


class StreamingAUC:
    """Bounded-memory AUC over arbitrarily large eval streams.

    The exact estimator above keeps every score in memory and sorts —
    fine to ~1e8 rows, not for production-scale eval sweeps. This one
    histograms sigmoid(logit) per class into ``n_bins`` fixed buckets
    (O(n_bins) memory, mergeable by addition across shards/hosts) and
    computes the Mann-Whitney statistic on the histogram with within-bin
    ties counted half — the same tie convention as :func:`auc`, so the two
    agree exactly when no two scores share a bin and to O(collisions/N²)
    otherwise (<~1/n_bins worst case).
    """

    def __init__(self, n_bins: int = 1 << 14):
        self.pos = np.zeros(n_bins, np.int64)
        self.neg = np.zeros(n_bins, np.int64)
        # streaming log-loss travels with the same accumulator
        self._ll_sum = 0.0
        self._n = 0

    def update(self, logits: np.ndarray, labels: np.ndarray) -> None:
        x = np.asarray(logits, np.float64).ravel()
        y = np.asarray(labels).ravel() > 0.5
        n_bins = len(self.pos)
        s = 1.0 / (1.0 + np.exp(-x))
        b = np.minimum((s * n_bins).astype(np.int64), n_bins - 1)
        self.pos += np.bincount(b[y], minlength=n_bins)
        self.neg += np.bincount(b[~y], minlength=n_bins)
        per = np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))
        self._ll_sum += float(per.sum())
        self._n += x.size

    def merge_counts(self, pos: np.ndarray, neg: np.ndarray,
                     ll_sum: float = 0.0, n: int = 0) -> None:
        """Fold in another accumulator's state (cross-host/shard merge)."""
        self.pos += np.asarray(pos, np.int64)
        self.neg += np.asarray(neg, np.int64)
        self._ll_sum += float(ll_sum)
        self._n += int(n)

    @property
    def state(self):
        return self.pos, self.neg, self._ll_sum, self._n

    def result(self) -> dict:
        n_pos, n_neg = int(self.pos.sum()), int(self.neg.sum())
        if n_pos == 0 or n_neg == 0:
            a = float("nan")
        else:
            neg_below = np.cumsum(self.neg) - self.neg
            wins = float((self.pos * neg_below).sum())
            ties = 0.5 * float((self.pos * self.neg).sum())
            a = (wins + ties) / (n_pos * n_neg)
        # Calibration from the histogram itself (bin-center probabilities):
        # integer-count arithmetic, so chunked/merged accumulators report
        # the identical value; error is O(1/n_bins) like the AUC.
        if n_pos > 0:
            centers = (np.arange(len(self.pos)) + 0.5) / len(self.pos)
            calib = float(((self.pos + self.neg) * centers).sum() / n_pos)
        else:
            calib = float("nan")
        return {"auc": a,
                "log_loss": self._ll_sum / max(self._n, 1),
                "calib": calib,
                "n": float(self._n)}


class StreamingGAUC:
    """Bounded-memory GAUC over arbitrarily large eval streams.

    Exact :func:`gauc` keeps every (score, label, uid) row and sorts twice —
    O(N) memory in the impression count. This keeps ONE fixed-size score
    histogram pair per user (``2 x n_bins`` int32, ~2 KB at the default),
    so memory is O(U) in the user count and independent of N — the bound
    that matters for production-scale eval sweeps where N >> U
    (SURVEY.md §5.5). ``max_users > 0`` makes the
    bound HARD: uids hash into that many buckets and colliding users merge
    (a graceful within-bucket approximation, not an error).

    Per-user AUC uses the same within-bin half-tie convention as
    :class:`StreamingAUC`, so it matches :func:`gauc` exactly when no two
    of a user's scores share a bin and to O(collisions) otherwise. State is
    mergeable across shards/hosts by per-uid addition (``merge_state``).
    """

    def __init__(self, n_bins: int = 256, max_users: int = 0):
        self.n_bins = int(n_bins)
        self.max_users = int(max_users)
        # One contiguous [capacity, 2, n_bins] int32 histogram block with
        # a uid->row dict and amortized-doubling growth, so update() is one
        # vectorized np.add.at over (row, class, bin) triples instead of a
        # Python loop over the batch's users.
        self._index: dict = {}  # key (uid or bucket) -> row
        self._row_keys: list = []  # row -> key
        self._hists = np.zeros((0, 2, self.n_bins), np.int32)

    def _key(self, uid: int) -> int:
        if self.max_users:
            # splitmix-style integer hash so adjacent uids don't collide
            # into adjacent buckets systematically
            h = (uid * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
            return int((h >> 17) % self.max_users)
        return int(uid)

    def _keys_vec(self, uids: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`_key` (bit-identical for uids >= 0)."""
        u = np.asarray(uids).ravel().astype(np.int64)
        if not self.max_users:
            return u
        h = u.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return ((h >> np.uint64(17))
                % np.uint64(self.max_users)).astype(np.int64)

    def _rows_for(self, keys: np.ndarray) -> np.ndarray:
        """Map bucket keys to arena rows, inserting unseen keys (amortized
        O(new) Python work; everything else stays vectorized)."""
        uniq, inv = np.unique(keys, return_inverse=True)
        rows_u = np.empty(len(uniq), np.intp)
        index = self._index
        n = len(self._row_keys)
        for i, k in enumerate(uniq.tolist()):
            r = index.get(k)
            if r is None:
                r = n
                index[k] = r
                self._row_keys.append(k)
                n += 1
            rows_u[i] = r
        if n > len(self._hists):
            cap = max(64, len(self._hists))
            while cap < n:
                cap *= 2
            grown = np.zeros((cap, 2, self.n_bins), np.int32)
            grown[:len(self._hists)] = self._hists
            self._hists = grown
        return rows_u[inv]

    def update(self, logits: np.ndarray, labels: np.ndarray,
               uids: np.ndarray) -> None:
        x = np.asarray(logits, np.float64).ravel()
        if x.size == 0:  # same graceful-empties contract as StreamingAUC
            return
        y = np.asarray(labels).ravel() > 0.5
        s = 1.0 / (1.0 + np.exp(-x))
        b = np.minimum((s * self.n_bins).astype(np.int64), self.n_bins - 1)
        rows = self._rows_for(self._keys_vec(uids))
        np.add.at(self._hists, (rows, np.where(y, 0, 1), b), 1)

    @property
    def _n_users(self) -> int:
        return len(self._row_keys)

    @property
    def state(self):
        """(uids [U] int64, hists [U, 2, n_bins] int32), uid-sorted —
        the mergeable wire form for the cross-host allgather."""
        n = self._n_users
        if n == 0:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, 2, self.n_bins), np.int32))
        keys = np.asarray(self._row_keys, np.int64)
        order = np.argsort(keys, kind="mergesort")
        return keys[order], self._hists[:n][order]

    def merge_state(self, uids: np.ndarray, hists: np.ndarray) -> None:
        """Fold in another accumulator's state (cross-host/shard merge).
        The peer must use the same (n_bins, max_users) configuration.
        Vectorized: one np.add.at over the peer's rows (duplicate peer
        uids, though never produced by ``state``, accumulate correctly)."""
        u = np.asarray(uids, np.int64).ravel()
        if u.size == 0:
            return
        rows = self._rows_for(u)  # peer keys are already bucketed
        np.add.at(self._hists, rows,
                  np.asarray(hists, np.int32).reshape(len(u), 2,
                                                      self.n_bins))

    def result(self, _chunk: int = 1 << 16) -> float:
        """Impression-weighted mean of per-user histogram AUCs, computed
        vectorized over user blocks (``_chunk`` rows per block bounds the
        float64 temporaries to ~2*n_bins*_chunk*8 bytes at any moment —
        the arena itself can be GBs at production user counts)."""
        total_w = 0.0
        acc = 0.0
        n = self._n_users
        for st in range(0, n, _chunk):
            h = self._hists[st:min(st + _chunk, n)].astype(np.float64)
            pos, neg = h[:, 0], h[:, 1]  # [u, n_bins]
            n_pos, n_neg = pos.sum(1), neg.sum(1)
            valid = (n_pos > 0) & (n_neg > 0)  # single-class users skipped
            if not valid.any():
                continue
            pos, neg = pos[valid], neg[valid]
            n_pos, n_neg = n_pos[valid], n_neg[valid]
            neg_below = np.cumsum(neg, axis=1) - neg
            wins = (pos * neg_below).sum(1)
            ties = 0.5 * (pos * neg).sum(1)
            w = n_pos + n_neg
            acc += float((w * (wins + ties) / (n_pos * n_neg)).sum())
            total_w += float(w.sum())
        return acc / total_w if total_w > 0 else float("nan")


def calibration(scores_logits: np.ndarray, labels: np.ndarray) -> float:
    """Calibration ratio: mean predicted CTR / observed CTR (pCTR/CTR; 1.0 =
    perfectly calibrated, the production-CTR companion to AUC — AUC is
    rank-only and blind to a global probability bias that would mis-price
    every downstream bid). nan when the stream has no positives."""
    x = np.asarray(scores_logits, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    n_pos = float(y.sum())
    if n_pos == 0 or x.size == 0:
        return float("nan")
    p = 1.0 / (1.0 + np.exp(-x))
    return float(p.sum() / n_pos)


def log_loss(scores_logits: np.ndarray, labels: np.ndarray) -> float:
    """Mean binary cross-entropy from logits."""
    x = np.asarray(scores_logits, np.float64).ravel()
    y = np.asarray(labels, np.float64).ravel()
    per = np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))
    return float(per.mean())


def gauc(scores: np.ndarray, labels: np.ndarray,
         uids: np.ndarray) -> float:
    """Group AUC: impression-weighted mean of per-user AUCs, skipping
    users whose eval examples are single-class (no ranking defined).

    The CTR-serving ranking metric (candidates are ranked within one
    user's request, never across users): GAUC = sum_u w_u * AUC_u /
    sum_u w_u with w_u = the user's impression count. Returns nan when no
    user has both classes. Complements the global ``auc`` the paper
    reports ([P §5.1.2]).
    """
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel()
    uids = np.asarray(uids).ravel()
    order = np.argsort(uids, kind="mergesort")
    u_sorted = uids[order]
    bounds = np.flatnonzero(np.diff(u_sorted)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(u_sorted)]])
    total_w = 0.0
    acc = 0.0
    for s, e in zip(starts, ends):
        grp = order[s:e]
        a = auc(scores[grp], labels[grp])
        if a == a:  # both classes present
            w = float(e - s)
            acc += w * a
            total_w += w
    return acc / total_w if total_w > 0 else float("nan")
