"""Synthetic CTR datasets — a numpy copy of ``hpmn_tpu/data/synthetic.py``.

Copied rather than imported: the JAX package's ``data/__init__.py`` imports
``jax``, which the port's machines need not have. The copy keeps the
generator's arithmetic and draw order, so the same spec and seed give the
same arrays as the JAX package (tests/test_torch_model.py).

Carried: :func:`make_ctr_dataset`, the planted long-range task
:func:`make_periodic_dataset` and the driver's split
:func:`train_val_test_split`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Schema-level description of one dataset family."""

    name: str
    seq_len: int  # T
    n_items: int  # item-id vocab (0 = pad)
    n_cats: int  # category-id vocab (0 = pad/unknown)
    n_users: int


AMAZON = DatasetSpec("amazon", seq_len=100, n_items=20000, n_cats=400, n_users=8000)
TAOBAO = DatasetSpec("taobao", seq_len=300, n_items=50000, n_cats=800, n_users=8000)
XLONG = DatasetSpec("xlong", seq_len=1000, n_items=50000, n_cats=800, n_users=4000)

SPECS = {s.name: s for s in (AMAZON, TAOBAO, XLONG)}


def _item_to_cat(items: np.ndarray, n_items: int, n_cats: int) -> np.ndarray:
    """Deterministic item->category map; id 0 (pad) maps to cat 0."""
    cats = (items.astype(np.int64) * 2654435761 % (n_cats - 1) + 1).astype(
        np.int32)
    return np.where(items == 0, 0, cats)


_POOLS: dict = {}  # (n_items, n_cats) -> per-category item pools


def _sample_items_for_cats(rng, cats: np.ndarray,
                           n_items: int, n_cats: int) -> np.ndarray:
    """Sample item ids whose category equals ``cats`` from per-category
    pools (items sorted by category, searchsorted boundaries)."""
    key = (n_items, n_cats)
    if key not in _POOLS:
        all_items = np.arange(1, n_items, dtype=np.int32)
        all_cats = _item_to_cat(all_items, n_items, n_cats)
        order = np.argsort(all_cats, kind="stable")
        sorted_items = all_items[order]
        sorted_cats = all_cats[order]
        starts = np.searchsorted(sorted_cats, np.arange(n_cats))
        ends = np.searchsorted(sorted_cats, np.arange(n_cats), side="right")
        _POOLS[key] = (sorted_items, starts, ends)
    sorted_items, starts, ends = _POOLS[key]
    lo, hi = starts[cats], ends[cats]
    # Categories with an empty pool fall back to a random item.
    empty = hi <= lo
    offs = (rng.random(cats.shape) * np.maximum(hi - lo, 1)).astype(np.int64)
    picked = sorted_items[np.minimum(lo + offs, len(sorted_items) - 1)]
    fallback = rng.integers(1, n_items, size=cats.shape).astype(np.int32)
    return np.where(empty, fallback, picked).astype(np.int32)


def _finalize(spec: DatasetSpec, rng, uid, item_seq, seq_mask, target_item,
              label) -> Dict[str, np.ndarray]:
    cat_seq = _item_to_cat(item_seq, spec.n_items, spec.n_cats)
    neg_item = rng.integers(1, spec.n_items, size=item_seq.shape).astype(np.int32)
    return dict(
        uid=uid.astype(np.int32),
        item_seq=item_seq.astype(np.int32),
        cat_seq=cat_seq.astype(np.int32),
        seq_mask=seq_mask.astype(np.float32),
        target_item=target_item.astype(np.int32),
        target_cat=_item_to_cat(target_item, spec.n_items, spec.n_cats),
        label=label.astype(np.float32),
        neg_item_seq=neg_item,
        neg_cat_seq=_item_to_cat(neg_item, spec.n_items, spec.n_cats),
    )


def make_ctr_dataset(spec: DatasetSpec, n_examples: int, seed: int = 0,
                     min_len_frac: float = 0.5) -> Dict[str, np.ndarray]:
    """CTR examples: a latent category preference per example drives its
    behaviours; the positive target is one more preferred behaviour, the
    negative a random item. Left-padded to lengths drawn from
    [min_len_frac*T, T]; ``min_len_frac=1.0`` gives full histories."""
    rng = np.random.default_rng(seed)
    T = spec.seq_len
    uid = rng.integers(0, spec.n_users, size=n_examples)
    k_fav = 5
    fav = rng.integers(1, spec.n_cats, size=(n_examples, k_fav)).astype(np.int32)
    # Behaviour categories: 70% from favourites, 30% uniform noise.
    pick = rng.integers(0, k_fav, size=(n_examples, T))
    beh_cat = np.take_along_axis(fav, pick, axis=1)
    noise_mask = rng.random((n_examples, T)) < 0.3
    beh_cat = np.where(noise_mask,
                       rng.integers(1, spec.n_cats, size=(n_examples, T)),
                       beh_cat).astype(np.int32)
    item_seq = _sample_items_for_cats(rng, beh_cat, spec.n_items, spec.n_cats)
    lens = rng.integers(int(T * min_len_frac), T + 1, size=n_examples)
    pos = np.arange(T)[None, :]
    seq_mask = (pos >= (T - lens[:, None])).astype(np.float32)
    item_seq = (item_seq * seq_mask).astype(np.int32)
    label = (rng.random(n_examples) < 0.5).astype(np.float32)
    pos_cat = np.take_along_axis(fav, rng.integers(0, k_fav, size=(n_examples, 1)),
                                 axis=1)[:, 0]
    pos_item = _sample_items_for_cats(rng, pos_cat, spec.n_items, spec.n_cats)
    neg_item = rng.integers(1, spec.n_items, size=n_examples).astype(np.int32)
    target_item = np.where(label > 0.5, pos_item, neg_item).astype(np.int32)
    return _finalize(spec, rng, uid, item_seq, seq_mask, target_item, label)


def make_periodic_dataset(spec: DatasetSpec, n_examples: int, seed: int = 0,
                          noise_window_frac: float = 0.3,
                          k_interests: int = 3,
                          signal_prob: float = 0.8) -> Dict[str, np.ndarray]:
    """Planted long-range task: interests appear only before the trailing
    noise window, and the label says whether the target's category is one
    of them. A model must remember across the window's steps of pure noise
    to solve it. Full histories (no padding)."""
    rng = np.random.default_rng(seed)
    T = spec.seq_len
    W = max(1, int(T * noise_window_frac))
    uid = rng.integers(0, spec.n_users, size=n_examples)
    # Disjoint pools: interest candidates in [1, half), noise in
    # [half, n_cats), so an interest category in the history is a signal.
    half = max(2, spec.n_cats // 2)
    interests = rng.integers(1, half,
                             size=(n_examples, k_interests)).astype(np.int32)
    pick = rng.integers(0, k_interests, size=(n_examples, T))
    beh_cat = np.take_along_axis(interests, pick, axis=1)
    u = rng.random((n_examples, T))
    noise_cat = rng.integers(half, spec.n_cats, size=(n_examples, T))
    is_late = np.arange(T)[None, :] >= (T - W)
    beh_cat = np.where(is_late | (u >= signal_prob), noise_cat, beh_cat)
    beh_cat = beh_cat.astype(np.int32)
    item_seq = _sample_items_for_cats(rng, beh_cat, spec.n_items, spec.n_cats)
    seq_mask = np.ones((n_examples, T), dtype=np.float32)
    # Positive target: an item of an interest; negative: an item of an
    # interest candidate that is not among this example's interests.
    label = (rng.random(n_examples) < 0.5).astype(np.float32)
    pos_cat = np.take_along_axis(
        interests, rng.integers(0, k_interests, size=(n_examples, 1)),
        axis=1)[:, 0]
    neg_cat = rng.integers(1, half, size=n_examples).astype(np.int32)
    for _ in range(16):  # redraw the negatives that hit an interest
        clash = (neg_cat[:, None] == interests).any(axis=1)
        if not clash.any():
            break
        neg_cat = np.where(clash, rng.integers(1, half, size=n_examples),
                           neg_cat).astype(np.int32)
    tcat = np.where(label > 0.5, pos_cat, neg_cat).astype(np.int32)
    target_item = _sample_items_for_cats(rng, tcat, spec.n_items, spec.n_cats)
    return _finalize(spec, rng, uid, item_seq, seq_mask, target_item, label)


def train_val_test_split(arrays: Dict[str, np.ndarray], val_frac: float = 0.1,
                         test_frac: float = 0.1):
    """-> (train, val, test): the first examples train, then val, then
    test (views, by example index)."""
    n = arrays["label"].shape[0]
    n_test = int(n * test_frac)
    n_val = int(n * val_frac)
    n_train = n - n_val - n_test

    def slice_all(lo, hi):
        return {k: v[lo:hi] for k, v in arrays.items()}

    return (slice_all(0, n_train), slice_all(n_train, n_train + n_val),
            slice_all(n_train + n_val, n))
