"""Dataset preprocessing: raw behaviour logs -> fixed-length id sequences
— a numpy copy of ``hpmn_tpu/data/preprocess.py``.

Copied rather than imported: the JAX package's ``data/__init__.py``
imports ``jax``. The copy keeps every step and every draw of the seeded
generator, so the same log and seed give the same arrays, bit for bit
(tests/test_torch_preprocess.py).

Each real dataset reduces to a generic event log (one row per behaviour:
``user_id, item_token, category_token, timestamp``). :func:`process_log`
runs the shared pipeline on such rows in Python: per-user chronological
event lists, frequency-ordered vocabs, the last behaviour held out as the
positive target, the (up to) T behaviours before it left-padded, a
sampled negative. :func:`process_events` is the vectorized form that
takes the native parser's interned arrays (:func:`process_csv_native`).
:func:`save_preprocessed` writes the ``.npz`` that ``cfg.data_dir`` points
at and :func:`load_preprocessed` reads it back, memory-mapped where the
archive is uncompressed.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from .synthetic import DatasetSpec


def build_vocab(tokens: Iterable) -> Dict:
    """Frequency-ordered token -> id (ids start at 1; 0 = pad/unknown)."""
    counts: Dict = defaultdict(int)
    for t in tokens:
        counts[t] += 1
    order = sorted(counts, key=lambda t: (-counts[t], str(t)))
    return {t: i + 1 for i, t in enumerate(order)}


def process_log(rows: Sequence[Tuple], seq_len: int, seed: int = 0,
                min_events: int = 5) -> Dict[str, np.ndarray]:
    """rows: iterable of (user, item_token, cat_token, timestamp).

    Emits one positive and one negative example per eligible user: the
    last behavior is held out as the positive target, the preceding
    (up to) T behaviors form the sequence, and the negative target is a
    uniformly sampled item (reference scheme, [P §5.1.1]).
    """
    rng = np.random.default_rng(seed)
    by_user: Dict = defaultdict(list)
    for user, item, cat, ts in rows:
        by_user[user].append((ts, item, cat))
    item_vocab = build_vocab(item for _, item, _, _ in rows)
    cat_vocab = build_vocab(cat for _, _, cat, _ in rows)
    item_to_cat = {}
    for _, item, cat, _ in rows:
        item_to_cat[item_vocab[item]] = cat_vocab[cat]
    n_items = len(item_vocab) + 1
    items_arr = np.array(sorted(item_to_cat), dtype=np.int32)
    cats_arr = np.array([item_to_cat[i] for i in items_arr], dtype=np.int32)

    out = defaultdict(list)
    uid_vocab = build_vocab(by_user.keys())
    # Row order IS the time-ordered split (train_val_test_split slices by
    # index): emit users by their held-out target event's timestamp, each
    # user's negative adjacent to its positive, so the tail slices (val/
    # test) are the LATEST examples with both classes present.
    for events in by_user.values():
        events.sort(key=lambda e: e[0])
    emit_order = sorted(
        (u for u, ev in by_user.items() if len(ev) >= min_events),
        key=lambda u: (by_user[u][-1][0], str(u)))
    for user in emit_order:
        events = by_user[user]
        ids = [(item_vocab[i], cat_vocab[c]) for _, i, c in events]
        hist, (pos_item, pos_cat) = ids[:-1], ids[-1]
        hist = hist[-seq_len:]
        pad = seq_len - len(hist)
        item_seq = [0] * pad + [i for i, _ in hist]
        cat_seq = [0] * pad + [c for _, c in hist]
        mask = [0.0] * pad + [1.0] * len(hist)
        neg_pos = rng.integers(0, len(items_arr))
        # Per-position negatives for the DIEN aux loss.
        neg_idx = rng.integers(0, len(items_arr), size=seq_len)
        for label, (t_item, t_cat) in (
                (1.0, (pos_item, pos_cat)),
                (0.0, (int(items_arr[neg_pos]), int(cats_arr[neg_pos])))):
            out["uid"].append(uid_vocab[user])
            out["item_seq"].append(item_seq)
            out["cat_seq"].append(cat_seq)
            out["seq_mask"].append(mask)
            out["target_item"].append(t_item)
            out["target_cat"].append(t_cat)
            out["label"].append(label)
            out["neg_item_seq"].append(items_arr[neg_idx].tolist())
            out["neg_cat_seq"].append(cats_arr[neg_idx].tolist())

    arrays = {
        "uid": np.asarray(out["uid"], np.int32),
        "item_seq": np.asarray(out["item_seq"], np.int32),
        "cat_seq": np.asarray(out["cat_seq"], np.int32),
        "seq_mask": np.asarray(out["seq_mask"], np.float32),
        "target_item": np.asarray(out["target_item"], np.int32),
        "target_cat": np.asarray(out["target_cat"], np.int32),
        "label": np.asarray(out["label"], np.float32),
        "neg_item_seq": np.asarray(out["neg_item_seq"], np.int32),
        "neg_cat_seq": np.asarray(out["neg_cat_seq"], np.int32),
    }
    arrays["_n_items"] = np.asarray(n_items, np.int64)
    arrays["_n_cats"] = np.asarray(len(cat_vocab) + 1, np.int64)
    arrays["_n_users"] = np.asarray(int(arrays["uid"].max()) + 1, np.int64)
    return arrays


def process_events(uid: np.ndarray, item: np.ndarray, cat: np.ndarray,
                   ts: np.ndarray, seq_len: int, seed: int = 0,
                   min_events: int = 5) -> Dict[str, np.ndarray]:
    """Vectorized example assembly from interned event arrays (the numpy
    half of the native fast path: ``native.parse_csv`` produces the
    inputs). Same scheme as :func:`process_log`: per-user
    chronological sort, last behavior held out as the positive target,
    preceding (up to) T behaviors left-padded, random-event negatives
    (pairing each negative item with its true category)."""
    rng = np.random.default_rng(seed)
    order = np.lexsort((ts, uid))
    u, it, ct = uid[order], item[order], cat[order]
    n_rows = len(u)
    change = np.flatnonzero(np.diff(u)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n_rows]])
    lens = ends - starts
    keep = lens >= min_events
    starts, ends, lens = starts[keep], ends[keep], lens[keep]
    n = len(starts)
    T = seq_len
    hist_len = np.minimum(lens - 1, T)
    col = np.arange(T)[None, :]
    offset = col - (T - hist_len[:, None])
    src = (ends - 1 - hist_len)[:, None] + offset
    valid = offset >= 0
    src_safe = np.where(valid, src, 0)
    item_seq = np.where(valid, it[src_safe], 0).astype(np.int32)
    cat_seq = np.where(valid, ct[src_safe], 0).astype(np.int32)
    mask = valid.astype(np.float32)
    uids_kept = u[starts].astype(np.int32)
    pos_item, pos_cat = it[ends - 1], ct[ends - 1]
    # Negatives = random real events, so each negative item keeps its true
    # category (the reference samples items; event-sampling additionally
    # follows the empirical popularity distribution).
    neg_ev = rng.integers(0, n_rows, size=n)
    neg_pos_ev = rng.integers(0, n_rows, size=(n, T))

    # Row order IS the train/val/test split (train_val_test_split slices by
    # index), so emit example PAIRS ordered by the held-out target event's
    # timestamp with each user's negative adjacent to its positive. A
    # [pos-block | neg-block] layout would make the tail slices — val and
    # test — single-class (AUC undefined).
    t_target = ts[order][ends - 1]
    time_idx = np.argsort(t_target, kind="mergesort")
    perm = np.empty(2 * n, np.int64)
    perm[0::2] = time_idx
    perm[1::2] = time_idx + n

    def dup(a):
        return np.concatenate([a, a])[perm]

    return {
        "uid": dup(uids_kept),
        "item_seq": dup(item_seq),
        "cat_seq": dup(cat_seq),
        "seq_mask": dup(mask),
        "target_item": np.concatenate(
            [pos_item, it[neg_ev]]).astype(np.int32)[perm],
        "target_cat": np.concatenate(
            [pos_cat, ct[neg_ev]]).astype(np.int32)[perm],
        "label": np.concatenate(
            [np.ones(n), np.zeros(n)]).astype(np.float32)[perm],
        "neg_item_seq": dup(it[neg_pos_ev].astype(np.int32)),
        "neg_cat_seq": dup(ct[neg_pos_ev].astype(np.int32)),
    }


def process_csv_native(path: str, seq_len: int, behavior_col: int = -1,
                       behavior_keep: str = "", seed: int = 0,
                       min_events: int = 5) -> Dict[str, np.ndarray]:
    """Native C++ parse (millions of rows/s) + vectorized assembly."""
    from . import native

    ev = native.parse_csv(path, behavior_col, behavior_keep)
    arrays = process_events(ev["uid"], ev["item"], ev["cat"], ev["ts"],
                            seq_len, seed=seed, min_events=min_events)
    arrays["_n_items"] = np.asarray(ev["n_items"], np.int64)
    arrays["_n_cats"] = np.asarray(ev["n_cats"], np.int64)
    arrays["_n_users"] = np.asarray(ev["n_users"], np.int64)
    return arrays


REQUIRED_KEYS = ("uid", "item_seq", "cat_seq", "seq_mask", "target_item",
                 "target_cat", "label", "neg_item_seq", "neg_cat_seq")


def save_preprocessed(path: str, arrays: Dict[str, np.ndarray],
                      compressed: bool = True) -> None:
    """compressed=False writes a plain .npz that ``load_preprocessed`` can
    memory-map — preferred for lifelong-scale datasets (XLong real data is
    GBs of id sequences; mmap keeps the loader's row-gather lazy)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    (np.savez_compressed if compressed else np.savez)(path, **arrays)


def _mmap_npz_members(path: str, keys) -> Dict[str, np.ndarray]:
    """True memory-maps of an uncompressed .npz's members.

    numpy SILENTLY IGNORES ``mmap_mode`` for zip archives (np.load returns
    eager ndarrays), so lifelong-scale datasets (XLong real data is GBs of
    id sequences) would be fully materialized at load. This computes each
    STORED member's absolute data offset (zip local header + npy header)
    and maps it with ``np.memmap`` — zero-copy until the loader gathers
    batch rows. Raises ValueError for compressed/unsupported members
    (caller falls back to eager load)."""
    import struct
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        infos = {i.filename: i for i in zf.infolist()}
        for key in keys:
            info = infos[f"{key}.npy"]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{key}: compressed member, cannot mmap")
            # npy header size: parse through the zip stream reader, whose
            # tell() is the position within the member.
            with zf.open(info.filename) as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(f)
                else:
                    raise ValueError(f"{key}: npy format {version}")
                npy_data_start = f.tell()
            if dtype.hasobject:
                raise ValueError(f"{key}: object dtype, cannot mmap")
            # Zip local file header: 30 fixed bytes; name/extra lengths at
            # offsets 26/28 (the LOCAL lengths can differ from the central
            # directory's — read them from the file).
            raw.seek(info.header_offset + 26)
            namelen, extralen = struct.unpack("<HH", raw.read(4))
            data_off = (info.header_offset + 30 + namelen + extralen
                        + npy_data_start)
            out[key] = np.memmap(path, dtype=dtype, mode="r",
                                 offset=data_off, shape=shape,
                                 order="F" if fortran else "C")
    return out


def load_preprocessed(data_dir: str, spec: DatasetSpec,
                      mmap: str = "auto") -> Dict[str, np.ndarray]:
    """Load ``<data_dir>/<dataset>.npz`` in the emitted format; validates
    the schema and sequence length against the dataset spec. mmap: "auto"
    memory-maps uncompressed archives and falls back to eager for
    compressed ones; True forces (raises if not mappable); False forces
    eager."""
    path = os.path.join(data_dir, f"{spec.name}.npz")
    z = np.load(path)
    if mmap is True or mmap == "auto":
        try:
            arrays = _mmap_npz_members(path, REQUIRED_KEYS)
        except (ValueError, KeyError):
            if mmap is True:
                raise
            arrays = {k: z[k] for k in REQUIRED_KEYS}
    else:
        arrays = {k: z[k] for k in REQUIRED_KEYS}
    T = arrays["item_seq"].shape[1]
    if T != spec.seq_len:
        raise ValueError(
            f"{path}: sequence length {T} != spec T={spec.seq_len}")
    # Real vocab sizes: the caller must size the embedding tables from
    # these, NOT from the synthetic stand-in spec (whose vocabs are
    # scaled-down placeholders) — otherwise out-of-range ids silently clamp.
    for key, id_keys in (("_n_items", ("item_seq", "target_item")),
                         ("_n_cats", ("cat_seq", "target_cat")),
                         ("_n_users", ("uid",))):
        if key in z:
            arrays[key] = np.asarray(int(z[key]), np.int64)
        else:
            arrays[key] = np.asarray(
                max(int(arrays[k].max()) for k in id_keys) + 1, np.int64)
    return arrays
