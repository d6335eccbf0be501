"""Lifelong serving for every family outside ``protocol.O1_FAMILIES``
(dien, dnn, lstm, caser, shan, svdpp, bst): a bounded window of each
user's W most recent behaviours, re-encoded per request — counterpart of
``hpmn_tpu/serving/history.py::HistoryStore`` and of its persistence and
bundles.

    store = HistoryStore(cfg, model)            # on the card, as the model
    store.ingest_histories(uids, item_seqs, cat_seqs, masks)  # cold start
    store.update(uids, item_ids, cat_ids)       # one new behaviour per user
    scores = store.predict(uids, cand_items, cand_cats)           # [B]
    scores = store.rank(uids, cand_items_bc, cand_cats_bc)        # [B, C]
    store.save_bundle(dir); store = HistoryStore.load_bundle(dir)

These families have no target-independent recurrence that one event
updates (DIEN and BST attend over every step from the candidate), so
``UserMemoryStore`` refuses them: the store keeps the ids and re-encodes
with the candidate as the target. The window has the
training layout: ``[W]`` int32 ids, left-padded with zeros, the newest
event at W-1, mask 1.0 at valid positions; W defaults to the dataset's
sequence length. A user with at most W events scores exactly what
``apply_model`` gives on their full history; beyond W the window slides
(the oldest event drops). One event per distinct user per ``update``.

The ids live on the host (a request moves ids up and scores down); the
uid -> row index, growth and LRU eviction are ``lifelong.UserRows``.
Scores are ``sigmoid(apply_model(...))`` on the model's device, under
``no_grad`` and with DIEN's auxiliary loss off (it reads the batch's
negatives and never the logits): with ``use_pallas`` each DIEN scoring
call runs K1 (the interest GRU, masked) and K1-scale (the AUGRU); the six
families of ``models/extra_baselines.py`` run no kernel, as in JAX. A
cold user scores from an all-masked window (BST's appended target keeps
its attention defined). A call scores at most
``max_score_rows`` (user, candidate) rows at a time, so a large ``rank``
cannot take the device's memory; each row's score depends on that row
alone, so the chunking changes no score. The batch carries the uids:
with ``use_user_emb`` the tower reads the user's embedding and SVD++
its ``p_u`` row, and a uid outside that table raises
(``lifelong.check_user_ids``) where JAX's gather would fill or clamp.

Persistence keeps the JAX package's files: ``save``/``load`` write and read
``user_history.npz`` (uids, the windows' ids, the counts and W), and a
bundle is that file plus ``lifelong.save_params_npz``'s params.npz and
serving_config.json with ``store: "history"`` and the window; the
module-level :func:`load_bundle` opens any bundle with its store's class.
``save_bundle(export_compiled=True)`` adds the scoring function as a
``torch.export`` graph (:func:`export_history_scoring`), which
:class:`AotHistoryStore` serves with no model code
(``aot.load_aot_store`` dispatches on the bundle's store kind).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import Config, config_to_dict
from ..data.schema import Batch, batch_from_numpy
from ..data.synthetic import SPECS
from ..models.model import apply_model, check_supported
from .lifelong import (UserMemoryStore, UserRows, _write_meta,
                       check_user_ids, load_bundle_params, reads_user_ids,
                       save_params_npz, user_rows)


def score_config(cfg: Config) -> Config:
    """The config a history store scores with: DIEN's auxiliary loss off
    (it reads the batch's negatives and never the logits); no other
    family reads the field."""
    return cfg.with_model(dien_use_aux_loss=False)


def score_batch(model, score_cfg: Config, batch: Batch) -> torch.Tensor:
    """The history store's scoring math: sigmoid(apply_model) [B], with
    ``score_cfg`` (:func:`score_config`). The store runs it eagerly and
    :func:`export_history_scoring` traces it."""
    logits, _ = apply_model(model, score_cfg, batch)
    return torch.sigmoid(logits)


class HistoryStore(UserRows):
    """Per-user recent-history windows with batched re-encoding
    predict/rank; the public API of ``UserMemoryStore``. ``model`` None
    makes a store without model code (:class:`AotHistoryStore`, which
    brings its own scoring)."""

    def __init__(self, cfg: Config, model, window: Optional[int] = None,
                 max_users: Optional[int] = None, max_score_rows: int = 8192,
                 device="cuda"):
        check_supported(cfg)
        self.device = torch.empty(0, device=device).device  # "cuda" -> cuda:i
        if model is not None and model.embedding.item.device != self.device:
            raise ValueError(f"the model is on {model.embedding.item.device}"
                             f", the store on {self.device}: move one")
        self.cfg = cfg
        self._score_cfg = score_config(cfg)
        self.model = model
        self._user_rows = 0 if model is None else user_rows(cfg, model)
        self.window = int(window) if window else SPECS[cfg.dataset].seq_len
        # Rows per scoring call (0: no bound): the encode's activations
        # grow with rows x W.
        self.max_score_rows = int(max_score_rows)
        cap = self._init_rows(max_users)
        self._items = np.zeros((cap, self.window), np.int32)
        self._cats = np.zeros((cap, self.window), np.int32)
        self._cnt = np.zeros((cap,), np.int64)  # lifetime event count

    # ------------------------------------------------------------ arena --
    def _grow_rows(self, cap: int, new_cap: int) -> None:
        for name in ("_items", "_cats", "_cnt"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:cap] = old
            setattr(self, name, new)

    def _clear_rows(self, rows: list) -> None:
        self._items[rows] = 0
        self._cats[rows] = 0
        self._cnt[rows] = 0

    # -------------------------------------------------------- operations --
    def update(self, uids, item_ids, cat_ids) -> None:
        """Append one behaviour per listed (distinct) user: the window
        slides left by one and the event lands at W-1."""
        rows = self._rows_for(np.asarray(uids), create=True)
        self._items[rows, :-1] = self._items[rows, 1:]
        self._cats[rows, :-1] = self._cats[rows, 1:]
        self._items[rows, -1] = np.asarray(item_ids, np.int32)
        self._cats[rows, -1] = np.asarray(cat_ids, np.int32)
        self._cnt[rows] += 1
        self._touch(rows)

    def ingest_histories(self, uids, item_seqs, cat_seqs, masks=None) -> None:
        """Set users' windows from whole histories (cold start): the last
        <= W valid events, right-aligned; the same windows as replaying
        each history through :meth:`update`. Overwrites their state."""
        item_seqs = np.asarray(item_seqs, np.int32)
        cat_seqs = np.asarray(cat_seqs, np.int32)
        W = self.window
        valid = (np.ones(item_seqs.shape, bool) if masks is None
                 else np.asarray(masks) > 0)
        rows = self._rows_for(np.asarray(uids), create=True)
        self._items[rows] = 0
        self._cats[rows] = 0
        for i, r in enumerate(rows):  # ragged per-user tails
            idx = np.flatnonzero(valid[i])[-W:]
            n = len(idx)
            if n:
                self._items[r, W - n:] = item_seqs[i, idx]
                self._cats[r, W - n:] = cat_seqs[i, idx]
            self._cnt[r] = n
        self._touch(rows)

    def _batch_arrays(self, uids, rows, cand_items, cand_cats) -> dict:
        """The scoring batch's arrays: unknown users (row -1) get the
        cold-start window, every step masked."""
        known = rows >= 0
        safe = np.where(known, rows, 0)
        W = self.window
        n_valid = np.minimum(np.where(known, self._cnt[safe], 0), W)
        zeros = np.zeros((len(rows), W), np.int32)
        return dict(
            uid=np.asarray(uids, np.int32),
            item_seq=np.where(known[:, None], self._items[safe], 0),
            cat_seq=np.where(known[:, None], self._cats[safe], 0),
            seq_mask=(np.arange(W)[None, :] >= (W - n_valid)[:, None]
                      ).astype(np.float32),
            target_item=cand_items, target_cat=cand_cats,
            label=np.zeros((len(rows),), np.float32),
            neg_item_seq=zeros, neg_cat_seq=zeros)

    @torch.no_grad()
    def _score_rows(self, uids, rows, cand_items, cand_cats) -> np.ndarray:
        """Scores of flat (user row, candidate) pairs, at most
        ``max_score_rows`` per call of the model."""
        if reads_user_ids(self.cfg):
            check_user_ids(self._user_rows, uids)
        n = len(rows)
        step = self.max_score_rows or max(n, 1)
        out = np.empty((n,), np.float32)
        for lo in range(0, n, step):
            sl = slice(lo, lo + step)
            batch = batch_from_numpy(
                self._batch_arrays(uids[sl], rows[sl], cand_items[sl],
                                   cand_cats[sl]), device=self.device)
            # float32 holds a bf16 model's bf16 scores exactly (JAX
            # returns them as ml_dtypes.bfloat16, which numpy lacks).
            out[sl] = self._score(batch).float().cpu().numpy()
        return out

    def _score(self, batch: Batch) -> torch.Tensor:
        """sigmoid(apply_model) [rows] of one scoring batch."""
        return score_batch(self.model, self._score_cfg, batch)

    def predict(self, uids, cand_items, cand_cats) -> np.ndarray:
        """CTR scores sigmoid(logit) [B] for (user, candidate) pairs."""
        uids = np.asarray(uids)
        rows = self._rows_for(uids, create=False)
        out = self._score_rows(uids, rows, np.asarray(cand_items, np.int32),
                               np.asarray(cand_cats, np.int32))
        self._touch(rows[rows >= 0])
        return out

    def rank(self, uids, cand_items, cand_cats) -> np.ndarray:
        """Scores [B, C] of C candidates per user; column c equals
        ``predict(uids, cand_items[:, c], cand_cats[:, c])``. The encode
        depends on the candidate, so each (user, candidate) row is encoded
        on its own: B*C rows, in chunks of ``max_score_rows``."""
        uids = np.asarray(uids)
        cand_items = np.asarray(cand_items, np.int32)
        B, C = cand_items.shape
        rows = self._rows_for(uids, create=False)
        rep = np.repeat(np.arange(B), C)
        out = self._score_rows(uids[rep], rows[rep], cand_items.reshape(-1),
                               np.asarray(cand_cats, np.int32).reshape(-1))
        self._touch(rows[rows >= 0])
        return out.reshape(B, C)

    # ------------------------------------------------------- persistence --
    def save(self, directory: str) -> None:
        """The live users' windows, counts and uids, and W, in
        ``directory/user_history.npz``."""
        os.makedirs(directory, exist_ok=True)
        live = np.flatnonzero(self._row_uid >= 0)
        np.savez(os.path.join(directory, "user_history.npz"),
                 uids=self._row_uid[live], items=self._items[live],
                 cats=self._cats[live], counts=self._cnt[live],
                 window=np.int64(self.window))

    def _restore(self, directory: str) -> None:
        path = os.path.join(directory, "user_history.npz")
        if not os.path.exists(path):
            return
        with np.load(path) as z:
            uids = z["uids"]
            if not len(uids):
                return
            if int(z["window"]) != self.window:
                raise ValueError(f"bundle window {int(z['window'])} != "
                                 f"store window {self.window}")
            rows = self._rows_for(uids, create=True)
            self._items[rows] = z["items"]
            self._cats[rows] = z["cats"]
            self._cnt[rows] = z["counts"]
        self._touch(rows)

    @classmethod
    def load(cls, directory: str, cfg: Config, model,
             window: Optional[int] = None, max_users: Optional[int] = None,
             max_score_rows: int = 8192, device="cuda") -> "HistoryStore":
        """A store of ``model`` holding the users of ``save``'s snapshot
        in ``directory`` (empty without one)."""
        store = cls(cfg, model, window=window, max_users=max_users,
                    max_score_rows=max_score_rows, device=device)
        store._restore(directory)
        return store

    def save_bundle(self, directory: str,
                    quantize_embeddings: bool = False,
                    export_compiled: bool = False,
                    export_platforms=("cpu", "cuda")) -> None:
        """The memory store's bundle layout, with ``store: "history"`` and
        the window, so :func:`load_bundle` dispatches on it. With
        ``export_compiled`` it also holds the scoring function as
        ``torch.export`` graphs, one file per platform
        (:func:`export_history_scoring`; "cuda" needs a card)."""
        self.save(directory)
        save_params_npz(self.model, directory, quantize_embeddings)
        meta = {"config": config_to_dict(self.cfg),
                "max_users": self.max_users, "store": "history",
                "window": self.window}
        if export_compiled:
            from .aot import save_exported

            meta["exported"] = save_exported(
                directory, export_history_scoring(
                    self.cfg, self.model, self.window, export_platforms),
                self.model)
        _write_meta(directory, meta)

    @classmethod
    def load_bundle(cls, directory: str, max_score_rows: int = 8192,
                    device="cuda") -> "HistoryStore":
        """Restore a ``save_bundle`` artifact (the port's or the JAX
        package's) on ``device``."""
        meta, cfg, model = load_bundle_params(directory, device)
        if meta.get("store", "memory") != "history":
            raise ValueError(f"bundle at {directory} is not a history-store "
                             f"artifact")
        return cls.load(directory, cfg, model, window=meta.get("window"),
                        max_users=meta.get("max_users"),
                        max_score_rows=max_score_rows, device=device)


def _score_graph(model, score_cfg: Config, items, cats, mask, uids, ci, cc):
    """:func:`score_batch` of a history batch's arrays (the graph's
    requests): the windows [b, W], their mask, the uids and one candidate
    per row."""
    z = torch.zeros_like(items)
    batch = Batch(uid=uids, item_seq=items, cat_seq=cats, seq_mask=mask,
                  target_item=ci, target_cat=cc,
                  label=mask.new_zeros(items.shape[0]), neg_item_seq=z,
                  neg_cat_seq=z)
    return score_batch(model, score_cfg, batch)


def export_history_scoring(cfg: Config, model, window: int,
                           platforms=("cpu", "cuda")) -> Dict:
    """Export the history store's scoring, the window re-encode with the
    candidate as attention target, -> {"score": {platform:
    ExportedProgram}} (``aot.export_function``: the parameters are inputs).
    The graph takes (item_seq, cat_seq [b, W] int32, seq_mask [b, W] f32,
    uids, target_item, target_cat [b] int32) and returns scores [b]; b is
    symbolic, W the bundle's window. The traced math is
    :func:`score_batch`, ``apply_model`` with the aux loss off: with
    ``use_pallas`` DIEN's two scans are K1 and K1-scale, each one
    ``hpmn::gru_scan_fwd`` node; the other families trace plain ops (BST's
    chunked inner blocks unrolled over the window's chunks, its last block
    from the target's query)."""
    from torch.export import Dim

    from .aot import _EXAMPLE_B, _platform_device, export_function

    for p in platforms:
        _platform_device(p)  # raise before any tracing
    b = Dim("b")
    i32 = torch.int32
    win = torch.zeros(_EXAMPLE_B, window, dtype=i32)
    vec = torch.zeros(_EXAMPLE_B, dtype=i32)
    mask = torch.ones(_EXAMPLE_B, window)
    dims = ({0: b},) * 6
    return {"score": {p: export_function(_score_graph, score_config(cfg),
                                         model, (win, win, mask, vec, vec,
                                                 vec), dims, p)
                      for p in platforms}}


class AotHistoryStore(HistoryStore):
    """A :class:`HistoryStore` whose scoring runs an exported graph
    (:func:`export_history_scoring`) instead of model code (load it with
    ``aot.load_aot_store`` or the daemon's ``--aot``). Updates and ingest
    are host-side array writes and work unchanged; ``save()`` persists
    the windows; re-exporting a bundle needs the trainer-side store. The
    ``max_score_rows`` chunking stays. ``leaves``: the parameters by
    keystr, in the manifest's ``leaf_order``."""

    def __init__(self, cfg: Config, leaves: Dict[str, np.ndarray], program,
                 window: Optional[int] = None,
                 max_users: Optional[int] = None,
                 max_score_rows: int = 8192, device="cuda"):
        from .aot import leaf_tensors

        super().__init__(cfg, None, window=window, max_users=max_users,
                         max_score_rows=max_score_rows, device=device)
        self._leaves, self._user_rows = leaf_tensors(leaves, self.device)
        self._run = program.module()

    def _score(self, batch: Batch) -> torch.Tensor:
        i32 = torch.int32
        return self._run((batch.item_seq.to(i32), batch.cat_seq.to(i32),
                          batch.seq_mask, batch.uid.to(i32),
                          batch.target_item.to(i32),
                          batch.target_cat.to(i32)), self._leaves)

    def save_bundle(self, *a, **k):
        raise ValueError("AotHistoryStore cannot re-export a bundle; its "
                         "window state persists via save() (the daemon's "
                         "--save_on_exit path)")


def load_bundle(directory: str, device="cuda", **kwargs):
    """Open any bundle with its store's class, from serving_config.json's
    ``store`` ("memory", also a bundle without the field:
    ``UserMemoryStore``; "history": ``HistoryStore``). ``kwargs`` go to
    that class's ``load_bundle``; the other class's options are dropped
    (``arena_dtype`` is the memory arena's, ``max_score_rows`` the history
    store's)."""
    with open(os.path.join(directory, "serving_config.json")) as f:
        kind = json.load(f).get("store", "memory")
    if kind == "history":
        kwargs.pop("arena_dtype", None)
        return HistoryStore.load_bundle(directory, device=device, **kwargs)
    kwargs.pop("max_score_rows", None)
    return UserMemoryStore.load_bundle(directory, device=device, **kwargs)
