"""Lifelong serving: per-user encoder state with O(1) updates per event —
counterpart of ``hpmn_tpu/serving/lifelong.py::UserMemoryStore`` in its
device-resident form, for every family of ``protocol.O1_FAMILIES`` (hpmn,
gru4rec, rum).

    store = UserMemoryStore(cfg, model)        # on the card, as the model
    store.ingest_histories(uids, item_seqs, cat_seqs)  # cold start, batched
    store.update(uids, item_ids, cat_ids)      # one new behaviour per user
    scores = store.predict(uids, cand_items, cand_cats)           # [B]
    scores = store.rank(uids, cand_items_bc, cand_cats_bc)        # [B, C]
    store.save(dir); store = UserMemoryStore.load(dir, cfg, model)
    store.save_bundle(dir); store = UserMemoryStore.load_bundle(dir)

The state arena ``[capacity, K, d_m]`` (K = ``protocol.n_state_slots(cfg)``)
and the event counters live on ``device``; the uid -> row index, the LRU
clock and eviction stay on the host. A request moves ids up and scores
down. Arena rows are updated in place. The arena is f32, or with
``arena_dtype="bfloat16"`` stored in bf16 (half the bytes per user):
gathers upcast to f32, every request computes in f32 and write-backs
round. With ``use_user_emb`` the tower reads the user's embedding too.

Persistence keeps the JAX package's files, so a store moves between the
two packages: ``save``/``load`` write and read ``user_memory.npz`` (f32
whatever the arena's dtype; a bf16 store rounds once on load), and a
deployment bundle (``save_bundle``/``load_bundle``) is that file plus
``params.npz`` (the flat keystr arrays of ``convert.flat_from_model``, the
2-D embedding tables optionally per-row symmetric int8) and
``serving_config.json`` (the config, ``max_users``, ``store: "memory"``).
``save_bundle(export_compiled=True)`` adds the request functions as
``torch.export`` graphs, which ``serving/aot.py::AotStore`` serves with no
model code. The request math is :func:`update_memory`,
:func:`predict_scores` and :func:`rank_scores`: the store runs them
eagerly and ``serving/aot.py`` traces the same functions.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import Config, config_from_dict, config_to_dict
from ..convert import (flat_from_model, is_bf16, model_from_flat,
                       tensor_from_array)
from ..models.embedding import dense_lookup, user_lookup
from ..models.model import check_supported, model_n_users
from ..models.tower import apply_tower
from ..train.checkpoint import load_user_memory, save_user_memory
from .protocol import (O1_FAMILIES, encode_full, n_state_slots, read_state,
                       update_state)


_ARENA_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bundle_array(z, key: str) -> np.ndarray:
    """One parameter from a bundle's params.npz by keystr, dequantizing an
    int8 table (``save_params_npz(quantize_embeddings=True)``) per row."""
    if key in z.files:
        return z[key]
    q = z["__q8__" + key].astype(np.float32)
    return q * z["__q8scale__" + key]


def _quantize_rows(a: np.ndarray):
    """-> (int8 rows, scales) of a 2-D table, in float32 arithmetic; a
    bf16 table's exact float32 values first (JAX's ``ml_dtypes`` arrays
    promote to float32 against the Python 127.0)."""
    if is_bf16(a):
        a = tensor_from_array(a).float().numpy()
    scale = np.abs(a).max(axis=1, keepdims=True) / 127.0
    scale[scale == 0] = 1.0
    return np.clip(np.rint(a / scale), -127, 127).astype(np.int8), scale


def save_params_npz(model, directory: str,
                    quantize_embeddings: bool = False) -> None:
    """Write a bundle's params.npz (every store kind's): the model's
    arrays by JAX keystr (a bf16 model's as the ``|V2`` bytes JAX's
    ``np.savez`` writes), the 2-D embedding tables optionally as per-row
    symmetric int8 (scale = max |row| / 127, a zero row's scale 1) under
    ``__q8__<key>`` with the f32 scales under ``__q8scale__<key>``, the
    JAX package's arithmetic."""
    arrays = {}
    for key, a in flat_from_model(model).items():
        if (quantize_embeddings and key.startswith("['embedding'][")
                and a.ndim == 2):
            q, scale = _quantize_rows(a)
            arrays["__q8__" + key] = q
            arrays["__q8scale__" + key] = scale.astype(np.float32)
        else:
            arrays[key] = a
    np.savez(os.path.join(directory, "params.npz"), **arrays)


def load_bundle_params(directory: str, device="cuda"):
    """-> (meta dict, cfg, model on ``device``) from any bundle, the
    port's or the JAX package's: the config read from
    serving_config.json (``config_from_dict``), the parameters placed by
    keystr (``convert.model_from_flat``), int8 tables dequantized."""
    with open(os.path.join(directory, "serving_config.json")) as f:
        meta = json.load(f)
    cfg = config_from_dict(meta["config"])
    with np.load(os.path.join(directory, "params.npz")) as z:
        keys = [k.replace("__q8__", "", 1) for k in z.files
                if not k.startswith("__q8scale__")]
        flat = {k: _bundle_array(z, k) for k in keys}
    return meta, cfg, model_from_flat(cfg, flat, device=device)


def reads_user_ids(cfg: Config) -> bool:
    """Whether scoring reads a table by the request's uids: the user table
    (use_user_emb) or SVD++'s user factors ``p_u``."""
    return cfg.model.use_user_emb or cfg.model.name == "svdpp"


def check_user_ids(n: int, uids: np.ndarray) -> None:
    """Raise unless every uid has a row in a user table of ``n`` rows: a
    request's uids index it on the device, where a row out of range would
    fault the card instead of raising. (The JAX gather fills or clamps
    such a row silently.)"""
    if len(uids) and (uids.min() < 0 or uids.max() >= n):
        raise ValueError(f"uids must lie in [0, {n}), the user table's "
                         f"rows (use_user_emb, or svdpp's p_u); got "
                         f"{uids.min()} to {uids.max()}")


def user_rows(cfg: Config, model) -> int:
    """The rows of the table the request's uids index
    (:func:`reads_user_ids`; 0 when none is read)."""
    return model_n_users(model) if reads_user_ids(cfg) else 0


def update_memory(model, cfg: Config, mem: torch.Tensor, cnt: torch.Tensor,
                  items: torch.Tensor, cats: torch.Tensor):
    """One event per row: mem [B, K, d_m] f32, cnt [B], items and cats [B]
    ids -> (mem', cnt + 1) (``protocol.update_state``)."""
    x = dense_lookup(model.embedding, items, cats)
    return update_state(cfg.model.name, model.encoder, mem, cnt, x,
                        cfg.model.hpmn_period)


def predict_scores(model, cfg: Config, mem: torch.Tensor, uids: torch.Tensor,
                   items: torch.Tensor, cats: torch.Tensor) -> torch.Tensor:
    """sigmoid(tower([q; read; user])) [B] for mem [B, K, d_m] f32 and one
    candidate per row; uids [B] are read only with use_user_emb."""
    q = dense_lookup(model.embedding, items, cats)
    read = read_state(cfg.model.name, model, mem, q)
    parts = [q, read]
    if cfg.model.use_user_emb:
        parts.append(user_lookup(model.embedding, uids))
    return torch.sigmoid(apply_tower(model.tower, torch.cat(parts, dim=-1)))


def rank_scores(model, cfg: Config, mem: torch.Tensor, uids: torch.Tensor,
                items: torch.Tensor, cats: torch.Tensor) -> torch.Tensor:
    """:func:`predict_scores` of C candidates per row: items and cats
    [B, C] -> [B, C]. Each row's state and uid are broadcast over its
    candidates by expand + reshape, which a traced graph takes with B and
    C symbolic (``repeat_interleave`` needs a concrete count)."""
    B, C = items.shape
    mem_bc = mem[:, None].expand(B, C, *mem.shape[1:]).reshape(
        B * C, *mem.shape[1:])
    uid_bc = uids[:, None].expand(B, C).reshape(B * C)
    return predict_scores(model, cfg, mem_bc, uid_bc, items.reshape(B * C),
                          cats.reshape(B * C)).reshape(B, C)


def _write_meta(directory: str, meta: Dict) -> None:
    with open(os.path.join(directory, "serving_config.json"), "w") as f:
        json.dump(meta, f)


class UserRows:
    """uid -> arena row, with amortized doubling growth and bulk LRU
    eviction: the host-side index that ``UserMemoryStore`` and
    ``serving.history.HistoryStore`` share (the JAX stores' identical
    mechanics). A subclass allocates its per-row arrays in ``__init__``
    (capacity ``_initial_capacity()``) and implements ``_grow_rows`` and
    ``_clear_rows``. With ``max_users`` set, a full store evicts the least
    recently touched quarter in one pass; an evicted user who comes back
    starts empty."""

    _MIN_CAP = 1024

    def _init_rows(self, max_users: Optional[int]) -> int:
        """Set up the index; -> the arena's first capacity."""
        self.max_users = max_users
        cap = (self._MIN_CAP if max_users is None
               else min(self._MIN_CAP, max_users))
        self._last_touch = np.zeros((cap,), np.int64)  # LRU clock per row
        self._clock = 0
        self._row: Dict[int, int] = {}  # uid -> arena row
        self._row_uid = np.full((cap,), -1, np.int64)  # row -> uid
        self._next_row = 0  # high-water mark; evicted rows are recycled
        self._free_rows: list = []
        return cap

    @property
    def n_users(self) -> int:
        return len(self._row)

    def _grow_rows(self, cap: int, new_cap: int) -> None:
        """Extend the subclass's per-row arrays from cap to new_cap rows."""
        raise NotImplementedError

    def _clear_rows(self, rows: list) -> None:
        """Reset the subclass's state of rows just allocated or recycled."""
        raise NotImplementedError

    def _grow(self, need: int) -> None:
        cap = len(self._row_uid)
        new_cap = max(cap * 2, need, self._MIN_CAP)
        if self.max_users is not None:
            new_cap = min(new_cap, max(self.max_users, need))
        for name, fill in (("_last_touch", 0), ("_row_uid", -1)):
            old = getattr(self, name)
            new = np.full((new_cap,), fill, old.dtype)
            new[:cap] = old
            setattr(self, name, new)
        self._grow_rows(cap, new_cap)

    def _evict(self, need: int, protected=frozenset()) -> None:
        """Drop the ~25% least recently touched users (or ``need``, if
        more) in one pass. ``protected`` rows belong to the request in
        flight and are never evicted."""
        n_live = len(self._row)
        live = np.flatnonzero(self._row_uid >= 0)
        if protected:
            live = live[~np.isin(live, np.fromiter(protected, np.int64))]
        if len(live) < need:
            raise ValueError(
                f"cannot evict {need} rows: only {len(live)} unprotected "
                f"users (max_users={self.max_users} smaller than the "
                f"request batch's distinct-user count?)")
        k = min(len(live), max(n_live // 4, need))
        victims = live[np.argpartition(self._last_touch[live], k - 1)[:k]]
        for u in self._row_uid[victims]:
            del self._row[int(u)]
        self._row_uid[victims] = -1
        self._free_rows = victims.tolist()

    def _rows_for(self, uids: np.ndarray, create: bool) -> np.ndarray:
        """uid -> arena row (-1 for unknown users unless ``create``)."""
        rows = np.empty(len(uids), np.int64)
        row_map = self._row
        missing = []
        fresh = []  # rows allocated or recycled here, cleared below
        for i, u in enumerate(uids):
            r = row_map.get(int(u), -1)
            rows[i] = r
            if r < 0:
                missing.append(i)
        if missing and create:
            protected = {int(r) for r in rows if r >= 0}
            for i in missing:
                u = int(uids[i])
                r = row_map.get(u, -1)  # a new uid repeated in the batch
                if r < 0:
                    if self._free_rows:
                        r = self._free_rows.pop()
                    elif (self.max_users is not None
                          and self._next_row >= self.max_users):
                        self._evict(1, frozenset(protected))
                        r = self._free_rows.pop()
                    else:
                        if self._next_row >= len(self._row_uid):
                            self._grow(self._next_row + 1)
                        r = self._next_row
                        self._next_row += 1
                    row_map[u] = r
                    self._row_uid[r] = u
                    fresh.append(r)
                    protected.add(int(r))
                rows[i] = r
        if fresh:
            self._clear_rows(fresh)
        return rows

    def _touch(self, rows: np.ndarray) -> None:
        self._clock += 1
        self._last_touch[rows] = self._clock


class UserMemoryStore(UserRows):
    """Per-user encoder state (uid -> [K, d_m] slots + event counter) in a
    device arena with amortized doubling growth, for the families whose
    encoder is a target-independent recurrence (``O1_FAMILIES``): hpmn's L
    memory slots, gru4rec's GRU state, rum's K slots. With ``max_users``
    set, a full store evicts the least recently touched quarter in one
    pass; an evicted user who comes back starts from an empty state.
    ``uid_to_memory`` ({uid: [K, d_m]}) and ``counters`` ({uid: n}) seed
    it, as the JAX store's do. ``model`` None makes a store without model
    code (``serving/aot.py::AotStore``, which brings its own request
    math)."""

    def __init__(self, cfg: Config, model, max_users: Optional[int] = None,
                 device="cuda", arena_dtype: str = "float32",
                 uid_to_memory: Optional[dict] = None,
                 counters: Optional[dict] = None):
        if arena_dtype not in _ARENA_DTYPES:
            raise ValueError(f"arena_dtype {arena_dtype!r}: one of "
                             f"{sorted(_ARENA_DTYPES)}")
        if cfg.model.name not in O1_FAMILIES:
            raise ValueError(
                f"model family {cfg.model.name!r} has no target-"
                f"independent encoder recurrence, so there is no O(1) "
                f"per-event state update; UserMemoryStore serves "
                f"{O1_FAMILIES}. Serve this family with "
                f"serving.history.HistoryStore (bounded recent-history "
                f"window, batched re-encode per request).")
        check_supported(cfg)
        self.device = torch.empty(0, device=device).device  # "cuda" -> cuda:i
        if model is not None and model.embedding.item.device != self.device:
            raise ValueError(f"the model is on {model.embedding.item.device}"
                             f", the store on {self.device}: move one")
        self.cfg = cfg
        self.model = model
        self._user_rows = 0 if model is None else user_rows(cfg, model)
        self.family = cfg.model.name
        self.L = n_state_slots(cfg)
        self.d_m = cfg.model.mem_dim
        self.period = cfg.model.hpmn_period
        self.arena_dtype = arena_dtype
        cap = self._init_rows(max_users)
        self._mem = torch.zeros(cap, self.L, self.d_m, device=self.device,
                                dtype=_ARENA_DTYPES[arena_dtype])
        self._cnt = torch.zeros(cap, dtype=torch.int64, device=self.device)
        if uid_to_memory:
            uids = np.fromiter(uid_to_memory, dtype=np.int64)
            mem = np.stack([np.asarray(uid_to_memory[int(u)], np.float32)
                            for u in uids])
            cnt = np.array([(counters or {}).get(int(u), 0) for u in uids],
                           np.int64)
            self._set_rows(uids, mem, cnt)

    # ------------------------------------------------------------ arena --
    def _grow_rows(self, cap: int, new_cap: int) -> None:
        for name in ("_mem", "_cnt"):
            old = getattr(self, name)
            new = old.new_zeros((new_cap,) + tuple(old.shape[1:]))
            new[:cap] = old
            setattr(self, name, new)

    def _clear_rows(self, rows: list) -> None:
        fr = torch.as_tensor(rows, device=self.device)
        self._mem[fr] = 0.0
        self._cnt[fr] = 0

    def _set_rows(self, uids: np.ndarray, mem, cnt) -> None:
        """Write f32 memories (tensors or arrays) into the arena, rounded
        once to its dtype, and the counters."""
        rows = self._rows_for(uids, create=True)
        r = torch.as_tensor(rows, device=self.device)
        self._mem[r] = torch.as_tensor(mem, device=self.device).to(
            self._mem.dtype)
        self._cnt[r] = torch.as_tensor(cnt, device=self.device).to(
            self._cnt.dtype)
        self._touch(rows)

    def _gather(self, uids: np.ndarray):
        """(memory [B, L, d_m] f32, counters [B]) of ``uids``; unknown
        users read zeros (the cold-start state)."""
        rows = torch.as_tensor(self._rows_for(uids, create=False),
                               device=self.device)
        known = rows >= 0
        safe = torch.where(known, rows, 0)
        mem = torch.where(known[:, None, None], self._mem[safe].float(), 0.0)
        cnt = torch.where(known, self._cnt[safe], 0)
        return mem, cnt

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -------------------------------------------------------- operations --
    @torch.no_grad()
    def ingest_histories(self, uids, item_seqs, cat_seqs, masks=None) -> None:
        """Set many users' memories from whole histories in one batched
        encode; the same state as replaying each history through
        :meth:`update`. item_seqs, cat_seqs: [B, T] left-padded ids; masks:
        [B, T] or None (full histories). Overwrites these users' state.

        hpmn and gru4rec with a model whose embeddings are not float32
        raise TypeError, as the JAX store does: there the scan's carry
        comes in in the embeddings' dtype and goes out in float32 (the
        mask's)."""
        emb_dtype = self.model.embedding.item.dtype
        if self.family in ("hpmn", "gru4rec") and emb_dtype != torch.float32:
            raise TypeError(
                f"ingest_histories of a {self.family} model in {emb_dtype}: "
                "the JAX UserMemoryStore's encode scan raises here (its "
                "carry is the embeddings' dtype on the way in and float32 "
                "on the way out); replay the events through update()")
        items, cats = self._ids(item_seqs), self._ids(cat_seqs)
        # Gathering with the transposed ids gives time-major embeddings.
        x_tm = dense_lookup(self.model.embedding, items.T, cats.T)
        mask_tm = (None if masks is None else
                   self._ids(masks).to(torch.float32).T.contiguous())
        mem, counts = encode_full(self.family, self.model, x_tm, mask_tm,
                                  self.period)
        self._set_rows(np.asarray(uids), mem, counts)

    @torch.no_grad()
    def update(self, uids, item_ids, cat_ids) -> None:
        """Ingest one new behaviour per listed user (O(1) each)."""
        rows = self._rows_for(np.asarray(uids), create=True)
        r = torch.as_tensor(rows, device=self.device)
        mem, cnt = self._run_update(self._mem[r].float(), self._cnt[r],
                                    self._ids(item_ids), self._ids(cat_ids))
        self._mem[r] = mem.to(self._mem.dtype)
        self._cnt[r] = cnt
        self._touch(rows)

    def _request_uids(self, uids) -> np.ndarray:
        """uids as an array, checked against the user table with
        use_user_emb (a request's uids index it on the device)."""
        uids = np.asarray(uids)
        if self.cfg.model.use_user_emb:
            check_user_ids(self._user_rows, uids)
        return uids

    def _run_update(self, mem, cnt, items, cats):
        return update_memory(self.model, self.cfg, mem, cnt, items, cats)

    def _run_predict(self, mem, uids, items, cats) -> torch.Tensor:
        return predict_scores(self.model, self.cfg, mem, uids, items, cats)

    def _run_rank(self, mem, uids, items, cats) -> torch.Tensor:
        return rank_scores(self.model, self.cfg, mem, uids, items, cats)

    @torch.no_grad()
    def predict(self, uids, cand_items, cand_cats) -> np.ndarray:
        """CTR scores sigmoid(logit) [B] for (user, candidate) pairs."""
        uids = self._request_uids(uids)
        mem, _ = self._gather(uids)
        return self._run_predict(mem, self._ids(uids), self._ids(cand_items),
                                 self._ids(cand_cats)).cpu().numpy()

    @torch.no_grad()
    def rank(self, uids, cand_items, cand_cats) -> np.ndarray:
        """Scores [B, C] of C candidates per user in one call; column c
        equals ``predict(uids, cand_items[:, c], cand_cats[:, c])``."""
        uids = self._request_uids(uids)
        mem, _ = self._gather(uids)
        return self._run_rank(mem, self._ids(uids), self._ids(cand_items),
                              self._ids(cand_cats)).cpu().numpy()

    # ------------------------------------------------------- persistence --
    def save(self, directory: str) -> None:
        """The live users' memories (f32), counters and uids in
        ``directory/user_memory.npz``."""
        live = np.flatnonzero(self._row_uid >= 0)
        r = torch.as_tensor(live, device=self.device)
        save_user_memory(directory, self._row_uid[live],
                         self._mem[r].float().cpu().numpy(),
                         self._cnt[r].cpu().numpy())

    @classmethod
    def load(cls, directory: str, cfg: Config, model,
             max_users: Optional[int] = None, device="cuda",
             arena_dtype: str = "float32") -> "UserMemoryStore":
        """A store of ``model`` holding the users of ``save``'s snapshot
        in ``directory`` (empty without one)."""
        uids, mem, cnt = load_user_memory(directory)
        store = cls(cfg, model, max_users=max_users, device=device,
                    arena_dtype=arena_dtype)
        if len(uids):
            store._set_rows(uids, mem, cnt)
        return store

    def save_bundle(self, directory: str,
                    quantize_embeddings: bool = False,
                    export_compiled: bool = False,
                    export_platforms=("cpu", "cuda")) -> None:
        """A self-contained serving artifact in ``directory``: the user
        memories (``save``), params.npz (``save_params_npz``) and
        serving_config.json. A serving host needs nothing else. With
        ``export_compiled`` it also holds update, predict and rank as
        ``torch.export`` graphs, one file per kind and platform
        (``serving/aot.py``; "cuda" needs a card), which
        ``aot.load_aot_store`` serves with no model code."""
        self.save(directory)
        save_params_npz(self.model, directory, quantize_embeddings)
        meta = {"config": config_to_dict(self.cfg),
                "max_users": self.max_users, "store": "memory"}
        if export_compiled:
            from .aot import export_serving, save_exported

            meta["exported"] = save_exported(
                directory, export_serving(self.cfg, self.model,
                                          export_platforms), self.model)
        _write_meta(directory, meta)

    @classmethod
    def load_bundle(cls, directory: str, device="cuda",
                    arena_dtype: str = "float32") -> "UserMemoryStore":
        """Restore a ``save_bundle`` artifact (the port's or the JAX
        package's) on ``device``."""
        meta, cfg, model = load_bundle_params(directory, device)
        kind = meta.get("store", "memory")
        if kind != "memory":
            raise ValueError(
                f"bundle at {directory} is a {kind!r}-store artifact; load "
                f"it with the matching store class (serving.load_bundle "
                f"dispatches on it)")
        return cls.load(directory, cfg, model, max_users=meta.get("max_users"),
                        device=device, arena_dtype=arena_dtype)
