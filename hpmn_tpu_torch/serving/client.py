"""Client for the serving daemon (``serving/server.py``) — counterpart of
``hpmn_tpu/serving/client.py``; it talks to either package's daemon.

Speaks the length-prefixed JSON frame protocol. One socket per client;
``predict``/``rank``/``update`` are blocking request-response calls guarded
by a lock, so a single client is safe to share across threads (calls
serialize); for concurrent load create one client per thread and let the
server's MicroBatcher fuse it.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional, Sequence

import numpy as np

from .server import read_frame, write_frame


class ServingClient:
    def __init__(self, host: str, port: int, timeout_s: float = 60.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._lock = threading.Lock()
        self._next_id = 0

    def _call(self, method: str, **payload) -> dict:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            write_frame(self._sock, {"id": rid, "method": method, **payload})
            resp = read_frame(self._sock)
        if resp is None:
            raise ConnectionError("server closed the connection")
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "unknown serving error"))
        return resp

    def predict(self, uids: Sequence[int], cand_items: Sequence[int],
                cand_cats: Sequence[int],
                model: Optional[str] = None) -> np.ndarray:
        """CTR scores for (user, candidate) pairs -> float32 [B].
        ``model`` addresses a named store on a multi-model daemon
        (``--extra_bundle NAME=PATH``); None = "default"."""
        r = self._call("predict", uids=_l(uids), cand_items=_l(cand_items),
                       cand_cats=_l(cand_cats), **_m(model))
        return np.asarray(r["scores"], np.float32)

    def rank(self, uids: Sequence[int], cand_items, cand_cats,
             model: Optional[str] = None) -> np.ndarray:
        """Score C candidates per user -> float32 [B, C]."""
        r = self._call("rank", uids=_l(uids), cand_items=_l(cand_items),
                       cand_cats=_l(cand_cats), **_m(model))
        return np.asarray(r["scores"], np.float32)

    def update(self, uids: Sequence[int], item_ids: Sequence[int],
               cat_ids: Sequence[int], model: Optional[str] = None) -> None:
        """Ingest one behavior per user into the lifelong memories."""
        self._call("update", uids=_l(uids), item_ids=_l(item_ids),
                   cat_ids=_l(cat_ids), **_m(model))

    def reload(self, bundle: str, model: Optional[str] = None) -> int:
        """Zero-downtime model refresh: swap the named model's store for a
        freshly loaded bundle (daemon-side path). Returns the new store's
        user count. Queued requests are answered (the swap serializes on
        the dispatcher); the model's journal is truncated: the new bundle
        is the new ground truth."""
        r = self._call("reload", bundle=bundle, **_m(model))
        return int(r.get("n_users", 0))

    def stats(self) -> dict:
        return self._call("stats")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _l(a) -> List:
    return np.asarray(a).tolist()


def _m(model: Optional[str]) -> dict:
    return {"model": model} if model else {}
