"""Horizontally sharded serving: uid-hash fan-out over independent daemons
— counterpart of ``hpmn_tpu/serving/sharded.py``.

A user's state is read and written by that user's requests alone, so
serving scales out with no coordination: run N independent daemons
(each owns the users hashed to it; the same bundle on every shard) and
fan requests out on the client. This module is that fan-out: a drop-in
with the ``ServingClient`` surface that partitions each request by
``uid % n_shards``, sends the per-shard sub-requests concurrently, and
puts the results back in request order. Each shard's daemon still
micro-batches its own stream (serving/server.py).

Placement is sticky by construction (the same uid goes to the same
shard), which keeps update->predict sequences coherent without any
routing state.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from .client import ServingClient


class ShardedServingClient:
    """Fan-out client over N daemon shards.

    addresses: [(host, port), ...]; shard i serves uids with
    ``uid % len(addresses) == i``.
    """

    def __init__(self, addresses: Sequence[Tuple[str, int]],
                 timeout_s: float = 60.0):
        if not addresses:
            raise ValueError("need at least one shard address")
        self._clients: List[ServingClient] = [
            ServingClient(h, p, timeout_s=timeout_s) for h, p in addresses]
        self._pool = ThreadPoolExecutor(
            max_workers=len(self._clients),
            thread_name_prefix="serving-shard")

    @property
    def n_shards(self) -> int:
        return len(self._clients)

    def _partition(self, uids: np.ndarray):
        shard = uids % self.n_shards
        return [np.flatnonzero(shard == s) for s in range(self.n_shards)]

    def _fan(self, call, uids, *fields, empty_tail=()):
        """Partition by uid, run call(client, sub_uids, *sub_fields) per
        non-empty shard concurrently, reassemble row results in order.
        empty_tail: trailing result shape for the zero-uid case so callers
        always get an array (as ServingClient does)."""
        uids = np.asarray(uids)
        parts = self._partition(uids) if len(uids) else []
        futs = []
        for s, part in enumerate(parts):
            if len(part) == 0:
                continue
            futs.append((part, self._pool.submit(
                call, self._clients[s], uids[part],
                *[np.asarray(f)[part] for f in fields])))
        out = None
        for part, fut in futs:
            res = fut.result()
            if res is None:
                continue
            if out is None:
                out = np.empty((len(uids),) + res.shape[1:], res.dtype)
            out[part] = res
        if out is None:
            out = np.zeros((0,) + tuple(empty_tail), np.float32)
        return out

    def predict(self, uids, cand_items, cand_cats, model=None) -> np.ndarray:
        return self._fan(lambda c, u, i, k: c.predict(u, i, k, model=model),
                         uids, cand_items, cand_cats)

    def rank(self, uids, cand_items, cand_cats, model=None) -> np.ndarray:
        ci = np.asarray(cand_items)
        tail = (ci.shape[1],) if ci.ndim == 2 else ()
        return self._fan(lambda c, u, i, k: c.rank(u, i, k, model=model),
                         uids, cand_items, cand_cats, empty_tail=tail)

    def update(self, uids, item_ids, cat_ids, model=None) -> None:
        self._fan(lambda c, u, i, k: c.update(u, i, k, model=model),
                  uids, item_ids, cat_ids)

    def reload(self, bundle: str, model=None) -> List[int]:
        """Swap every shard's store for a freshly loaded bundle (no
        downtime per shard; shards reload independently, so for a moment
        they serve mixed versions)."""
        return [c.reload(bundle, model=model) for c in self._clients]

    def stats(self) -> List[dict]:
        return [c.stats() for c in self._clients]

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for c in self._clients:
            c.close()

    def __enter__(self) -> "ShardedServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
