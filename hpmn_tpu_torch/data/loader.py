"""Batch iterator over example arrays — counterpart of
``hpmn_tpu/data/loader.py``, with its order, its padding and its state.

- Every process derives the same example order per epoch from (seed,
  epoch) and takes its contiguous slice of each global batch, so the global
  batch is the same for any process count.
- Training batches are always full (the tail of an epoch is dropped); eval
  batches (:meth:`DataLoader.one_epoch`) are padded to full and carry the
  count of real rows.
- The position (``epoch``, ``step``, ``seed``, ``global_batch``) is state
  that a checkpoint saves and a resumed run loads.

Batches are built on the host (CPU tensors over the rows that
``batch_from_numpy`` gathers, natively where the core is built); the
driver moves them to the card.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from .schema import Batch, batch_from_numpy


class DataLoader:
    """Shuffling, shardable, resumable batch iterator.

    ``batch_size`` is the per-process batch; the global batch is
    ``batch_size * process_count`` rows, process ``p`` taking rows
    ``[p*batch_size, (p+1)*batch_size)`` of it."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True, process_index: int = 0,
                 process_count: int = 1):
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.n = arrays["label"].shape[0]
        self.global_batch = batch_size * process_count
        self._offset = process_index * batch_size
        self._process_count = process_count
        # This process's static shard of the examples (eval: one_epoch).
        self._local_idx = np.arange(process_index, self.n, process_count)
        if shuffle and drop_remainder and self.n < self.global_batch:
            raise ValueError(
                f"dataset has {self.n} examples < global batch "
                f"{self.global_batch} (batch_size={batch_size} x "
                f"process_count={process_count}); shrink the batch or "
                f"grow the dataset")
        self.epoch = 0
        self.step = 0  # step within the epoch

    @property
    def n_local(self) -> int:
        return len(self._local_idx)

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.global_batch
        return -(-self.n // self.global_batch)

    def _epoch_order(self) -> np.ndarray:
        """The global example order of this epoch, a function of (seed,
        epoch) alone."""
        if not self.shuffle:
            return np.arange(self.n)
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(self.n)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            order = self._epoch_order()
            spe = self.steps_per_epoch()
            while self.step < spe:
                lo = self.step * self.global_batch + self._offset
                idx = order[lo:lo + self.batch_size]
                self.step += 1
                yield batch_from_numpy(self.arrays, idx, device="cpu")
            self.epoch += 1
            self.step = 0

    def epoch_batches(self) -> int:
        """The number of (batch, n_valid) pairs :meth:`one_epoch` yields,
        the same in every process: ceil(ceil(n / P) / B)."""
        if self.n == 0:
            return 0
        max_local = -(-self.n // self._process_count)
        return -(-max_local // self.batch_size)

    def one_epoch(self) -> Iterator[Tuple[Batch, int]]:
        """This process's shard once, in order, without touching the
        iterator's state: :meth:`epoch_batches` pairs (batch, n_valid),
        short or empty trailing batches padded to ``batch_size`` by
        repeating the last example (n_valid counts the real rows)."""
        order = self._local_idx
        n = len(order)
        fill = order[-1:] if n else np.zeros(1, dtype=np.int64)
        for b in range(self.epoch_batches()):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            n_valid = len(idx)
            if n_valid < self.batch_size:
                idx = np.concatenate(
                    [idx, np.repeat(fill, self.batch_size - n_valid)])
            yield batch_from_numpy(self.arrays, idx, device="cpu"), n_valid

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "step": self.step, "seed": self.seed,
                "global_batch": self.global_batch}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        gb = int(state.get("global_batch", self.global_batch))
        if gb != self.global_batch:
            raise ValueError(
                f"cannot resume: checkpoint global batch {gb} != this "
                f"run's {self.global_batch} (batch_size x process_count "
                f"must be kept across restarts)")
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self.seed = int(state["seed"])
