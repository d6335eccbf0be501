"""Checkpoints and resume — counterpart of ``hpmn_tpu/train/checkpoint.py``
(orbax there, ``torch.save`` here), with its semantics:

- a snapshot holds the model's parameters, the optimizer's state (the
  EMA shadow and the accumulator included), the loader's position and the
  step, so that a resumed run continues exactly;
- one directory per step, ``<dir>/<step>/state.pt``, with
  ``metrics.json`` beside it when the save carries metrics; a snapshot is
  written under a temporary name and renamed, so a crash leaves none torn;
- the ``keep_best_k`` snapshots with the best ``val_auc`` are kept, and a
  snapshot saved without metrics (a preemption snapshot) is never ranked,
  so it survives and becomes ``latest_step()``;
- ``async_checkpointing`` copies the state to the host in ``save`` and
  writes it on a thread; ``restore``, ``best_step``, ``latest_step``,
  ``close`` and the next ``save`` wait for that write.

:func:`save_user_memory` and :func:`load_user_memory` keep the JAX
package's npz file, so the serving store's memory moves between the two.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_STATE = "state.pt"
_METRICS = "metrics.json"
_PREEMPT = "preempt_step.txt"


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the CPU, so later
    updates of the live tensors cannot reach the snapshot."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, keep_best_k: int = 3,
                 async_checkpointing: bool = False):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep_best_k
        self._async = async_checkpointing
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # --- the steps on disk ---
    def _path(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _steps(self):
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit()
                      and os.path.isfile(os.path.join(self._dir, n, _STATE)))

    def all_steps(self):
        self.wait_until_finished()
        return self._steps()

    def _metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = os.path.join(self._path(step), _METRICS)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _ranked(self):
        """The steps saved with metrics, worst val_auc first (ties: the
        earlier step first)."""
        scored = [(m.get("val_auc", 0.0), s) for s in self._steps()
                  for m in (self._metrics(s),) if m is not None]
        return [s for _, s in sorted(scored)]

    def best_step(self) -> Optional[int]:
        self.wait_until_finished()
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def delete(self, step: int) -> None:
        shutil.rmtree(self._path(step), ignore_errors=True)

    # --- writing ---
    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed"
                               ) from err

    def _write(self, step: int, state: Dict, metrics) -> None:
        tmp = os.path.join(self._dir, f".tmp.{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        if metrics is not None:
            with open(os.path.join(tmp, _METRICS), "w") as f:
                json.dump(metrics, f)
        shutil.rmtree(self._path(step), ignore_errors=True)
        os.replace(tmp, self._path(step))
        ranked = self._ranked()
        if self._keep > 0:
            for old in ranked[:max(0, len(ranked) - self._keep)]:
                self.delete(old)

    def _write_async(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # raised again by wait_until_finished
            self._error = e

    def save(self, step: int, model_state: Dict, opt_state: Dict,
             loader_state: Dict,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Snapshot ``step``. ``metrics=None`` saves without metrics: the
        snapshot is never ranked for the best-k rotation, so it survives
        it and is ``latest_step()`` (the graceful-preemption shape)."""
        self.wait_until_finished()
        state = {"params": _to_host(model_state),
                 "opt_state": _to_host(opt_state),
                 "loader": dict(loader_state), "step": int(step)}
        if metrics is not None:
            metrics = {k: float(v) for k, v in metrics.items()}
        if self._async:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, state, metrics),
                daemon=False)
            self._thread.start()
        else:
            self._write(step, state, metrics)

    def save_preemption(self, step: int, model_state: Dict, opt_state: Dict,
                        loader_state: Dict) -> None:
        """The graceful-preemption snapshot: saved without metrics, and
        rotated: the previous preemption snapshot (named in a marker file)
        is deleted unless it is the best one, so only one is kept."""
        marker = os.path.join(self._dir, _PREEMPT)
        prev = None
        if os.path.exists(marker):
            try:
                with open(marker) as f:
                    prev = int(f.read().strip())
            except ValueError:
                prev = None
        self.save(step, model_state, opt_state, loader_state)
        self.wait_until_finished()
        if (prev is not None and prev != step and prev in self.all_steps()
                and prev != self.best_step()):
            self.delete(prev)
        with open(marker + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(marker + ".tmp", marker)

    # --- reading ---
    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at ``step`` (default: the latest) as a dict
        with ``params``, ``opt_state``, ``loader`` and ``step`` (tensors on
        the CPU), or None when there is no snapshot."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self._path(step), _STATE),
                          map_location="cpu", weights_only=True)

    def close(self) -> None:
        self.wait_until_finished()


def save_user_memory(directory: str, uids: np.ndarray, memory: np.ndarray,
                     counters: np.ndarray) -> None:
    """Persist per-user lifelong memory: uids [U], memory [U, L, d_m] and
    the event counters [U], sorted by uid, in ``user_memory.npz`` (the JAX
    package's file), written atomically."""
    os.makedirs(directory, exist_ok=True)
    order = np.argsort(uids)
    path = os.path.join(directory, "user_memory.npz")
    np.savez(path + ".tmp.npz",
             uids=np.asarray(uids, np.int64)[order],
             memory=np.asarray(memory, np.float32)[order],
             counters=np.asarray(counters, np.int64)[order])
    os.replace(path + ".tmp.npz", path)


def load_user_memory(directory: str):
    """-> (uids [U], memory [U, L, d_m], counters [U]); empty arrays if no
    snapshot exists."""
    path = os.path.join(directory, "user_memory.npz")
    if not os.path.exists(path):
        return (np.zeros((0,), np.int64), np.zeros((0, 0, 0), np.float32),
                np.zeros((0,), np.int64))
    z = np.load(path)
    return z["uids"], z["memory"], z["counters"]
