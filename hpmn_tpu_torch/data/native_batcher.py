"""The native batch gather — counterpart of
``hpmn_tpu/data/native_batcher.py``, with its C++ core copied into
``_native/batcher.cpp`` and built as ``native.py`` builds the parser.

``gather(arrays, idx)`` takes the rows ``idx`` of every field in one
native call, which releases the GIL and spreads the rows over a persistent
thread pool. numpy's fancy indexing (``a[idx]``) is its oracle and the
path taken where there is no g++, for a field the core cannot take
(not C-contiguous, or more than 2-D), and for a call with an index out of
range.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Optional

import numpy as np

from .native import build_native

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "batcher.cpp")

#: Native gathers so far in this process (one per ``gather`` call that
#: reached the core): a run's proof of which route its batches took.
#: Callers may reset it to 0.
gathers = 0


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    path = build_native(_SRC, ("-pthread",))
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.batcher_gather.restype = None
    lib.batcher_gather.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.batcher_n_threads.restype = ctypes.c_int
    lib.batcher_n_threads.argtypes = []
    return lib


def available() -> bool:
    """True where the core is built (or g++ can build it)."""
    return _load() is not None


def n_threads() -> int:
    lib = _load()
    return int(lib.batcher_n_threads()) if lib else 0


def _eligible(a: np.ndarray) -> bool:
    return a.flags["C_CONTIGUOUS"] and a.ndim in (1, 2) and a.itemsize > 0


def gather(arrays: Dict[str, np.ndarray],
           idx: np.ndarray) -> Dict[str, np.ndarray]:
    """{name: [N, ...]} and idx [B] -> {name: [B, ...]}, every eligible
    field in one native call. Raises where the core is not available
    (callers check :func:`available`)."""
    global gathers
    lib = _load()
    if lib is None:
        raise RuntimeError("the native batcher needs g++, which this machine "
                           "lacks")
    idx = np.asarray(idx)
    if idx.size and int(idx.max(initial=0)) > np.iinfo(np.int32).max:
        raise ValueError("the native batcher indexes with int32; the "
                         f"dataset has rows beyond 2^31 ({int(idx.max())})")
    idx = np.ascontiguousarray(idx, np.int32)
    names = list(arrays)
    native = [n for n in names if _eligible(arrays[n])]
    if idx.size and native:
        # The core reads raw pointers: an index out of range must keep
        # numpy's behaviour (IndexError, or a negative index wrapping
        # around), never read memory beside the array. Any such index
        # sends the whole call to numpy.
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= min(arrays[n].shape[0] for n in native):
            native = []
    out: Dict[str, np.ndarray] = {
        n: arrays[n][idx] for n in names if n not in native}
    if not native:
        return out
    b = idx.shape[0]
    srcs = (ctypes.c_void_p * len(native))()
    dsts = (ctypes.c_void_p * len(native))()
    row_bytes = (ctypes.c_int64 * len(native))()
    for i, n in enumerate(native):
        a = arrays[n]
        o = np.empty((b,) + a.shape[1:], a.dtype)
        out[n] = o
        srcs[i] = a.ctypes.data
        dsts[i] = o.ctypes.data
        row_bytes[i] = a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                      dtype=np.int64))
    lib.batcher_gather(len(native), srcs, dsts, row_bytes,
                       idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), b)
    gathers += 1
    return out
