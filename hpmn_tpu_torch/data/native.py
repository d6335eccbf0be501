"""The native CSV event-log parser — counterpart of
``hpmn_tpu/data/native.py``, with its C++ core copied into
``_native/fast_log.cpp``.

    ev = parse_csv(path, behavior_col=-1, behavior_keep="")
    # -> dict(uid, item, cat, ts, n_users, n_items, n_cats)

The ids come back interned in first-seen order: int32, items and
categories from 1 (0 is the pad), users from 0.

:func:`build_native` compiles a source with g++ at first use into
``hpmn_tpu_torch/_build/native/`` (keyed by a hash of the source and the
flags; never next to the source) and is shared with
``native_batcher.py``. Without g++, :func:`available` is False and the
callers keep their Python paths; where g++ exists and the build fails, the
call raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_native", "fast_log.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def build_native(src: str, flags: Sequence[str] = ()) -> Optional[str]:
    """Compile ``src`` into a shared library if it is not built yet -> its
    path, or None where there is no g++. Raises RuntimeError with the
    compiler's stderr when g++ fails."""
    flags = GXX_FLAGS + tuple(flags)
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A name of this process's own: concurrent builders (test workers on a
    # fresh tree) must not write one file, or one replace() takes the
    # other's half-written output.
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        proc = subprocess.run([gxx, *flags, src, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {src}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    path = build_native(_SRC)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.fast_parse_csv.restype = ctypes.c_void_p
    lib.fast_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_char_p]
    lib.fast_n_rows.restype = ctypes.c_int64
    for name in ("fast_n_users", "fast_n_items", "fast_n_cats"):
        getattr(lib, name).restype = ctypes.c_int32
    for name in ("fast_uid", "fast_item", "fast_cat", "fast_ts"):
        getattr(lib, name).restype = ctypes.c_void_p
    for name in ("fast_n_rows", "fast_n_users", "fast_n_items", "fast_n_cats",
                 "fast_uid", "fast_item", "fast_cat", "fast_ts", "fast_free"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.fast_free.restype = None
    return lib


def available() -> bool:
    """True where the parser is built (or g++ can build it)."""
    return _load() is not None


def parse_csv(path: str, behavior_col: int = -1,
              behavior_keep: str = "") -> Dict[str, np.ndarray]:
    """Parse a ``user,item,cat[,behavior],ts`` CSV with the native core;
    with ``behavior_col`` >= 0 and a non-empty ``behavior_keep``, only the
    rows whose behavior field equals it."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native parser needs g++, which this machine "
                           "lacks; use the Python path")
    res = lib.fast_parse_csv(path.encode(), behavior_col,
                             behavior_keep.encode())
    if not res:
        raise FileNotFoundError(path)
    try:
        n = lib.fast_n_rows(res)

        def arr(getter, dtype):
            if n == 0:
                return np.empty((0,), dtype)
            size = n * np.dtype(dtype).itemsize
            return np.frombuffer(ctypes.string_at(getter(res), size),
                                 dtype=dtype).copy()

        return {
            "uid": arr(lib.fast_uid, np.int32),
            "item": arr(lib.fast_item, np.int32),
            "cat": arr(lib.fast_cat, np.int32),
            "ts": arr(lib.fast_ts, np.int64),
            "n_users": int(lib.fast_n_users(res)),
            "n_items": int(lib.fast_n_items(res)),
            "n_cats": int(lib.fast_n_cats(res)),
        }
    finally:
        lib.fast_free(res)
