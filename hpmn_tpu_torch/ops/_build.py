"""Build and load the port's CUDA kernels (``hpmn_tpu_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, for Hopper only (``sm_90a``), and ``ctypes`` loads
it. The library lands in ``hpmn_tpu_torch/_build/<key>/``, where ``key``
hashes the sources and the flags, so a change to either rebuilds and an
unchanged tree reuses the last build. A file lock keeps concurrent
processes from building the same key twice. A failed build raises with
nvcc's stderr; there is no fallback.

Nothing here runs at import: the CPU tests import every module, and the
machines they run on have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libhpmn_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(found):
        raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda):"
                           " the CUDA kernels cannot be built")
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return srcs, headers


def build_key() -> str:
    """Hash of every kernel source, header and flag."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu into the keyed library if it is not there yet and
    return its path."""
    srcs, _ = _sources()
    key = build_key()
    out_dir = os.path.join(BUILD_DIR, key)
    lib = os.path.join(out_dir, LIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(BUILD_DIR, key + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(lib):
                return lib
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *srcs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library once per process."""
    lib = ctypes.CDLL(build())
    lib.hpmn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hpmn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(code: int, kernel: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if code != 0:
        msg = load_library().hpmn_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}: {msg}")
