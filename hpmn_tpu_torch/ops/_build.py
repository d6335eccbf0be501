"""Build and load the port's CUDA kernels (``hpmn_tpu_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper only
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, which ``ctypes``
loads. The library lands in ``hpmn_tpu_torch/_build/<key>/``, where ``key``
hashes the sources and the flags, so a change to either rebuilds and an
unchanged tree reuses the last build. A file lock keeps concurrent
processes from building the same key twice. A failed build raises with
nvcc's stderr; there is no fallback.

Nothing here runs at import: the CPU tests import every module, and the
machines they run on have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libhpmn_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(found):
        raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda):"
                           " the CUDA kernels cannot be built")
    return found


def _sources(csrc: str):
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    headers = sorted(glob.glob(os.path.join(csrc, "*.cuh")))
    return srcs, headers


def build_key(csrc: str = CSRC) -> str:
    """Hash of every kernel source, header and flag."""
    srcs, headers = _sources(csrc)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in srcs + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with nvcc's stderr if any
    fails, after all have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def build(csrc: str = CSRC) -> str:
    """Compile csrc/*.cu (this package's, or another tree's for a
    comparison) into the keyed library if it is not there yet and return
    its path."""
    srcs, _ = _sources(csrc)
    key = build_key(csrc)
    out_dir = os.path.join(BUILD_DIR, key)
    lib = os.path.join(out_dir, LIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(BUILD_DIR, key + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(lib):
                return lib
            tmp = f"{lib}.{os.getpid()}.tmp"
            objs = [os.path.join(out_dir, f"{os.path.basename(src)}."
                                 f"{os.getpid()}.o") for src in srcs]
            nvcc = _nvcc()
            _run_all([[nvcc, *NVCC_FLAGS, "-I", csrc, "-c", "-o", obj, src]
                      for src, obj in zip(srcs, objs)])
            _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@functools.lru_cache(maxsize=None)
def load_library(csrc: str = CSRC) -> ctypes.CDLL:
    """Build if needed, then load the kernels' library once per process."""
    lib = ctypes.CDLL(build(csrc))
    lib.hpmn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hpmn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(code: int, kernel: str) -> None:
    """Raise if a launch function returned a nonzero cudaError_t."""
    if code != 0:
        msg = load_library().hpmn_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}: {msg}")


def on_device(t: torch.Tensor):
    """The context of one launch: ``t``'s device made current
    (``torch.cuda.device``), so that the C launcher's kernels run there and
    size their grids by that device's SM count, whichever device was
    current before. A CPU tensor (a seam test's stand-in for the card's)
    gets a context that does nothing."""
    if t.device.type == "cpu":
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
