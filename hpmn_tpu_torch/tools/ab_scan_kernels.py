"""The scan kernels (K1 and K2, or K1-bf16 and K2-bf16) of this tree
against those of another tree, on one card: the same inputs through both
builds, compared bit for bit, then timed in turns (other, this, this,
other) with CUDA events.

    git archive <commit> | tar -x -C build/other      # a gitignored place
    python3 -m hpmn_tpu_torch.tools.ab_scan_kernels \\
        build/other/hpmn_tpu_torch/csrc [bfloat16]

Inputs: the xlong_hpmn layer-0 shape (T = 1000, B = 512, d_in = 32), the
port's seeded GRU init, random x and dh_seq, no mask and a left-padded
mask. Exits nonzero if an output differs or there is no card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import sys

import torch

from ..ops import _build, cuda_gru
from ..ops.gru import GRUParams

T, B, D_IN = 1000, 512, 32
REPS = 20


@contextlib.contextmanager
def _kernels_of(csrc: str):
    """Route the scan wrappers to the library built from ``csrc``."""
    load = _build.load_library
    _build.load_library = functools.partial(load, csrc)
    cuda_gru._kernel_fn.cache_clear()
    cuda_gru._bwd_fns.cache_clear()
    try:
        yield
    finally:
        _build.load_library = load
        cuda_gru._kernel_fn.cache_clear()
        cuda_gru._bwd_fns.cache_clear()


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if (len(argv) not in (1, 2) or not os.path.isdir(argv[0])
            or argv[1:] and argv[1] not in dtypes):
        print("usage: python3 -m hpmn_tpu_torch.tools.ab_scan_kernels "
              "OTHER_TREE/hpmn_tpu_torch/csrc [float32|bfloat16]")
        return 2
    name = argv[1] if argv[1:] else "float32"
    dtype = dtypes[name]
    if not torch.cuda.is_available():
        print("FAIL no CUDA device")
        return 1
    trees = {"other": os.path.abspath(argv[0]), "this": _build.CSRC}
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    p = GRUParams(D_IN, 32)
    p.reset_parameters(gen)
    p = p.requires_grad_(False).to(dev, dtype)
    x = torch.randn(T, B, D_IN, generator=gen).to(dev, dtype)
    dh = torch.randn(T, B, 32, generator=gen).to(dev, dtype)
    lens = torch.randint(1, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[:, None] >= T - lens[None, :]).to(dev, dtype)

    outs = {}
    for tree, csrc in trees.items():
        with _kernels_of(csrc):
            res = []
            for m in (None, mask):
                h = cuda_gru.gru_sequence_tm(p, x, m)[0]
                res += [h, *cuda_gru.gru_scan_bwd(p, x, m, h, dh)]
            torch.cuda.synchronize()
            outs[tree] = res
    same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ab_scan_kernels: {smi} | T={T} B={B} d_in={D_IN} {name} | "
          f"forward and backward outputs, mask and no mask, bit for bit the "
          f"same: {same}")
    h = outs["this"][0]
    for tree in ("other", "this", "this", "other"):
        with _kernels_of(trees[tree]):
            fwd = _ms(lambda: cuda_gru.gru_sequence_tm(p, x, None))
            bwd = _ms(lambda: cuda_gru.gru_scan_bwd(p, x, None, h, dh))
        print(f"ab_scan_kernels: {tree} ({trees[tree]}): forward {fwd:.4f} "
              f"ms | backward {bwd:.4f} ms (mean of {REPS}, no mask, "
              f"{name})")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
