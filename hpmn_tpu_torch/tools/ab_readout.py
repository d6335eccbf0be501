"""K5, the attention-readout forward (``hpmn_readout_fwd``), of this tree
against that of another tree, on one card: the same inputs through both
builds, compared bit for bit, then timed in turns (other, this, this,
other) by device time.

    git archive <commit> | tar -x -C build/other      # a gitignored place
    python3 -m hpmn_tpu_torch.tools.ab_readout build/other/hpmn_tpu_torch/csrc
    python3 -m hpmn_tpu_torch.tools.ab_readout OTHER/csrc D_M A L D_Q

Inputs, for every B in :data:`BS`, L in :data:`LS` and d_q in :data:`DQS`
and two memory scales (1, and 4, which drives tanh into saturation and
sharpens the softmax): the port's seeded ``Readout`` weights with a random
bias, and normal memory and query, all drawn from a seed per case. Both
trees run through ``cuda_readout.fused_attention_readout``, the library
switched by ``ab_scan_kernels._kernels_of`` (the C entry point and its
arguments are the same in both). Then B = 512 and 6400 at L = 6, d_q = 32
(the xlong readout's step and predict shape, and a rank chunk of 64 users
x 100 candidates) are timed in turns by :func:`device_ms`. Exits nonzero
if an output differs or there is no card.

With D_M A L D_Q (the memory width, the attention width, the slots and
the query width), every case has those widths, over B in :data:`BS` and
both memory scales, and B = 512 and 6400 are timed at them: at any other
shape than A = d_m = 32, L <= 16, d_q <= 256 that is K5-general
(``csrc/readout_general.cu``, ``hpmn_readout_gen_fwd``), which both
trees must have.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from ..models.readout import Readout
from ..ops import _build, cuda_readout
from .ab_scan_kernels import _kernels_of

BS = (1, 37, 512, 6400, 8192)
LS = (1, 3, 5, 6, 16)
DQS = (32, 40, 256)
SCALES = (1.0, 4.0)
TIMED = ((512, 6, 32), (6400, 6, 32))
LAUNCHES = 200  # device time: the mean over this many launches
KERNEL = "readout_fwd_kernel"
GEN_KERNEL = "readout_gen_kernel"


def device_ms(fn, n: int = LAUNCHES, kernel: str = KERNEL):
    """fn() once, then n times under ``torch.profiler`` -> (the mean
    device duration in ms of the K5 kernels it saw, their count). The
    durations are the kernels' own, without the host's call path or the
    gaps between launches; (None, 0) if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return (sum(us) / len(us) / 1e3 if us else None), len(us)


def case_inputs(B: int, L: int, d_q: int, scale: float, dev, d_m: int = 32,
                A: int = 32):
    """The seeded weights, memory and query of one case."""
    gen = torch.Generator().manual_seed(B * 1000 + L * 10 + d_q
                                        + int(scale))
    r = Readout(d_m, d_q, A)
    r.reset_parameters(gen)
    with torch.no_grad():
        r.b.uniform_(-0.1, 0.1, generator=gen)
    r = r.requires_grad_(False).to(dev)
    mem = (scale * torch.randn(B, L, d_m, generator=gen)).to(dev)
    q = torch.randn(B, d_q, generator=gen).to(dev)
    return r, mem, q


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if (len(argv) not in (1, 5) or not os.path.isdir(argv[0])
            or not all(a.isdigit() and int(a) >= 1 for a in argv[1:])):
        print("usage: python3 -m hpmn_tpu_torch.tools.ab_readout "
              "OTHER_TREE/hpmn_tpu_torch/csrc [D_M A L D_Q]")
        return 2
    if not torch.cuda.is_available():
        print("FAIL no CUDA device")
        return 1
    trees = {"other": os.path.abspath(argv[0]), "this": _build.CSRC}
    dev = torch.device("cuda", 0)
    d_m, A, L_w, d_q_w = (int(a) for a in argv[1:]) if argv[1:] else (
        32, 32, None, None)
    cuda_readout.check_shapes(d_m, A, L_w or 1, d_q_w or 1, "ab_readout")
    widths = dict(d_m=d_m, A=A)
    kernel = (GEN_KERNEL if argv[1:] and not cuda_readout.fixed_width(
        d_m, A, L_w, d_q_w) else KERNEL)
    if kernel == GEN_KERNEL and not all(
            os.path.isfile(os.path.join(c, "readout_general.cu"))
            for c in trees.values()):
        print("FAIL these widths run K5-general, which the other tree does "
              "not have (csrc/readout_general.cu)")
        return 2
    ls, dqs = ((L_w,), (d_q_w,)) if argv[1:] else (LS, DQS)
    timed = (((512, L_w, d_q_w), (6400, L_w, d_q_w)) if argv[1:]
             else TIMED)
    cases = [(B, L, d_q, s) for B in BS for L in ls for d_q in dqs
             for s in SCALES]
    outs = {}
    for tree, csrc in trees.items():
        with _kernels_of(csrc):
            outs[tree] = [cuda_readout.fused_attention_readout(
                *case_inputs(*c, dev, **widths)) for c in cases]
            torch.cuda.synchronize()
    differ = [c for c, a, b in zip(cases, outs["other"], outs["this"])
              if not torch.equal(a, b)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ab_readout: {smi} | {len(cases)} cases (B {BS} x L {ls} x d_q "
          f"{dqs} x memory scale {SCALES}, d_m={d_m} A={A}): every output "
          f"bit for bit the same: {not differ}"
          f"{f' | differ: {differ[:8]}' if differ else ''}", flush=True)
    inputs = {c: case_inputs(*c, 1.0, dev, **widths) for c in timed}
    for tree in ("other", "this", "this", "other"):
        with _kernels_of(trees[tree]):
            parts = []
            for (B, L, d_q), args in inputs.items():
                ms, n = device_ms(
                    lambda: cuda_readout.fused_attention_readout(*args),
                    kernel=kernel)
                parts.append(f"B={B} L={L} d_q={d_q} "
                             + (f"{ms:.5f} ms" if ms is not None
                                else "not measured") + f" ({n} launches)")
        print(f"ab_readout: {tree} ({trees[tree]}): device time, "
              f"torch.profiler kernel durations, mean of {LAUNCHES} "
              f"launches: {' | '.join(parts)}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
