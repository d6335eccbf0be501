"""Registers, spills and the static instruction mix of the port's CUDA
kernels, from the CUDA toolkit's own reports, on a machine with nvcc.

    python3 -m hpmn_tpu_torch.tools.kernel_report [OTHER_TREE/hpmn_tpu_torch/csrc]

For each ``csrc/*.cu`` of the tree (this package's by default): nvcc with
``_build.NVCC_FLAGS`` plus ``-Xptxas -v``, whose lines give each kernel's
registers, shared memory and spills; an entry line names the scan kernel
it compiles where its mangled name says (:data:`LABELS`: K3's recurrence
is ``gru_scan_fwd_xp_kernel`` with the ``StrideOut`` policy, K1-scale's
the ``DenseOut`` one with ``kScale``, its last template argument, true;
the width-general forms' kernels are named by their operand functors and
recurrences, the scale and shared-memory forms by their template
arguments <S, kScale, kSmemW>).
Then ``cuobjdump -sass`` of the
library built from that tree and, per kernel, the static count of the
instructions that load shared memory (LDS), shuffle (SHFL), load or store
device memory (LDG, STG), store shared memory (STS), fuse a multiply-add
(FFMA) and call the special-function unit (MUFU). A static count reads the
unrolled loop body once: it says which loads sit inside the time loop, not
how many run.
"""

from __future__ import annotations

import collections
import glob
import os
import re
import shutil
import subprocess
import sys

from ..ops import _build

OPS = ("LDS", "SHFL", "LDG", "STG", "STS", "FFMA", "MUFU")
# (substrings of a mangled kernel name, all present) -> which kernel it is;
# the first that matches. "Lb1EEEv" closes a template argument list whose
# last argument is the bool true.
LABELS = ((("gru_scan_fwd_xp_kernel", "StrideOut"), "K3 recurrence"),
          (("gru_scan_fwd_xp_kernel", "DenseOut", "Lb1EEEv"),
           "K1-scale recurrence"),
          (("gru_scan_fwd_xp_kernel", "DenseOut"), "K1 recurrence"),
          (("input_proj_kernel",), "K1/K1-scale/K3/K4 projection"),
          (("gru_scan_stride_bwd_rec_kernel",), "K4 recurrence"),
          (("gru_scan_bwd_rec_kernel",), "K2 recurrence"),
          (("gru_bwd_pass_kernel",), "K2/K4 pass"),
          (("readout_fwd_kernel",), "K5"),
          # the width-general forms (gru_general_*.cu, readout_general.cu)
          (("gen_fwd_rec_kernel", "GenStride"), "K3-general recurrence"),
          (("gen_fwd_rec_kernel", "GenReplay"), "K4-general replay"),
          (("gen_bwd_rec_kernel", "StrideCot"), "K4-general sweep"),
          (("gen_fwd_rec_kernel",), "K1-general recurrence"),
          (("gen_bwd_rec_kernel",), "K2-general recurrence"),
          (("tall_kernel", "ProjOp"), "K1-K4-general projection"),
          (("tall_kernel", "HprevOp"), "K2-general h_prev @ wh"),
          (("tall_kernel", "DxOp"), "K2/K4-general dx"),
          (("wgrad_kernel",), "K2/K4-general dwx, db and dwh"),
          # the earlier form of the products (an older tree's csrc)
          (("gemm_kernel", "ProjOp"), "K1-K4-general projection"),
          (("gemm_kernel", "HprevOp"), "K2-general h_prev @ wh"),
          (("gemm_kernel", "DxOp"), "K2/K4-general dx"),
          (("gemm_kernel", "WxGradOp"), "K2/K4-general dwx and db"),
          (("gemm_kernel", "WhGradOp"), "K2/K4-general dwh"),
          (("readout_gen_kernel",), "K5-general"))
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)")


def _demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(_build._nvcc()), "cu++filt")
    if not os.path.isfile(tool):
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(csrc: str) -> None:
    for src in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc,
             "-c", "-o", os.devnull, src], capture_output=True, text=True)
        for line in res.stderr.splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                label = next((f" [{name}]" for parts, name in LABELS
                              if "Compiling entry" in line
                              and all(p in line for p in parts)), "")
                print(f"ptxas {os.path.basename(src)}: {line.strip()}{label}")
        if res.returncode != 0:
            print(res.stderr)
            raise SystemExit(f"nvcc failed on {src}")


def sass_report(csrc: str) -> None:
    lib = _build.build(csrc)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            counts[name] = collections.Counter()
            continue
        insn = _INSN.search(line)
        if name is not None and insn:
            op = insn.group(1).split(".")[0]
            counts[name][op] += 1
    names = list(counts)
    for mangled, pretty in zip(names, _demangle(names)):
        c = counts[mangled]
        mix = " ".join(f"{op} {c[op]}" for op in OPS)
        print(f"sass {pretty[:96]}: {sum(c.values())} instructions | {mix}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    csrc = os.path.abspath(argv[0]) if argv else _build.CSRC
    if not os.path.isdir(csrc):
        print("usage: python3 -m hpmn_tpu_torch.tools.kernel_report "
              "[OTHER_TREE/hpmn_tpu_torch/csrc]")
        return 2
    ptxas_report(csrc)
    sass_report(csrc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
