"""The scan kernels (K1 and K2, or K1-bf16 and K2-bf16; the strided K3 and
K4, or their bf16 forms, and the AUGRU K1-scale and K2-scale, or their
bf16 forms, where both trees have them) of this tree against those of
another tree, on one card: the same inputs through both builds, compared
bit for bit, then timed in turns (other, this, this, other) with CUDA
events.

    git archive <commit> | tar -x -C build/other      # a gitignored place
    python3 -m hpmn_tpu_torch.tools.ab_scan_kernels \\
        build/other/hpmn_tpu_torch/csrc [float32|bfloat16] [D_IN] [T] [B] \\
        [D_M] [--bits]

Inputs: the xlong_hpmn layer-0 shape (T = 1000, B = 512, d_in = 32, d_m =
32; D_IN, 1 to 512, sets another d_in, T another length: 300 is
taobao_dien's, where the AUGRU kernels run, B another batch: 6400 is a
DIEN rank call's 64 users x 100 candidates, and D_M, 1 to 256, another
hidden width), the port's seeded GRU init, random x and
dh_seq, no mask and a left-padded mask; for the strided kernels period 3
and random cotangents of the strided rows and of h_T; for the AUGRU
kernels a scale in [0, 1), with and without the mask. Exits nonzero if an
output differs or there is no card. ``--bits`` stops after the bit
comparisons (no times).

A tree whose K1 (f32, no scale) predates the two-kernel form has no
``hpmn_gru_scan_fwd_ws``; its K1 is then called through its one-kernel
entry point ``hpmn_gru_scan_fwd``, with that entry point's arguments.
Likewise a tree without ``hpmn_gru_scan_fwd_bf16_ws`` (K1-bf16 as one
kernel): its ``hpmn_gru_scan_fwd_bf16``; and a tree without
``hpmn_gru_scan_bwd_ws`` (K2 and K2-bf16 as one kernel): its
``hpmn_gru_scan_bwd`` and ``hpmn_gru_scan_bwd_bf16``; and a tree without
``hpmn_gru_scan_stride_bwd_ws`` (K4 and K4-bf16 as one kernel): its
``hpmn_gru_scan_stride_bwd`` and ``hpmn_gru_scan_stride_bwd_bf16``; and a
tree without ``hpmn_gru_scan_stride_fwd_ws`` (K3 and K3-bf16 as one
kernel): its ``hpmn_gru_scan_stride_fwd`` and
``hpmn_gru_scan_stride_fwd_bf16``; and a tree without
``hpmn_gru_scan_bwd_scale_ws`` (K2-scale and K2-scale-bf16 as one kernel):
its ``hpmn_gru_scan_bwd_scale`` and ``hpmn_gru_scan_bwd_scale_bf16``,
through :func:`one_kernel_k2_scale` in ``cuda_gru._k2``'s place for the
scaled calls; and a tree without ``hpmn_gru_scan_fwd_scale_ws`` (K1-scale
and K1-scale-bf16 as one kernel): its ``hpmn_gru_scan_fwd_scale`` and
``hpmn_gru_scan_fwd_scale_bf16``, through :func:`one_kernel_k1_scale` in
``cuda_gru._k1``'s place for the scaled calls. This tree's K1 and K2 (or
K1-bf16 and K2-bf16), K3 and K4 (K3-bf16 and K4-bf16), and K1-scale and
K2-scale (their bf16 forms), dscale included, in the default chunks
(``cuda_gru.WORKSPACE_BYTES``) are also held, bit for bit, to themselves
in one chunk of all T steps.

Past d_m = 32, d_in <= 96 the scans are the width-general forms
(``csrc/gru_general_*.cu``: K1-general, K2-general and their bf16 and scale
forms), which both trees must have, and the strided ones K3-general and
K4-general where both trees have them (``hpmn_gru_gen_stride_fwd``).
K2-general's weight gradients sum each chunk's rows in slices, so against
one chunk they are held within 1e-5 of their max abs (printed), every
other output bit for bit (K4-general's weight gradients too: its
partials are batch slices).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import subprocess
import sys

import torch

from ..ops import _build, cuda_gru, cuda_gru_stride, cuda_readout
from ..ops.gru import GRUParams

T_DEFAULT, B_DEFAULT, D_IN, D_M = 1000, 512, 32, 32
PERIOD = 3
REPS = 20
_CACHES = (cuda_gru._ws_fn, cuda_gru._proj_fn,
           cuda_gru._rows_fn, cuda_gru._bwd_fn, cuda_gru._pass_fn,
           cuda_gru._gen_fwd_fn, cuda_gru._gen_bwd_fn,
           cuda_readout._gen_kernel_fn,
           cuda_gru_stride.chunk, cuda_gru_stride._fwd_fn,
           cuda_gru_stride._rows_fn, cuda_gru_stride._bwd_fn,
           cuda_gru_stride._gen_fwd_fn, cuda_gru_stride._gen_bwd_fn,
           cuda_readout._kernel_fn)


def _one_kernel_k1(w, x_tm, mask_tm, h0, hseq, stream, scale_tm=None) -> int:
    """K1 (K1-bf16) of a tree without the two-kernel form: its
    hpmn_gru_scan_fwd (hpmn_gru_scan_fwd_bf16)."""
    bf16 = x_tm.dtype == torch.bfloat16
    fn = getattr(_build.load_library(),
                 "hpmn_gru_scan_fwd" + ("_bf16" if bf16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, d_in = x_tm.shape
    return fn(x_tm.data_ptr(), x_tm.stride(0), cuda_gru._ptr(mask_tm),
              cuda_gru._tstride(mask_tm), w.wx.data_ptr(), w.wh.data_ptr(),
              w.b.data_ptr(), cuda_gru._ptr(h0), hseq.data_ptr(), T, B, d_in,
              stream)


def one_kernel_k1_scale(w, x_tm, mask_tm, h0, hseq, stream,
                        scale_tm) -> int:
    """K1-scale (K1-scale-bf16) of a tree without its two-kernel form: its
    hpmn_gru_scan_fwd_scale (hpmn_gru_scan_fwd_scale_bf16), in
    ``cuda_gru._k1``'s place -> the cudaError_t code: no workspace."""
    bf16 = x_tm.dtype == torch.bfloat16
    fn = getattr(_build.load_library(),
                 "hpmn_gru_scan_fwd_scale" + ("_bf16" if bf16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, d_in = x_tm.shape
    return fn(x_tm.data_ptr(), x_tm.stride(0), cuda_gru._ptr(mask_tm),
              cuda_gru._tstride(mask_tm), scale_tm.data_ptr(),
              scale_tm.stride(0), w.wx.data_ptr(), w.wh.data_ptr(),
              w.b.data_ptr(), cuda_gru._ptr(h0), hseq.data_ptr(), T, B, d_in,
              stream)


def one_kernel_k3(w, x_tm, h0, period, outs, stream) -> int:
    """K3 (K3-bf16) through its one-kernel entry point
    hpmn_gru_scan_stride_fwd (hpmn_gru_scan_stride_fwd_bf16), in
    ``cuda_gru_stride._k3``'s place; outs = (h_stride, boundaries, h_T)
    -> the cudaError_t code."""
    bf16 = x_tm.dtype == torch.bfloat16
    fn = getattr(_build.load_library(),
                 "hpmn_gru_scan_stride_fwd" + ("_bf16" if bf16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, d_in = x_tm.shape
    return fn(x_tm.data_ptr(), x_tm.stride(0), w.wx.data_ptr(),
              w.wh.data_ptr(), w.b.data_ptr(), cuda_gru._ptr(h0),
              *(t.data_ptr() for t in outs), T, B, d_in, period, stream)


def one_kernel_k4(w, x_tm, period, bounds, dhs, dhT, outs, stream,
                  t_chunk=None):
    """K4 (K4-bf16) through its one-kernel entry point
    hpmn_gru_scan_stride_bwd (hpmn_gru_scan_stride_bwd_bf16), in
    ``cuda_gru_stride._k4``'s place; outs = (dx, dh0, dwx, dwh, db) -> (the
    cudaError_t code, None, None): no workspaces."""
    bf16 = x_tm.dtype == torch.bfloat16
    fn = getattr(_build.load_library(),
                 "hpmn_gru_scan_stride_bwd" + ("_bf16" if bf16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, d_in = x_tm.shape
    code = fn(x_tm.data_ptr(), x_tm.stride(0), w.wx.data_ptr(),
              w.wh.data_ptr(), w.b.data_ptr(), bounds.data_ptr(),
              cuda_gru._ptr(dhs), cuda_gru._ptr(dhT),
              *(t.data_ptr() for t in outs), T, B, d_in, period, stream)
    return code, None, None


def _one_kernel_k2(w, x_tm, mask_tm, h0, hseq, dhseq, outs, stream,
                   scale_tm=None, t_chunk=None):
    """K2 (K2-bf16) of a tree without the two-kernel form: its
    hpmn_gru_scan_bwd (hpmn_gru_scan_bwd_bf16); outs = (dx, dh0, dwx, dwh,
    db) -> (the cudaError_t code, None): no workspace."""
    bf16 = x_tm.dtype == torch.bfloat16
    fn = getattr(_build.load_library(),
                 "hpmn_gru_scan_bwd" + ("_bf16" if bf16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, d_in = x_tm.shape
    code = fn(x_tm.data_ptr(), x_tm.stride(0), cuda_gru._ptr(mask_tm),
              cuda_gru._tstride(mask_tm), w.wx.data_ptr(), w.wh.data_ptr(),
              w.b.data_ptr(), cuda_gru._ptr(h0), hseq.data_ptr(),
              dhseq.data_ptr(), *(t.data_ptr() for t in outs), T, B, d_in,
              stream)
    return code, None


def one_kernel_k2_scale(w, x_tm, mask_tm, h0, hseq, dhseq, outs, stream,
                        scale_tm, t_chunk=None):
    """K2-scale (K2-scale-bf16) of a tree without its two-kernel form: its
    hpmn_gru_scan_bwd_scale (hpmn_gru_scan_bwd_scale_bf16), in
    ``cuda_gru._k2``'s place; outs = (dx, dh0, dwx, dwh, db, dscale) ->
    (the cudaError_t code, None): no workspace."""
    bf16 = x_tm.dtype == torch.bfloat16
    fn = getattr(_build.load_library(),
                 "hpmn_gru_scan_bwd_scale" + ("_bf16" if bf16 else ""))
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    T, B, d_in = x_tm.shape
    dx, dh0, dwx, dwh, db, dscale = outs
    code = fn(x_tm.data_ptr(), x_tm.stride(0), cuda_gru._ptr(mask_tm),
              cuda_gru._tstride(mask_tm), scale_tm.data_ptr(),
              scale_tm.stride(0), w.wx.data_ptr(), w.wh.data_ptr(),
              w.b.data_ptr(), cuda_gru._ptr(h0), hseq.data_ptr(),
              dhseq.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
              dh0.data_ptr(), dwx.data_ptr(), dwh.data_ptr(), db.data_ptr(),
              T, B, d_in, stream)
    return code, None


@contextlib.contextmanager
def _kernels_of(csrc: str):
    """Route the kernels' wrappers (the scans', and K5's through
    ``cuda_readout``) to the library built from ``csrc``."""
    load, k1, k2 = _build.load_library, cuda_gru._k1, cuda_gru._k2
    k3, k4 = cuda_gru_stride._k3, cuda_gru_stride._k4
    _build.load_library = functools.partial(load, csrc)
    two = {torch.float32: "hpmn_gru_scan_fwd_ws",
           torch.bfloat16: "hpmn_gru_scan_fwd_bf16_ws"}
    two = {dt: _has(csrc, "gru_scan_fwd.cu", sym) for dt, sym in two.items()}
    k1s_two = _has(csrc, "gru_scan_fwd.cu", "hpmn_gru_scan_fwd_scale_ws")
    if not (all(two.values()) and k1s_two):
        def routed_k1(w, x_tm, *args, scale_tm=None):
            if scale_tm is None:
                fn = k1 if two[x_tm.dtype] else _one_kernel_k1
            else:
                fn = k1 if k1s_two else one_kernel_k1_scale
            return fn(w, x_tm, *args, scale_tm=scale_tm)
        cuda_gru._k1 = routed_k1
    k2_two = _has(csrc, "gru_scan_bwd.cu", "hpmn_gru_scan_bwd_ws")
    k2s_two = _has(csrc, "gru_scan_bwd.cu", "hpmn_gru_scan_bwd_scale_ws")
    if not (k2_two and k2s_two):
        def routed_k2(*args, scale_tm=None, t_chunk=None):
            if scale_tm is None:
                fn = k2 if k2_two else _one_kernel_k2
            else:
                fn = k2 if k2s_two else one_kernel_k2_scale
            return fn(*args, scale_tm=scale_tm, t_chunk=t_chunk)
        cuda_gru._k2 = routed_k2
    if (_has_stride(csrc) and not _has(csrc, "gru_scan_stride_bwd.cu",
                                       "hpmn_gru_scan_stride_bwd_ws")):
        cuda_gru_stride._k4 = one_kernel_k4
    if (_has_stride(csrc) and not _has(csrc, "gru_scan_fwd.cu",
                                       "hpmn_gru_scan_stride_fwd_ws")):
        cuda_gru_stride._k3 = one_kernel_k3
    for cache in _CACHES:
        cache.cache_clear()
    try:
        yield
    finally:
        _build.load_library, cuda_gru._k1, cuda_gru._k2 = load, k1, k2
        cuda_gru_stride._k3, cuda_gru_stride._k4 = k3, k4
        for cache in _CACHES:
            cache.cache_clear()


def _has(csrc: str, source: str, symbol: str) -> bool:
    """Whether the tree's ``source`` names ``symbol``."""
    with open(os.path.join(csrc, source)) as f:
        return symbol in f.read()


def _has_stride(csrc: str) -> bool:
    return os.path.isfile(os.path.join(csrc, "gru_scan_stride_fwd.cu"))




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
    bits_only = "--bits" in argv
    argv = [a for a in argv if a != "--bits"]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if (len(argv) not in (1, 2, 3, 4, 5, 6) or not os.path.isdir(argv[0])
            or argv[1:] and argv[1] not in dtypes
            or argv[2:] and not (argv[2].isdigit()
                                 and 1 <= int(argv[2]) <= 512)
            or argv[5:] and not (argv[5].isdigit()
                                 and 1 <= int(argv[5]) <= 256)
            or not all(a.isdigit() and int(a) >= 1 for a in argv[3:])):
        print("usage: python3 -m hpmn_tpu_torch.tools.ab_scan_kernels "
              "OTHER_TREE/hpmn_tpu_torch/csrc [float32|bfloat16] [D_IN] [T] "
              "[B] [D_M] [--bits]")
        return 2
    name = argv[1] if argv[1:] else "float32"
    dtype = dtypes[name]
    d_in = int(argv[2]) if argv[2:] else D_IN
    T = int(argv[3]) if argv[3:] else T_DEFAULT
    B = int(argv[4]) if argv[4:] else B_DEFAULT
    d_m = int(argv[5]) if argv[5:] else D_M
    if not torch.cuda.is_available():
        print("FAIL no CUDA device")
        return 1
    trees = {"other": os.path.abspath(argv[0]), "this": _build.CSRC}
    general = not cuda_gru.fixed_width(d_in, d_m)
    if general and not all(os.path.isfile(os.path.join(c, "gru_general.cuh"))
                           for c in trees.values()):
        print(f"FAIL d_in={d_in} d_m={d_m} runs the width-general forms, "
              "which the other tree does not have (csrc/gru_general.cuh)")
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    p = GRUParams(d_in, d_m)
    p.reset_parameters(gen)
    p = p.requires_grad_(False).to(dev, dtype)
    x = torch.randn(T, B, d_in, generator=gen).to(dev, dtype)
    dh = torch.randn(T, B, d_m, generator=gen).to(dev, dtype)
    lens = torch.randint(1, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[:, None] >= T - lens[None, :]).to(dev, dtype)
    dhs = torch.randn(T // PERIOD, B, d_m, generator=gen).to(dev, dtype)
    dhT = torch.randn(B, d_m, generator=gen).to(dev, dtype)
    a = torch.rand(T, B, generator=gen).to(dev, dtype)
    strided = all(_has(c, "gru_general_fwd.cu", "hpmn_gru_gen_stride_fwd")
                  if general else _has_stride(c) for c in trees.values())
    scaled = all(_has(c, "gru_scan_fwd.cu", "hpmn_gru_scan_fwd_scale")
                 for c in trees.values())

    outs = {}
    for tree, csrc in trees.items():
        with _kernels_of(csrc):
            res = []
            for m in (None, mask):
                h = cuda_gru.gru_sequence_tm(p, x, m)[0]
                res += [h, *cuda_gru.gru_scan_bwd(p, x, m, h, dh)]
            if strided:
                hs, hT, bounds = cuda_gru_stride.stride_fwd(p, x, PERIOD)
                res += [hs, hT, bounds, *cuda_gru_stride.stride_bwd(
                    p, x, PERIOD, bounds, dhs, dhT)]
            for m in (None, mask) if scaled else ():
                h = cuda_gru.gru_sequence_tm(p, x, m, scale_tm=a)[0]
                res += [h, *cuda_gru.gru_scan_bwd(p, x, m, h, dh,
                                                  scale_tm=a)]
            torch.cuda.synchronize()
            outs[tree] = res
    same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
    # This tree's K1 and K2 (and K3 and K4, and the AUGRU forms) in one
    # chunk of all T steps against their default chunks (the no-mask and
    # masked outputs above): a cap that holds K1's (and K3's) f32
    # workspace, K2's (and K2-scale's) in x's dtype and K4's three.
    cap = cuda_gru.WORKSPACE_BYTES
    k1_chunks = -(-T // cuda_gru.workspace_steps(T, B, d_m))
    chunks = -(-T // (cuda_gru.gen_bwd_workspace_steps(T, B, d_m, dtype)
                      if general else
                      cuda_gru.bwd_workspace_steps(T, B, dtype)))
    step = cuda_gru_stride.chunk() if strided else 1
    k4_chunks = -(-T // cuda_gru_stride.bwd_workspace_steps(
        T, B, dtype, step, d_m, d_in)) if strided else 0
    cuda_gru.WORKSPACE_BYTES = (-(-T // step) * step * B * d_m
                                * (24 + 5 * x.element_size()))
    try:
        one = []
        for m in (None, mask):
            h = cuda_gru.gru_sequence_tm(p, x, m)[0]
            one += [h, *cuda_gru.gru_scan_bwd(p, x, m, h, dh)]
        if strided:
            hs, hT, bounds = cuda_gru_stride.stride_fwd(p, x, PERIOD)
            one += [hs, hT, bounds, *cuda_gru_stride.stride_bwd(
                p, x, PERIOD, bounds, dhs, dhT)]
        for m in (None, mask) if scaled else ():
            h = cuda_gru.gru_sequence_tm(p, x, m, scale_tm=a)[0]
            one += [h, *cuda_gru.gru_scan_bwd(p, x, m, h, dh, scale_tm=a)]
        torch.cuda.synchronize()
    finally:
        cuda_gru.WORKSPACE_BYTES = cap
    # K2-general's weight gradients (dwx, dwh, db: outputs 2-4 of each
    # dense forward-and-backward group of 6 or 7) are held within 1e-5 of
    # their max abs; every other output (the strided group's 8 too) bit
    # for bit.
    wgrad = set()
    if general:
        i = 0
        groups = ([(6, True)] * 2 + [(8, False)] * strided
                  + [(7, True)] * (2 * scaled))  # (outputs, row-sliced)
        for size, sliced in groups:
            if sliced:
                wgrad |= {i + 2, i + 3, i + 4}
            i += size
    w_rel = max((((a_ - b_).abs().max() / b_.abs().max().clamp_min(1e-30)
                  ).item() for j, (a_, b_) in enumerate(zip(one, outs["this"]))
                 if j in wgrad), default=0.0)
    one_chunk = all(torch.equal(a_, b_) for j, (a_, b_) in
                    enumerate(zip(one, outs["this"])) if j not in wgrad)
    one_chunk = one_chunk and w_rel <= 1e-5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"ab_scan_kernels: {smi} | T={T} B={B} d_in={d_in} d_m={d_m} "
          f"{'(the width-general forms) ' if general else ''}{name} | "
          f"forward and backward outputs, mask and no mask"
          f"{', and the strided kernels' if strided else ''}"
          f"{', and the AUGRU kernels' if scaled else ''}, bit for bit "
          f"the same: {same} | this tree's K1 in {k1_chunks} chunks, K2 "
          f"in {chunks}"
          f"{f', K3 in {k1_chunks} and K4 in {k4_chunks}' if strided else ''}"
          f"{f', K1-scale in {k1_chunks}' if scaled else ''}"
          f"{f', K2-scale in {chunks}' if scaled else ''}"
          f", and each in one: bit for bit the same: {one_chunk}"
          f"{f' (weight gradients within {w_rel:.2e} of max abs)' if general else ''}")
    h = outs["this"][0]
    bounds = outs["this"][14] if strided else None
    for tree in () if bits_only else ("other", "this", "this", "other"):
        with _kernels_of(trees[tree]):
            fwd = _ms(lambda: cuda_gru.gru_sequence_tm(p, x, None))
            bwd = _ms(lambda: cuda_gru.gru_scan_bwd(p, x, None, h, dh))
            st = ""
            if strided:
                st_fwd = _ms(lambda: cuda_gru_stride.stride_fwd(p, x, PERIOD))
                st_bwd = _ms(lambda: cuda_gru_stride.stride_bwd(
                    p, x, PERIOD, bounds, dhs, dhT))
                st = (f" | strided forward (K3) {st_fwd:.4f} ms | strided "
                      f"backward (K4) {st_bwd:.4f} ms (period {PERIOD})")
            if scaled:
                h_a = cuda_gru.gru_sequence_tm(p, x, None, scale_tm=a)[0]
                h_am = cuda_gru.gru_sequence_tm(p, x, mask, scale_tm=a)[0]
                sc_fwd = _ms(lambda: cuda_gru.gru_sequence_tm(
                    p, x, None, scale_tm=a))
                sc_fwd_m = _ms(lambda: cuda_gru.gru_sequence_tm(
                    p, x, mask, scale_tm=a))
                sc_bwd = _ms(lambda: cuda_gru.gru_scan_bwd(
                    p, x, None, h_a, dh, scale_tm=a))
                sc_bwd_m = _ms(lambda: cuda_gru.gru_scan_bwd(
                    p, x, mask, h_am, dh, scale_tm=a))
                st += (f" | AUGRU forward (K1-scale) {sc_fwd:.4f} ms, masked "
                       f"{sc_fwd_m:.4f} ms | AUGRU backward (K2-scale) "
                       f"{sc_bwd:.4f} ms, masked {sc_bwd_m:.4f} ms")
        print(f"ab_scan_kernels: {tree} ({trees[tree]}): forward {fwd:.4f} "
              f"ms | backward {bwd:.4f} ms{st} (mean of {REPS}, no mask, "
              f"{name}, d_in={d_in}, d_m={d_m})")
    return 0 if same and one_chunk else 1


if __name__ == "__main__":
    sys.exit(main())
