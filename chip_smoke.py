#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's xlong_hpmn serving path and training step
(f32 and bf16 scans, dense and strided-output), the taobao_dien training
step and HistoryStore serving, the training driver, the real-data
layer with the GRU4Rec and RUM baselines, the stores' persistence and
bundles from train to serve, the serving daemon with the AOT-exported
graphs, the remaining families (BST, DNN, LSTM, Caser, SHAN, SVD++)
trained, served and compared, data, model and sequence parallelism
over ranks of the card, and the kernels' width-general forms with the
paths at other widths, once on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a GPU

Phases, one line each (a failed check prints ``FAIL ...`` and exits 1
before the last line):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: compile the CUDA kernels from ``hpmn_tpu_torch/csrc`` (nvcc).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the paths' shapes, with its tolerance, its time, the plain time, the
   time of the one PyTorch call that computes the same (cuDNN's GRU for the
   scans), and the least time the card could take (bound); before each K1
   and K1-bf16 line, its input projection alone (its first kernel),
   against the plain projection, with its time and share of the scan's;
   before each K2 and
   K2-bf16 line, their second kernel alone (dx and the weight gradients
   from gate gradients), against its plain version, with its time and
   share of theirs; the bf16 scan
   kernels in bf16, with their drift from the f32 kernels; the strided
   scan kernels (K3, K4 and their bf16 forms), with their difference from
   the dense kernels' strided rows and gradients, K3 (K3-bf16) bit for bit
   against its one-kernel form and after its input projection's time and
   share of K3's (its first kernel, K1's), and before each K4 and
   K4-bf16 line its recurrence's gate gradients and h_prev against the
   plain sweep's, and its h_prev against the forward's states bit for
   bit; the AUGRU scan kernels
   (K1-scale, K2-scale and their bf16 forms) at DIEN's shape, before each
   K1-scale and K1-scale-bf16 line its input projection alone (its first
   kernel, K1's), against the plain projection, with its time and share of
   K1-scale's, and before each K2-scale and K2-scale-bf16 line its
   recurrence's gate gradients and dscale against the plain sweep's, and
   its second kernel's (the pass's) time and share of its time; the
   readout (K5) at B = 512 and 6400 with its device time (torch.profiler's
   kernel durations over 220 launches), its call time (CUDA events over
   50 calls through ``fused_attention_readout``) and the host's enqueue
   time per call (1000 calls, no synchronize), that last in turns with
   and without the launch's device context. The phase 5-9 profiles
   print K5's device time per step or request.
4. serving: a ``UserMemoryStore`` on the card at the full width of
   xlong_hpmn (random seeded weights) ingests histories, takes updates,
   predicts and ranks; launch counters prove the path ran the kernels, and
   the outputs are checked against plain versions and each other.
5. training: the xlong_hpmn training step at B = 512, T = 1000 with the
   kernels (bench.py's flags), held against the plain path's loss and
   gradients, full and left-padded; then k = 8 steps per dispatch, timed,
   with launch counters; then one profiled dispatch for the device's
   busy share.
6. bf16 training: the same step with ``scan_dtype="bfloat16"`` (bench.py's
   headline leg: K1-bf16 and K2-bf16), held against the plain bf16 path
   and the f32 step's loss, then timed, counted and profiled as phase 5.
7. strided training: the step with ``pallas_stride_outputs=True`` (K3 and
   K4), f32 then bf16, held against its plain path and the dense step's
   loss, then timed, counted and profiled as phase 5; the profile gives
   the strided forward's device time (K3's projection and recurrence)
   apart from K4's projection.
8. DIEN training: the taobao_dien step at B = 512, T = 300 with the
   kernels, f32 on left-padded histories (the config's default: K1, K2,
   K1-scale, K2-scale) and bf16 on full ones (the bench flagship: their
   bf16 forms), each held against its plain path (``plain=True``), then
   timed, counted and profiled as phase 5.
9. DIEN serving: a ``HistoryStore`` on the card ingests 8192 histories,
   takes updates, predicts and ranks (K1 and K1-scale per scoring call),
   checked against the plain path and against the same store on the CPU.
10. the training driver, ``train()`` (what ``python -m
   hpmn_tpu_torch.train.train`` runs): (a) amazon_hpmn, 200 steps at B =
   64 with the kernels (K1 and K5 per train step and per eval batch, K2
   per train step, counted), against the same run on the CPU (the plain
   versions) from the same seeded weights: best val AUC and test AUC
   within 0.02, test log-loss within 1e-5 and the step-200 parameters
   within 1e-4 of their max abs; (b) xlong_hpmn at full width (B 512,
   T 1000, six layers; 6144 examples), 16 steps with warmup, cosine,
   clipping and EMA and a checkpoint at each improving eval, then a fresh
   run resumed from the step-8 snapshot: its step-16 parameters against the uninterrupted
   run's (bit for bit, or within 1e-5 of max abs; it prints which), and
   the driver's ex/s, eval and checkpoint seconds and goodput.
11. real data and the baselines: (a) a seeded Amazon dump in the public
   JSON-lines format through ``python -m hpmn_tpu_torch.data.process_amazon``,
   then amazon_gru4rec (K1 per train step and eval batch, K2 per step,
   counted) and amazon_rum trained 100 steps through ``train()`` on that
   ``data_dir``, each against the same run on the CPU and beside a card
   run from perturbed weights (see the tolerances below), and amazon_rum
   a second time on the card, its parameters bit for bit the first run's
   (the gather's backward on the card repeats: ``models/embedding.py``);
   (b) a ``UserMemoryStore``
   per trained model ingests the test users (gru4rec: K1 once per batch),
   its scores held to the training path's, to one event at a time and to
   the same store on the CPU; (c) a seeded XLong CSV of about 3.4M rows
   through ``process_xlong`` (the native parser, asserted), then
   xlong_hpmn at full width 16 steps on it through the native batch
   gather (counted), with the parser's rows/s, the gather's and numpy's
   ms per batch and the driver's ex/s beside phase 5's.
12. persistence and bundles: (a) phase 4's store through ``save_bundle``
   and ``load_bundle`` (memories and predict/rank bit for bit, K5
   counted), an int8 bundle (scores within 0.03, params.npz under 0.45 of
   the f32 one), and a bf16-arena store over phase 4's ingest and updates
   (within 3e-2 and 1e-2 of the f32 store; its rates beside phase 4's,
   predict/rank in turns with the f32 store, the arena's bytes; saved f32
   and restored bit for bit); (b) phase 9's DIEN store through a bundle
   (scores bit for bit, K1 and K1-scale counted); (c) the xlong_hpmn step
   with ``use_user_emb`` (4000 users) against its plain path at phase 5's
   tolerances (K1 x 6, K2 x 6, K5); (d) phase 10's xlong checkpoint
   through ``python -m hpmn_tpu_torch.tools.export_bundle --histories
   --quantize`` and ``--ema``, then ``serve_batch --update``, as
   subprocesses, with their seconds and bundle bytes.

13. the daemon and the AOT graphs: (a) ``python -m
   hpmn_tpu_torch.tools.serve --warmup --journal`` as a subprocess on the
   card, serving phase 12's xlong bundle and, as model "dien", its DIEN
   bundle: predict (512 users) and rank (64 x 100) through a
   ``ServingClient`` held to in-process stores on the same bundles (within
   1e-6; it prints whether bit for bit), K5 counted per request (and (b)
   K1 and K1-scale per DIEN request) through the daemon's ``stats``; then
   update rounds, a SIGKILL, and a restart whose journal replay gives the
   same scores; (c) phase 10's checkpoint through ``export_bundle
   --export_compiled --platforms cpu,cuda`` (in the background of (a)) and
   phase 9's DIEN store through ``save_bundle(export_compiled=True)``, then
   ``serve --aot``: scores held to the eager stores within 1e-6, and the
   exported graphs' launches of K5, K1 and K1-scale counted per request;
   the bundle's cpu graphs against its cuda graphs at 1e-4; (d) ``python
   -m hpmn_tpu_torch.tools.serve_fleet`` with 2 shards on the card behind a
   ``ShardedServingClient``, against the single daemon's answers; (e) the
   daemons' requests/s and latency percentiles under load (eager and
   --aot), their startup seconds with --warmup, and the host's enqueue
   time per call through the custom ops and through the direct launch
   (K5 at B = 512 and 6400, K1 at DIEN's scoring shape), in turns.
14. the remaining families (``models/extra_baselines.py``, which runs no
   hand kernel, as JAX runs them in no Pallas kernel): (a) xlong_bst at
   full width (B 256, T 1000, d 32, 2 heads, FFN 128, one block, chunk
   128): the f32 loss and every gradient on the card against the same
   weights and batch on the CPU, the bf16 step against the card's f32,
   the two-block step (the chunked online softmax at S = 1001) against the
   CPU on 64 rows; then k = 8 steps per dispatch timed after warm-up, with
   examples/s, device ms per step, busy share, peak memory, and the
   attention's, FFN's and gather's device time alone against the step's;
   (b) taobao_bst's HistoryStore (W = 300): 8192 left-padded users, 4 x
   512 updates, predict 512, rank 64 x 100, against the same store on the
   CPU, through a bundle (bit for bit) and its exported scoring graph;
   (c) ``hpmn_tpu_torch.tools.compare_models`` over the ten families on
   amazon (B 128, 48 steps, use_pallas), its table, and each family's
   test AUC beside the same table run on the CPU in a subprocess; (d) the
   launch counters: none on (a), (b) and the six new families of (c);
   hpmn, dien and gru4rec launch theirs in (c).

15. data and model parallelism (``hpmn_tpu_torch/parallel/``, through
   ``python -m hpmn_tpu_torch.tools.parallel_check``): (a) 4 ranks on the
   card over gloo (CUDA tensors through the host), a (2, 2) grid, run
   xlong_hpmn at full width (global B 512, T 1000, six layers, items
   50000, cats 800, batch over data and model, the a2a exchange,
   use_pallas) for 4 SGD steps from the seeded weights, held to the same
   steps in one process (losses, parameters, the first step's table
   gradients and the tables' change over the steps, the dense parameters
   the same on every rank), K1 x 6, K2 x 6 and K5 counted on every rank
   and step; a psum step, and a step with the capacity factor forced low,
   which takes the exact fallback (overflow counter 1, the a2a step's
   result); the step's ms per rank, and a profiled step's exchange split
   into the wait for queued kernels, the transfer and the wait for the
   other rank; (b) train() on the same ranks, 16 steps with evaluation
   and checkpoints, against one process at phase 10's tolerances, rank 0
   alone writing, its best checkpoint equal to the returned parameters
   and loaded on one device; (c) ``python -m torch.distributed.run
   --nproc_per_node <cards> -m hpmn_tpu_torch.train.train`` over NCCL (on
   one card a 1-rank bootstrap check; (a) over NCCL, one rank per card,
   where there are 2 cards or more); (d) bf16 BST's gradient gap
   from f32 on the card (cuBLAS's reduced-precision bf16 reduction on and
   off) beside the CPU's.
16. sequence parallelism (``parallel/seq_parallel.py``, through
   ``parallel_check --seq_parallel 2``; use_pallas off, the kernels as the
   chunk scan, ``mesh.sp_inner=pallas``): (a) 2 ranks of the card over
   gloo, a (1, 2, 1) grid, xlong_hpmn at full width and depth (B 512, T
   1000: layer 0 split into chunks of 500 steps, 4 microbatches of 128
   rows, through K1-scale and K2-scale from the received carry; the five
   upper layers, whose T does not split, whole through K1 and K2), 3 SGD
   steps against one process (losses, parameters, the first step's table
   gradients, the tables' change), the launches counted per rank and
   step; layer 0's SP scan with the kernels against the plain SP scan;
   the step's ms per rank against one process's, and a profiled step's
   ``seq_handoff`` and ``seq_gather`` spans; (b) the (1, 2, 2) grid on 4
   ranks: the tables row-sharded, a2a with the batch over data and
   model, the same checks, and its train(); (c) taobao_dien (T 300, B
   512, left-padded) on (1, 2, 1), both scans T-sharded (K1-scale and
   K2-scale, the AUGRU's dscale crossing the handoffs), against one
   process; (d) train() with ``mesh.seq_parallel=2`` on the 2 ranks, 16
   steps with evaluation and checkpoints, against one process at phase
   10's tolerances, rank 0 alone writing.
17. the bf16 model and the last driver options: (a) xlong_hpmn at full
   width and depth with ``model.dtype=bfloat16``, f32 then bf16 scans
   (K1, K2, K5 or K1-bf16, K2-bf16, K5 once a step, counted): the kernel
   path against the plain path (the loss, every bf16 gradient, the update
   of 3 Adam steps with bf16 moments), examples/s, the peak memory and a
   profiled dispatch beside phase 5's f32 model; (b) taobao_dien's bf16
   model (T 300, B 512, left-padded; K1, K2, K1-scale, K2-scale) the same
   way; (c) train() on amazon_hpmn with a bf16 model, ``train.log_dir``
   and ``train.debug_nans`` against the CPU at step 10, its event file
   read back against its log lines, the same run without the options bit
   for bit, a NaN weight raising FloatingPointError at step 1; (d)
   ``python -m hpmn_tpu_torch.tools.quality_gate --device cuda`` (2000
   steps, both floors met) and a two-point ``tools.sweep``.

18. widths: the width-general forms (``csrc/gru_general_*.cu``: K1-general
   and K2-general in every dtype, mask and scale form;
   ``csrc/readout_general.cu``: K5-general), which run every width but the
   fixed-width kernels' d_m = 32, d_in <= 96 (A = d_m = 32, L <= 16, d_q <=
   256): (1) each against its plain version on the card at (d_in, d_m) in
   (1, 1), (3, 4), (16, 16), (40, 48), (128, 64), (64, 128), (256, 256)
   and (d_m, A, L, d_q) in (16, 24, 3, 8), (64, 64, 6, 128), (48, 96, 20,
   300), (32, 32, 40, 32), at phase 3's tolerances; (2) their CUDA-event
   times at T = 1000, B = 512 for d_m = d_in in 16, 64, 128 beside the
   d_m = 32 kernels, cuDNN's nn.GRU at the same hidden size (forward, and
   forward with backward) and each form's bound, the scale forms at T =
   300, the readout at three widths; (3) (a) xlong_hpmn at mem_dim =
   readout_dim = emb_dim = 64 (layer 0's d_in 128, K5's A = d_m = 64 and
   d_q = 128), B 512, T 1000, f32 and bf16 scans, against the plain path
   at phases 5 and 6's tolerances, then k = 8 steps per dispatch timed
   (examples/s, ms per step, peak MiB, a profiled dispatch's busy share),
   the general forms' launches counted; (b) its UserMemoryStore: 2048
   histories ingested, updates, predict and rank against the plain
   hierarchy and scores; (c) taobao_dien at mem_dim = 64, f32 left-padded
   and bf16 full, as phase 8; (d) ``python -m hpmn_tpu_torch.tools.sweep
   --grid model.mem_dim=16,32 --set model.use_pallas=true`` (100 steps)
   as a subprocess, each point's kernel launches (> 0) and its metric;
   (e) the strided forms, K3-general and K4-general (f32 and bf16): in (1)
   on (d_in, d_m) in (1, 1), (40, 48), (128, 64), (64, 128), (128, 32),
   (512, 256), period 3, in (2) at d_m = d_in in 16, 64, 128 beside
   K1-general, K2-general and cuDNN's nn.GRU (its backward from the
   strided rows' cotangents), and (a)'s model with
   ``pallas_stride_outputs``: against the plain strided path and the dense
   wide step's loss, timed, with 6 K3-general and 6 K4-general launches a
   step and no other scan kernel.

Then one JSON line with every kernel's numbers (the general forms' at d_m
= 64, with their times at every width beside), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Without a CUDA device,
or away from the repo, it exits nonzero and prints no result. Imports
nothing of JAX.
"""

import contextlib
import copy
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

# Tolerances (max abs difference from the plain PyTorch version, f32, TF32
# off). The kernels sum in another order and use expf/tanhf where PyTorch
# uses its own sigmoid/tanh, a few ulp per step. The GRU carry is a convex
# mix of the old state and a bounded candidate, so step errors do not grow
# over the scan; 1e-4 leaves that much headroom over 1000 steps. The readout
# is one pass of O(1) values: 1e-5. Scores of the whole slice (sigmoid of
# the tower over the readout) inherit the memory's 1e-4.
TOL_GRU = 1e-4
TOL_READOUT = 1e-5
TOL_SLICE = 1e-4
# K1's input projection alone against the plain projection computed in
# float64: max abs difference over the plain result's max abs. Each output
# is one f32 fmaf chain over d_in = 32 terms, about sqrt(32) roundings of
# half an ulp of the partial sums: 1e-6.
TOL_PROJ = 1e-6
# K1-bf16's projection: its r and z blocks are such chains over bf16 values
# (TOL_PROJ); its c block is the chain plus b_c rounded to bf16: the bf16
# rounding of the float64 sum, up to that f32 error (TOL_PROJ of max abs),
# which moves it by one bf16 ulp at most unless the sum cancels far below
# its terms.
# The scan backward (K2) and the training step's gradients: max abs
# difference over each tensor's max abs. Weight gradients sum over T*B =
# 512k row-steps, in the kernel per warp, then per block, then over blocks,
# in the plain version as one product; the dh carry runs 1000 steps. The
# step's gradients add six scans, the readout and an embedding scatter-add
# (atomics, in no fixed order) to that: 1e-4 for a kernel, 1e-3 for a step.
# The loss is a mean of O(1) values: 1e-5 relative.
TOL_GRAD = 1e-4
TOL_STEP_GRAD = 1e-3
TOL_STEP_LOSS = 1e-5
# The bf16 chain (K1-bf16, K2-bf16) against the plain bf16 versions, in
# bf16. Both round at the same places but sum x@wx and h@wh in their own
# f32 orders, so a bf16 rounding may flip, and a flip runs on through the
# recurrence as a few bf16 ulps (2^-8 at |h| in [0.5, 1); up to 1.95e-2 at
# T = 30 on the CPU against JAX): h within 3e-2. K2-bf16's outputs, whose
# dh carry and sums are f32: 1e-2 of their max abs. Against the f32 kernel
# the bf16 chain drifts by its own roundings: h within 0.06, the JAX
# package's bound (tests/test_pallas.py). The bf16 step against its plain
# bf16 path (autograd through the plain chain, which rounds the backward's
# ops elsewhere than K2-bf16): loss 1e-4 relative, gradients 2e-2 of their
# max abs; its loss against the f32 step's: 1e-4 relative. PERF.md has the
# measured worst cases.
TOL_GRU_BF16 = 3e-2
TOL_GRAD_BF16 = 1e-2
TOL_BF16_VS_F32 = 0.06
TOL_STEP_LOSS_BF16 = 1e-4
TOL_STEP_GRAD_BF16 = 2e-2
TOL_STEP_LOSS_BF16_VS_F32 = 1e-4

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W; the printed
# power limit says whether this card runs at it): float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# bf16 operands with f32 sums are what the tensor cores do: the bf16 scans'
# operations are counted at the dense bf16 tensor-core rate.
PEAK_BF16_FLOPS = 989e12

B_SCAN = 512  # the JAX config's batch, also the ingest batch below
N_FULL_USERS = 8192
N_PADDED_USERS = 512
UPDATE_ROUNDS = 4
RANK_USERS, RANK_CANDS = 64, 100
REQUEST_REPS = 5  # predict and rank calls, timed one by one
STEPS_PER_DISPATCH = 8
WARMUP_DISPATCHES, TIMED_DISPATCHES = 2, 3
N_TRAIN_BATCHES = 4  # distinct batches, cycled as bench.py does
# K5's device time: the profiled launches, and how many of them the
# profiler must see (its first profile in a process can miss a few: 198
# of 200 once).
READOUT_DEVICE_LAUNCHES, READOUT_DEVICE_MIN = 220, 200
READOUT_HOST_CALLS = 1000  # K5's host enqueue time: calls
# Phase 10: the driver's xlong_hpmn examples (the config's 20000 cut so
# that 16 steps of B = 512 and two evals fit the script's time), and the
# tolerances: the amazon run on the card against the CPU run, on
# best_val_auc and test auc (tests/test_train.py's golden tolerance: two
# trajectories whose steps differ by the kernels' 1e-6 drift apart over 200
# steps of Adam), on the test log-loss (absolute), and on the step-200
# parameters (over their max abs): the model is near chance on this data,
# so the AUCs alone cannot tell a wrong kernel from a right one; the
# resumed run's step-16 parameters against the uninterrupted run's, over
# their max abs, when the path is not deterministic.
XLONG_EXAMPLES = 6144
TOL_DRIVER = 0.02
TOL_DRIVER_LOG_LOSS = 1e-5
TOL_DRIVER_PARAMS = 1e-4
TOL_RESUME = 1e-5
# Phase 11: the seeded stand-ins for the public dumps. Amazon: the 5-core
# reviews' shape (each reviewer 5-40 reviews) at 20000 reviewers, 20000
# items and 400 categories (the amazon configs' vocab widths). XLong: 3072
# users of 1001-1200 events (every history fills T = 1000), items 50000
# and categories 800, about 3.4M rows. Each user prefers two categories
# and draws 80% of its events from them, so the next behaviour is
# predictable and AUC moves off 0.5.
# A baseline that learns makes a long run chaotic: over 200 steps a run
# from weights perturbed by 1e-7 (relative) ended about 1e-4 apart in test
# log-loss and 1e-2 of max abs apart in parameters, where at step 10 it is
# about 1e-6 apart (the phase prints the distances). So the card's run is
# held to the CPU's where the two can agree: its step-10 parameters within
# TOL_DRIVER_PARAMS of max abs and its step-50 VAL log-loss within
# TOL_DRIVER_LOG_LOSS (phase 10's tolerances), the best VAL and the TEST
# AUC within TOL_DRIVER; at its last step (BASELINE_STEPS, cut from 200 to
# keep the script inside its time limit) its test log-loss and parameters
# to within DIVERGENCE_FACTOR times the distance between the card run and
# a card run from weights perturbed by PERTURB (measured in the phase; the
# log-loss distance, a difference of two scalars, is the larger of the
# TEST and the last step's VAL log-loss's, and at least
# TOL_DRIVER_LOG_LOSS).
# The same for rum, which has no kernel (its matmuls sum in other orders
# on the two devices). The stores' scores: the training path's at 1e-5,
# the CPU store's at TOL_GRU.
PERTURB = 1e-7
DIVERGENCE_FACTOR = 10
CAPTURE_STEP, VAL_CHECK_STEP = 10, 50
AMAZON_USERS, AMAZON_ITEMS, AMAZON_CATS = 20000, 20000, 400
AMAZON_REVIEWS = (5, 40)
XLONG_USERS, XLONG_EVENTS = 3072, (1001, 1200)
XLONG_ITEMS, XLONG_CATS = 50000, 800
PREFERRED_SHARE = 0.8
BASELINE_STEPS = 100
TOL_STORE = 1e-5
STORE_BATCH = 512  # the stores' ingest batch
ONE_BY_ONE_USERS = 32
GATHER_REPS = 20  # native and numpy batch gathers, alternating
# Phase 12: an int8 bundle's scores against the f32 bundle's, and its
# params.npz against the f32 one's (the JAX package's bounds,
# tests/test_serving.py); the bf16 arena against the f32 arena, memories
# and scores (the JAX package's bf16 bounds). A bundle round trip moves no
# bit: its scores are compared for equality.
TOL_Q8, Q8_SIZE = 0.03, 0.45
TOL_ARENA_BF16_MEM, TOL_ARENA_BF16_SCORE = 3e-2, 1e-2
# Phase 13: the daemon's scores against an in-process store on the same
# bundle, and the AOT graphs' against the eager store's. Where the bucket
# equals the request's size (as here) the daemon runs the store's ops on
# the same rows, and the phase prints whether they are equal bit for bit;
# a padded bucket may take another cuBLAS algorithm for the tower's
# matmuls: 1e-6 (the JAX package's tests/test_aot.py tolerance). The host
# enqueue check: rounds in turns, and calls per round for K5 (1000, as
# phase 3) and K1 (200: each call allocates a workspace); a rank chunk's
# readout rows.
TOL_DAEMON = 1e-6
# The load on each daemon: LOAD_CLIENTS clients at once, each sending
# LOAD_REQUESTS predict requests of LOAD_ROWS users.
LOAD_CLIENTS, LOAD_REQUESTS, LOAD_ROWS = 8, 25, 64
HOST_ROUNDS = 6
SCAN_HOST_CALLS = 200
READOUT_RANK_ROWS = RANK_USERS * RANK_CANDS
# Phase 14: the remaining families. xlong_bst's card step against the same
# weights and batch on the CPU at tests/test_torch_bst.py's tolerances:
# logits 1e-4 abs, the loss rtol 1e-5, every gradient within 1e-5 of
# max(1, its max abs) plus rtol 1e-4; the bf16 step against the card's
# f32 at the JAX package's bounds (tests/test_models.py::
# test_bst_bf16_matches_f32: loss 3e-2, logits 0.15); the two-block step
# (the chunked inner block at S = 1001) on BST_BLOCKS2_ROWS rows of the
# batch, so that its O(S^2) CPU run stays a few seconds. taobao_bst's
# HistoryStore against the same store on the CPU at TOL_STORE; through a
# bundle bit for bit; its exported scoring graph at TOL_DAEMON. The
# comparison table over the ten families on amazon (COMPARE_EXAMPLES
# examples, COMPARE_STEPS steps of COMPARE_BATCH, four evals), each
# family's test AUC on the card against its CPU run from the same seed
# within TOL_DRIVER (phase 10's: 48 steps of Adam keep the two runs a
# few 1e-6 apart).
BST_BLOCKS2_ROWS = 64
TOL_BST_LOGITS = 1e-4
TOL_BST_LOSS = 1e-5
TOL_BST_GRAD_ABS, TOL_BST_GRAD_REL = 1e-5, 1e-4
TOL_BST_BF16_LOSS, TOL_BST_BF16_LOGITS = 3e-2, 0.15
COMPARE_STEPS, COMPARE_BATCH, COMPARE_EXAMPLES = 48, 128, 8000
# The CPU table runs beside (b) and the card's table, as one process per
# group of families, one thread each: the scan and write loops of hpmn,
# gru4rec, dien, rum and lstm are small ops that threads do not speed up.
COMPARE_CPU_GROUPS = ("hpmn", "gru4rec", "dien", "rum", "lstm",
                      "dnn,caser,shan,svdpp,bst")
# Which counters (the `counted` order of main) each family of the table
# must move with use_pallas: K1, K2, K5 (hpmn); K1, K2, K1-scale, K2-scale
# (dien); K1, K2 (gru4rec). No other family launches a hand kernel.
COMPARE_KERNELS = {"hpmn": (0, 1, 4), "dien": (0, 1, 9, 10),
                   "gru4rec": (0, 1)}
# Phase 15: the sharded xlong_hpmn step on PARALLEL_RANKS ranks of the one
# card (gloo, whose collectives take CUDA tensors through the host), a
# (2, 2) grid, batch over data and model, against the same
# PARALLEL_STEPS SGD steps in this process: the losses within
# TOL_STEP_LOSS relative, the parameters within TOL_DRIVER_PARAMS of max
# abs (the ranks sum the gradients in other orders); the psum step
# likewise against the first step; the step through the forced fallback
# against the a2a step within TOL_FALLBACK of max abs (its table
# gradients are the same sums, gathered otherwise); train() on the ranks
# at phase 10's tolerances. The tables, held on their own: the first
# step's table gradients within TOL_TABLE_GRAD of each table's max abs
# gradient, and each table's change over the steps within TOL_TABLE_DELTA
# of its max abs change (a cotangent sent to the wrong owner or a lost
# 1/n_model scale is off by the change itself). PARALLEL_CLI: the CLI under
# torch.distributed.run with one rank per card (NCCL).
PARALLEL_RANKS, PARALLEL_STEPS = 4, 4
TOL_FALLBACK = 1e-6
TOL_TABLE_GRAD, TOL_TABLE_DELTA = 1e-4, 1e-2
# Phase 16: sequence parallelism, SP_STEPS SGD steps on (1, 2, 1) (2
# ranks: xlong_hpmn, then taobao_dien) and on (1, 2, 2) (4 ranks, a2a with
# the batch over data and model), against the same steps in one process
# with the kernels, time-major, at phase 15's tolerances (the SP ranks
# split T and scan the chunks with K1-scale and K2-scale from a received
# h0, another order of the same sums); layer 0's T-sharded scan with the
# kernels against the plain chunk scan at TOL_GRU (values) and TOL_GRAD
# (the gradients over their max abs); train() as phase 15 (b).
SP_STEPS = 3
# Phase 17: the bf16 model (model.dtype=bfloat16). The kernel path against
# the plain path on the same bf16 weights and batches: the loss at
# TOL_STEP_LOSS_BF16 relative; each bf16 gradient within
# TOL_BF16_MODEL_GRAD of its norm (the two paths' f32 values differ by
# ulps, and a bf16 rounding then flips: 1 ulp is 2^-8 of a value); the
# update of 3 Adam steps within TOL_BF16_MODEL_UPDATE of its norm (a bf16
# parameter moves a few ulps a step, so one flipped rounding of p + u is a
# large share of u; on the CPU the port's kernel path meets JAX's within
# 0.102 of the norm, tests/test_torch_dtype_kernels.py). train() on the
# card against the CPU after 10 steps: the parameters' gap within
# TOL_BF16_MODEL_DRIVER of the norm of the CPU's 10-step update (p10 -
# p0 over every parameter; measured 3.18e-3 of it on an H100), far below
# the 0.5 that an update of half the size reads, and the 1 of a card run
# that did not train. OPTIONS_STEPS: that run's steps, an eval and a log
# line every 10.
TOL_BF16_MODEL_GRAD = 3e-2
TOL_BF16_MODEL_UPDATE = 0.15
TOL_BF16_MODEL_DRIVER = 1e-2
OPTIONS_STEPS = 20
PARALLEL_CLI = ["--config", "xlong_hpmn", "--set", "n_examples=2048",
                "train.max_steps=4", "train.eval_every=4",
                "train.log_every=2", "model.use_pallas=true",
                "eval_batch_size=256", "train.steps_per_dispatch=1"]


def fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(flops, n_bytes, peak_flops=PEAK_FP32_FLOPS):
    """-> (ms, "operations" or "bytes"): the least time for the work."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def scan_fwd_work(T, B, d_in, masked, es=4, scaled=False, d_m=32):
    """K1: x@wx and h@wh per row-step; x, the mask and the weights read,
    h_seq written, es bytes per element (4 in f32, 2 in bf16). K1-scale
    (``scaled``): the scale read too, and zs = z*a per unit. d_m: the
    hidden width (the general forms')."""
    flops = (2 * T * B * (d_in + d_m) * 3 * d_m
             + (T * B * d_m if scaled else 0))
    n_bytes = es * (T * B * (d_in + d_m) + (T * B if masked else 0)
                    + (T * B if scaled else 0) + (d_in + d_m + 1) * 3 * d_m)
    return flops, n_bytes


def scan_bwd_work(T, B, d_in, masked, es=4, scaled=False, d_m=32):
    """K2: the recompute, dh, dx, dWx and dWh products per row-step; x,
    h_seq, dh_seq, the mask and the weights read (es bytes per element),
    dx written (es), dh0 and the weight gradients written (f32). K2-scale
    (``scaled``): the scale read and dscale written (es), and per unit zs,
    dz's factor a and dscale's product and sum. d_m: the hidden width."""
    flops = (2 * T * B * 3 * d_m * (3 * d_in + 3 * d_m)
             + (4 * T * B * d_m if scaled else 0))
    n_bytes = (es * (T * B * (2 * d_in + 2 * d_m) + (T * B if masked else 0)
                     + (2 * T * B if scaled else 0)
                     + (d_in + d_m + 1) * 3 * d_m)
               + 4 * (B * d_m + (d_in + d_m + 1) * 3 * d_m))
    return flops, n_bytes


def stride_rows(T, period, chunk):
    """K3's outputs, in rows of B x d_m: the strided rows, the chunk
    boundaries and h_T."""
    return T // period + -(-T // chunk) + 1


def scan_stride_fwd_work(T, B, d_in, period, chunk, es=4, d_m=32):
    """K3: K1's operations; x and the weights read, the strided rows, the
    boundaries and h_T written. d_m: the hidden width (the general
    forms')."""
    flops = 2 * T * B * (d_in + d_m) * 3 * d_m
    n_bytes = es * (T * B * d_in + stride_rows(T, period, chunk) * B * d_m
                    + (d_in + d_m + 1) * 3 * d_m)
    return flops, n_bytes


def scan_stride_bwd_work(T, B, d_in, period, chunk, es=4, d_m=32):
    """K4: K2's operations (its replay is K2's recompute of x@wx and h@wh:
    the sweep reads the replay's gates back); x, the boundaries, dhs, dhT
    and the weights read, dx written (es bytes per element), dh0 and the
    weight gradients written (f32). d_m: the hidden width."""
    flops = 2 * T * B * 3 * d_m * (3 * d_in + 3 * d_m)
    n_bytes = (es * (2 * T * B * d_in
                     + stride_rows(T, period, chunk) * B * d_m
                     + (d_in + d_m + 1) * 3 * d_m)
               + 4 * (B * d_m + (d_in + d_m + 1) * 3 * d_m))
    return flops, n_bytes


def kernel_label(name):
    """A profiler kernel name, short but with its template arguments (K2
    and K2-scale are one template)."""
    return name.replace("void ", "").replace("(anonymous namespace)::",
                                              "")[:56]


def bwd_pass_work(T, B, d_in, es=4):
    """K2's pass: dx, dWx and dWh per row-step; x, h_prev and the gate
    gradients (128 per row-step) read and dx written (es bytes per
    element), the weight-gradient sums written (f32)."""
    flops = 2 * T * B * 96 * (2 * d_in + 32)
    n_bytes = (es * (T * B * (2 * d_in + 32 + 128) + d_in * 96)
               + 4 * (d_in + 33) * 96)
    return flops, n_bytes


def bf16_reach(got, want, delta):
    """got against float64 sums want: (the share of values that differ from
    want's bf16 rounding, whether every value is a bf16 value between the
    bf16 roundings of want - delta and want + delta)."""
    g = got.double()
    w, lo, hi = ((want + d).float().bfloat16().double()
                 for d in (0.0, -delta, delta))
    is_bf16 = g == got.bfloat16().double()
    return ((g != w).double().mean().item(),
            bool((is_bf16 & (g >= lo) & (g <= hi)).all().item()))


def readout_work(B, L, d_q, d_m=32, A=32):
    """K5: memory and query through wm, wq and the scores; memory and query
    read, the read written. d_m, A: the widths (K5-general's)."""
    flops = 2 * B * A * (L * d_m + d_q + L) + 2 * B * L * d_m
    n_bytes = 4 * (B * (L * d_m + d_q + d_m) + (d_m + d_q + 2) * A)
    return flops, n_bytes


def preferred_events(rng, n_users, lengths, n_items, n_cats):
    """Per-event (user, item, category) ids: each user has two preferred
    categories and draws PREFERRED_SHARE of its events from them; item i
    belongs to category i % n_cats."""
    user = np.repeat(np.arange(n_users), lengths)
    pref = rng.integers(0, n_cats, (n_users, 2))
    cat = pref[user, rng.integers(0, 2, user.size)]
    item = cat + n_cats * rng.integers(0, n_items // n_cats, user.size)
    item = np.where(rng.random(user.size) < PREFERRED_SHARE, item,
                    rng.integers(0, n_items, user.size))
    return user, item, item % n_cats


def event_times(rng, lengths, base, step):
    """Increasing timestamps per user from a random start."""
    start = np.repeat(rng.integers(0, 30_000_000, lengths.size), lengths)
    first = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return base + start + step * (np.arange(lengths.sum()) - first)


def write_amazon_dump(directory, seed):
    """Seeded reviews and meta files in the public Amazon dump's JSON-lines
    format (reviewerID, asin, unixReviewTime; asin, categories) -> the
    number of reviews."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(AMAZON_REVIEWS[0], AMAZON_REVIEWS[1] + 1,
                           AMAZON_USERS)
    user, item, _ = preferred_events(rng, AMAZON_USERS, lengths,
                                     AMAZON_ITEMS, AMAZON_CATS)
    ts = event_times(rng, lengths, 1_300_000_000, 86_400)
    with open(os.path.join(directory, "reviews.json"), "w") as f:
        f.write("".join(
            f'{{"reviewerID": "A{u:07d}", "asin": "B{i:09d}", '
            f'"overall": 5.0, "unixReviewTime": {t}}}\n'
            for u, i, t in zip(user.tolist(), item.tolist(), ts.tolist())))
    with open(os.path.join(directory, "meta.json"), "w") as f:
        f.write("".join(
            f'{{"asin": "B{i:09d}", "categories": [["Electronics", '
            f'"C{i % AMAZON_CATS:03d}"]]}}\n' for i in range(AMAZON_ITEMS)))
    return int(lengths.sum())


def write_xlong_csv(path, seed):
    """A seeded XLong event log, ``user,item,category,timestamp`` rows with
    zero-padded ids, written from numpy digits -> the number of rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(XLONG_EVENTS[0], XLONG_EVENTS[1] + 1, XLONG_USERS)
    user, item, cat = preferred_events(rng, XLONG_USERS, lengths,
                                       XLONG_ITEMS, XLONG_CATS)
    ts = event_times(rng, lengths, 1_500_000_000, 60)
    cols = ((user, 5), (item, 5), (cat, 3), (ts, 10))
    width = sum(w + 1 for _, w in cols)
    buf = np.empty((user.size, width), np.uint8)
    at = 0
    for values, w in cols:
        pow10 = 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
        buf[:, at:at + w] = values[:, None] // pow10 % 10 + ord("0")
        buf[:, at + w] = ord(",")
        at += w + 1
    buf[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    return int(user.size)


def phase_12(p):
    """Persistence and bundles on the card, from train to serve. ``p``
    carries phase 4's store and requests, phase 9's DIEN store and
    requests, phase 5's kernel config, batch and ``step_check``, phase
    10's xlong checkpoint and the launch counters. -> the launches of its
    in-process paths, by name (the counters' 13-tuples)."""
    import torch

    from hpmn_tpu_torch.serving import HistoryStore, UserMemoryStore
    from hpmn_tpu_torch.serving import load_bundle
    from hpmn_tpu_torch.train.checkpoint import CheckpointManager

    dev, store, L = p.dev, p.store, p.cfg.model.hpmn_layers
    t12 = time.perf_counter()
    launches = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn, reps=REQUEST_REPS):
        """-> (the last result, the median seconds of reps calls)."""
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts))

    def size(d, name):
        return os.path.getsize(os.path.join(d, name))

    def predict(s):
        return s.predict(p.upd_uids, p.full["target_item"][:B_SCAN],
                         p.full["target_cat"][:B_SCAN])

    def rank(s):
        return s.rank(p.rank_uids, p.rank_items, p.rank_cats)

    # (a) phase 4's store (8192 full histories, 512 left-padded, updates)
    # through a bundle, f32 and int8; then the bf16 arena.
    d_f32, d_q8 = (os.path.join(p.work, n) for n in ("hpmn", "hpmn_q8"))
    want_p, want_r = predict(store), rank(store)
    t0 = time.perf_counter()
    store.save_bundle(d_f32)
    t_save = time.perf_counter() - t0
    store.save_bundle(d_q8, quantize_embeddings=True)
    t0 = time.perf_counter()
    back = UserMemoryStore.load_bundle(d_f32, device=dev)
    sync()
    t_load = time.perf_counter() - t0
    uids = np.sort(np.fromiter(store._row, np.int64))
    (m_a, c_a), (m_b, c_b) = store._gather(uids), back._gather(uids)
    check(back.n_users == store.n_users and torch.equal(m_a, m_b)
          and torch.equal(c_a, c_b), "phase 12 hpmn bundle: the memories "
          "or counters did not come back bit for bit")
    sync()
    p.zero_counters()
    got_p, got_r = predict(back), rank(back)
    launches["bundle_hpmn"] = p.counters()
    check(np.array_equal(got_p, want_p) and np.array_equal(got_r, want_r),
          f"phase 12 hpmn bundle: scores moved by "
          f"{np.abs(got_p - want_p).max():.3e} (predict), "
          f"{np.abs(got_r - want_r).max():.3e} (rank)")
    lb = launches["bundle_hpmn"]
    check(lb[4] >= 2 and sum(lb) == lb[4], f"phase 12 hpmn bundle launches "
          f"{lb}: expected readout_fwd (K5) only, per predict and rank")
    q8 = UserMemoryStore.load_bundle(d_q8, device=dev)
    q8_err = max(float(np.abs(predict(q8) - want_p).max()),
                 float(np.abs(rank(q8) - want_r).max()))
    bytes_f32, bytes_q8 = size(d_f32, "params.npz"), size(d_q8, "params.npz")
    check(0.0 < q8_err <= TOL_Q8, f"phase 12 int8 bundle: scores "
          f"{q8_err:.3e} from the f32 bundle's (tol {TOL_Q8}, and not 0)")
    check(bytes_q8 < Q8_SIZE * bytes_f32, f"phase 12 int8 params.npz "
          f"{bytes_q8} B, f32 {bytes_f32} B")
    del back, q8

    b16 = UserMemoryStore(p.cfg, p.model, device=dev, arena_dtype="bfloat16")
    n_full = len(p.full_uids)
    sync()
    p.zero_counters()
    t0 = time.perf_counter()
    for lo in range(0, n_full, B_SCAN):
        sl = slice(lo, lo + B_SCAN)
        b16.ingest_histories(p.full_uids[sl], p.full["item_seq"][sl],
                             p.full["cat_seq"][sl])
    sync()
    t_ingest16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(UPDATE_ROUNDS):
        b16.update(p.upd_uids, p.upd_items[k], p.upd_cats[k])
    sync()
    t_update16 = time.perf_counter() - t0
    # predict and rank of both arenas, in turns (f32, bf16, bf16, f32)
    launches["store_bf16"] = p.counters()
    ls = launches["store_bf16"]
    n_batches = -(-n_full // B_SCAN)
    check(ls == (L * n_batches,) + (0,) * 12, f"phase 12 bf16 store "
          f"launches {ls}: expected gru_scan_fwd {L} per ingest batch")
    # Both arenas in turns (f32, bf16, bf16, f32): the same update rounds
    # on each, then predict and rank.
    ms = {"f32": [], "bf16": []}
    outs = {}
    for name in ("f32", "bf16", "bf16", "f32"):
        s = store if name == "f32" else b16
        sync()
        t0 = time.perf_counter()
        for k in range(UPDATE_ROUNDS):
            s.update(p.upd_uids, p.upd_items[k], p.upd_cats[k])
        sync()
        t_u = time.perf_counter() - t0
        out_p, t_p = timed(lambda: predict(s))
        out_r, t_r = timed(lambda: rank(s))
        ms[name].append((t_u, t_p, t_r))
        outs[name] = out_p, out_r
    mem_err = (b16._gather(p.full_uids)[0]
               - store._gather(p.full_uids)[0]).abs().max().item()
    cnt_same = torch.equal(b16._gather(p.full_uids)[1],
                           store._gather(p.full_uids)[1])
    score_err = max(float(np.abs(a - b).max())
                    for a, b in zip(outs["bf16"], outs["f32"]))
    check(cnt_same and mem_err <= TOL_ARENA_BF16_MEM
          and score_err <= TOL_ARENA_BF16_SCORE, f"phase 12 bf16 arena vs "
          f"f32: memories {mem_err:.3e} (tol {TOL_ARENA_BF16_MEM}), scores "
          f"{score_err:.3e} (tol {TOL_ARENA_BF16_SCORE}), counters equal "
          f"{cnt_same}")
    arena = {n: n_full * L * p.cfg.model.mem_dim * s._mem.element_size()
             for n, s in (("f32", store), ("bf16", b16))}
    d_b16 = os.path.join(p.work, "bf16")
    b16.save(d_b16)
    b16_back = UserMemoryStore.load(d_b16, p.cfg, p.model, device=dev,
                                    arena_dtype="bfloat16")
    with np.load(os.path.join(d_b16, "user_memory.npz")) as z:
        saved_f32 = z["memory"].dtype == np.float32
    check(saved_f32 and torch.equal(b16_back._gather(p.full_uids)[0],
                                    b16._gather(p.full_uids)[0]),
          "phase 12 bf16 arena: save/load is not f32 on disk and bit for "
          "bit back")
    del b16, b16_back
    med = {n: [float(np.median([t[i] for t in v])) for i in range(3)]
           for n, v in ms.items()}
    print(f"phase 12 (a) hpmn bundle xlong_hpmn {store.n_users} users: "
          f"save_bundle {t_save:.3f} s, load_bundle {t_load:.3f} s "
          f"(params.npz {bytes_f32} B, user_memory.npz "
          f"{size(d_f32, 'user_memory.npz')} B), memories and predict/rank "
          f"bit for bit, launches {lb} | int8 params.npz {bytes_q8} B "
          f"({bytes_q8 / bytes_f32:.3f} of f32, tol {Q8_SIZE}), scores "
          f"{q8_err:.3e} from f32 (tol {TOL_Q8}) | bf16 arena: "
          f"{arena['bf16']} B for {n_full} users (f32 {arena['f32']} B), "
          f"ingest {n_full / t_ingest16:.1f} histories/s, update "
          f"{UPDATE_ROUNDS * B_SCAN / t_update16:.1f} events/s (phase 4 f32:"
          f" ingest {n_full / p.phase4['ingest']:.1f}, update "
          f"{UPDATE_ROUNDS * B_SCAN / p.phase4['update']:.1f}); in turns "
          f"with the f32 store, median of 2: update "
          + ", ".join(f"{n} {UPDATE_ROUNDS * B_SCAN / med[n][0]:.1f}"
                      for n in ("bf16", "f32"))
          + " events/s, predict "
          + ", ".join(f"{n} {1e3 * med[n][1]:.3f}" for n in ("bf16", "f32"))
          + " ms, rank "
          + ", ".join(f"{n} {1e3 * med[n][2]:.3f}" for n in ("bf16", "f32"))
          + f" ms (phase 4: predict {1e3 * p.phase4['predict']:.3f}, rank "
          f"{1e3 * p.phase4['rank']:.3f})"
          f" | vs f32: memories {mem_err:.3e} (tol {TOL_ARENA_BF16_MEM}), "
          f"scores {score_err:.3e} (tol {TOL_ARENA_BF16_SCORE}), counters "
          f"equal; saved f32, restored bit for bit | launches {ls}",
          flush=True)

    # (b) phase 9's DIEN store through a bundle.
    d_h = os.path.join(p.work, "dien")
    sd = p.store_d
    want_pd = sd.predict(p.h_uids[:B_SCAN], p.pr_i, p.pr_c)
    want_rd = sd.rank(p.h_uids[:RANK_USERS], p.rk_i, p.rk_c)
    t0 = time.perf_counter()
    sd.save_bundle(d_h)
    t_save_d = time.perf_counter() - t0
    t0 = time.perf_counter()
    back_d = HistoryStore.load_bundle(d_h, device=dev)
    t_load_d = time.perf_counter() - t0
    rows_a = sd._rows_for(p.h_uids, False)
    rows_b = back_d._rows_for(p.h_uids, False)
    check(back_d.window == sd.window and np.array_equal(
        sd._items[rows_a], back_d._items[rows_b]) and np.array_equal(
        sd._cnt[rows_a], back_d._cnt[rows_b]), "phase 12 DIEN bundle: the "
        "windows did not come back")
    sync()
    p.zero_counters()
    got_pd = back_d.predict(p.h_uids[:B_SCAN], p.pr_i, p.pr_c)
    got_rd = back_d.rank(p.h_uids[:RANK_USERS], p.rk_i, p.rk_c)
    launches["bundle_dien"] = p.counters()
    ld = launches["bundle_dien"]
    check(np.array_equal(got_pd, want_pd) and np.array_equal(got_rd,
                                                             want_rd),
          f"phase 12 DIEN bundle: scores moved by "
          f"{np.abs(got_pd - want_pd).max():.3e}, "
          f"{np.abs(got_rd - want_rd).max():.3e}")
    want_l = (2,) + (0,) * 8 + (2, 0, 0, 0)
    check(ld == want_l, f"phase 12 DIEN bundle launches {ld}, expected "
          f"{want_l} (K1 and K1-scale once per scoring call)")
    print(f"phase 12 (b) DIEN bundle taobao_dien W={back_d.window} "
          f"{back_d.n_users} users: save_bundle {t_save_d:.3f} s, "
          f"load_bundle {t_load_d:.3f} s (user_history.npz "
          f"{size(d_h, 'user_history.npz')} B, params.npz "
          f"{size(d_h, 'params.npz')} B) | predict and rank bit for bit | "
          f"launches gru_scan_fwd {ld[0]} gru_scan_fwd_scale {ld[9]}",
          flush=True)
    del back_d

    # (c) use_user_emb: the training step with the user table.
    c_u = p.cfg_k.with_model(use_user_emb=True)
    check(int(p.batch.uid.max()) < p.n_users, "phase 12: a uid beyond the "
          "user table")
    sync()
    p.zero_counters()
    p.step_check(12, "use_user_emb f32 full", c_u, p.batch,
                 c_u.with_model(use_pallas=False), False, TOL_STEP_LOSS,
                 TOL_STEP_GRAD)
    launches["training_user_emb"] = p.counters()
    want_l = (L, L, 0, 0, 1) + (0,) * 8
    check(launches["training_user_emb"] == want_l, f"phase 12 use_user_emb "
          f"step launches {launches['training_user_emb']}, expected "
          f"{want_l}")

    # (d) the CLIs, as subprocesses: phase 10's checkpoint -> bundles ->
    # scores.
    def tool(name, *args):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", f"hpmn_tpu_torch.tools.{name}", *args,
             *p.cli_device], cwd=p.repo, capture_output=True, text=True,
            timeout=300)
        check(out.returncode == 0, f"phase 12 {name} exited "
              f"{out.returncode}: {out.stderr[-2000:]}")
        return out.stdout.strip(), time.perf_counter() - t0

    hist = os.path.join(p.work, "hist.npz")
    np.savez(hist, uids=p.full_uids[:B_SCAN],
             item_seqs=p.full["item_seq"][:B_SCAN],
             cat_seqs=p.full["cat_seq"][:B_SCAN])
    d_cli, d_ema = (os.path.join(p.work, n) for n in ("cli", "cli_ema"))
    common = ["--ckpt_dir", p.ckpt, "--config", "xlong_hpmn", "--set",
              *p.ckpt_set]
    line_q, t_q = tool("export_bundle", *common, "--out", d_cli,
                       "--histories", hist, "--quantize")
    check(f"n_users={B_SCAN}" in line_q and "quantized=True" in line_q,
          f"phase 12 export_bundle: {line_q}")
    line_e, t_e = tool("export_bundle", *common, "--out", d_ema, "--ema")
    mngr = CheckpointManager(p.ckpt)
    step = mngr.best_step()
    state = mngr.restore(step)
    check(f"exported step {step} " in line_e and "ema=True" in line_e,
          f"phase 12 export_bundle --ema: {line_e}")
    names = list(state["params"])
    shadow = dict(zip(names, state["opt_state"]["ema"]))["embedding.item"]
    ema_item = load_bundle(d_ema, device=dev).model.embedding.item
    check(torch.equal(ema_item.cpu(), shadow) and not torch.equal(
        shadow, state["params"]["embedding.item"]), "phase 12 --ema: the "
        "bundle's item table is not the checkpoint's EMA shadow")
    served = load_bundle(d_cli, device=dev)
    req, out_npz = (os.path.join(p.work, n) for n in ("req.npz", "out.npz"))
    ci, cc = p.full["target_item"][:B_SCAN], p.full["target_cat"][:B_SCAN]
    np.savez(req, uids=p.full_uids[:B_SCAN], cand_items=ci, cand_cats=cc,
             item_ids=p.upd_items[0], cat_ids=p.upd_cats[0])
    line_s, t_s = tool("serve_batch", "--bundle", d_cli, "--requests", req,
                       "--out", out_npz, "--update")
    scores = np.load(out_npz)["scores"]
    check(scores.shape == (B_SCAN,) and np.isfinite(scores).all()
          and ((scores > 0) & (scores < 1)).all(), "phase 12 serve_batch: "
          "scores not in (0, 1)")
    served.update(p.full_uids[:B_SCAN], p.upd_items[0], p.upd_cats[0])
    cli_err = float(np.abs(served.predict(p.full_uids[:B_SCAN], ci, cc)
                           - scores).max())
    check(cli_err <= TOL_STORE, f"phase 12 serve_batch vs the same "
          f"requests in this process: {cli_err:.3e}")
    cnt = load_bundle(d_cli, device=dev)._gather(p.full_uids[:B_SCAN])[1]
    check(bool((cnt == p.full["seq_mask"].shape[1] + 1).all()),
          "phase 12 serve_batch --update did not persist the counters")
    print(f"phase 12 (d) CLIs on phase 10's xlong checkpoint (step {step}):"
          f" export_bundle --histories ({B_SCAN} users) --quantize "
          f"{t_q:.1f} s, params.npz {size(d_cli, 'params.npz')} B: {line_q}"
          f" | --ema {t_e:.1f} s, params.npz {size(d_ema, 'params.npz')} B,"
          f" the item table = the EMA shadow | serve_batch --update "
          f"{t_s:.1f} s: {line_s}, scores in (0, 1), {cli_err:.2e} from "
          f"this process's, counters +1 saved | phase 12 "
          f"{time.perf_counter() - t12:.1f} s", flush=True)
    return launches


def host_enqueue(p, library, cuda_readout, cuda_gru):
    """The host's time to enqueue one kernel call through its custom op
    (``ops/library.py``) and through the direct launch the eager path
    takes, in turns, HOST_ROUNDS rounds of calls with no synchronize: K5
    at B = 512 and 6400 (phase 4's readout, L slots), K1 at DIEN's scoring
    shape (T = 300, B = 512, masked f32, phase 9's interest GRU). -> {name:
    (median op us, median direct us, spread of the direct rounds' us)}."""
    import torch

    dev = p.dev
    gen = torch.Generator(device=dev).manual_seed(7)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def us(fn, n):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        sync()
        return t

    ro = p.model.readout
    w = (ro.wm, ro.wq, ro.b, ro.v)
    L, d_q = p.cfg.model.hpmn_layers, ro.wq.shape[0]
    cases = {}
    for B in (B_SCAN, READOUT_RANK_ROWS):
        mem = torch.randn(B, L, 32, device=dev, generator=gen)
        q = torch.randn(B, d_q, device=dev, generator=gen)
        cases[f"readout_fwd B={B}"] = (
            lambda m=mem, q_=q: library.readout_fwd(m, q_, *w),
            lambda m=mem, q_=q: cuda_readout.readout_by_device(m, q_, *w),
            READOUT_HOST_CALLS)
    g1 = p.store_d.model.encoder.gru1
    x = torch.randn(p.dien_window, B_SCAN, g1.wx.shape[0], device=dev,
                    generator=gen)
    mask = torch.ones(p.dien_window, B_SCAN, device=dev)
    args = (x, mask, None, g1.wx, g1.wh, g1.b, None)
    cases[f"gru_scan_fwd T={p.dien_window} B={B_SCAN}"] = (
        lambda: library.gru_scan_fwd(*args),
        lambda: cuda_gru.scan_by_device(*args), SCAN_HOST_CALLS)
    out = {}
    with torch.no_grad():
        for name, (op, direct, n) in cases.items():
            o, d = [], []
            for _ in range(HOST_ROUNDS):
                o.append(us(op, n))
                d.append(us(direct, n))
            out[name] = (float(np.median(o)), float(np.median(d)),
                         max(d) - min(d))
    return out


def phase_13(p):
    """The serving daemon and the AOT graphs on the card, from phase 12's
    bundles and phase 10's checkpoint. ``p`` carries phase 12's, and the
    host-enqueue check's tensors. -> the launches of each daemon path, by
    path and kernel (read through the daemons' ``stats``)."""
    import threading

    from hpmn_tpu_torch.ops import cuda_gru, cuda_readout, library
    from hpmn_tpu_torch.serving import load_bundle
    from hpmn_tpu_torch.serving.aot import load_aot_store
    from hpmn_tpu_torch.serving.client import ServingClient
    from hpmn_tpu_torch.serving.sharded import ShardedServingClient

    dev = p.dev
    t13 = time.perf_counter()
    d_hpmn, d_dien = (os.path.join(p.work, n) for n in ("hpmn", "dien"))
    d_aot, d_dien_aot = (os.path.join(p.work, n)
                         for n in ("aot", "dien_aot"))
    journal = os.path.join(p.work, "daemon.journal")
    log_path = os.path.join(p.work, "daemons.log")
    log = open(log_path, "w")
    procs, clients = [], []
    launches = {}
    rng = np.random.default_rng(13)

    def log_tail():
        log.flush()
        with open(log_path) as f:
            return f.read()[-3000:]

    def start(module, *args):
        # Each in a process group of its own, so that the fleet's shards
        # are stopped with it whatever ends the phase.
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", f"hpmn_tpu_torch.tools.{module}",
             *args, *p.cli_device], cwd=p.repo, stdout=subprocess.PIPE,
            stderr=log, text=True, start_new_session=True)
        procs.append(proc)
        return proc

    def ready(proc, marker):
        """The process's lines up to the first that holds ``marker``."""
        lines = []
        while True:
            line = proc.stdout.readline()
            if not line:
                fail(f"phase 13: a process exited ({proc.wait()}) before "
                     f"'{marker}': {''.join(lines)[-1500:]} | stderr: "
                     f"{log_tail()}")
            lines.append(line)
            if marker in line:
                return lines

    def daemon(*args):
        """Start ``serve`` on an ephemeral port -> (process, client,
        its lines up to ready, seconds from start to ready)."""
        t0 = time.perf_counter()
        proc = start("serve", "--port", "0", "--max_batch", str(B_SCAN),
                     *args)
        lines = ready(proc, "serving bundle")
        secs = time.perf_counter() - t0
        host, port = lines[-1].rsplit(" on ", 1)[1].split()[0].rsplit(":",
                                                                        1)
        client = ServingClient(host, int(port), timeout_s=300)
        clients.append(client)
        return proc, client, lines, secs

    def stop(proc, sig=signal.SIGTERM):
        proc.send_signal(sig)
        proc.wait(timeout=60)

    def launched(client):
        return client.stats()["launches"]

    def diff(after, before, names):
        return {n: after[n] - before[n] for n in names}

    def err(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    def load(client, model=None, threads=LOAD_CLIENTS, reqs=LOAD_REQUESTS,
             rows=LOAD_ROWS):
        """threads clients x reqs predict calls of rows users each, at
        once -> (requests/s on the host's clock, the daemon's stats)."""
        addr = client._sock.getpeername()
        errors = []

        def one(seed):
            r = np.random.default_rng(seed)
            try:
                with ServingClient(*addr, timeout_s=300) as c:
                    for _ in range(reqs):
                        u = r.choice(p.upd_uids, rows, replace=False)
                        c.predict(u, p.rank_items[0, :rows],
                                  p.rank_cats[0, :rows], model=model)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=one, args=(s,)) for s in
              range(threads)]
        t0 = time.perf_counter()
        [t.start() for t in ts]
        [t.join() for t in ts]
        wall = time.perf_counter() - t0
        check(not errors, f"phase 13 load: {errors[:1]}")
        return threads * reqs / wall, client.stats()

    hp = (p.upd_uids, p.full["target_item"][:B_SCAN],
          p.full["target_cat"][:B_SCAN])
    rk = (p.rank_uids, p.rank_items, p.rank_cats)
    dp = (p.h_uids[:B_SCAN], p.pr_i, p.pr_c)
    dr = (p.h_uids[:RANK_USERS], p.rk_i, p.rk_c)
    try:
        # (a) + (b): one daemon serves the xlong bundle and, as model
        # "dien", the DIEN bundle, with warm-up and a journal.
        eager = load_bundle(d_hpmn, device=dev)
        eager_d = load_bundle(d_dien, device=dev)
        args_a = ("--bundle", d_hpmn, "--extra_bundle", f"dien={d_dien}",
                  "--journal", journal, "--warmup")
        proc, cl, lines, t_start = daemon(*args_a)
        check(any("warmed predict buckets" in s for s in lines),
              f"phase 13 --warmup: {lines}")
        # the checkpoint's bundle with its graphs, and the fleet, in the
        # background while (a) and (b) run
        hist = os.path.join(p.work, "hist.npz")
        t0 = time.perf_counter()
        exporter = start("export_bundle", "--ckpt_dir", p.ckpt, "--config",
                         "xlong_hpmn", "--set", *p.ckpt_set, "--out", d_aot,
                         "--histories", hist, "--export_compiled",
                         "--platforms", p.platforms)
        fleet = start("serve_fleet", "--bundle", d_hpmn, "--shards", "2",
                      "--base_port", "0", "--max_batch", str(B_SCAN))
        st0 = launched(cl)
        got_p, got_r = cl.predict(*hp), cl.rank(*rk)
        n_a = diff(launched(cl), st0, ("readout_fwd",))
        want_p, want_r = eager.predict(*hp), eager.rank(*rk)
        st0 = launched(cl)
        got_dp, got_dr = (cl.predict(*dp, model="dien"),
                          cl.rank(*dr, model="dien"))
        n_b = diff(launched(cl), st0, ("gru_scan_fwd", "gru_scan_fwd_scale"))
        want_dp, want_dr = eager_d.predict(*dp), eager_d.rank(*dr)
        e_a = max(err(got_p, want_p), err(got_r, want_r))
        e_b = max(err(got_dp, want_dp), err(got_dr, want_dr))
        same_a = (np.array_equal(got_p, want_p)
                  and np.array_equal(got_r, want_r))
        same_b = (np.array_equal(got_dp, want_dp)
                  and np.array_equal(got_dr, want_dr))
        check(e_a <= TOL_DAEMON and e_b <= TOL_DAEMON, f"phase 13 daemon "
              f"vs the in-process stores: hpmn {e_a:.3e}, dien {e_b:.3e} "
              f"(tol {TOL_DAEMON})")
        check(n_a == {"readout_fwd": 2} and n_b == {
            "gru_scan_fwd": 2, "gru_scan_fwd_scale": 2}, f"phase 13 daemon "
            f"launches hpmn {n_a}, dien {n_b}: expected K5 once per predict "
            f"and rank, K1 and K1-scale once per DIEN scoring call")
        launches["daemon_hpmn"] = n_a
        launches["daemon_dien"] = n_b
        # updates through the daemon (journaled), then a crash and a
        # restart that replays them
        d_ev = rng.integers(1, p.dien_items, size=(2, B_SCAN))
        for k in range(UPDATE_ROUNDS):
            cl.update(p.upd_uids, p.upd_items[k], p.upd_cats[k])
            eager.update(p.upd_uids, p.upd_items[k], p.upd_cats[k])
        for k in range(2):
            d_cat = d_ev[k] % (p.dien_cats - 1) + 1
            cl.update(dp[0], d_ev[k], d_cat, model="dien")
            eager_d.update(dp[0], d_ev[k], d_cat)
        stop(proc, signal.SIGKILL)
        proc, cl, lines, t_restart = daemon(*args_a)
        replayed = [s.strip() for s in lines if s.startswith("replayed")]
        check(len(replayed) == 2, f"phase 13 restart: no journal replay "
              f"for both models: {lines}")
        e_re = max(err(cl.predict(*hp), eager.predict(*hp)),
                   err(cl.rank(*rk), eager.rank(*rk)),
                   err(cl.predict(*dp, model="dien"), eager_d.predict(*dp)))
        check(e_re <= TOL_DAEMON, f"phase 13 after the journal replay: "
              f"{e_re:.3e} from the in-process stores")
        check(exporter.wait(timeout=600) == 0, f"phase 13 export_bundle "
              f"--export_compiled failed: {log_tail()}")
        t_export = time.perf_counter() - t0
        fleet_line = ready(fleet, "FLEET ready:")[-1]
        rps_e, st_e = load(cl)
        print(f"phase 13 (a)+(b) daemon xlong_hpmn + dien on {dev}: "
              f"startup with --warmup {t_start:.1f} s (restart with journal "
              f"replay {t_restart:.1f} s: {'; '.join(replayed)}) | predict "
              f"{B_SCAN} and rank {RANK_USERS}x{RANK_CANDS} vs the "
              f"in-process store {e_a:.2e} (bit for bit {same_a}), DIEN "
              f"{e_b:.2e} (bit for bit {same_b}), tol {TOL_DAEMON} | "
              f"launches {n_a} {n_b} | after {UPDATE_ROUNDS} + 2 update "
              f"rounds, SIGKILL and restart: {e_re:.2e}", flush=True)

        # (d) the fleet of 2 shards against the single daemon's answers.
        addrs = [(h, int(x)) for h, x in (
            a.rsplit(":", 1) for a in fleet_line.split(":", 1)[1].split())]
        with ShardedServingClient(addrs, timeout_s=300) as sh:
            st0 = [s["launches"] for s in sh.stats()]
            f_p, f_r = sh.predict(*hp), sh.rank(*rk)
            st1 = [s["launches"] for s in sh.stats()]
        n_d = {"readout_fwd": sum(b["readout_fwd"] - a["readout_fwd"]
                                  for a, b in zip(st0, st1))}
        e_d = max(err(f_p, got_p), err(f_r, got_r))
        check(e_d <= TOL_DAEMON and n_d["readout_fwd"] >= 2, f"phase 13 "
              f"fleet vs the single daemon: {e_d:.3e} (tol {TOL_DAEMON}), "
              f"launches {n_d}")
        launches["fleet_hpmn"] = n_d
        stop(fleet)
        print(f"phase 13 (d) fleet of 2 shards on one card: predict and "
              f"rank vs the single daemon {e_d:.2e} (tol {TOL_DAEMON}) | "
              f"launches {n_d}", flush=True)
        stop(proc)

        # (c) AOT: the checkpoint's exported bundle and the DIEN store's.
        with open(os.path.join(d_aot, "serving_config.json")) as f:
            exp = json.load(f)["exported"]
        check(exp["format"] == "torch.export" and exp["platforms"] == sorted(
            p.platforms.split(",")), f"phase 13 export manifest {exp}")
        t0 = time.perf_counter()
        p.store_d.save_bundle(d_dien_aot, export_compiled=True,
                              export_platforms=(dev.type,))
        t_export_d = time.perf_counter() - t0
        eager_x = load_bundle(d_aot, device=dev)
        proc, cl, lines, t_aot = daemon(
            "--bundle", d_aot, "--extra_bundle", f"dien={d_dien_aot}",
            "--aot", "--warmup")
        check("aot" in lines[-1], f"phase 13 --aot: {lines[-1]}")
        st0 = launched(cl)
        a_p, a_r = cl.predict(*hp), cl.rank(*rk)
        n_c = diff(launched(cl), st0, ("readout_fwd",))
        st0 = launched(cl)
        a_dp, a_dr = (cl.predict(*dp, model="dien"),
                      cl.rank(*dr, model="dien"))
        n_cd = diff(launched(cl), st0, ("gru_scan_fwd",
                                        "gru_scan_fwd_scale"))
        e_c = max(err(a_p, eager_x.predict(*hp)),
                  err(a_r, eager_x.rank(*rk)))
        e_cd = max(err(a_dp, p.store_d.predict(*dp)),
                   err(a_dr, p.store_d.rank(*dr)))
        check(e_c <= TOL_DAEMON and e_cd <= TOL_DAEMON, f"phase 13 --aot vs "
              f"the eager stores: hpmn {e_c:.3e}, dien {e_cd:.3e} (tol "
              f"{TOL_DAEMON})")
        check(n_c == {"readout_fwd": 2} and n_cd == {
            "gru_scan_fwd": 2, "gru_scan_fwd_scale": 2}, f"phase 13 --aot "
            f"launches hpmn {n_c}, dien {n_cd}: the exported graphs must "
            f"launch K5 per predict and rank, K1 and K1-scale per DIEN call")
        launches["aot_hpmn"] = n_c
        launches["aot_dien"] = n_cd
        # the bundle's CPU graphs, here in this process, against the
        # card's graphs on the same state
        on_cpu = load_aot_store(d_aot, device="cpu")
        e_cpu = err(on_cpu.predict(*(a[:RANK_USERS] for a in hp)),
                    a_p[:RANK_USERS])
        check(e_cpu <= TOL_SLICE, f"phase 13 the bundle's cpu graphs vs "
              f"its cuda graphs: {e_cpu:.3e} (tol {TOL_SLICE})")
        del on_cpu
        cl.update(p.upd_uids, p.upd_items[0], p.upd_cats[0])
        eager_x.update(p.upd_uids, p.upd_items[0], p.upd_cats[0])
        e_cu = err(cl.predict(*hp), eager_x.predict(*hp))
        check(e_cu <= TOL_DAEMON, f"phase 13 --aot after an update: "
              f"{e_cu:.3e}")
        rps_a, st_a = load(cl)
        stop(proc)
        print(f"phase 13 (c) AOT: export_bundle --export_compiled "
              f"--platforms {p.platforms} {t_export:.1f} s (in the "
              f"background of (a)), DIEN store save_bundle(export_compiled) "
              f"{t_export_d:.1f} s | serve --aot startup with --warmup "
              f"{t_aot:.1f} s | vs the eager stores: hpmn {e_c:.2e}, dien "
              f"{e_cd:.2e}, after an update {e_cu:.2e} (tol {TOL_DAEMON}); "
              f"its cpu graphs (in this process) vs its cuda graphs "
              f"{e_cpu:.2e} (tol {TOL_SLICE}) | "
              f"launches per predict+rank {n_c} {n_cd}", flush=True)

        # (e) the numbers: the daemons under load, and the host's cost of
        # the custom ops against the direct launch.
        enq = host_enqueue(p, library, cuda_readout, cuda_gru)
        print(f"phase 13 (e) load: {LOAD_CLIENTS} clients x {LOAD_REQUESTS} "
              f"predict requests of {LOAD_ROWS} users | eager {rps_e:.1f} requests/s, daemon latency "
              f"{st_e['latency_ms']} stats {st_e['stats']} | aot "
              f"{rps_a:.1f} requests/s, latency {st_a['latency_ms']} stats "
              f"{st_a['stats']} | startup with --warmup: eager "
              f"{t_start:.1f} s, aot {t_aot:.1f} s | host enqueue us per "
              f"call, median of rounds in turns (op, direct; spread of the "
              f"direct rounds): " + ", ".join(
                  f"{k} op {v[0]:.2f} direct {v[1]:.2f} (spread {v[2]:.2f})"
                  for k, v in enq.items()), flush=True)
        p.numbers13 = {"rps_eager": rps_e, "rps_aot": rps_a,
                       "lat_eager": st_e["latency_ms"],
                       "lat_aot": st_a["latency_ms"], "startup": t_start,
                       "startup_aot": t_aot, "enqueue": enq}
    finally:
        for c in clients:
            c.close()
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass  # the group has ended
            proc.wait()
        log.close()
    print(f"phase 13 time: {time.perf_counter() - t13:.1f} s", flush=True)
    return launches


def phase_14(p):
    """The remaining families on the card (see the module docstring): (a)
    xlong_bst's training step at full width, (b) taobao_bst's HistoryStore,
    (c) the comparison table of all ten families, (d) no hand-kernel
    launch on the six new families' legs. ``p`` carries the device, the
    launch counters (``counters``, ``zero_counters``) and the repo root.
    -> the counters of the table's kernel families, by path."""
    import torch

    from hpmn_tpu_torch.configs import get_config
    from hpmn_tpu_torch.data.schema import batch_from_numpy
    from hpmn_tpu_torch.data.synthetic import (AMAZON, TAOBAO, XLONG,
                                               make_ctr_dataset)
    from hpmn_tpu_torch.models import extra_baselines as eb
    from hpmn_tpu_torch.models.embedding import dense_lookup
    from hpmn_tpu_torch.models.model import init_model, loss_fn
    from hpmn_tpu_torch.serving import load_bundle
    from hpmn_tpu_torch.serving.aot import load_aot_store
    from hpmn_tpu_torch.serving.history import HistoryStore
    from hpmn_tpu_torch.tools import compare_models
    from hpmn_tpu_torch.train.train import (make_multistep_train,
                                            make_optimizer)

    dev = p.dev
    t14 = time.perf_counter()

    def no_kernel(leg):
        c = p.counters()
        check(not any(c), f"phase 14 {leg}: hand-kernel launches {c} on a "
              "family that runs none")
        return c

    def kernel_ms(fn, n):
        """fn() once, then n times under torch.profiler -> (the device's
        kernel time per call in ms, the top kernels)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kern = sorted(((a.self_device_time_total, a.key)
                       for a in prof.key_averages()
                       if a.device_type == DeviceType.CUDA
                       and not getattr(a, "is_user_annotation", False)
                       and a.self_device_time_total > 0), reverse=True)
        return sum(t for t, _ in kern) / 1e3 / n, kern[:6]

    # ------------------------------------------- (a) xlong_bst training --
    cfg = get_config("xlong_bst")
    m = cfg.model
    n_b = cfg.train.batch_size
    data = make_ctr_dataset(XLONG, N_TRAIN_BATCHES * n_b, seed=14)
    check(data["seq_mask"].min() == 0.0, "phase 14: no padded history")
    batches = [batch_from_numpy(data, np.arange(i * n_b, (i + 1) * n_b),
                                device=dev) for i in range(N_TRAIN_BATCHES)]

    def run(c, device, rows):
        """One loss and backward of c's seeded model on the first ``rows``
        examples -> (loss, logits, {name: grad}) on the host, seconds."""
        model_r = init_model(c, XLONG.n_items, XLONG.n_cats, seed=c.seed,
                             device=device)
        batch = batch_from_numpy(data, np.arange(rows), device=device)
        t0 = time.perf_counter()
        loss, metrics = loss_fn(model_r, c, batch)
        loss.backward()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        took = time.perf_counter() - t0
        return (loss.item(), metrics["logits"].detach().cpu(),
                {n: q.grad.detach().cpu()
                 for n, q in model_r.named_parameters()}), took

    def held(form, card, cpu):
        """The card's loss, logits and every gradient against the CPU's."""
        (l_k, lg_k, g_k), (l_c, lg_c, g_c) = card, cpu
        loss_rel = abs(l_k - l_c) / abs(l_c)
        lg_err = (lg_k - lg_c).abs().max().item()
        worst, worst_name = -np.inf, ""
        for name, gc in g_c.items():
            gk = g_k[name]
            check(torch.isfinite(gk).all().item(),
                  f"phase 14 (a) {form}: gradient of {name} not finite")
            over = (((gk - gc).abs() - TOL_BST_GRAD_REL * gc.abs()).max()
                    / (TOL_BST_GRAD_ABS * max(1.0, gc.abs().max().item()))
                    ).item()
            if over >= worst:
                worst, worst_name = over, name
        check(np.isfinite(l_k) and loss_rel <= TOL_BST_LOSS,
              f"phase 14 (a) {form}: loss {l_k} vs CPU {l_c}")
        check(lg_err <= TOL_BST_LOGITS,
              f"phase 14 (a) {form}: logits {lg_err:.3e} from the CPU's")
        check(worst <= 1.0, f"phase 14 (a) {form}: gradient of {worst_name}"
              f" at {worst:.3f} of its tolerance")
        return loss_rel, lg_err, worst, worst_name, len(g_c)

    p.zero_counters()
    card32, t_card = run(cfg, dev, n_b)
    cpu32, t_cpu = run(cfg, "cpu", n_b)
    r = held("f32", card32, cpu32)
    print(f"phase 14 (a) xlong_bst f32 B={n_b} T={XLONG.seq_len} d="
          f"{2 * m.emb_dim} heads={m.bst_heads} FFN {m.bst_ffn_mult * 2 * m.emb_dim}"
          f" blocks={m.bst_blocks} chunk={m.bst_attn_chunk}: card vs CPU loss "
          f"{card32[0]:.7f} / {cpu32[0]:.7f} (relative {r[0]:.2e}, tol "
          f"{TOL_BST_LOSS}), logits {r[1]:.2e} (tol {TOL_BST_LOGITS}), "
          f"{r[4]} gradients, worst {r[3]} at {r[2]:.3f} of its tolerance "
          f"| first call: card {1e3 * t_card:.1f} ms, CPU {1e3 * t_cpu:.1f}"
          " ms", flush=True)
    c16 = cfg.with_model(bst_dtype="bfloat16")
    card16, _ = run(c16, dev, n_b)
    d_loss = abs(card16[0] - card32[0])
    d_lg = (card16[1] - card32[1]).abs().max().item()
    check(d_loss < TOL_BST_BF16_LOSS and d_lg < TOL_BST_BF16_LOGITS,
          f"phase 14 (a) bf16: loss {d_loss:.3e}, logits {d_lg:.3e} from "
          "the card's f32")
    check(all(g.dtype == torch.float32 and torch.isfinite(g).all().item()
              for g in card16[2].values()),
          "phase 14 (a) bf16: a gradient not finite f32")
    print(f"phase 14 (a) xlong_bst bf16 vs the card's f32: loss "
          f"{card16[0]:.7f} / {card32[0]:.7f} ({d_loss:.3e}, tol "
          f"{TOL_BST_BF16_LOSS}), logits {d_lg:.3e} (tol "
          f"{TOL_BST_BF16_LOGITS}), every gradient f32 and finite",
          flush=True)
    c2 = cfg.with_model(bst_blocks=2)
    card2, t_card2 = run(c2, dev, BST_BLOCKS2_ROWS)
    cpu2, t_cpu2 = run(c2, "cpu", BST_BLOCKS2_ROWS)
    r2 = held("2 blocks", card2, cpu2)
    print(f"phase 14 (a) xlong_bst 2 blocks (the inner one chunked by "
          f"{m.bst_attn_chunk} at S={XLONG.seq_len + 1}) B="
          f"{BST_BLOCKS2_ROWS}: card vs CPU loss relative {r2[0]:.2e}, "
          f"logits {r2[1]:.2e}, {r2[4]} gradients, worst {r2[3]} at "
          f"{r2[2]:.3f} of its tolerance | card {1e3 * t_card2:.1f} ms, "
          f"CPU {1e3 * t_cpu2:.1f} ms", flush=True)
    no_kernel("(a) checks")

    k = STEPS_PER_DISPATCH
    stacks = [[batches[(i + j) % N_TRAIN_BATCHES] for j in range(k)]
              for i in range(N_TRAIN_BATCHES)]
    # Peak memory: the model, its optimizer state and the steps' own, above
    # what earlier phases and the batches hold.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held_mib = torch.cuda.memory_allocated(dev) / 2**20
    model_t = init_model(cfg, XLONG.n_items, XLONG.n_cats, seed=cfg.seed,
                         device=dev)
    multistep = make_multistep_train(
        cfg, model_t, make_optimizer(cfg, model_t.parameters()))
    p.zero_counters()
    for i in range(WARMUP_DISPATCHES):
        metrics = multistep(stacks[i % N_TRAIN_BATCHES])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP_DISPATCHES, WARMUP_DISPATCHES + TIMED_DISPATCHES):
        metrics = multistep(stacks[i % N_TRAIN_BATCHES])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    no_kernel("(a) training")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 - held_mib
    metrics = {n: v.item() for n, v in metrics.items()}
    check(all(np.isfinite(v) for v in metrics.values()),
          f"phase 14 (a): training metrics not finite: {metrics}")
    step_ms = 1e3 * t_train / (TIMED_DISPATCHES * k)
    ex_s = TIMED_DISPATCHES * k * n_b / t_train
    dev_ms, top = kernel_ms(lambda: multistep(stacks[0]), 1)
    dev_ms /= k
    # The step's parts alone, forward and backward, on the first batch's
    # shapes under the profiler: the gather (both lookups), the block's
    # attention (the projections, the target's scores over S keys, P.V and
    # wo) and the rest of the block (the layer norms and the FFN).
    blk = model_t.encoder.blocks[0]
    emb = model_t.embedding
    b0 = batches[0]
    T = XLONG.seq_len
    with torch.no_grad():
        x0 = dense_lookup(emb, b0.item_seq, b0.cat_seq)
        q0 = dense_lookup(emb, b0.target_item, b0.target_cat)
        h0 = torch.cat([x0, q0[:, None, :]], 1) + model_t.encoder.pos[None,
                                                                      :T + 1]
        kmask = torch.cat([b0.seq_mask, torch.ones_like(b0.seq_mask[:, :1])],
                          1)
        kbias = (1.0 - kmask.float()) * -1e9
        hq0, a0 = eb.bst_attention(blk, h0, kbias, m.bst_heads,
                                   m.bst_attn_chunk, True)
    h0.requires_grad_()
    hq_in = hq0.clone().requires_grad_()
    a_in = a0.clone().requires_grad_()
    g_x = torch.ones_like(x0)
    g_q = torch.ones_like(q0)
    g_a = torch.ones_like(a0)

    def gather():
        x = dense_lookup(emb, b0.item_seq, b0.cat_seq)
        q = dense_lookup(emb, b0.target_item, b0.target_cat)
        torch.autograd.backward((x, q), (g_x, g_q))

    def attention():
        _, a = eb.bst_attention(blk, h0, kbias, m.bst_heads,
                                m.bst_attn_chunk, True)
        a.backward(g_a)

    def ffn():
        eb.bst_ffn(blk, h0, hq_in, a_in).backward(g_a)

    parts = {name: kernel_ms(fn, 10)[0] for name, fn in
             (("gather", gather), ("attention", attention), ("ffn", ffn))}
    model_t.zero_grad(set_to_none=True)
    rest = dev_ms - sum(parts.values())

    def share(t):
        return f"{t / dev_ms:.1%}" if dev_ms > 0 else "not measured"

    top_s = ", ".join(f"{kernel_label(n)} {t / 1e3 / k:.3f}" for t, n in top)
    busy = (f"busy {dev_ms / step_ms:.1%}, idle {1 - dev_ms / step_ms:.1%}"
            if dev_ms > 0 else "the profiler saw no device time: busy "
            "share not measured")
    print(f"phase 14 (a) train xlong_bst B={n_b} T={T} f32, {k} steps per "
          f"dispatch: {ex_s:.1f} examples/s ({step_ms:.3f} ms per step, "
          f"{TIMED_DISPATCHES} dispatches after {WARMUP_DISPATCHES} warm-up,"
          f" {N_TRAIN_BATCHES} batches cycled) | last step loss "
          f"{metrics['loss']:.6f} | peak device memory {peak:.1f} MiB above "
          f"the {held_mib:.1f} held before | "
          f"profile: device kernel time {dev_ms:.3f} ms per step: {busy} | "
          f"alone, forward and backward: attention {parts['attention']:.3f}"
          f" ms ({share(parts['attention'])} of the step's device time), "
          f"layer norms and FFN {parts['ffn']:.3f} ({share(parts['ffn'])}),"
          f" gather {parts['gather']:.3f} ({share(parts['gather'])}), the "
          f"rest (tower, loss, optimizer) {rest:.3f} | top: {top_s}",
          flush=True)
    del model_t, multistep, stacks, batches
    torch.cuda.empty_cache()

    t_a = time.perf_counter() - t14
    # The CPU half of (c) runs beside (b) and the card's half of (c).
    work = tempfile.mkdtemp(prefix="phase14_")
    cmp_args = ["--dataset", "amazon", "--steps", str(COMPARE_STEPS),
                "--batch_size", str(COMPARE_BATCH), "--n_examples",
                str(COMPARE_EXAMPLES), "--use_pallas", "--device", "cpu"]
    procs = [(os.path.join(work, f"compare_cpu_{i}.json"), subprocess.Popen(
        [sys.executable, "-m", "hpmn_tpu_torch.tools.compare_models",
         *cmp_args, "--models", group, "--json",
         os.path.join(work, f"compare_cpu_{i}.json")], cwd=p.repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, env=dict(os.environ, OMP_NUM_THREADS="1")))
        for i, group in enumerate(COMPARE_CPU_GROUPS)]
    try:
        # ------------------------------- (b) taobao_bst HistoryStore --
        cfg_b = get_config("taobao_bst")
        model_b = init_model(cfg_b, TAOBAO.n_items, TAOBAO.n_cats,
                             seed=cfg_b.seed, device=dev)
        model_bc = init_model(cfg_b, TAOBAO.n_items, TAOBAO.n_cats,
                              seed=cfg_b.seed, device="cpu")
        store = HistoryStore(cfg_b, model_b, device=dev)
        store_c = HistoryStore(cfg_b, model_bc, device="cpu")
        hist = make_ctr_dataset(TAOBAO, N_FULL_USERS, seed=15)
        check(hist["seq_mask"].min() == 0.0, "phase 14 (b): no padding")
        users = np.arange(N_FULL_USERS)
        rng = np.random.default_rng(16)
        p.zero_counters()
        t0 = time.perf_counter()
        for s_ in (store, store_c):
            for lo in range(0, N_FULL_USERS, B_SCAN):
                sl = slice(lo, lo + B_SCAN)
                s_.ingest_histories(users[sl], hist["item_seq"][sl],
                                    hist["cat_seq"][sl],
                                    masks=hist["seq_mask"][sl])
            if s_ is store:
                t_ingest = time.perf_counter() - t0
        rounds = [(rng.choice(N_FULL_USERS, B_SCAN, replace=False),
                   rng.integers(1, TAOBAO.n_items, B_SCAN),
                   rng.integers(1, TAOBAO.n_cats, B_SCAN))
                  for _ in range(UPDATE_ROUNDS)]
        t0 = time.perf_counter()
        for u, it, ct in rounds:
            store.update(u, it, ct)
        t_update = time.perf_counter() - t0
        for u, it, ct in rounds:
            store_c.update(u, it, ct)
        pu = rng.choice(N_FULL_USERS + 64, B_SCAN, replace=False)  # some cold
        pi = rng.integers(1, TAOBAO.n_items, B_SCAN)
        pc = rng.integers(1, TAOBAO.n_cats, B_SCAN)
        ru = rng.choice(N_FULL_USERS, RANK_USERS, replace=False)
        ri = rng.integers(1, TAOBAO.n_items, (RANK_USERS, RANK_CANDS))
        rc = rng.integers(1, TAOBAO.n_cats, (RANK_USERS, RANK_CANDS))
        t_pred, t_rank = [], []
        for _ in range(REQUEST_REPS):
            t0 = time.perf_counter()
            got_p = store.predict(pu, pi, pc)
            t_pred.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got_r = store.rank(ru, ri, rc)
            t_rank.append(time.perf_counter() - t0)
        no_kernel("(b) store")
        want_p, want_r = store_c.predict(pu, pi, pc), store_c.rank(ru, ri, rc)
        err_p = float(np.abs(got_p - want_p).max())
        err_r = float(np.abs(got_r - want_r).max())
        check(np.isfinite(got_p).all() and np.isfinite(got_r).all()
              and err_p <= TOL_STORE and err_r <= TOL_STORE,
              f"phase 14 (b): card store {err_p:.3e} / {err_r:.3e} from the "
              "CPU store's")
        check(np.allclose(got_r[:, 0], store.predict(ru, ri[:, 0], rc[:, 0]),
                          atol=1e-6, rtol=0),
              "phase 14 (b): rank's first column is not predict's")
        bdir = os.path.join(work, "bundle")
        t0 = time.perf_counter()
        store.save_bundle(bdir)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_bundle(bdir, device=dev)
        t_load = time.perf_counter() - t0
        check(isinstance(back, HistoryStore) and back.n_users
              == store.n_users, "phase 14 (b): the bundle's store")
        check(np.array_equal(back.predict(pu, pi, pc), got_p)
              and np.array_equal(back.rank(ru, ri, rc), got_r),
              "phase 14 (b): the bundle's scores are not bit for bit")
        adir = os.path.join(work, "aot")
        t0 = time.perf_counter()
        store.save_bundle(adir, export_compiled=True,
                          export_platforms=(dev.type,))
        t_export = time.perf_counter() - t0
        aot = load_aot_store(adir, device=dev)
        err_ap = float(np.abs(aot.predict(pu, pi, pc) - got_p).max())
        err_ar = float(np.abs(aot.rank(ru, ri, rc) - got_r).max())
        check(err_ap <= TOL_DAEMON and err_ar <= TOL_DAEMON,
              f"phase 14 (b): the exported graph {err_ap:.3e} / "
              f"{err_ar:.3e} from the eager store")
        no_kernel("(b) bundle and exported graph")
        print(f"phase 14 (b) serve taobao_bst HistoryStore W={store.window} "
              f"{store.n_users} users: ingest "
              f"{N_FULL_USERS / t_ingest:.1f} histories/s, update "
              f"{UPDATE_ROUNDS * B_SCAN / t_update:.1f} events/s, predict "
              f"{B_SCAN} {1e3 * np.median(t_pred):.3f} ms, rank "
              f"{RANK_USERS} x {RANK_CANDS} {1e3 * np.median(t_rank):.3f} "
              f"ms (medians of {REQUEST_REPS}) | the CPU store's scores "
              f"{err_p:.2e} / {err_r:.2e} (tol {TOL_STORE}) | bundle saved "
              f"in {t_save:.3f} s, loaded in {t_load:.3f} s, scores bit for "
              f"bit | exported scoring graph ({dev.type}) in "
              f"{t_export:.1f} s, "
              f"{err_ap:.2e} / {err_ar:.2e} from eager (tol {TOL_DAEMON}) | "
              f"no hand-kernel launch", flush=True)
        del store, store_c, back, aot, model_b, model_bc
        torch.cuda.empty_cache()
        print(f"phase 14 (b) took {time.perf_counter() - t14 - t_a:.1f} s",
              flush=True)

        # ------------------------- (c) the table of the ten families --
        results, launches = {}, {}
        t0 = time.perf_counter()
        for name in compare_models.DEFAULT_MODELS.split(","):
            p.zero_counters()
            results.update(compare_models.compare(
                [name], device=dev, report=None, dataset="amazon",
                steps=COMPARE_STEPS, n_examples=COMPARE_EXAMPLES,
                batch_size=COMPARE_BATCH, use_pallas=True))
            launches[name] = p.counters()
            want = COMPARE_KERNELS.get(name, ())
            c = launches[name]
            check(all(c[i] > 0 for i in want)
                  and not any(v for i, v in enumerate(c) if i not in want),
                  f"phase 14 (c) {name}: launches {c}, expected counters "
                  f"{want} only")
        t_card = time.perf_counter() - t0
        for line in compare_models.format_table(results).splitlines():
            print(f"phase 14 (c) table | {line}", flush=True)
        t0 = time.perf_counter()
        cpu = {}
        for path, proc in procs:
            out, _ = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"phase 14 (c): the CPU table "
                  f"failed:\n{out[-2000:]}")
            with open(path) as f:
                cpu.update(json.load(f)["results"])
        t_wait = time.perf_counter() - t0
        worst = 0.0
        for name, res in results.items():
            a_k, a_c = res["test"]["auc"], cpu[name]["auc"]
            check(a_c is not None and np.isfinite(a_k),
                  f"phase 14 (c) {name}: AUC {a_k} (CPU {a_c})")
            d = abs(a_k - a_c)
            worst = max(worst, d)
            check(d <= TOL_DRIVER, f"phase 14 (c) {name}: test AUC {a_k:.4f}"
                  f" on the card, {a_c:.4f} on the CPU")
            print(f"phase 14 (c) {name:>8}: test AUC card {a_k:.6f} CPU "
                  f"{a_c:.6f} (|diff| {d:.2e}), log-loss card "
                  f"{res['test']['log_loss']:.6f} CPU "
                  f"{cpu[name]['log_loss']:.6f} | launches "
                  f"{launches[name]}", flush=True)
        print(f"phase 14 (c) compare_models amazon B={COMPARE_BATCH} T="
              f"{AMAZON.seq_len} {COMPARE_STEPS} steps, {COMPARE_EXAMPLES} "
              f"examples, use_pallas: ten families in {t_card:.1f} s on the "
              f"card, then {t_wait:.1f} s waiting for the CPU table "
              f"({len(procs)} processes); AUCs within {worst:.2e} of the "
              f"CPU run's (tol {TOL_DRIVER}); hpmn, dien and gru4rec "
              f"launched their kernels, the other seven none", flush=True)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 14 time: {time.perf_counter() - t14:.1f} s ((a) "
          f"{t_a:.1f} s, (b) and (c) {time.perf_counter() - t14 - t_a:.1f}"
          " s)", flush=True)
    return {f"compare_{name}": launches[name] for name in COMPARE_KERNELS}


def phase_15(p):
    """Data and model parallelism on the card (see the module docstring):
    (a) the sharded step on PARALLEL_RANKS ranks of the card against one
    process, its psum step and its forced fallback, (b) train() on the same
    ranks, (c) the CLI under torch.distributed.run over NCCL, (d) bf16
    BST's gradient gap from f32. ``p`` carries the device, the repo root
    and the card line. -> the ranks' launch counters (K1, K2, K5), by
    path."""
    import torch

    from hpmn_tpu_torch.configs import get_config
    from hpmn_tpu_torch.data.schema import batch_from_numpy
    from hpmn_tpu_torch.data.synthetic import make_ctr_dataset
    from hpmn_tpu_torch.models.model import init_model, loss_fn
    from hpmn_tpu_torch.tools import parallel_check
    from hpmn_tpu_torch.train.checkpoint import CheckpointManager

    t15 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    launches = {}
    try:
        argv = ["--ranks", str(PARALLEL_RANKS), "--backend", "gloo",
                "--steps", str(PARALLEL_STEPS), "--out", work]
        res = parallel_check.run(argv)
        c, ranks, ref = res["compare"], res["ranks"], res["reference"]
        L = get_config("xlong_hpmn").model.hpmn_layers
        for r in ranks:
            check(all(tuple(n) == (L, L, 1) for n in r["launches"]),
                  f"phase 15 (a) rank {r['rank']}: launches per step "
                  f"{r['launches']}, expected K1 x {L}, K2 x {L}, K5 x 1")
            check(r["overflow"] == [0.0] * PARALLEL_STEPS,
                  f"phase 15 (a) rank {r['rank']}: a2a fallback "
                  f"{r['overflow']}")
            launches[f"sharded_step_rank{r['rank']}"] = tuple(
                sum(n[i] for n in r["launches"]) for i in range(3))
            launches[f"driver_sharded_rank{r['rank']}"] = tuple(
                r["train"]["launches"])
        check(c["loss_rel"] <= TOL_STEP_LOSS, f"phase 15 (a): losses "
              f"{c['loss_rel']:.3e} relative from one process's")
        check(c["params_err"] <= TOL_DRIVER_PARAMS * c["params_max"],
              f"phase 15 (a): parameters off by {c['params_err']:.3e}")
        check(c["table_grad_rel"] <= TOL_TABLE_GRAD, f"phase 15 (a): the "
              f"first step's table gradients {c['table_grad_rel']:.3e} of "
              f"their max abs from one process's")
        check(c["table_delta_rel"] <= TOL_TABLE_DELTA, f"phase 15 (a): the "
              f"tables' change {c['table_delta_rel']:.3e} of its max abs "
              f"{c['table_delta_max']} from one process's")
        check(c["dense_identical"], "phase 15 (a): the ranks' dense "
              "parameters differ")
        check(c["psum_loss_rel"] <= TOL_STEP_LOSS and c["psum_params_err"]
              <= TOL_DRIVER_PARAMS * c["psum_params_max"]
              and c["psum_table_delta_rel"] <= TOL_TABLE_DELTA,
              f"phase 15 (a): the psum step off by {c['psum_loss_rel']:.3e}"
              f" (loss), {c['psum_params_err']:.3e} (parameters), "
              f"{c['psum_table_delta_rel']:.3e} (the tables' change)")
        check(c["fallback_overflow"] == [1.0] * PARALLEL_RANKS,
              f"phase 15 (a): the forced step's overflow counters "
              f"{c['fallback_overflow']}, expected 1 on every rank")
        check(c["fallback_params_err"] <= TOL_FALLBACK
              * c["fallback_params_max"] and c["fallback_table_delta_rel"]
              <= TOL_TABLE_DELTA, f"phase 15 (a): the fallback step off "
              f"the a2a step by {c['fallback_params_err']:.3e} (parameters)"
              f", {c['fallback_table_delta_rel']:.3e} (the tables' change)")
        n_rank = [r["train"]["launches"] for r in ranks]
        check(all(n == n_rank[0] and min(n) > 0 for n in n_rank),
              f"phase 15 (b): the ranks' train() launches {n_rank}")
        check(c["train_auc_gap"] < TOL_DRIVER and c["train_best_val_gap"]
              < TOL_DRIVER and c["train_log_loss_gap"] < TOL_DRIVER_LOG_LOSS
              and c["train_params_err"]
              <= TOL_DRIVER_PARAMS * c["train_params_max"],
              f"phase 15 (b): train() on the ranks against one process: "
              f"{c}")
        check(len(c["writes"][0]) > 0 and not any(c["writes"][1:]),
              f"phase 15 (b): checkpoint writes by rank {c['writes']}")
        check(c["checkpoint_matches"], "phase 15 (b): the best checkpoint "
              "differs from rank 0's returned parameters")
        mngr = CheckpointManager(res["ckpt"])
        state = mngr.restore(mngr.best_step())
        cfg_x = get_config("xlong_hpmn")
        spec = parallel_check._spec(res["args"])
        one = init_model(cfg_x.with_model(use_pallas=True), spec.n_items,
                         spec.n_cats, device=p.dev)
        one.load_state_dict(state["params"])
        arrays = make_ctr_dataset(spec, 64, seed=5, min_len_frac=1.0)
        with torch.no_grad():
            lg = loss_fn(one, cfg_x.with_model(use_pallas=True),
                         batch_from_numpy(arrays, device=p.dev))[1]["logits"]
        check(bool(torch.isfinite(lg).all()), "phase 15 (b): the checkpoint "
              "loaded on one device gives non-finite logits")
        step_ms = [float(np.median(r["ms"][1:])) for r in ranks]
        split = " / ".join(
            f"{x['queue_ms']:.3f} {x['transfer_ms']:.3f} "
            f"{x['peer_wait_ms']:.3f} of {x['wall_ms']:.3f}"
            for x in c["exchange"])
        deltas = ", ".join(f"{n} {v:.3e}"
                           for n, v in c["table_delta_max"].items())
        print(f"phase 15 (a) sharded step xlong_hpmn B=512 (128 rows a "
              f"rank) T={spec.seq_len} L={L} items {spec.n_items} cats "
              f"{spec.n_cats}, {PARALLEL_RANKS} ranks on the card over gloo "
              f"(2 x 2, batch over data and model, a2a), {PARALLEL_STEPS} "
              f"SGD steps against one process: losses "
              f"{c['loss_rel']:.3e} relative (tol {TOL_STEP_LOSS}), "
              f"parameters {c['params_err']:.3e} of max abs "
              f"{c['params_max']:.3e} (tol {TOL_DRIVER_PARAMS} of it), "
              f"first-step table gradients {c['table_grad_rel']:.3e} of "
              f"their max abs (tol {TOL_TABLE_GRAD}), the tables' change "
              f"{c['table_delta_rel']:.3e} of its max abs ({deltas}; tol "
              f"{TOL_TABLE_DELTA}), "
              f"dense parameters identical on every rank | launches per "
              f"rank per step gru_scan_fwd {L} gru_scan_bwd {L} readout_fwd "
              f"1 (= expected) | step ms per rank (median of steps 2-"
              f"{PARALLEL_STEPS}) " + ", ".join(f"{x:.3f}" for x in step_ms)
              + f" (one process "
              f"{float(np.median(ref['ms'][1:])):.3f}), capacity factor "
              f"{ranks[0]['capacity_factor']:.4f} (derived) | a profiled "
              f"step's host ms per rank, queued-kernel wait, exchange "
              f"transfer, wait for the model group's other rank, of the "
              f"step: {split} ({c['exchange'][0]['collectives']} "
              f"collectives) | psum step: loss "
              f"{c['psum_loss_rel']:.3e} relative, parameters "
              f"{c['psum_params_err']:.3e}, the tables' change "
              f"{c['psum_table_delta_rel']:.3e} | capacity factor 0.01: "
              f"overflow {c['fallback_overflow']}, parameters "
              f"{c['fallback_params_err']:.3e} from the a2a step (tol "
              f"{TOL_FALLBACK} of max abs), the tables' change "
              f"{c['fallback_table_delta_rel']:.3e} | {p.card}", flush=True)
        r0 = ranks[0]["train"]
        print(f"phase 15 (b) train() xlong_hpmn on the {PARALLEL_RANKS} "
              f"ranks, 16 steps, 2 evals, checkpoints: {r0['seconds']:.1f} s,"
              f" test auc {r0['test']['auc']:.4f} log_loss "
              f"{r0['test']['log_loss']:.4f} | against one process: auc gap "
              f"{c['train_auc_gap']:.2e}, log_loss gap "
              f"{c['train_log_loss_gap']:.2e}, parameters "
              f"{c['train_params_err']:.3e} of max abs "
              f"{c['train_params_max']:.3e} | checkpoint writes by rank "
              f"{[len(w) for w in c['writes']]}, the best one equal to rank "
              f"0's returned parameters bit for bit and loaded on one "
              f"device | launches per rank "
              f"{n_rank[0]} | " + " | ".join(
                  line for line in r0["lines"]
                  if line.startswith(("mesh", "derived", "goodput"))),
              flush=True)

        # (c) the CLI under NCCL, one rank per card; on one card a 1-rank
        # group (a 1 x 1 mesh, no collective crosses ranks): the bootstrap
        n_cards = torch.cuda.device_count()
        grid = ([f"mesh.model_parallel={2 if n_cards % 2 == 0 else 1}"]
                if n_cards > 1 else [])
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nnodes", "1", "--nproc_per_node", str(n_cards), "-m",
             "hpmn_tpu_torch.train.train", *PARALLEL_CLI, *grid],
            cwd=p.repo, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(cli.returncode == 0 and "TEST auc" in cli.stdout,
              f"phase 15 (c): torch.distributed.run exited "
              f"{cli.returncode}:\n{cli.stdout[-2000:]}\n"
              f"{cli.stderr[-3000:]}")
        mesh_line = next(line for line in cli.stdout.splitlines()
                         if line.startswith("mesh"))
        test_line = next(line for line in cli.stdout.splitlines()
                         if line.startswith("TEST"))
        what = ("a 1-rank bootstrap check, no collective crosses ranks"
                if n_cards == 1 else f"{n_cards} ranks")
        print(f"phase 15 (c) python -m torch.distributed.run "
              f"--nproc_per_node {n_cards} -m hpmn_tpu_torch.train.train "
              f"(NCCL, {what}): exit 0 in {cli_s:.1f} s | {mesh_line} | "
              f"{test_line}", flush=True)
        if n_cards >= 2:
            n = n_cards - n_cards % 2
            res2 = parallel_check.run(["--ranks", str(n), "--backend",
                                       "nccl", "--steps",
                                       str(PARALLEL_STEPS)])
            c2 = {k: v for k, v in res2["compare"].items()
                  if k not in ("writes", "exchange")}
            check(c2["loss_rel"] <= TOL_STEP_LOSS and c2["params_err"]
                  <= TOL_DRIVER_PARAMS * c2["params_max"]
                  and c2["table_grad_rel"] <= TOL_TABLE_GRAD
                  and c2["table_delta_rel"] <= TOL_TABLE_DELTA,
                  f"phase 15 (c): the step over NCCL on {n} cards: {c2}")
            print(f"phase 15 (c) the sharded step over NCCL, one rank per "
                  f"card ({n}): {c2}", flush=True)

        # (d) bf16 BST's gradients against f32, on the card and the CPU
        print("phase 15 (d) " + bst_bf16_gap(p.dev), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 15 time: {time.perf_counter() - t15:.1f} s", flush=True)
    return launches


def sp_launches(cfg, T, B, n_seq, train=True):
    """A step's expected launches on one rank of a seq group over
    sequences of T steps and B rows: (K1, K2, K1-scale, K2-scale) of
    hpmn's hierarchy (a layer whose T splits into chunks of at least
    ``sp_min_local_steps`` runs its microbatches through the scale forms,
    the others run whole through K1 and K2) or of DIEN's two scans; K2
    and K2-scale only with ``train``."""
    m, mesh = cfg.model, cfg.mesh
    mb = max(1, min(mesh.sp_microbatches, B))
    while B % mb:
        mb -= 1
    if m.name == "dien":
        lengths = [T, T]
    else:
        lengths = [T // m.hpmn_period ** l for l in range(m.hpmn_layers)]
        lengths = [t for t in lengths if t]
    whole = sum(1 for t in lengths
                if t % n_seq or t // n_seq < mesh.sp_min_local_steps)
    split = len(lengths) - whole
    return (whole, whole * train, split * mb, split * mb * train)


def phase_16(p):
    """Sequence parallelism on the card (see the module docstring): (a)
    and (c) the SP steps of xlong_hpmn and taobao_dien on 2 ranks of a
    (1, 2, 1) grid, with layer 0's SP scan against the plain SP scan, and
    (d) train(), all through one ``parallel_check`` run; (b) the
    composed (1, 2, 2) grid on 4 ranks. ``p`` carries the card line. ->
    the ranks' launch counters (K1, K2, K5, K1-scale, K2-scale), by
    path."""
    from hpmn_tpu_torch.configs import get_config
    from hpmn_tpu_torch.tools import parallel_check
    from hpmn_tpu_torch.train.train import apply_overrides

    t16 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    launches = {}
    sp = ["mesh.seq_parallel=2", "model.use_pallas=false",
          "mesh.sp_inner=pallas"]
    cfg_x = apply_overrides(get_config("xlong_hpmn"), sp)
    cfg_d = apply_overrides(get_config("taobao_dien"), sp)
    B = 512
    try:
        runs = {}
        for name, grid in (("sp", ["--ranks", "2", "--model_parallel", "1"]),
                           ("composed", ["--ranks", "4"])):
            t0 = time.perf_counter()
            runs[name] = parallel_check.run(
                [*grid, "--seq_parallel", "2", "--backend", "gloo",
                 "--steps", str(SP_STEPS), "--out",
                 os.path.join(work, name)])
            runs[name]["seconds"] = time.perf_counter() - t0
        for name, res in runs.items():
            c, ranks, ref = res["compare"], res["ranks"], res["reference"]
            tag = {"sp": "(a)", "composed": "(b)"}[name]
            b_rank = B // ranks[0]["grid"][2]  # rows of a rank (bom)
            T = parallel_check._spec(res["args"]).seq_len
            k1, k2, k1s, k2s = sp_launches(cfg_x, T, b_rank, 2)
            for r in ranks:
                got = [(*n, *ns) for n, ns in zip(r["launches"],
                                                  r["launches_scale"])]
                check(got == [(k1, k2, 0, k1s, k2s)] * SP_STEPS
                      and min(k1, k2, k1s, k2s) > 0,
                      f"phase 16 {tag} rank {r['rank']}: launches per step "
                      f"(K1, K2, K5, K1-scale, K2-scale) {got}, expected "
                      f"{(k1, k2, 0, k1s, k2s)}")
                launches[f"{name}_step_rank{r['rank']}"] = tuple(
                    sum(n[i] for n in got) for i in range(5))
                t = r["train"]
                launches[f"driver_{name}_rank{r['rank']}"] = (
                    *t["launches"], *t["launches_scale"])
            check(c["loss_rel"] <= TOL_STEP_LOSS, f"phase 16 {tag}: losses "
                  f"{c['loss_rel']:.3e} relative from one process's")
            check(c["params_err"] <= TOL_DRIVER_PARAMS * c["params_max"],
                  f"phase 16 {tag}: parameters off by {c['params_err']:.3e}")
            check(c["table_grad_rel"] <= TOL_TABLE_GRAD, f"phase 16 {tag}: "
                  f"the first step's table gradients {c['table_grad_rel']:.3e}"
                  f" of their max abs from one process's")
            check(c["table_delta_rel"] <= TOL_TABLE_DELTA, f"phase 16 {tag}: "
                  f"the tables' change {c['table_delta_rel']:.3e} of its max "
                  f"abs from one process's")
            check(c["dense_identical"], f"phase 16 {tag}: the ranks' dense "
                  "parameters differ")
            n_rank = [(*r["train"]["launches"], *r["train"]["launches_scale"])
                      for r in ranks]
            check(all(n == n_rank[0] and n[0] > 0 and n[3] > 0
                      for n in n_rank), f"phase 16 {tag}: the ranks' train() "
                  f"launches {n_rank}")
            check(c["train_auc_gap"] < TOL_DRIVER and c["train_best_val_gap"]
                  < TOL_DRIVER and c["train_log_loss_gap"]
                  < TOL_DRIVER_LOG_LOSS and c["train_params_err"]
                  <= TOL_DRIVER_PARAMS * c["train_params_max"],
                  f"phase 16 {tag}: train() on the ranks against one "
                  f"process: {c}")
            check(len(c["writes"][0]) > 0 and not any(c["writes"][1:])
                  and c["checkpoint_matches"], f"phase 16 {tag}: checkpoint "
                  f"writes by rank {c['writes']}, equal to rank 0's "
                  f"parameters: {c['checkpoint_matches']}")
            step_ms = [float(np.median(r["ms"][1:])) for r in ranks]
            ex = c["exchange"]
            spans = " / ".join(
                f"{x['seq_handoff_ms']:.3f} {x['seq_gather_ms']:.3f} "
                f"{x['seq_queue_ms']:.3f}"
                + (f" {x['exchange_ms']:.3f}" if name == "composed" else "")
                + f" of {x['wall_ms']:.3f}" for x in ex)
            what = (f"(1, 2, 1), xlong_hpmn B={b_rank} on each rank"
                    if name == "sp" else "(1, 2, 2), batch over data and "
                    f"model ({b_rank} rows a rank), a2a (capacity factor "
                    f"{ranks[0]['capacity_factor']:.4f}, derived)")
            print(f"phase 16 {tag} SP step {what}, T={T} L="
                  f"{cfg_x.model.hpmn_layers}, {len(ranks)} ranks on the card "
                  f"over gloo, {SP_STEPS} SGD steps against one process "
                  f"(kernels, time-major): losses {c['loss_rel']:.3e} "
                  f"relative (tol {TOL_STEP_LOSS}), parameters "
                  f"{c['params_err']:.3e} of max abs {c['params_max']:.3e} "
                  f"(tol {TOL_DRIVER_PARAMS} of it), first-step table "
                  f"gradients {c['table_grad_rel']:.3e} (tol "
                  f"{TOL_TABLE_GRAD}), the tables' change "
                  f"{c['table_delta_rel']:.3e} (tol {TOL_TABLE_DELTA}) | "
                  f"launches per rank per step gru_scan_fwd {k1} "
                  f"gru_scan_bwd {k2} gru_scan_fwd_scale {k1s} "
                  f"gru_scan_bwd_scale {k2s} (= expected) | step ms per rank "
                  f"(median of steps 2-{SP_STEPS}) "
                  + ", ".join(f"{x:.3f}" for x in step_ms)
                  + f" (one process {float(np.median(ref['ms'][1:])):.3f}) "
                  f"| a profiled step's host ms per rank, seq_handoff, "
                  f"seq_gather, seq_queue_wait"
                  + (", embedding_exchange" if name == "composed" else "")
                  + f", of the step: {spans} ({ex[0]['seq_collectives']} seq "
                  f"collectives) | train() 16 steps, 2 evals: "
                  f"{ranks[0]['train']['seconds']:.1f} s, auc gap "
                  f"{c['train_auc_gap']:.2e}, log_loss gap "
                  f"{c['train_log_loss_gap']:.2e}, parameters "
                  f"{c['train_params_err']:.3e} of max abs "
                  f"{c['train_params_max']:.3e}, launches per rank "
                  f"{n_rank[0]}, writes by rank "
                  f"{[len(w) for w in c['writes']]} | run "
                  f"{res['seconds']:.1f} s | " + " | ".join(
                      line for line in ranks[0]["train"]["lines"]
                      if line.startswith(("mesh", "derived", "goodput")))
                  + f" | {p.card}", flush=True)

        # (a) layer 0's SP scan, kernels against the plain chunk scan
        ranks = runs["sp"]["ranks"]
        for r in ranks:
            sc = r["sp_scan"]
            check(sc["h_err"] <= TOL_GRU and sc["h_T_err"] <= TOL_GRU
                  and sc["grad_rel"] <= TOL_GRAD, f"phase 16 (a) rank "
                  f"{r['rank']}: layer 0's SP scan with the kernels off the "
                  f"plain one: {sc}")
            n = sc["launches"]["pallas"]
            check(n[3] > 0 and n[4] > 0 and sum(
                sc["launches"]["jnp"]) == 0, f"phase 16 (a) rank "
                f"{r['rank']}: the SP scan's launches {sc['launches']}")
        print(f"phase 16 (a) layer 0's SP scan (T {ranks[0]['sp_scan']['T']}"
              f" over 2 ranks, {cfg_x.mesh.sp_microbatches} microbatches), "
              "the kernels against the plain chunk scan, per rank: "
              + " / ".join(
                  f"h {r['sp_scan']['h_err']:.3e} of max abs "
                  f"{r['sp_scan']['h_max']:.3e}, h_T "
                  f"{r['sp_scan']['h_T_err']:.3e} (tol {TOL_GRU}), x and "
                  f"weight gradients {r['sp_scan']['grad_rel']:.3e} of max "
                  f"abs (tol {TOL_GRAD}), ms {r['sp_scan']['ms']['pallas']:.3f}"
                  f" (plain {r['sp_scan']['ms']['jnp']:.3f}), launches "
                  f"{r['sp_scan']['launches']['pallas']}" for r in ranks),
              flush=True)

        # (c) taobao_dien on (1, 2, 1)
        c = runs["sp"]["compare"]
        ref = runs["sp"]["reference"]
        T_d = parallel_check._spec(runs["sp"]["args"],
                                   parallel_check.DIEN_DATASET).seq_len
        k1, k2, k1s, k2s = sp_launches(cfg_d, T_d, B, 2)
        for r in ranks:
            d = r["dien"]
            got = [(*n, *ns) for n, ns in zip(d["launches"],
                                              d["launches_scale"])]
            check(got == [(k1, k2, 0, k1s, k2s)] * SP_STEPS and k1s > 0,
                  f"phase 16 (c) rank {r['rank']}: launches per step {got}, "
                  f"expected {(k1, k2, 0, k1s, k2s)}")
            launches[f"sp_dien_step_rank{r['rank']}"] = tuple(
                sum(n[i] for n in got) for i in range(5))
        check(c["dien_loss_rel"] <= TOL_STEP_LOSS and c["dien_params_err"]
              <= TOL_DRIVER_PARAMS * c["dien_params_max"]
              and c["dien_identical"], f"phase 16 (c): the DIEN SP step "
              f"against one process: losses {c['dien_loss_rel']:.3e}, "
              f"parameters {c['dien_params_err']:.3e}, identical on the "
              f"ranks {c['dien_identical']}")
        print(f"phase 16 (c) SP step taobao_dien B={B} T={T_d} left-padded on "
              f"(1, 2, 1), {SP_STEPS} SGD steps against one process (K1, K2, "
              f"K1-scale, K2-scale time-major): losses "
              f"{c['dien_loss_rel']:.3e} relative, parameters "
              f"{c['dien_params_err']:.3e} of max abs "
              f"{c['dien_params_max']:.3e}, the same on both ranks | "
              f"launches per rank per step gru_scan_fwd_scale {k1s} "
              f"gru_scan_bwd_scale {k2s} (= expected: two scans of 4 "
              f"microbatches) | step ms per rank " + ", ".join(
                  f"{float(np.median(r['dien']['ms'][1:])):.3f}"
                  for r in ranks) + f" (one process "
              f"{float(np.median(ref['dien']['ms'][1:])):.3f})", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 16 time: {time.perf_counter() - t16:.1f} s", flush=True)
    return launches


def phase_17(p):
    """The bf16 model and the last driver options on the card (see the
    module docstring): (a) xlong_hpmn at full width and depth with
    model.dtype=bfloat16 and scan_dtype float32, then bfloat16: the kernel
    path against the plain path (the loss, every gradient, the parameters
    after 3 Adam steps), the launches per step, examples/s, the profiled
    device time and the peak memory beside the f32 model's step (phase
    5); (b) taobao_dien's bf16 model the same way, with K1, K2, K1-scale
    and K2-scale; (c) train() on amazon_hpmn with a bf16 model, log_dir
    and debug_nans against the CPU at step 10, its event file read back
    against its log lines, the run with debug_nans off bit for bit, a NaN
    weight raising at step 1; (d) quality_gate --device cuda at 2000 steps
    and a 2-point sweep, as subprocesses. ``p`` carries main's closures
    and phase 5's numbers. -> launches by path (main's 13 counters)."""
    import torch

    from hpmn_tpu_torch.data.synthetic import AMAZON, TAOBAO, XLONG
    from hpmn_tpu_torch.models.model import init_model, loss_fn
    from hpmn_tpu_torch.train import events
    from hpmn_tpu_torch.train.train import make_optimizer

    t17 = time.perf_counter()
    dev, k, L = p.dev, p.k, p.cfg_k.model.hpmn_layers
    launches = {}

    def adam3(c, batches3, plain, spec):
        """3 Adam steps from the seeded weights -> (the first step's loss,
        its gradients, the parameters before and after, the peak device
        memory in MiB)."""
        model = init_model(c, spec.n_items, spec.n_cats, seed=p.seed,
                           device=dev)
        p0 = {n: t.detach().clone() for n, t in model.named_parameters()}
        opt = make_optimizer(c, model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i, batch in enumerate(batches3):
            opt.zero_grad()
            loss, _ = loss_fn(model, c, batch, plain=plain)
            loss.backward()
            if i == 0:
                loss0 = loss.item()
                grads = {n: torch.zeros_like(t) if t.grad is None
                         else t.grad.clone()
                         for n, t in model.named_parameters()}
            opt.step()
        torch.cuda.synchronize()
        mib = torch.cuda.max_memory_allocated(dev) / 2**20
        p3 = {n: t.detach().clone() for n, t in model.named_parameters()}
        return loss0, grads, p0, p3, mib

    def rel_norm(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    def model_check(tag, c, batches3, spec):
        """The kernel path against the plain path: the loss, each gradient
        (bf16, the parameters' dtype) and the update of 3 Adam steps, each
        over its norm -> the kernel path's peak MiB."""
        lk, gk, p0, pk, mib = adam3(c, batches3, False, spec)
        lp, gp, _, pp, _ = adam3(c, batches3, True, spec)
        check(np.isfinite(lk), f"phase 17 {tag}: loss {lk}")
        loss_rel = abs(lk - lp) / abs(lp)
        check(all(g.dtype == torch.bfloat16 for g in gk.values()),
              f"phase 17 {tag}: gradients not in bf16")
        grad = {n: rel_norm(gk[n], gp[n]) for n in gp}
        upd = {n: rel_norm(pk[n] - p0[n], pp[n] - p0[n]) for n in pp}
        gw, uw = max(grad, key=grad.get), max(upd, key=upd.get)
        for what, gap, tol in (("loss", loss_rel, TOL_STEP_LOSS_BF16),
                               (f"gradient of {gw}", grad[gw],
                                TOL_BF16_MODEL_GRAD),
                               (f"3-step update of {uw}", upd[uw],
                                TOL_BF16_MODEL_UPDATE)):
            check(np.isfinite(gap) and gap <= tol, f"phase 17 {tag}: {what}"
                  f" kernel vs plain path {gap:.3e} > {tol}")
        print(f"phase 17 {tag} kernel vs plain path (same bf16 weights and "
              f"batches): loss {lk:.7f} vs {lp:.7f} (relative "
              f"{loss_rel:.2e}, tol {TOL_STEP_LOSS_BF16}) | {len(grad)} bf16 "
              f"gradients, worst {gw} {grad[gw]:.2e} of its norm (tol "
              f"{TOL_BF16_MODEL_GRAD}) | after 3 Adam steps (bf16 moments) "
              f"worst update {uw} {upd[uw]:.2e} of its norm (tol "
              f"{TOL_BF16_MODEL_UPDATE})", flush=True)
        return mib

    # (a) xlong_hpmn, model.dtype=bfloat16, f32 then bf16 scans.
    n_steps = (WARMUP_DISPATCHES + TIMED_DISPATCHES) * k
    n_b = p.batches[0].batch_size
    for scan in ("float32", "bfloat16"):
        c = p.cfg_k.with_model(dtype="bfloat16", scan_dtype=scan)
        tag = f"(a) xlong_hpmn bf16 model, {scan} scans"
        mib = model_check(tag, c, p.batches[:3], XLONG)
        torch.cuda.empty_cache()
        metrics, step_ms, eps, got, multistep = p.timed_train(c, p.stacks)
        b16 = scan == "bfloat16"
        want = ((0, 0, L * n_steps, L * n_steps) if b16 else
                (L * n_steps, L * n_steps, 0, 0)) + (n_steps,) + (0,) * 8
        check(got == want, f"phase 17 {tag}: launches over {n_steps} steps "
              f"{got}, expected {want}")
        launches["bf16_model_xlong" + ("_bf16_scans" if b16 else "")] = got
        print(f"phase 17 {tag} B={n_b} T={XLONG.seq_len} L={L}, {k} steps "
              f"per dispatch: {eps:.1f} examples/s ({step_ms:.3f} ms per "
              f"step) beside the f32 model's (phase 5) {p.f32_eps:.1f} "
              f"examples/s ({p.f32_step_ms:.3f} ms) | last step loss "
              f"{metrics['loss']:.6f} bce {metrics['bce']:.6f} | peak "
              f"device memory of 3 steps {mib:.1f} MiB | launches over "
              f"{n_steps} steps: {'gru_scan_fwd_bf16' if b16 else 'gru_scan_fwd'}"
              f" {got[2 if b16 else 0]} {'gru_scan_bwd_bf16' if b16 else 'gru_scan_bwd'}"
              f" {got[3 if b16 else 1]} readout_fwd {got[4]} ({L}, {L}, 1 "
              f"per step)", flush=True)
        p.profile_dispatch(17, multistep, step_ms, p.stacks[0])
        del multistep
        torch.cuda.empty_cache()

    # (b) taobao_dien, model.dtype=bfloat16, left-padded (f32 scans).
    c = p.cfg_d.with_model(dtype="bfloat16")
    dien = p.dien_batches
    tag = "(b) taobao_dien bf16 model, left-padded"
    model_check(tag, c, dien[:3], TAOBAO)
    torch.cuda.empty_cache()
    stacks_d = [[dien[(i + j) % len(dien)] for j in range(k)]
                for i in range(len(dien))]
    metrics, step_ms, eps, got, multistep = p.timed_train(c, stacks_d,
                                                          TAOBAO)
    want = (n_steps, n_steps) + (0,) * 7 + (n_steps, n_steps, 0, 0)
    check(got == want, f"phase 17 {tag}: launches over {n_steps} steps "
          f"{got}, expected {want}")
    launches["bf16_model_dien"] = got
    print(f"phase 17 {tag} B={dien[0].batch_size} T={TAOBAO.seq_len}: "
          f"{eps:.1f} examples/s ({step_ms:.3f} ms per step) | last step "
          f"loss {metrics['loss']:.6f} aux_loss {metrics['aux_loss']:.6f} | "
          f"launches over {n_steps} steps: gru_scan_fwd {got[0]} "
          f"gru_scan_bwd {got[1]} gru_scan_fwd_scale {got[9]} "
          f"gru_scan_bwd_scale {got[10]} (1 each per step)", flush=True)
    p.profile_dispatch(17, multistep, step_ms, stacks_d[0])
    del multistep
    torch.cuda.empty_cache()

    # (c) train() with a bf16 model, log_dir and debug_nans.
    work = tempfile.mkdtemp(prefix="chip_smoke_options_")
    try:
        base = ["n_examples=3000", "train.batch_size=64",
                f"train.max_steps={OPTIONS_STEPS}", "train.eval_every=10",
                "train.log_every=10", "train.early_stop_patience=100",
                "train.steps_per_dispatch=1", "eval_steps_per_dispatch=1",
                "model.use_pallas=true", "model.dtype=bfloat16"]
        on = [f"train.log_dir={os.path.join(work, 'events')}",
              "train.debug_nans=true"]
        c_on = p.apply_overrides(p.get_config("amazon_hpmn"), base + on)
        c_off = p.apply_overrides(p.get_config("amazon_hpmn"), base)
        t0 = time.perf_counter()
        res_on, lines_on, early_on, got, secs_on = p.driver_run(
            "driver_bf16_model_options", c_on, "cuda", capture_at=10)
        res_off, _, early_off, _, secs_off = p.driver_run(
            "driver_bf16_model", c_off, "cuda", capture_at=10)
        c_cpu = p.apply_overrides(c_on, [
            f"train.log_dir={os.path.join(work, 'events_cpu')}"])
        res_cpu, _, early_cpu, _, secs_cpu = p.driver_run(
            "driver_bf16_model_cpu", c_cpu, "cpu", capture_at=10)
        want = p.expect(c_on, OPTIONS_STEPS, OPTIONS_STEPS // 10,
                        c_on.model.hpmn_layers)
        check(got == want, f"phase 17 (c) launches {got}, expected {want}")
        same = (res_on["params"].keys() == res_off["params"].keys()
                and all(torch.equal(res_on["params"][n], res_off["params"][n])
                        for n in res_off["params"]))
        check(same, "phase 17 (c): the run with debug_nans and log_dir is "
              "not the run without them bit for bit")
        check(all(t.dtype == torch.bfloat16
                  for t in res_on["params"].values()),
              "phase 17 (c): the trained parameters are not bf16")
        init = res_cpu["params_init"]
        upd = torch.cat([(early_cpu[n].float() - init[n].float()).flatten()
                         for n in early_cpu]).norm().item()
        gap = torch.cat([(early_on[n].cpu().float() - early_cpu[n].float()
                          ).flatten() for n in early_cpu]).norm().item()
        check(upd > 0 and gap <= TOL_BF16_MODEL_DRIVER * upd, f"phase 17 "
              f"(c): step-10 parameters on the card vs the CPU off by "
              f"{gap:.3e} (norm), the CPU's 10-step update {upd:.3e}, tol "
              f"{TOL_BF16_MODEL_DRIVER} of it")
        files = os.listdir(os.path.join(work, "events"))
        check(len(files) == 1 and files[0].startswith("events.out.tfevents."),
              f"phase 17 (c): event files {files}")
        got_ev = events.scalars(os.path.join(work, "events", files[0]))
        want_ev = []
        for line in lines_on:
            w = line.split()
            if w[2:3] == ["loss"]:
                want_ev += [("train/loss", int(w[1]), float(w[3])),
                            ("train/bce", int(w[1]), float(w[5])),
                            ("train/examples_per_sec", int(w[1]),
                             float(w[7]))]
            elif w[2:3] == ["VAL"]:
                want_ev += [("val/auc", int(w[1]), float(w[4])),
                            ("val/log_loss", int(w[1]), float(w[8]))]
            elif w[:1] == ["TEST"]:
                want_ev += [("test/auc", OPTIONS_STEPS, float(w[2])),
                            ("test/log_loss", OPTIONS_STEPS, float(w[6]))]
        found = {(tag_, s): v for tag_, s, v in got_ev}
        # A log line prints 4 decimals (ex/s 1): half a unit of the last.
        bad = [(tag_, s, v, found.get((tag_, s))) for tag_, s, v in want_ev
               if (tag_, s) not in found or abs(found[tag_, s] - v) > (
                   0.05 if "per_sec" in tag_ else 5e-5) * (1 + 1e-6)]
        tags = sorted({tag_ for tag_, _, _ in got_ev})
        want_tags = sorted({"train/bce", "train/cov_reg", "train/l2",
                            "train/loss", "train/examples_per_sec",
                            "val/auc", "val/log_loss", "test/auc",
                            "test/log_loss"})
        check(not bad and tags == want_tags, f"phase 17 (c): event file "
              f"vs log lines {bad[:5]}, tags {tags}")
        # One weight NaN: the first step raises.
        seam = p.driver.init_model_for

        def nan_init(c_i, spec_i, device_i):
            model = seam(c_i, spec_i, device_i)
            with torch.no_grad():
                model.tower.layers[0].w.view(-1)[0] = float("nan")
            return model

        p.driver.init_model_for = nan_init
        try:
            p.driver.train(c_on, log=lambda s: None, device=dev)
            nan_msg = None
        except FloatingPointError as e:
            nan_msg = str(e)
        finally:
            p.driver.init_model_for = seam
        check(nan_msg is not None and nan_msg.startswith("train step 1:"),
              f"phase 17 (c): a NaN weight gave {nan_msg!r}")
        print(f"phase 17 (c) driver amazon_hpmn model.dtype=bfloat16 "
              f"use_pallas {OPTIONS_STEPS} steps, log_dir and debug_nans: "
              f"card vs CPU step-10 parameters {gap:.3e} (norm; the CPU's "
              f"10-step update {upd:.3e}, {gap / upd:.2e} of it, tol "
              f"{TOL_BF16_MODEL_DRIVER}) | test auc "
              f"card {res_on['test']['auc']:.4f} CPU "
              f"{res_cpu['test']['auc']:.4f} | debug_nans and log_dir on vs "
              f"off: parameters bit for bit, wall {secs_on:.1f} s vs "
              f"{secs_off:.1f} s (CPU {secs_cpu:.1f} s) | event file "
              f"{files[0]}: {len(got_ev)} scalars, tags {', '.join(tags)}, "
              f"each of the {len(want_ev)} logged values at its step (to the"
              f" log line's digits) | a NaN weight: FloatingPointError "
              f"{nan_msg!r} | launches gru_scan_fwd {got[0]} gru_scan_bwd "
              f"{got[1]} readout_fwd {got[4]} (= expected)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) the tools, as a user runs them.
    def tool(name, *args):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", f"hpmn_tpu_torch.tools.{name}", *args],
            cwd=p.repo, capture_output=True, text=True, timeout=600)
        rows = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        return out.returncode, rows, time.perf_counter() - t0, out.stderr

    rc, rows, secs_g, err = tool("quality_gate", "--device", "cuda")
    gate = rows[-1] if rows else {}
    check(rc == 0 and gate.get("passed") is True and gate.get("steps") ==
          2000 and all(gate["auc"][m_] >= f_
                       for m_, f_ in gate["floors"].items()),
          f"phase 17 (d) quality_gate exited {rc}: {gate} {err[-1500:]}")
    rc, rows, secs_s, err = tool(
        "sweep", "--config", "amazon_hpmn", "--grid", "train.lr=1e-3,3e-3",
        "--set", "n_examples=3000", "train.batch_size=64",
        "train.max_steps=20", "train.eval_every=10",
        "model.use_pallas=true", "--device", "cuda")
    check(rc == 0 and len(rows) == 3 and "best" in rows[-1]
          and all(np.isfinite(r_["test_auc"]) for r_ in rows[:2]),
          f"phase 17 (d) sweep exited {rc}: {rows} {err[-1500:]}")
    print(f"phase 17 (d) quality_gate --device cuda: {json.dumps(gate)} in "
          f"{secs_g:.1f} s | sweep over train.lr=1e-3,3e-3 (20 steps each):"
          f" " + ", ".join(f"lr {r_['trial']['train.lr']} best_val_auc "
                           f"{r_['best_val_auc']:.4f} test_auc "
                           f"{r_['test_auc']:.4f}" for r_ in rows[:2])
          + f", best lr {rows[-1]['best']['trial']['train.lr']}, in "
          f"{secs_s:.1f} s", flush=True)
    print(f"phase 17 time: {time.perf_counter() - t17:.1f} s", flush=True)
    return launches


# Phase 18: the width-general forms (csrc/gru_general_*.cu,
# csrc/readout_general.cu), which run every width but the fixed-width
# kernels' d_m = 32, d_in <= 96 (A = d_m = 32, L <= 16, d_q <= 256); the
# strided ones (K3-general, K4-general) on their own grid and widths.
GEN_GRU_GRID = ((1, 1), (3, 4), (16, 16), (40, 48), (128, 64), (64, 128),
                (256, 256))  # (d_in, d_m)
GEN_STRIDE_GRID = ((1, 1), (40, 48), (128, 64), (64, 128), (128, 32),
                   (512, 256))  # (d_in, d_m)
GEN_STRIDE_WIDTHS = (16, 64, 128)  # d_m = d_in, timed
GEN_READOUT_GRID = ((16, 24, 3, 8), (64, 64, 6, 128), (48, 96, 20, 300),
                    (32, 32, 40, 32))  # (d_m, A, L, d_q)
GEN_GRID_T, GEN_GRID_B = 40, 33
GEN_TIME_WIDTHS = (16, 32, 64, 128)  # d_m = d_in; 32: the fixed-width row
GEN_SCALE_T = 300  # the scale forms' timing T (DIEN's)
WIDE = dict(mem_dim=64, readout_dim=64, emb_dim=64)
GEN_STORE_USERS = 2048
# The general forms' kernels in a profile (substrings of the name, all
# present): the tiled products (csrc/gru_general_gemm.cu), then the
# recurrences by output or cotangent policy.
GEN_PROFILE_PARTS = (
    (("tall_kernel", "ProjOp"), "projection"),
    (("tall_kernel", "HprevOp"), "h_prev @ wh"),
    (("tall_kernel", "DxOp"), "dx"),
    (("wgrad_kernel",), "weight gradients"),
    (("gen_fwd_rec_kernel", "GenDense"), "K1-general recurrence"),
    (("gen_fwd_rec_kernel", "GenStride"), "K3-general recurrence"),
    (("gen_fwd_rec_kernel", "GenReplay"), "K4-general replay"),
    (("gen_bwd_rec_kernel", "DenseCot"), "K2-general recurrence"),
    (("gen_bwd_rec_kernel", "StrideCot"), "K4-general sweep"))


def gen_products_gflop(Ts, B, d_ins, d_m, strided):
    """GFLOP (2 per multiply-add) of the general forms' products in one
    training step of GRU layers with lengths Ts and input widths d_ins:
    the projection (the forward's and the backward's), h_prev @ wh (the
    dense backward's; the strided one replays it in its recurrence), dx,
    and the weight gradients with db's row of ones."""
    G = 3 * d_m
    rows = [T * B for T in Ts]
    out = {"projection": sum(2 * 2 * r * d * G for r, d in zip(rows, d_ins)),
           "dx": sum(2 * r * G * d for r, d in zip(rows, d_ins)),
           "weight gradients": sum(2 * r * (d + 1 + d_m) * G
                                   for r, d in zip(rows, d_ins))}
    if not strided:
        out["h_prev @ wh"] = sum(2 * r * d_m * G for r in rows)
    return {k_: v / 1e9 for k_, v in out.items()}
SWEEP_CLI = ["--config", "amazon_hpmn", "--grid", "model.mem_dim=16,32",
             "--set", "model.use_pallas=true", "n_examples=4000",
             "train.max_steps=100", "train.eval_every=50",
             "train.log_every=50", "train.batch_size=64",
             "train.early_stop_patience=100"]
# The general forms, in the kernels line's order: (name, the module of
# hpmn_tpu_torch.ops that counts it, its gen_ counter).
GEN_FORMS = (("gru_gen_fwd", "cuda_gru", "gen_launches"),
             ("gru_gen_bwd", "cuda_gru", "gen_bwd_launches"),
             ("gru_gen_fwd_bf16", "cuda_gru", "gen_launches_bf16"),
             ("gru_gen_bwd_bf16", "cuda_gru", "gen_bwd_launches_bf16"),
             ("gru_gen_fwd_scale", "cuda_gru", "gen_launches_scale"),
             ("gru_gen_bwd_scale", "cuda_gru", "gen_bwd_launches_scale"),
             ("gru_gen_fwd_scale_bf16", "cuda_gru",
              "gen_launches_scale_bf16"),
             ("gru_gen_bwd_scale_bf16", "cuda_gru",
              "gen_bwd_launches_scale_bf16"),
             ("readout_gen_fwd", "cuda_readout", "gen_launches"),
             ("gru_stride_gen_fwd", "cuda_gru_stride", "gen_launches"),
             ("gru_stride_gen_bwd", "cuda_gru_stride", "gen_bwd_launches"),
             ("gru_stride_gen_fwd_bf16", "cuda_gru_stride",
              "gen_launches_bf16"),
             ("gru_stride_gen_bwd_bf16", "cuda_gru_stride",
              "gen_bwd_launches_bf16"))


def phase_18(p):
    """The width-general forms on the card (see the module docstring): (1)
    each form against its plain version on a grid of widths; (2) their
    CUDA-event times at T = 1000, B = 512 beside the d_m = 32 kernels,
    cuDNN's nn.GRU at the same hidden size and each form's bound; (3) the
    paths at other widths: (a) xlong_hpmn at mem_dim = readout_dim =
    emb_dim = 64, f32 and bf16 scans, (b) its UserMemoryStore, (c)
    taobao_dien at mem_dim = 64, (d) the mem_dim = 16, 32 sweep as a
    subprocess, (e) the wide xlong_hpmn with pallas_stride_outputs
    (K3-general and K4-general). ``p`` carries main's closures and
    batches. -> (the kernels line's entries of the general forms, their
    launches by path)."""
    import importlib

    import torch

    from hpmn_tpu_torch.data.synthetic import TAOBAO, XLONG, make_ctr_dataset
    from hpmn_tpu_torch.models.embedding import dense_lookup
    from hpmn_tpu_torch.models.hpmn import encode_hierarchical_tm
    from hpmn_tpu_torch.models.model import init_model
    from hpmn_tpu_torch.models.readout import Readout, attention_readout
    from hpmn_tpu_torch.models.tower import apply_tower
    from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride, cuda_readout
    from hpmn_tpu_torch.ops.gru import (GRUParams, GRUWeights,
                                        gru_scan_stride_tm,
                                        gru_scan_stride_tm_bf16,
                                        gru_scan_stride_tm_bwd,
                                        gru_scan_stride_tm_bwd_bf16,
                                        gru_scan_tm, gru_scan_tm_bf16,
                                        gru_scan_tm_bwd, gru_scan_tm_bwd_bf16)
    from hpmn_tpu_torch.serving.lifelong import UserMemoryStore
    from hpmn_tpu_torch.train.train import (make_multistep_train,
                                            make_optimizer)

    t18 = time.perf_counter()
    dev, k = p.dev, p.k
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(18)
    names = [n for n, _, _ in GEN_FORMS]
    mods = {m: importlib.import_module(f"hpmn_tpu_torch.ops.{m}")
            for _, m, _ in GEN_FORMS}

    def gen_counts():
        return tuple(getattr(mods[m], var) for _, m, var in GEN_FORMS)

    def zero_gen():
        for _, m, var in GEN_FORMS:
            setattr(mods[m], var, 0)

    def cuda_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def layer(d_in, d_m, dtype):
        w = GRUParams(d_in, d_m)
        w.reset_parameters(torch.Generator().manual_seed(d_in + d_m))
        with torch.no_grad():
            w.b.uniform_(-0.1, 0.1, generator=g)
        w = w.requires_grad_(False).to(dev)
        return GRUWeights(w.wx.to(dtype), w.wh.to(dtype), w.b.to(dtype))

    def left_pad(T, B):
        lens = torch.randint(1, T + 1, (B,), generator=g)
        return (torch.arange(T)[:, None] >= T - lens[None, :]).float().to(
            dev)

    def form_name(bwd, scaled, bf16):
        return ("gru_gen_" + ("bwd" if bwd else "fwd")
                + ("_scale" if scaled else "") + ("_bf16" if bf16 else ""))

    # (1) the grid: every form against its plain version.
    err = {n: 0.0 for n in names}  # h: max abs; gradients: over max abs
    abs_err = {n: 0.0 for n in names}
    T, B = GEN_GRID_T, GEN_GRID_B
    for d_in, d_m in GEN_GRU_GRID:
        for dtype in (torch.float32, bf):
            w = layer(d_in, d_m, dtype)
            b16 = dtype == bf
            tol_h, tol_g = (TOL_GRU_BF16, TOL_GRAD_BF16) if b16 else (
                TOL_GRU, TOL_GRAD)
            x = torch.randn(2 * T, B, d_in, generator=g).to(dev, dtype)[::2]
            h0 = torch.randn(B, d_m, generator=g).to(dev, dtype)
            dh = torch.randn(T, B, d_m, generator=g).to(dev, dtype)
            for masked, scaled in ((False, False), (True, False),
                                   (False, True), (True, True)):
                mask = left_pad(T, B).to(dtype) if masked else None
                a = (torch.rand(T, B, generator=g).to(dev, dtype) if scaled
                     else None)
                before = gen_counts()
                h_k = cuda_gru.scan_fwd(x, mask, h0, w.wx, w.wh, w.b, a)
                h_p = (gru_scan_tm_bf16 if b16 else gru_scan_tm)(
                    w, x, mask, h0, a)[0]
                got = cuda_gru.gru_scan_bwd(w, x, mask, h_k, dh, h0, a)
                want = (gru_scan_tm_bwd_bf16 if b16 else gru_scan_tm_bwd)(
                    w, x, mask, h_k, dh, h0, a)
                torch.cuda.synchronize()
                fw, bw = form_name(False, scaled, b16), form_name(True,
                                                                   scaled,
                                                                   b16)
                ran = [b_ - a_ for a_, b_ in zip(before, gen_counts())]
                check(ran[names.index(fw)] == 1 and ran[names.index(bw)] == 1
                      and sum(ran) == 2, f"phase 18 grid d_in={d_in} "
                      f"d_m={d_m} {fw}/{bw}: launches {ran}")
                e_h = (h_k.float() - h_p.float()).abs().max().item()
                check(np.isfinite(e_h) and e_h <= tol_h, f"phase 18 {fw} "
                      f"d_in={d_in} d_m={d_m} mask={masked}: h max abs err "
                      f"{e_h:.3e} > {tol_h}")
                err[fw] = max(err[fw], e_h)
                abs_err[fw] = max(abs_err[fw], e_h)
                for gname, a_, b_ in zip(("dx", "dwx", "dwh", "db", "dh0",
                                          "dscale"), got, want):
                    d_ = (a_.float() - b_.float()).abs().max().item()
                    rel = d_ / max(b_.float().abs().max().item(), 1e-30)
                    check(a_.shape == b_.shape and np.isfinite(rel)
                          and rel <= tol_g, f"phase 18 {bw} d_in={d_in} "
                          f"d_m={d_m} mask={masked}: {gname} off by "
                          f"{rel:.3e} of its max abs > {tol_g}")
                    err[bw] = max(err[bw], rel)
                    abs_err[bw] = max(abs_err[bw], d_)
    B_ro = B_SCAN
    for d_m, A, L, d_q in GEN_READOUT_GRID:
        r = Readout(d_m, d_q, A)
        r.reset_parameters(torch.Generator().manual_seed(d_m + A))
        r = r.requires_grad_(False).to(dev)
        mem = torch.randn(B_ro, L, d_m, generator=g).to(dev)
        q = torch.randn(B_ro, d_q, generator=g).to(dev)
        before = cuda_readout.gen_launches
        got = cuda_readout.fused_attention_readout(r, mem, q)
        want = attention_readout(r, mem, q)
        torch.cuda.synchronize()
        e_r = (got - want).abs().max().item()
        check(cuda_readout.gen_launches == before + 1,
              f"phase 18 readout_gen_fwd {(d_m, A, L, d_q)} not launched")
        check(e_r <= TOL_READOUT, f"phase 18 readout_gen_fwd d_m={d_m} "
              f"A={A} L={L} d_q={d_q}: max abs err {e_r:.3e} > "
              f"{TOL_READOUT}")
        err["readout_gen_fwd"] = max(err["readout_gen_fwd"], e_r)
        abs_err["readout_gen_fwd"] = err["readout_gen_fwd"]
    # The strided forms: K3-general then K4-general from its boundaries,
    # period 3 (T = 40 is ragged against it and the 16-step boundaries).
    for d_in, d_m in GEN_STRIDE_GRID:
        for dtype in (torch.float32, bf):
            w = layer(d_in, d_m, dtype)
            b16 = dtype == bf
            tol_h, tol_g = (TOL_GRU_BF16, TOL_GRAD_BF16) if b16 else (
                TOL_GRU, TOL_GRAD)
            x = torch.randn(2 * T, B, d_in, generator=g).to(dev, dtype)[::2]
            h0 = torch.randn(B, d_m, generator=g).to(dev, dtype)
            dhs = torch.randn(T // 3, B, d_m, generator=g).to(dev, dtype)
            dhT = torch.randn(B, d_m, generator=g).to(dev, dtype)
            before = gen_counts()
            hs, hT, bounds = cuda_gru_stride.stride_fwd(w, x, 3, h0)
            got = cuda_gru_stride.stride_bwd(w, x, 3, bounds, dhs, dhT, h0)
            hs_p, hT_p = (gru_scan_stride_tm_bf16 if b16
                          else gru_scan_stride_tm)(w, x, 3, h0)
            want = (gru_scan_stride_tm_bwd_bf16 if b16
                    else gru_scan_stride_tm_bwd)(w, x, 3, dhs, dhT, h0)
            torch.cuda.synchronize()
            fw = "gru_stride_gen_fwd" + ("_bf16" if b16 else "")
            bw = "gru_stride_gen_bwd" + ("_bf16" if b16 else "")
            ran = [b_ - a_ for a_, b_ in zip(before, gen_counts())]
            check(ran[names.index(fw)] == 1 and ran[names.index(bw)] == 1
                  and sum(ran) == 2, f"phase 18 grid d_in={d_in} d_m={d_m} "
                  f"{fw}/{bw}: launches {ran}")
            e_h = max((hs.float() - hs_p.float()).abs().max().item(),
                      (hT.float() - hT_p.float()).abs().max().item())
            check(np.isfinite(e_h) and e_h <= tol_h, f"phase 18 {fw} "
                  f"d_in={d_in} d_m={d_m}: h max abs err {e_h:.3e} > {tol_h}")
            err[fw] = max(err[fw], e_h)
            abs_err[fw] = max(abs_err[fw], e_h)
            for gname, a_, b_ in zip(("dx", "dwx", "dwh", "db", "dh0"), got,
                                     want):
                d_ = (a_.float() - b_.float()).abs().max().item()
                rel = d_ / max(b_.float().abs().max().item(), 1e-30)
                check(a_.shape == b_.shape and np.isfinite(rel)
                      and rel <= tol_g, f"phase 18 {bw} d_in={d_in} "
                      f"d_m={d_m}: {gname} off by {rel:.3e} of its max abs "
                      f"> {tol_g}")
                err[bw] = max(err[bw], rel)
                abs_err[bw] = max(abs_err[bw], d_)
    print(f"phase 18 (1) grid T={T} B={B} (x a strided time view, an h0), "
          f"(d_in, d_m) in {list(GEN_GRU_GRID)}, every dtype, mask and "
          f"scale form; strided (period 3) (d_in, d_m) in "
          f"{list(GEN_STRIDE_GRID)}; readout B={B_ro} (d_m, A, L, d_q) in "
          f"{list(GEN_READOUT_GRID)}: worst h (max abs) and gradient (of "
          f"max abs) errors " + ", ".join(f"{n} {err[n]:.2e}" for n in names)
          + f" (tol h {TOL_GRU}/{TOL_GRU_BF16}, gradients {TOL_GRAD}/"
          f"{TOL_GRAD_BF16}, readout {TOL_READOUT}): ok", flush=True)

    # (2) times at T = 1000, B = 512 (the scale forms at T = 300, masked
    # in f32 and full in bf16, their paths' forms).
    Tt = XLONG.seq_len
    times = {}  # (name, width) -> (ms, plain_ms, library_ms, bound, by)
    for wd in GEN_TIME_WIDTHS:
        for dtype in (torch.float32, bf):
            b16 = dtype == bf
            es, peak = (2, PEAK_BF16_FLOPS) if b16 else (4, PEAK_FP32_FLOPS)
            w = layer(wd, wd, dtype)
            x = torch.randn(Tt, B_SCAN, wd, generator=g).to(dev, dtype)
            dh = torch.randn(Tt, B_SCAN, wd, generator=g).to(dev, dtype)
            h = cuda_gru.scan_fwd(x, None, None, w.wx, w.wh, w.b)
            ms_f = cuda_ms(lambda: cuda_gru.scan_fwd(x, None, None, w.wx,
                                                     w.wh, w.b), 5)
            ms_b = cuda_ms(lambda: cuda_gru.gru_scan_bwd(w, x, None, h, dh),
                           3)
            pl_f = cuda_ms(lambda: (gru_scan_tm_bf16 if b16 else
                                    gru_scan_tm)(w, x, None), 1, 0)
            pl_b = cuda_ms(lambda: (gru_scan_tm_bwd_bf16 if b16 else
                                    gru_scan_tm_bwd)(w, x, None, h, dh),
                           1, 0)
            lib = torch.nn.GRU(wd, wd).to(dev, dtype)
            x_lib = x.clone().requires_grad_(True)

            def lib_fwd():
                with torch.no_grad():
                    return lib(x)

            def lib_fwd_bwd():
                out, _ = lib(x_lib)
                return torch.autograd.grad(out, [x_lib, *lib.parameters()],
                                           dh)

            lib_f, lib_fb = cuda_ms(lib_fwd, 5), cuda_ms(lib_fwd_bwd, 3)
            bf_ms, bf_by = bound(*scan_fwd_work(Tt, B_SCAN, wd, False, es,
                                                d_m=wd), peak)
            bb_ms, bb_by = bound(*scan_bwd_work(Tt, B_SCAN, wd, False, es,
                                                d_m=wd), peak)
            tag = "fixed-width K1/K2" if wd == 32 else "general"
            times[form_name(False, False, b16), wd] = (ms_f, pl_f, lib_f,
                                                       bf_ms, bf_by)
            times[form_name(True, False, b16), wd] = (ms_b, pl_b, lib_fb,
                                                      bb_ms, bb_by)
            print(f"phase 18 (2) {tag} d_m=d_in={wd} T={Tt} B={B_SCAN} "
                  f"{'bf16' if b16 else 'f32'}: forward {ms_f:.4f} ms "
                  f"(plain {pl_f:.4f}, cuDNN nn.GRU {lib_f:.4f}, bound "
                  f"{bf_ms:.4f} {bf_by}) | backward {ms_b:.4f} ms (plain "
                  f"{pl_b:.4f}, cuDNN forward with backward {lib_fb:.4f}, "
                  f"bound {bb_ms:.4f} {bb_by})", flush=True)
            del lib, x_lib, h
        for dtype in (torch.float32, bf):
            if wd == 32:
                continue  # the fixed-width scale forms: phase 3
            b16 = dtype == bf
            es, peak = (2, PEAK_BF16_FLOPS) if b16 else (4, PEAK_FP32_FLOPS)
            Ts = GEN_SCALE_T
            w = layer(wd, wd, dtype)
            x = torch.randn(Ts, B_SCAN, wd, generator=g).to(dev, dtype)
            dh = torch.randn(Ts, B_SCAN, wd, generator=g).to(dev, dtype)
            mask = None if b16 else left_pad(Ts, B_SCAN)
            a = torch.rand(Ts, B_SCAN, generator=g).to(dev, dtype)
            h = cuda_gru.scan_fwd(x, mask, None, w.wx, w.wh, w.b, a)
            ms_f = cuda_ms(lambda: cuda_gru.scan_fwd(x, mask, None, w.wx,
                                                     w.wh, w.b, a), 5)
            ms_b = cuda_ms(lambda: cuda_gru.gru_scan_bwd(w, x, mask, h, dh,
                                                         None, a), 3)
            pl_f = cuda_ms(lambda: (gru_scan_tm_bf16 if b16 else
                                    gru_scan_tm)(w, x, mask, None, a), 1, 0)
            pl_b = cuda_ms(lambda: (gru_scan_tm_bwd_bf16 if b16 else
                                    gru_scan_tm_bwd)(w, x, mask, h, dh, None,
                                                     a), 1, 0)
            bf_ms, bf_by = bound(*scan_fwd_work(Ts, B_SCAN, wd, not b16, es,
                                                scaled=True, d_m=wd), peak)
            bb_ms, bb_by = bound(*scan_bwd_work(Ts, B_SCAN, wd, not b16, es,
                                                scaled=True, d_m=wd), peak)
            times[form_name(False, True, b16), wd] = (ms_f, pl_f, None,
                                                      bf_ms, bf_by)
            times[form_name(True, True, b16), wd] = (ms_b, pl_b, None,
                                                     bb_ms, bb_by)
            print(f"phase 18 (2) general scale d_m=d_in={wd} T={Ts} "
                  f"B={B_SCAN} {'bf16 full' if b16 else 'f32 left-padded'}: "
                  f"forward {ms_f:.4f} ms (plain {pl_f:.4f}, bound "
                  f"{bf_ms:.4f} {bf_by}) | backward {ms_b:.4f} ms (plain "
                  f"{pl_b:.4f}, bound {bb_ms:.4f} {bb_by})", flush=True)
    # K3-general and K4-general at period 3 (the xlong layers'), beside
    # K1-general and K2-general above and cuDNN's dense nn.GRU (forward;
    # forward with backward from the strided rows' and h_T's cotangents).
    for wd in GEN_STRIDE_WIDTHS:
        for dtype in (torch.float32, bf):
            b16 = dtype == bf
            es, peak = (2, PEAK_BF16_FLOPS) if b16 else (4, PEAK_FP32_FLOPS)
            sfx = "_bf16" if b16 else ""
            w = layer(wd, wd, dtype)
            x = torch.randn(Tt, B_SCAN, wd, generator=g).to(dev, dtype)
            dhs = torch.randn(Tt // 3, B_SCAN, wd, generator=g).to(dev,
                                                                   dtype)
            dhT = torch.randn(B_SCAN, wd, generator=g).to(dev, dtype)
            bounds = cuda_gru_stride.stride_fwd(w, x, 3)[2]
            ms_f = cuda_ms(lambda: cuda_gru_stride.stride_fwd(w, x, 3), 5)
            ms_b = cuda_ms(lambda: cuda_gru_stride.stride_bwd(
                w, x, 3, bounds, dhs, dhT), 3)
            pl_f = cuda_ms(lambda: (gru_scan_stride_tm_bf16 if b16 else
                                    gru_scan_stride_tm)(w, x, 3), 1, 0)
            pl_b = cuda_ms(lambda: (gru_scan_stride_tm_bwd_bf16 if b16 else
                                    gru_scan_stride_tm_bwd)(w, x, 3, dhs,
                                                            dhT), 1, 0)
            lib = torch.nn.GRU(wd, wd).to(dev, dtype)
            x_lib = x.clone().requires_grad_(True)

            def lib_fwd():
                with torch.no_grad():
                    return lib(x)

            def lib_fwd_bwd():
                out, h_n = lib(x_lib)
                return torch.autograd.grad(
                    (out[2::3], h_n[0]), [x_lib, *lib.parameters()],
                    (dhs, dhT))

            lib_f, lib_fb = cuda_ms(lib_fwd, 5), cuda_ms(lib_fwd_bwd, 3)
            bf_ms, bf_by = bound(*scan_stride_fwd_work(
                Tt, B_SCAN, wd, 3, 16, es, d_m=wd), peak)
            bb_ms, bb_by = bound(*scan_stride_bwd_work(
                Tt, B_SCAN, wd, 3, 16, es, d_m=wd), peak)
            times["gru_stride_gen_fwd" + sfx, wd] = (ms_f, pl_f, lib_f,
                                                     bf_ms, bf_by)
            times["gru_stride_gen_bwd" + sfx, wd] = (ms_b, pl_b, lib_fb,
                                                     bb_ms, bb_by)
            dense_f = times[form_name(False, False, b16), wd][0]
            dense_b = times[form_name(True, False, b16), wd][0]
            print(f"phase 18 (2) strided general d_m=d_in={wd} T={Tt} "
                  f"B={B_SCAN} period 3 {'bf16' if b16 else 'f32'}: forward "
                  f"{ms_f:.4f} ms (dense K1-general {dense_f:.4f}, plain "
                  f"{pl_f:.4f}, cuDNN nn.GRU {lib_f:.4f}, bound "
                  f"{bf_ms:.4f} {bf_by}) | backward {ms_b:.4f} ms (dense "
                  f"K2-general {dense_b:.4f}, plain {pl_b:.4f}, cuDNN "
                  f"forward with backward, strided cotangent {lib_fb:.4f}, "
                  f"bound {bb_ms:.4f} {bb_by})", flush=True)
            del lib, x_lib, bounds
    # The timed paths' peak memory counts what is live: free the inputs.
    del x, dhs, dhT, w
    for d_m, A, L, d_q in ((64, 64, 6, 128), (16, 32, 4, 32),
                           (128, 128, 6, 256)):
        r = Readout(d_m, d_q, A)
        r.reset_parameters(torch.Generator().manual_seed(d_m))
        r = r.requires_grad_(False).to(dev)
        mem = torch.randn(B_SCAN, L, d_m, generator=g).to(dev)
        q = torch.randn(B_SCAN, d_q, generator=g).to(dev)
        ms = cuda_ms(lambda: cuda_readout.fused_attention_readout(r, mem, q),
                     50)
        pl = cuda_ms(lambda: attention_readout(r, mem, q), 20)
        b_ms, b_by = bound(*readout_work(B_SCAN, L, d_q, d_m, A))
        times["readout_gen_fwd", d_m] = (ms, pl, None, b_ms, b_by)
        print(f"phase 18 (2) readout_gen_fwd B={B_SCAN} d_m={d_m} A={A} "
              f"L={L} d_q={d_q}: {ms:.4f} ms (call, CUDA events over 50) | "
              f"plain {pl:.4f} ms | bound {b_ms:.4f} ms ({b_by})", flush=True)
    zero_gen()
    p.zero_counters()
    torch.cuda.synchronize()

    # (3) the paths at other widths. Each timed run: k steps per dispatch,
    # 2 warm-up and 3 timed dispatches, the counters set to 0 just before.
    launches = {}

    def timed(c, stacks_, spec):
        model_t = init_model(c, spec.n_items, spec.n_cats, seed=p.seed,
                             device=dev)
        multistep = make_multistep_train(
            c, model_t, make_optimizer(c, model_t.parameters()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_gen()
        p.zero_counters()
        for i in range(WARMUP_DISPATCHES):
            metrics = multistep(stacks_[i % len(stacks_)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WARMUP_DISPATCHES,
                       WARMUP_DISPATCHES + TIMED_DISPATCHES):
            metrics = multistep(stacks_[i % len(stacks_)])
        torch.cuda.synchronize()
        t_ = time.perf_counter() - t0
        got, fixed = gen_counts(), p.counters()
        mib = torch.cuda.max_memory_allocated(dev) / 2**20
        metrics = {n_: v.item() for n_, v in metrics.items()}
        check(all(np.isfinite(v) for v in metrics.values()),
              f"phase 18 training metrics not finite: {metrics}")
        check(not any(fixed), f"phase 18: a fixed-width kernel ran on a "
              f"wide path: {fixed}")
        n_ex = stacks_[0][0].batch_size
        return (metrics, 1e3 * t_ / (TIMED_DISPATCHES * k),
                TIMED_DISPATCHES * k * n_ex / t_, got, mib, multistep)

    n_steps = (WARMUP_DISPATCHES + TIMED_DISPATCHES) * k
    cfg_w = p.cfg_k.with_model(**WIDE)
    L_x = cfg_w.model.hpmn_layers
    wide_Ts = [XLONG.seq_len // cfg_w.model.hpmn_period ** l_
               for l_ in range(L_x)]
    wide_d_ins = [2 * WIDE["emb_dim"]] + [WIDE["mem_dim"]] * (L_x - 1)

    def wide_gflop(strided):
        return gen_products_gflop(wide_Ts, p.batches[0].batch_size,
                                  wide_d_ins, WIDE["mem_dim"], strided)
    wide_dense = {}  # scan dtype -> (loss, ms per step, peak MiB)
    for scan in ("float32", "bfloat16"):
        b16 = scan == "bfloat16"
        c = cfg_w.with_model(scan_dtype=scan)
        tag = f"(a) xlong_hpmn mem_dim=readout_dim=emb_dim=64 {scan} scans"
        if b16:
            loss_a = p.step_check(18, tag, c, p.batches[0], c, True,
                                  TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16)
        else:
            loss_a = p.step_check(18, tag, c, p.batches[0],
                                  c.with_model(use_pallas=False), False,
                                  TOL_STEP_LOSS, TOL_STEP_GRAD)
        torch.cuda.empty_cache()
        metrics, step_ms, eps, got, mib, multistep = timed(c, p.stacks,
                                                           XLONG)
        want = [0] * len(names)
        want[names.index(form_name(False, False, b16))] = L_x * n_steps
        want[names.index(form_name(True, False, b16))] = L_x * n_steps
        want[names.index("readout_gen_fwd")] = n_steps
        check(list(got) == want, f"phase 18 {tag}: launches {got}, "
              f"expected {want}")
        launches["wide_xlong" + ("_bf16" if b16 else "")] = got
        wide_dense[scan] = (loss_a, step_ms, mib)
        print(f"phase 18 {tag} B={p.batches[0].batch_size} "
              f"T={XLONG.seq_len} L={L_x} (layer 0 d_in 128, K5 A=d_m=64 "
              f"d_q=128), {k} steps per dispatch: {eps:.1f} examples/s "
              f"({step_ms:.3f} ms per step) | last step loss "
              f"{metrics['loss']:.6f} | peak device memory {mib:.1f} MiB | "
              f"launches over {n_steps} steps: "
              + ", ".join(f"{n_} {v}" for n_, v in zip(names, got) if v),
              flush=True)
        p.profile_dispatch(18, multistep, step_ms, p.stacks[0],
                           wide_gflop(False))
        del multistep
        torch.cuda.empty_cache()

    # (b) the wide model served: ingest, update, predict, rank.
    model_w = init_model(cfg_w, XLONG.n_items, XLONG.n_cats, seed=p.seed,
                         device=dev).requires_grad_(False)
    store = UserMemoryStore(cfg_w, model_w, device=dev)
    full = make_ctr_dataset(XLONG, GEN_STORE_USERS, seed=21,
                            min_len_frac=1.0)
    uids = np.arange(GEN_STORE_USERS)
    rng = np.random.default_rng(18)
    zero_gen()
    p.zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, GEN_STORE_USERS, B_SCAN):
        sl = slice(lo, lo + B_SCAN)
        store.ingest_histories(uids[sl], full["item_seq"][sl],
                               full["cat_seq"][sl])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    ingest_launches = gen_counts()
    upd = uids[:B_SCAN]
    for _ in range(2):
        items = rng.integers(1, XLONG.n_items, size=B_SCAN)
        store.update(upd, items, items % (XLONG.n_cats - 1) + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = store.predict(upd, full["target_item"][:B_SCAN],
                         full["target_cat"][:B_SCAN])
    t_pred = time.perf_counter() - t0
    ri = rng.integers(1, XLONG.n_items, size=(RANK_USERS, RANK_CANDS))
    rc = rng.integers(1, XLONG.n_cats, size=(RANK_USERS, RANK_CANDS))
    t0 = time.perf_counter()
    ranked = store.rank(uids[:RANK_USERS], ri, rc)
    t_rank = time.perf_counter() - t0
    got = gen_counts()
    check(not any(p.counters()), "phase 18 (b): a fixed-width kernel ran")
    n_b = GEN_STORE_USERS // B_SCAN
    check(ingest_launches[0] == L_x * n_b and got[0] == L_x * n_b
          and got[names.index("readout_gen_fwd")] >= 2,
          f"phase 18 (b): launches {got} (ingest {ingest_launches}), "
          f"expected gru_gen_fwd {L_x} per ingest batch and "
          f"readout_gen_fwd per request")
    launches["store_wide"] = got
    with torch.no_grad():
        emb = model_w.embedding
        ids = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        sl = slice(B_SCAN, 2 * B_SCAN)  # ingested, not updated
        x_tm = dense_lookup(emb, ids(full["item_seq"][sl]).T,
                            ids(full["cat_seq"][sl]).T)
        mem_plain = encode_hierarchical_tm(
            model_w.encoder, x_tm, None, cfg_w.model.hpmn_period,
            gru_seq_tm_fn=lambda p_, xs, mk: gru_scan_tm(p_, xs, mk))
        hier_err = (store._gather(uids[sl])[0] - mem_plain).abs().max()
        q = dense_lookup(emb, ids(full["target_item"][:B_SCAN]),
                         ids(full["target_cat"][:B_SCAN]))
        read = attention_readout(model_w.readout, store._gather(upd)[0], q)
        pred_plain = torch.sigmoid(apply_tower(
            model_w.tower, torch.cat([q, read], -1))).cpu().numpy()
    hier_err = hier_err.item()
    del emb, x_tm, mem_plain, q, read
    score_err = float(np.abs(pred - pred_plain).max())
    col_err = float(np.abs(ranked[:, 0] - store.predict(
        uids[:RANK_USERS], ri[:, 0], rc[:, 0])).max())
    check(np.isfinite(ranked).all() and ranked.shape == (RANK_USERS,
                                                         RANK_CANDS),
          "phase 18 (b): rank scores")
    check(hier_err <= TOL_SLICE and score_err <= TOL_SLICE
          and col_err <= TOL_READOUT, f"phase 18 (b): ingest vs plain "
          f"hierarchy {hier_err:.3e}, predict vs plain scores "
          f"{score_err:.3e} (tol {TOL_SLICE}), rank vs predict "
          f"{col_err:.3e} (tol {TOL_READOUT})")
    print(f"phase 18 (b) UserMemoryStore of the wide xlong_hpmn: ingest "
          f"{GEN_STORE_USERS / t_ingest:.1f} histories/s ({GEN_STORE_USERS} "
          f"of T={XLONG.seq_len}, batches of {B_SCAN}), 2 update rounds of "
          f"{B_SCAN}, predict {B_SCAN} users {1e3 * t_pred:.2f} ms, rank "
          f"{RANK_USERS}x{RANK_CANDS} {1e3 * t_rank:.2f} ms (first calls) | "
          f"ingest vs plain hierarchy {hier_err:.2e}, predict vs plain "
          f"scores {score_err:.2e}, rank column vs predict {col_err:.2e} | "
          f"launches: gru_gen_fwd {got[0]}, readout_gen_fwd "
          f"{got[names.index('readout_gen_fwd')]}", flush=True)
    del store, model_w
    torch.cuda.empty_cache()

    # (c) taobao_dien at mem_dim = 64: f32 left-padded, bf16 full.
    for form, c, batches_d, tols in (
            ("f32 padded", p.cfg_d.with_model(mem_dim=64),
             p.dien_batches["f32 padded"], (TOL_STEP_LOSS, TOL_STEP_GRAD)),
            ("bf16 full", p.cfg_d.with_model(
                mem_dim=64, scan_dtype="bfloat16", assume_full_mask=True),
             p.dien_batches["bf16 full"],
             (TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16))):
        b16 = form.startswith("bf16")
        tag = f"(c) taobao_dien mem_dim=64 {form}"
        p.step_check(18, tag, c, batches_d[0], c, True, *tols, spec=TAOBAO)
        torch.cuda.empty_cache()
        st = [[batches_d[(i + j) % len(batches_d)] for j in range(k)]
              for i in range(len(batches_d))]
        metrics, step_ms, eps, got, mib, multistep = timed(c, st, TAOBAO)
        want = [0] * len(names)
        for bwd in (False, True):
            for scaled in (False, True):
                want[names.index(form_name(bwd, scaled, b16))] = n_steps
        check(list(got) == want, f"phase 18 {tag}: launches {got}, "
              f"expected {want}")
        launches["wide_dien" + ("_bf16" if b16 else "")] = got
        print(f"phase 18 {tag} B={batches_d[0].batch_size} "
              f"T={TAOBAO.seq_len}: {eps:.1f} examples/s ({step_ms:.3f} ms "
              f"per step) | last step loss {metrics['loss']:.6f} | peak "
              f"device memory {mib:.1f} MiB | launches over {n_steps} "
              f"steps: " + ", ".join(f"{n_} {v}" for n_, v in
                                     zip(names, got) if v), flush=True)
        p.profile_dispatch(18, multistep, step_ms, st[0])
        del multistep
        torch.cuda.empty_cache()

    # (e) the wide xlong_hpmn with pallas_stride_outputs: each layer's scan
    # K3-general (K3-general-bf16), its backward K4-general; no dense
    # h_seq, and no dense or fixed-width scan kernel.
    for scan in ("float32", "bfloat16"):
        b16 = scan == "bfloat16"
        sfx = "_bf16" if b16 else ""
        c = cfg_w.with_model(scan_dtype=scan, pallas_stride_outputs=True)
        tag = (f"(e) xlong_hpmn mem_dim=readout_dim=emb_dim=64 {scan} scans, "
               f"strided outputs")
        tols = ((TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16) if b16
                else (TOL_STEP_LOSS, TOL_STEP_GRAD))
        loss_e = p.step_check(18, tag, c, p.batches[0], c, True, *tols)
        loss_a, dense_ms, dense_mib = wide_dense[scan]
        rel = abs(loss_e - loss_a) / abs(loss_a)
        check(rel <= tols[0], f"phase 18 {tag}: loss {loss_e} vs the dense "
              f"wide step's {loss_a}, relative {rel:.3e} > {tols[0]}")
        torch.cuda.empty_cache()
        metrics, step_ms, eps, got, mib, multistep = timed(c, p.stacks,
                                                           XLONG)
        want = [0] * len(names)
        want[names.index("gru_stride_gen_fwd" + sfx)] = L_x * n_steps
        want[names.index("gru_stride_gen_bwd" + sfx)] = L_x * n_steps
        want[names.index("readout_gen_fwd")] = n_steps
        check(list(got) == want, f"phase 18 {tag}: launches {got}, "
              f"expected {want}")
        launches["wide_xlong_stride" + sfx] = got
        print(f"phase 18 {tag} B={p.batches[0].batch_size} "
              f"T={XLONG.seq_len} L={L_x}, {k} steps per dispatch: "
              f"{eps:.1f} examples/s ({step_ms:.3f} ms per step; the dense "
              f"wide step (a) {dense_ms:.3f}) | loss vs the dense wide "
              f"step's (same weights and batch) {loss_e:.7f} vs "
              f"{loss_a:.7f}, relative {rel:.2e} (tol {tols[0]}) | last step "
              f"loss {metrics['loss']:.6f} | peak device memory {mib:.1f} "
              f"MiB (dense {dense_mib:.1f}) | launches over {n_steps} "
              f"steps: " + ", ".join(f"{n_} {v}" for n_, v in
                                     zip(names, got) if v), flush=True)
        p.profile_dispatch(18, multistep, step_ms, p.stacks[0],
                           wide_gflop(True))
        del multistep
        torch.cuda.empty_cache()

    # (d) the sweep over mem_dim 16 and 32 with the kernels, a subprocess.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "hpmn_tpu_torch.tools.sweep", *SWEEP_CLI,
         "--device", "cuda"], cwd=p.repo, capture_output=True, text=True,
        timeout=600)
    check(proc.returncode == 0, f"phase 18 (d) sweep exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    trials = [r_ for r_ in rows if "trial" in r_]
    counts = [json.loads(line) for line in proc.stderr.splitlines()
              if line.startswith('{"trial"')]
    check(len(trials) == len(counts) == 2
          and rows[-1].get("best") is not None,
          f"phase 18 (d) sweep printed {rows}, launches {counts}")
    for r_, c_ in zip(trials, counts):
        md = int(r_["trial"]["model.mem_dim"])
        pre = "gru_gen_" if md != 32 else "gru_scan_"
        ro = "readout_gen_fwd" if md != 32 else "readout_fwd"
        n_ = c_["launches"]
        check(c_["trial"] == r_["trial"] and n_.get(pre + "fwd", 0) > 0
              and n_.get(pre + "bwd", 0) > 0 and n_.get(ro, 0) > 0
              and np.isfinite(r_["best_val_auc"]),
              f"phase 18 (d) sweep mem_dim={md}: {r_}, launches {c_}")
        launches[f"sweep_mem_dim_{md}"] = tuple(
            n_.get(n2, 0) for n2 in names)
        print(f"phase 18 (d) sweep amazon_hpmn mem_dim={md} (100 steps, "
              f"use_pallas): best_val_auc {r_['best_val_auc']:.4f} test_auc "
              f"{r_['test_auc']:.4f} | launches {n_}", flush=True)
    print(f"phase 18 (d) sweep subprocess {time.perf_counter() - t0:.1f} s; "
          f"phase 18 in all {time.perf_counter() - t18:.1f} s", flush=True)

    # The kernels line's entries: the numbers at d_m = 64 (the wide path's
    # width; the readout's at (64, 64, 6, 128)), every width beside them.
    entries = []
    for i, (name, _, _) in enumerate(GEN_FORMS):
        by_path = {path: v[i] for path, v in launches.items() if v[i]}
        row = times[name, 64]
        widths = sorted(wd for n_, wd in times if n_ == name and wd != 32)
        readout = name.startswith("readout")
        stride = name.startswith("gru_stride")
        mod = cuda_gru_stride if stride else cuda_gru
        source = (cuda_readout.GEN_SOURCE if readout
                  else mod.GEN_BWD_SOURCE if "bwd" in name
                  else mod.GEN_SOURCE)
        replaces = (cuda_readout.REPLACES if readout
                    else mod.BWD_REPLACES if "bwd" in name
                    else mod.REPLACES)
        # K4-general runs the tiled products, K3-general's recurrence (its
        # replay) and its own sweep.
        sources = ([source] if readout
                   else list(cuda_gru.GEN_SOURCES) if stride and "bwd" in name
                   else list(cuda_gru.GEN_SOURCES[:1]) + [source])
        extra = ({"dense_general_ms_by_width": {
            str(wd): times[name.replace("stride_gen", "gen"), wd][0]
            for wd in widths}} if stride else {})
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": abs_err[name],
            "ms": row[0], "plain_ms": row[1], "bound_ms": row[3],
            "bound_by": row[4], "library_ms": row[2],
            "max_err_over_max_abs": err[name] if "bwd" in name else None,
            "sources": sources,
            "width": 64,
            "ms_by_width": {str(wd): times[name, wd][0] for wd in widths},
            "plain_ms_by_width": {str(wd): times[name, wd][1]
                                  for wd in widths},
            "library_ms_by_width": {str(wd): times[name, wd][2]
                                    for wd in widths},
            "bound_ms_by_width": {str(wd): times[name, wd][3]
                                  for wd in widths},
            "fixed_width_ms_d_m_32": (times[name, 32][0]
                                      if (name, 32) in times else None),
            **extra})
    return entries, launches


def bst_bf16_gap(dev):
    """bf16 BST's gradient gap from the f32 gradient (the max over the
    parameters of the max abs difference over the f32 one's max abs), the
    shapes of tests/test_torch_cuda.py's bf16 BST case, on the card with
    cuBLAS's reduced-precision bf16 reductions on and off, and on the CPU;
    and the card's bf16 gradients' gap from the CPU's -> one line."""
    import torch

    from hpmn_tpu_torch.configs import get_config
    from hpmn_tpu_torch.data.schema import batch_from_numpy
    from hpmn_tpu_torch.data.synthetic import (DatasetSpec,
                                               make_ctr_dataset)
    from hpmn_tpu_torch.models.model import init_model, loss_fn

    cfg = get_config("amazon_hpmn").with_model(name="bst", bst_blocks=2)
    spec = DatasetSpec("amazon", seq_len=100, n_items=500, n_cats=40,
                       n_users=50)
    data = make_ctr_dataset(spec, 24, seed=3, min_len_frac=0.3)

    def grads(device, dtype):
        c = cfg.with_model(bst_dtype=dtype)
        model = init_model(c, 500, 40, seed=3, device=device, n_users=600)
        loss, _ = loss_fn(model, c, batch_from_numpy(data, device=device))
        loss.backward()
        return {n: q.grad.cpu() for n, q in model.named_parameters()}

    def gap(got, want):
        return max(((got[n] - want[n]).abs().max()
                    / want[n].abs().max().clamp_min(1e-30)).item()
                   for n in want)

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        f32 = grads(dev, "float32")
        card = {}
        for on in (True, False):
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = on
            card[on] = grads(dev, "bfloat16")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    cpu32, cpu16 = grads("cpu", "float32"), grads("cpu", "bfloat16")
    return (f"bf16 BST gradients (amazon, 2 blocks, B 24, T 100), max over "
            f"parameters of max abs gap / max abs: card bf16 vs card f32 "
            f"{gap(card[True], f32):.4e} (reduced-precision reduction on, "
            f"PyTorch's default), {gap(card[False], f32):.4e} (off); CPU "
            f"bf16 vs CPU f32 {gap(cpu16, cpu32):.4e}; card bf16 vs CPU "
            f"bf16 {gap(card[True], cpu16):.4e} (on), "
            f"{gap(card[False], cpu16):.4e} (off)")


def main():
    import torch

    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hpmn_tpu_torch.configs import get_config
        from hpmn_tpu_torch.data.synthetic import (AMAZON, TAOBAO, XLONG,
                                                   make_ctr_dataset)
        from hpmn_tpu_torch.models.embedding import dense_lookup
        from hpmn_tpu_torch.models.hpmn import (encode_hierarchical_tm,
                                                encode_oracle)
        from hpmn_tpu_torch.data.schema import batch_from_numpy
        from hpmn_tpu_torch.models.model import (apply_model, init_model,
                                                 loss_fn)
        from hpmn_tpu_torch.models.readout import attention_readout
        from hpmn_tpu_torch.models.tower import apply_tower
        from hpmn_tpu_torch.ops import (_build, cuda_gru, cuda_gru_stride,
                                        cuda_readout)
        from hpmn_tpu_torch.ops.gru import (
            GRUWeights, gru_bwd_pass, gru_scan_stride_tm,
            gru_scan_stride_tm_bf16, gru_input_proj, gru_scan_stride_tm_bwd,
            gru_scan_stride_tm_bwd_bf16, gru_scan_stride_tm_sweep,
            gru_scan_stride_tm_sweep_bf16, gru_scan_tm, gru_scan_tm_bf16,
            gru_scan_tm_bwd, gru_scan_tm_bwd_bf16, gru_scan_tm_sweep,
            gru_scan_tm_sweep_bf16)
        from hpmn_tpu_torch.serving.history import HistoryStore
        from hpmn_tpu_torch.serving.lifelong import UserMemoryStore
        from hpmn_tpu_torch.tools.ab_readout import device_ms
        from hpmn_tpu_torch.tools.ab_scan_kernels import one_kernel_k3
        from hpmn_tpu_torch.train import train as driver
        from hpmn_tpu_torch.train.train import (make_multistep_train,
                                                make_optimizer)
        from hpmn_tpu_torch.data import native, native_batcher, preprocess
    except ImportError as e:
        fail(f"cannot import the port ({e}): run from the repo root")

    # ---------------------------------------------------------- 1. device --
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | tf32 off", flush=True)

    # ----------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_key()})", flush=True)

    # --------------------------------------------------------- 3. kernels --
    cfg = get_config("xlong_hpmn")
    m = cfg.model
    model = init_model(cfg, XLONG.n_items, XLONG.n_cats, seed=cfg.seed,
                       device=dev)
    model.requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def cuda_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def enqueue_us(fn, n):
        """Host microseconds per fn() over n calls without a synchronize
        (after one call and a synchronize): the host's cost of the call
        path."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / n

    def left_pad_mask(T, B):
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        pos = torch.arange(T, device=dev)[:, None]
        return (pos >= T - lens[None, :]).float().contiguous()  # [T, B]

    def cudnn_gru(layer, d_in, dtype=torch.float32):
        """The library yardstick: torch.nn.GRU (cuDNN) computing the same
        scan as K1: our z is torch's 1 - z, so the z blocks of wx, wh and b
        are negated, and the hidden-side bias is 0. Timed only."""
        g = torch.nn.GRU(d_in, 32).to(dev, dtype)
        neg = torch.ones(96, 1, device=dev)
        neg[32:64] = -1.0
        with torch.no_grad():
            g.weight_ih_l0.copy_(layer.wx.T * neg)
            g.weight_hh_l0.copy_(layer.wh.T * neg)
            g.bias_ih_l0.copy_(layer.b * neg[:, 0])
            g.bias_hh_l0.zero_()
        return g

    def lib_times(lib, x, dh_seq):
        """-> (forward ms, backward ms) of nn.GRU on x."""
        x_lib = x.clone().requires_grad_(True)
        out_lib, _ = lib(x_lib)
        args = [x_lib, *lib.parameters()]

        def fwd():
            with torch.no_grad():
                return lib(x)

        return cuda_ms(fwd, 10), cuda_ms(lambda: torch.autograd.grad(
            out_lib, args, dh_seq, retain_graph=True), 10)

    def fmt(t):
        return "-" if t is None else f"{t:.4f}"

    def library_kernels(lib, x):
        """The device kernels of one forward of the library's GRU, by launch
        count: which path cuDNN takes for this dtype."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                lib(x)
            torch.cuda.synchronize()
        kern = sorted(((a.count, a.key) for a in prof.key_averages()
                       if a.device_type == DeviceType.CUDA
                       and a.self_device_time_total > 0), reverse=True)
        return ", ".join(f"{name[:40]} x{n}" for n, name in kern[:3])

    T_l = [XLONG.seq_len]
    for _ in range(m.hpmn_layers - 1):
        T_l.append(T_l[-1] // m.hpmn_period)
    gru_err, gru_rows = 0.0, []
    proj_err_max, proj_rows = 0.0, []  # K1's projection: (T, err, ms)
    # K1-bf16's projection: worst r/z error over max abs and share of c
    # values off the float64 sum's rounding, and per layer (T, err, share,
    # ms).
    proj16_err_max, proj16_off_max, proj16_rows = 0.0, 0.0, []
    bwd_err, bwd_abs, bwd_rows = 0.0, 0.0, []
    # K2's pass alone, by dtype: worst error over max abs, and the first
    # layer's (err, ms, plain ms, bound ms, bound by).
    pass_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    pass_first = {}
    bf_err, bf_rows, bf_drift = 0.0, [], 0.0
    bfb_err, bfb_abs, bfb_rows, bfb_drift = 0.0, 0.0, [], 0.0
    period = m.hpmn_period
    chunk = cuda_gru_stride.chunk()
    # The strided kernels' rows, by name: (T, err, ms, plain ms, library
    # ms, bound ms, bound by); worst errors and differences from the dense
    # kernels over the six shapes.
    st_rows = {n: [] for n in ("fwd", "bwd", "fwd_bf16", "bwd_bf16")}
    st_err = dict.fromkeys(st_rows, 0.0)
    st_abs = dict.fromkeys(st_rows, 0.0)
    st_vs_dense = dict.fromkeys(st_rows, 0.0)
    # K4's (K4-bf16's) recurrence seen whole against the plain sweep: worst
    # gate-gradient error over max abs and h_prev max abs error, by name.
    rec_err = {n: 0.0 for n in ("bwd", "bwd_bf16")}
    rec_h_err = dict.fromkeys(rec_err, 0.0)
    for l, T in enumerate(T_l):
        layer = model.encoder.layers[l]
        d_in = layer.wx.shape[0]
        x = torch.randn(T, B_SCAN, d_in, generator=gen, device=dev)
        dh_seq = torch.randn(T, B_SCAN, 32, generator=gen, device=dev)
        lib = cudnn_gru(layer, d_in)
        x_lib = x.clone().requires_grad_(True)
        out_lib, _ = lib(x_lib)
        with torch.no_grad():
            lib_err = (out_lib - gru_scan_tm(layer, x, None)[0]).abs().max()
        check(lib_err.item() <= TOL_GRU, f"the cuDNN yardstick is not K1's "
              f"function: {lib_err.item():.3e}")

        def lib_fwd():
            with torch.no_grad():
                return lib(x)

        lib_ms = cuda_ms(lib_fwd, 10)
        lib_args = [x_lib, *lib.parameters()]
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out_lib, lib_args, dh_seq, retain_graph=True), 10)
        # The bf16 chain's inputs: the same x, dh_seq and weights in bf16.
        w16 = GRUWeights(layer.wx.bfloat16(), layer.wh.bfloat16(),
                         layer.b.bfloat16())
        x16, dh16 = x.bfloat16(), dh_seq.bfloat16()
        # nn.GRU goes to cuDNN only where ATen's cudnn_is_acceptable
        # takes the input; otherwise it runs its own per-step loop, timed
        # and printed, but no cuDNN yardstick.
        cudnn16 = bool(torch.cudnn_is_acceptable(x16))
        lib16 = cudnn_gru(layer, d_in, torch.bfloat16)
        nat16 = lib_times(lib16, x16, dh16)
        lib16_fwd, lib16_bwd = nat16 if cudnn16 else (None, None)
        print(f"phase 3 library nn.GRU bf16 T={T}: cuDNN takes bf16: "
              f"{cudnn16} | nn.GRU forward {nat16[0]:.4f} ms, backward "
              f"{nat16[1]:.4f} ms | forward kernels: "
              f"{library_kernels(lib16, x16)}", flush=True)
        # K1's first kernel alone: the input projection of the whole x.
        xp_k = cuda_gru.input_proj(layer, x)
        xp_p = gru_input_proj(GRUWeights(layer.wx.double(),
                                         layer.wh.double(),
                                         layer.b.double()), x.double())
        torch.cuda.synchronize()
        check(torch.isfinite(xp_k).all().item(), f"K1's projection "
              f"non-finite T={T}")
        proj_err = ((xp_k.double() - xp_p).abs().max()
                    / xp_p.abs().max()).item()
        check(proj_err <= TOL_PROJ, f"K1's projection T={T}: max err over "
              f"max abs {proj_err:.3e} > {TOL_PROJ}")
        del xp_k, xp_p
        proj_ms = cuda_ms(lambda: cuda_gru.input_proj(layer, x), 10)
        proj_err_max = max(proj_err_max, proj_err)
        proj_rows.append((T, proj_err, proj_ms))
        # K1-bf16's first kernel alone: the bf16 projection of the whole x,
        # against float64 sums of the same bf16 values.
        xp16_k = cuda_gru.input_proj(w16, x16)
        xw64 = x16.double() @ w16.wx.double()
        torch.cuda.synchronize()
        check(torch.isfinite(xp16_k).all().item(), f"K1-bf16's projection "
              f"non-finite T={T}")
        proj16_err = ((xp16_k[..., :64].double() - xw64[..., :64]).abs().max()
                      / xw64[..., :64].abs().max()).item()
        want_c = xw64[..., 64:] + w16.b[64:].double()
        proj16_off, reach = bf16_reach(xp16_k[..., 64:], want_c,
                                       TOL_PROJ * want_c.abs().max())
        check(proj16_err <= TOL_PROJ, f"K1-bf16's projection T={T}: r and z "
              f"max err over max abs {proj16_err:.3e} > {TOL_PROJ}")
        check(reach, f"K1-bf16's projection T={T}: a c value off the bf16 "
              f"rounding of the float64 sum by more than the f32 sum error")
        del xp16_k, xw64, want_c
        proj16_ms = cuda_ms(lambda: cuda_gru.input_proj(w16, x16), 10)
        proj16_err_max = max(proj16_err_max, proj16_err)
        proj16_off_max = max(proj16_off_max, proj16_off)
        proj16_rows.append((T, proj16_err, proj16_off, proj16_ms))
        # K2's (and K2-bf16's) second kernel alone: dx and the weight
        # gradients from gate gradients of the backward's shape, against
        # gru_bwd_pass.
        gg = torch.randn(4, T, B_SCAN, 32, generator=gen, device=dev)
        hp = torch.rand(T, B_SCAN, 32, generator=gen, device=dev) * 2 - 1
        pass_now = {}
        for dt in (torch.float32, torch.bfloat16):
            bf = dt == torch.bfloat16
            xs, hs, wxd = x.to(dt), hp.to(dt), layer.wx.to(dt)
            gs = gg.to(dt)
            dpx = torch.cat([gs[0], gs[1], gs[2]], -1)
            dph = torch.cat([gs[0], gs[1], gs[3]], -1)
            got_p = cuda_gru.bwd_pass(wxd, xs, hs, dpx, dph)
            want_p = gru_bwd_pass(xs, hs, dpx, dph, wxd)
            torch.cuda.synchronize()
            check(all(a.shape == b.shape and a.dtype == b.dtype
                      and torch.isfinite(a.float()).all().item()
                      for a, b in zip(got_p, want_p)),
                  f"K2's pass {dt} T={T}: shape, dtype or non-finite")
            rel = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30)).item()
                      for a, b in zip(got_p, want_p))
            tol = TOL_GRAD_BF16 if bf else TOL_GRAD
            check(rel <= tol, f"K2's pass {dt} T={T}: max err over max abs "
                  f"{rel:.3e} > {tol}")
            del got_p, want_p
            p_ms = cuda_ms(lambda: cuda_gru.bwd_pass(wxd, xs, hs, dpx, dph),
                           10)
            p_plain = cuda_ms(lambda: gru_bwd_pass(xs, hs, dpx, dph, wxd), 2)
            b_ms, b_by = bound(*bwd_pass_work(T, B_SCAN, d_in, 2 if bf else 4),
                               PEAK_BF16_FLOPS if bf else PEAK_FP32_FLOPS)
            pass_err[dt] = max(pass_err[dt], rel)
            pass_now[dt] = (rel, p_ms, p_plain, b_ms, b_by)
            pass_first.setdefault(dt, pass_now[dt])
        del gg, hp, xs, hs, gs, dpx, dph

        def pass_line(dt, k2_ms, masked):
            rel, p_ms, p_plain, b_ms, b_by = pass_now[dt]
            bf = dt == torch.bfloat16
            print(f"phase 3 kernel gru_bwd_pass{'_bf16' if bf else ''} "
                  f"T={T} B={B_SCAN} d_in={d_in}: max err over max abs "
                  f"{rel:.3e} against gru_bwd_pass (tol "
                  f"{TOL_GRAD_BF16 if bf else TOL_GRAD}) | kernel "
                  f"{p_ms:.4f} ms, {100 * p_ms / k2_ms:.1f}% of "
                  f"K2{'-bf16' if bf else ''}'s {k2_ms:.4f} ms "
                  f"(mask={masked}) | plain {p_plain:.4f} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

        for masked in (False, True):
            mask = left_pad_mask(T, B_SCAN) if masked else None
            h_k, hT_k = cuda_gru.gru_sequence_tm(layer, x, mask)
            h_p, hT_p = gru_scan_tm(layer, x, mask)
            torch.cuda.synchronize()
            err = max((h_k - h_p).abs().max().item(),
                      (hT_k - hT_p).abs().max().item())
            check(torch.isfinite(h_k).all().item(), f"K1 non-finite T={T}")
            check(err <= TOL_GRU, f"K1 T={T} mask={masked}: max abs err "
                  f"{err:.3e} > {TOL_GRU}")
            ms = cuda_ms(lambda: cuda_gru.gru_sequence_tm(layer, x, mask), 10)
            plain_ms = cuda_ms(lambda: gru_scan_tm(layer, x, mask), 2)
            lib_t = None if masked else lib_ms  # cuDNN's GRU has no mask
            b_ms, b_by = bound(*scan_fwd_work(T, B_SCAN, d_in, masked))
            gru_err = max(gru_err, err)
            gru_rows.append((T, masked, err, ms, plain_ms, lib_t, b_ms, b_by))
            print(f"phase 3 kernel gru_input_proj T={T} B={B_SCAN} "
                  f"d_in={d_in}: max err over max abs {proj_err:.3e} "
                  f"against the plain projection in float64 (tol "
                  f"{TOL_PROJ}) | kernel {proj_ms:.4f} ms, "
                  f"{100 * proj_ms / ms:.1f}% of K1's {ms:.4f} ms "
                  f"(mask={masked})", flush=True)
            print(f"phase 3 kernel gru_scan_fwd T={T} B={B_SCAN} d_in={d_in} "
                  f"mask={masked}: max_abs_err {err:.3e} (tol {TOL_GRU}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | library "
                  f"{'-' if lib_t is None else f'{lib_t:.4f}'} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

            # K2 on K1's output, against the plain backward.
            got = cuda_gru.gru_scan_bwd(layer, x, mask, h_k, dh_seq)
            want = gru_scan_tm_bwd(layer, x, mask, h_k, dh_seq)
            if not masked:
                h_dense = h_k
            torch.cuda.synchronize()
            rel, absd = 0.0, 0.0
            for name, a, b in zip(("dx", "dwx", "dwh", "db", "dh0"), got,
                                  want):
                check(a.shape == b.shape and torch.isfinite(a).all().item(),
                      f"K2 T={T} mask={masked}: {name} shape or non-finite")
                d = (a - b).abs().max().item()
                absd = max(absd, d)
                rel = max(rel, d / max(b.abs().max().item(), 1e-30))
            check(rel <= TOL_GRAD, f"K2 T={T} mask={masked}: max abs err "
                  f"over max abs {rel:.3e} > {TOL_GRAD}")
            ms = cuda_ms(lambda: cuda_gru.gru_scan_bwd(layer, x, mask, h_k,
                                                       dh_seq), 10)
            plain_ms = cuda_ms(lambda: gru_scan_tm_bwd(layer, x, mask, h_k,
                                                       dh_seq), 2)
            lib_t = None if masked else lib_bwd_ms
            b_ms, b_by = bound(*scan_bwd_work(T, B_SCAN, d_in, masked))
            bwd_err, bwd_abs = max(bwd_err, rel), max(bwd_abs, absd)
            bwd_rows.append((T, masked, absd, ms, plain_ms, lib_t, b_ms,
                             b_by))
            pass_line(torch.float32, ms, masked)
            print(f"phase 3 kernel gru_scan_bwd T={T} B={B_SCAN} d_in={d_in} "
                  f"mask={masked}: max_abs_err {absd:.3e}, over max abs "
                  f"{rel:.3e} (tol {TOL_GRAD}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | library "
                  f"{'-' if lib_t is None else f'{lib_t:.4f}'} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

            # K1-bf16 and K2-bf16 on the same inputs in bf16, against the
            # plain bf16 chain and against the f32 kernels above.
            m16 = None if mask is None else mask.bfloat16()
            h16, hT16 = cuda_gru.gru_sequence_tm(w16, x16, m16)
            h16_p, hT16_p = gru_scan_tm_bf16(w16, x16, m16)
            if not masked:
                h16_dense, hT16_dense = h16, hT16
            torch.cuda.synchronize()
            check(h16.dtype == torch.bfloat16
                  and torch.isfinite(h16.float()).all().item(),
                  f"K1-bf16 T={T}: not finite bf16")
            err = max((h16.float() - h16_p.float()).abs().max().item(),
                      (hT16.float() - hT16_p.float()).abs().max().item())
            drift = (h16.float() - h_k).abs().max().item()
            check(err <= TOL_GRU_BF16, f"K1-bf16 T={T} mask={masked}: max "
                  f"abs err {err:.3e} > {TOL_GRU_BF16}")
            check(drift <= TOL_BF16_VS_F32, f"K1-bf16 T={T} mask={masked}: "
                  f"{drift:.3e} from the f32 kernel > {TOL_BF16_VS_F32}")
            ms = cuda_ms(lambda: cuda_gru.gru_sequence_tm(w16, x16, m16), 10)
            plain_ms = cuda_ms(lambda: gru_scan_tm_bf16(w16, x16, m16), 2)
            lib_t = None if masked else lib16_fwd
            b_ms, b_by = bound(*scan_fwd_work(T, B_SCAN, d_in, masked, 2),
                               PEAK_BF16_FLOPS)
            bf_err, bf_drift = max(bf_err, err), max(bf_drift, drift)
            bf_rows.append((T, masked, err, ms, plain_ms, lib_t, b_ms, b_by))
            print(f"phase 3 kernel gru_input_proj_bf16 T={T} B={B_SCAN} "
                  f"d_in={d_in}: r and z max err over max abs "
                  f"{proj16_err:.3e} against float64 sums (tol {TOL_PROJ}), "
                  f"c {100 * proj16_off:.4f}% of values off the float64 "
                  f"sum's bf16 rounding, all within its f32 error | kernel "
                  f"{proj16_ms:.4f} ms, {100 * proj16_ms / ms:.1f}% of "
                  f"K1-bf16's {ms:.4f} ms (mask={masked})", flush=True)
            print(f"phase 3 kernel gru_scan_fwd_bf16 T={T} B={B_SCAN} "
                  f"d_in={d_in} mask={masked}: max_abs_err {err:.3e} (tol "
                  f"{TOL_GRU_BF16}) | vs f32 kernel {drift:.3e} (tol "
                  f"{TOL_BF16_VS_F32}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | library {fmt(lib_t)} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

            got16 = cuda_gru.gru_scan_bwd(w16, x16, m16, h16, dh16)
            want16 = gru_scan_tm_bwd_bf16(w16, x16, m16, h16, dh16)
            torch.cuda.synchronize()
            rel, absd, drift = 0.0, 0.0, 0.0
            for name, a, b, f in zip(("dx", "dwx", "dwh", "db", "dh0"),
                                     got16, want16, got):
                check(a.shape == b.shape and a.dtype == b.dtype
                      and torch.isfinite(a.float()).all().item(),
                      f"K2-bf16 T={T} mask={masked}: {name} shape, dtype or "
                      "non-finite")
                d = (a.float() - b.float()).abs().max().item()
                absd = max(absd, d)
                rel = max(rel, d / max(b.float().abs().max().item(), 1e-30))
                drift = max(drift, (a.float() - f).abs().max().item()
                            / max(f.abs().max().item(), 1e-30))
            check(rel <= TOL_GRAD_BF16, f"K2-bf16 T={T} mask={masked}: max "
                  f"abs err over max abs {rel:.3e} > {TOL_GRAD_BF16}")
            ms = cuda_ms(lambda: cuda_gru.gru_scan_bwd(w16, x16, m16, h16,
                                                       dh16), 10)
            plain_ms = cuda_ms(lambda: gru_scan_tm_bwd_bf16(
                w16, x16, m16, h16, dh16), 2)
            lib_t = None if masked else lib16_bwd
            b_ms, b_by = bound(*scan_bwd_work(T, B_SCAN, d_in, masked, 2),
                               PEAK_BF16_FLOPS)
            bfb_err, bfb_abs = max(bfb_err, rel), max(bfb_abs, absd)
            bfb_drift = max(bfb_drift, drift)
            bfb_rows.append((T, masked, absd, ms, plain_ms, lib_t, b_ms,
                             b_by))
            pass_line(torch.bfloat16, ms, masked)
            print(f"phase 3 kernel gru_scan_bwd_bf16 T={T} B={B_SCAN} "
                  f"d_in={d_in} mask={masked}: max_abs_err {absd:.3e}, over "
                  f"max abs {rel:.3e} (tol {TOL_GRAD_BF16}) | vs f32 kernel "
                  f"{drift:.3e} of max abs | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | library {fmt(lib_t)} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

        # K3, K4 and their bf16 forms on the same x and weights, no mask,
        # with random cotangents on the strided rows and on h_T; K4 runs
        # from K3's boundaries. The dense kernels on the same inputs give
        # the strided rows h_seq[period-1::period] and, with dh_seq holding
        # dhs at the firing steps and dhT added at T-1, the same gradients
        # up to rounding. No PyTorch call emits only the strided rows: the
        # library time is nn.GRU's dense forward, and its backward with
        # that dh_seq.
        S = T // period
        dhs = torch.randn(S, B_SCAN, 32, generator=gen, device=dev)
        dhT = torch.randn(B_SCAN, 32, generator=gen, device=dev)
        dh_dense = torch.zeros(T, B_SCAN, 32, device=dev)
        dh_dense[period - 1:S * period:period] = dhs
        dh_dense[T - 1] += dhT
        lib_st_bwd = cuda_ms(lambda: torch.autograd.grad(
            out_lib, lib_args, dh_dense, retain_graph=True), 10)
        lib16_st = lib_times(lib16, x16, dh_dense.bfloat16())
        lib16_st_bwd = lib16_st[1] if cudnn16 else None
        for bf in (False, True):
            sfx = "_bf16" if bf else ""
            w, xs = (w16, x16) if bf else (layer, x)
            d_s, d_T = ((dhs.bfloat16(), dhT.bfloat16()) if bf
                        else (dhs, dhT))
            es, peak = (2, PEAK_BF16_FLOPS) if bf else (4, PEAK_FP32_FLOPS)
            tol_h, tol_g = ((TOL_GRU_BF16, TOL_GRAD_BF16) if bf
                            else (TOL_GRU, TOL_GRAD))
            p_fwd, p_bwd = ((gru_scan_stride_tm_bf16,
                             gru_scan_stride_tm_bwd_bf16) if bf else
                            (gru_scan_stride_tm, gru_scan_stride_tm_bwd))
            hs_k, hT_k, bounds = cuda_gru_stride.stride_fwd(w, xs, period)
            hs_p, hT_p = p_fwd(w, xs, period)
            hd, hTd = (h16_dense, hT16_dense) if bf else (h_dense,
                                                          h_dense[-1])
            torch.cuda.synchronize()
            check(hs_k.shape == (S, B_SCAN, 32) and hs_k.dtype == xs.dtype
                  and torch.isfinite(hs_k.float()).all().item()
                  and torch.isfinite(hT_k.float()).all().item(),
                  f"K3{sfx} T={T}: shape, dtype or non-finite")
            err = max((hs_k.float() - hs_p.float()).abs().max().item()
                      if S else 0.0,
                      (hT_k.float() - hT_p.float()).abs().max().item())
            vs = max((hs_k.float() - hd[period - 1::period].float()).abs()
                     .max().item() if S else 0.0,
                     (hT_k.float() - hTd.float()).abs().max().item())
            check(err <= tol_h, f"K3{sfx} T={T}: max abs err {err:.3e} > "
                  f"{tol_h}")
            bits = (torch.equal(hs_k, hd[period - 1::period])
                    and torch.equal(hT_k, hTd))
            if bf:
                check(bits, f"K3-bf16 T={T}: strided rows not K1-bf16's bit "
                      f"for bit ({vs:.3e})")
            # K3's two kernels against its first, one-kernel form.
            one = (torch.empty_like(hs_k), torch.empty_like(bounds),
                   torch.empty_like(hT_k))
            _build.check_launch(one_kernel_k3(
                w, xs, None, period, one,
                torch.cuda.current_stream(dev).cuda_stream),
                f"gru_scan_stride_fwd{sfx} (one kernel)")
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(
                one, (hs_k, bounds, hT_k))), f"K3{sfx} T={T}: not its "
                f"one-kernel form's bit for bit")
            del one
            ms = cuda_ms(lambda: cuda_gru_stride.stride_fwd(w, xs, period),
                         10)
            plain_ms = cuda_ms(lambda: p_fwd(w, xs, period), 2)
            lib_t = lib16_fwd if bf else lib_ms
            b_ms, b_by = bound(*scan_stride_fwd_work(T, B_SCAN, d_in, period,
                                                     chunk, es), peak)
            name = "fwd" + sfx
            st_err[name] = st_abs[name] = max(st_err[name], err)
            st_vs_dense[name] = max(st_vs_dense[name], vs)
            st_rows[name].append((T, err, ms, plain_ms, lib_t, b_ms, b_by))
            p_ms = proj16_ms if bf else proj_ms
            print(f"phase 3 kernel gru_input_proj{sfx} (K3{sfx.replace('_', '-')}"
                  f"'s first kernel) T={T} B={B_SCAN} d_in={d_in}: kernel "
                  f"{p_ms:.4f} ms over all T (checked above), "
                  f"{100 * p_ms / ms:.1f}% of K3{sfx.replace('_', '-')}'s "
                  f"{ms:.4f} ms (phase 7's profile has the recurrence "
                  f"apart) | workspace chunks: "
                  f"{-(-T // cuda_gru.workspace_steps(T, B_SCAN))}",
                  flush=True)
            print(f"phase 3 kernel gru_stride_fwd{sfx} T={T} B={B_SCAN} "
                  f"d_in={d_in} period={period}: max_abs_err {err:.3e} (tol "
                  f"{tol_h}) | vs dense kernel's strided rows {vs:.3e} (bit "
                  f"for bit: {bits}) | bit for bit the one-kernel form | "
                  f"kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | library {fmt(lib_t)} ms (dense "
                  f"nn.GRU) | bound {b_ms:.4f} ms ({b_by})", flush=True)

            # K4's recurrence alone, over all T in one workspace chunk:
            # its gate gradients and h_prev against the plain sweep's.
            rec_k = cuda_gru_stride.stride_bwd_gates(w, xs, period, bounds,
                                                     d_s, d_T)
            rec_p = (gru_scan_stride_tm_sweep_bf16 if bf else
                     gru_scan_stride_tm_sweep)(w, xs, period, d_s, d_T)
            torch.cuda.synchronize()
            check(all(a.shape == b.shape and a.dtype == b.dtype
                      and torch.isfinite(a.float()).all().item()
                      for a, b in zip(rec_k, rec_p)),
                  f"K4{sfx}'s recurrence T={T}: shape, dtype or non-finite")
            g_err = max(((a.float() - b.float()).abs().max()
                         / b.float().abs().max().clamp_min(1e-30)).item()
                        for a, b in ((rec_k[i], rec_p[i]) for i in (0, 1, 3)))
            h_err = (rec_k[2].float() - rec_p[2].float()).abs().max().item()
            check(g_err <= tol_g, f"K4{sfx}'s recurrence T={T}: gate "
                  f"gradients or dh0, max err over max abs {g_err:.3e} > "
                  f"{tol_g}")
            check(h_err <= tol_h, f"K4{sfx}'s recurrence T={T}: h_prev max "
                  f"abs err {h_err:.3e} > {tol_h}")
            # The recurrence replays K3's steps, so h_prev is K3's states
            # bit for bit: zeros at t = 0, K3's strided rows at t = k *
            # period; in bf16 every row is K1-bf16's (K3-bf16's rows are,
            # checked above).
            hp = rec_k[2]
            h_bits = (not hp[0].any().item() and torch.equal(
                hp[period::period], hs_k[:(T - 1) // period]))
            if bf:
                h_bits = h_bits and torch.equal(hp[1:], hd[:-1])
            check(h_bits, f"K4{sfx}'s recurrence T={T}: h_prev not K3"
                  f"{sfx.replace('_', '-')}'s states bit for bit")
            del hp, rec_k, rec_p
            name = "bwd" + sfx
            rec_err[name] = max(rec_err[name], g_err)
            rec_h_err[name] = max(rec_h_err[name], h_err)
            n_ws = -(-T // cuda_gru_stride.bwd_workspace_steps(
                T, B_SCAN, xs.dtype, chunk))
            print(f"phase 3 kernel gru_stride_bwd_rec{sfx} T={T} B={B_SCAN} "
                  f"d_in={d_in} period={period}: gate gradients and dh0 max "
                  f"err over max abs {g_err:.3e} (tol {tol_g}), h_prev max "
                  f"abs err {h_err:.3e} (tol {tol_h}) against the plain sweep "
                  f"| h_prev bit for bit the forward's states | "
                  f"K4{sfx.replace('_', '-')} runs it in {n_ws} workspace "
                  f"chunks", flush=True)

            got = cuda_gru_stride.stride_bwd(w, xs, period, bounds, d_s, d_T)
            want = p_bwd(w, xs, period, d_s, d_T)
            dense = cuda_gru.gru_scan_bwd(w, xs, None, hd,
                                          dh_dense.to(xs.dtype))
            torch.cuda.synchronize()
            rel, absd, vs = 0.0, 0.0, 0.0
            for gname, a, b, f in zip(("dx", "dwx", "dwh", "db", "dh0"), got,
                                      want, dense):
                check(a.shape == b.shape and a.dtype == b.dtype
                      and torch.isfinite(a.float()).all().item(),
                      f"K4{sfx} T={T}: {gname} shape, dtype or non-finite")
                d = (a.float() - b.float()).abs().max().item()
                absd = max(absd, d)
                rel = max(rel, d / max(b.float().abs().max().item(), 1e-30))
                vs = max(vs, (a.float() - f.float()).abs().max().item()
                         / max(f.float().abs().max().item(), 1e-30))
            check(rel <= tol_g, f"K4{sfx} T={T}: max abs err over max abs "
                  f"{rel:.3e} > {tol_g}")
            ms = cuda_ms(lambda: cuda_gru_stride.stride_bwd(
                w, xs, period, bounds, d_s, d_T), 10)
            plain_ms = cuda_ms(lambda: p_bwd(w, xs, period, d_s, d_T), 2)
            lib_t = lib16_st_bwd if bf else lib_st_bwd
            b_ms, b_by = bound(*scan_stride_bwd_work(T, B_SCAN, d_in, period,
                                                     chunk, es), peak)
            st_err[name] = max(st_err[name], rel)
            st_abs[name] = max(st_abs[name], absd)
            st_vs_dense[name] = max(st_vs_dense[name], vs)
            st_rows[name].append((T, absd, ms, plain_ms, lib_t, b_ms, b_by))
            print(f"phase 3 kernel gru_stride_bwd{sfx} T={T} B={B_SCAN} "
                  f"d_in={d_in} period={period}: max_abs_err {absd:.3e}, over"
                  f" max abs {rel:.3e} (tol {tol_g}) | vs dense kernel's "
                  f"gradients {vs:.3e} of max abs | kernel {ms:.4f} ms | "
                  f"plain {plain_ms:.4f} ms | library {fmt(lib_t)} ms (dense "
                  f"nn.GRU, strided cotangent) | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
        del lib, out_lib, x_lib, lib_args

    ro_err, ro_rows = 0.0, []
    for B in (B_SCAN, RANK_USERS * RANK_CANDS):
        mem = torch.randn(B, m.hpmn_layers, m.mem_dim, generator=gen,
                          device=dev)
        q = torch.randn(B, 2 * m.emb_dim, generator=gen, device=dev)
        r_k = cuda_readout.fused_attention_readout(model.readout, mem, q)
        r_p = attention_readout(model.readout, mem, q)
        torch.cuda.synchronize()
        err = (r_k - r_p).abs().max().item()
        check(err <= TOL_READOUT, f"K5 B={B}: max abs err {err:.3e} > "
              f"{TOL_READOUT}")
        def run_k5():
            return cuda_readout.fused_attention_readout(model.readout, mem,
                                                        q)

        dev_ms, n_dev = device_ms(run_k5, READOUT_DEVICE_LAUNCHES)
        check(n_dev >= READOUT_DEVICE_MIN, f"K5 B={B}: the profiler saw "
              f"{n_dev} of {READOUT_DEVICE_LAUNCHES} launches")
        call_ms = cuda_ms(run_k5, 50, warmup=3)
        host_us = enqueue_us(run_k5, READOUT_HOST_CALLS)
        # The enqueue again with the launch's device context
        # (_build.on_device) made a null context, in turns with it: the
        # host's cost of selecting the tensor's device per launch.
        on_device = _build.on_device
        _build.on_device = lambda t: contextlib.nullcontext()
        try:
            no_ctx_us = [enqueue_us(run_k5, READOUT_HOST_CALLS)
                         for _ in range(2)]
        finally:
            _build.on_device = on_device
        ctx_us = [host_us, enqueue_us(run_k5, READOUT_HOST_CALLS)]
        plain_ms = cuda_ms(lambda: attention_readout(model.readout, mem, q),
                           50, warmup=3)
        b_ms, b_by = bound(*readout_work(B, m.hpmn_layers, 2 * m.emb_dim))
        ro_err = max(ro_err, err)
        ro_rows.append((B, err, dev_ms, plain_ms, b_ms, b_by, call_ms,
                        host_us))
        print(f"phase 3 kernel readout_fwd B={B} L={m.hpmn_layers}: "
              f"max_abs_err {err:.3e} (tol {TOL_READOUT}) | device "
              f"{dev_ms:.5f} ms (torch.profiler kernel durations, mean of "
              f"{n_dev} launches) | call {call_ms:.4f} ms (CUDA events, 50 "
              f"calls through fused_attention_readout) | host enqueue "
              f"{host_us:.2f} us per call ({READOUT_HOST_CALLS} calls, no "
              f"synchronize) | device context: host enqueue with "
              f"{ctx_us[0]:.2f}, {ctx_us[1]:.2f} us, without "
              f"{no_ctx_us[0]:.2f}, {no_ctx_us[1]:.2f} us (in turns: with, "
              f"without, without, with) | plain {plain_ms:.4f} ms | library "
              f"- | bound {b_ms:.5f} ms ({b_by}) | {card}", flush=True)

    # The AUGRU kernels (K1-scale, K2-scale and their bf16 forms) at
    # DIEN's shape (T = 300, B = 512, d_in = 32: taobao_dien's AUGRU, whose
    # input is the first GRU's h_seq), on the port's seeded AUGRU weights,
    # a scale in [0, 1) and random x and dh_seq, against the plain scaled
    # scans. No PyTorch call computes a gate-scaled GRU (nn.GRU has no
    # gate scale): no library time. A strided time view of x and the scale
    # is the scan's other caller form; it is covered by the card tests.
    cfg_d = get_config("taobao_dien").with_model(use_pallas=True)
    model_d = init_model(cfg_d, TAOBAO.n_items, TAOBAO.n_cats, seed=cfg.seed,
                         device=dev).requires_grad_(False)
    T_d = TAOBAO.seq_len
    aug = model_d.encoder.augru
    x = torch.randn(T_d, B_SCAN, 32, generator=gen, device=dev)
    a = torch.rand(T_d, B_SCAN, generator=gen, device=dev)
    dh_seq = torch.randn(T_d, B_SCAN, 32, generator=gen, device=dev)
    # by name: [(masked, err, ms, plain ms, bound ms, bound by)]
    sc_rows = {n: [] for n in ("fwd", "bwd", "fwd_bf16", "bwd_bf16")}
    sc_err = dict.fromkeys(sc_rows, 0.0)   # fwd: abs; bwd: of max abs
    sc_abs = dict.fromkeys(sc_rows, 0.0)
    sc_rec_err = {"bwd": 0.0, "bwd_bf16": 0.0}  # the recurrence alone
    sc_pass = {}  # (name, masked) -> the pass's ms
    sc_proj = {}  # fwd name -> (the projection's err, its ms)
    for bf in (False, True):
        sfx = "_bf16" if bf else ""
        dt = torch.bfloat16 if bf else torch.float32
        w = GRUWeights(aug.wx.to(dt), aug.wh.to(dt), aug.b.to(dt))
        xs, a_s, dhs_ = x.to(dt), a.to(dt), dh_seq.to(dt)
        es, peak = (2, PEAK_BF16_FLOPS) if bf else (4, PEAK_FP32_FLOPS)
        tol_h, tol_g = ((TOL_GRU_BF16, TOL_GRAD_BF16) if bf
                        else (TOL_GRU, TOL_GRAD))
        p_fwd, p_bwd, p_sweep = (
            (gru_scan_tm_bf16, gru_scan_tm_bwd_bf16, gru_scan_tm_sweep_bf16)
            if bf else (gru_scan_tm, gru_scan_tm_bwd, gru_scan_tm_sweep))
        # K1-scale's first kernel alone (K1's projection) on the AUGRU's
        # x and weights, against float64 sums: in f32 every block, in bf16
        # the r and z blocks (the c block within bf16_reach of its sum).
        xp_k = cuda_gru.input_proj(w, xs)
        xw64 = xs.double() @ w.wx.double()
        torch.cuda.synchronize()
        check(torch.isfinite(xp_k).all().item(), f"K1-scale{sfx}'s "
              "projection non-finite")
        if bf:
            want_c = xw64[..., 64:] + w.b[64:].double()
            reach = bf16_reach(xp_k[..., 64:], want_c,
                               TOL_PROJ * want_c.abs().max())[1]
            check(reach, f"K1-scale{sfx}'s projection: a c value off the "
                  "bf16 rounding of the float64 sum by more than the f32 "
                  "sum error")
            del want_c
            xp_k, xw64 = xp_k[..., :64], xw64[..., :64]
        else:
            xw64 = xw64 + w.b.double()
        sp_err = ((xp_k.double() - xw64).abs().max()
                  / xw64.abs().max()).item()
        check(sp_err <= TOL_PROJ, f"K1-scale{sfx}'s projection: max err over"
              f" max abs {sp_err:.3e} > {TOL_PROJ}")
        del xp_k, xw64
        sc_proj["fwd" + sfx] = (sp_err, cuda_ms(
            lambda: cuda_gru.input_proj(w, xs), 10))
        for masked in (False, True):
            mask = left_pad_mask(T_d, B_SCAN).to(dt) if masked else None
            h_k, hT_k = cuda_gru.gru_sequence_tm(w, xs, mask, scale_tm=a_s)
            h_p, hT_p = p_fwd(w, xs, mask, None, a_s)
            torch.cuda.synchronize()
            check(h_k.dtype == dt and torch.isfinite(h_k.float()).all().item(),
                  f"K1-scale{sfx} mask={masked}: dtype or non-finite")
            err = max((h_k.float() - h_p.float()).abs().max().item(),
                      (hT_k.float() - hT_p.float()).abs().max().item())
            check(err <= tol_h, f"K1-scale{sfx} mask={masked}: max abs err "
                  f"{err:.3e} > {tol_h}")
            ms = cuda_ms(lambda: cuda_gru.gru_sequence_tm(
                w, xs, mask, scale_tm=a_s), 10)
            plain_ms = cuda_ms(lambda: p_fwd(w, xs, mask, None, a_s), 2)
            b_ms, b_by = bound(*scan_fwd_work(T_d, B_SCAN, 32, masked, es,
                                              scaled=True), peak)
            name = "fwd" + sfx
            sc_err[name] = sc_abs[name] = max(sc_err[name], err)
            sc_rows[name].append((masked, err, ms, plain_ms, b_ms, b_by))
            sp_err, sp_ms = sc_proj[name]
            print(f"phase 3 kernel gru_input_proj{sfx} (K1-scale"
                  f"{sfx.replace('_', '-')}'s first kernel) T={T_d} "
                  f"B={B_SCAN} d_in=32: max err over max abs {sp_err:.3e} "
                  f"against the plain projection in float64 (tol {TOL_PROJ})"
                  f" | kernel {sp_ms:.4f} ms, {100 * sp_ms / ms:.1f}% of "
                  f"K1-scale{sfx.replace('_', '-')}'s {ms:.4f} ms "
                  f"(mask={masked})", flush=True)
            print(f"phase 3 kernel gru_scan_fwd_scale{sfx} T={T_d} B={B_SCAN}"
                  f" d_in=32 mask={masked}: max_abs_err {err:.3e} (tol "
                  f"{tol_h}) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms |"
                  f" library - (nn.GRU has no gate scale) | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

            # K2-scale's recurrence alone, over all T in one workspace
            # chunk: its gate gradients (dg), dh0 and dscale against the
            # plain sweep's.
            rec_k = cuda_gru.bwd_gates(w, xs, mask, h_k, dhs_, scale_tm=a_s)
            sw = p_sweep(w, xs, mask, h_k, dhs_, None, a_s)
            rec_p = (cuda_gru.gate_layout(sw[0], sw[1]), sw[3], sw[4])
            h_prev = sw[2]
            torch.cuda.synchronize()
            check(all(u.shape == v.shape and u.dtype == v.dtype
                      and torch.isfinite(u.float()).all().item()
                      for u, v in zip(rec_k, rec_p)),
                  f"K2-scale{sfx}'s recurrence mask={masked}: shape, dtype "
                  "or non-finite")
            r_err = max(((u.float() - v.float()).abs().max()
                         / v.float().abs().max().clamp_min(1e-30)).item()
                        for u, v in zip(rec_k, rec_p))
            check(r_err <= tol_g, f"K2-scale{sfx}'s recurrence mask={masked}:"
                  f" dg, dh0 or dscale max err over max abs {r_err:.3e} > "
                  f"{tol_g}")
            # The pass alone (K2's second kernel, one launch over all T) on
            # the recurrence's own dg.
            dg_k = rec_k[0]
            pass_ms = cuda_ms(lambda: cuda_gru.bwd_pass_dg(w.wx, xs, h_prev,
                                                           dg_k), 10)
            del rec_k, rec_p, sw, dg_k
            name = "bwd" + sfx
            sc_rec_err[name] = max(sc_rec_err[name], r_err)
            sc_pass[name, masked] = pass_ms
            n_ws = -(-T_d // cuda_gru.bwd_workspace_steps(T_d, B_SCAN, dt))
            print(f"phase 3 kernel gru_scan_bwd_scale_rec{sfx} T={T_d} "
                  f"B={B_SCAN} d_in=32 mask={masked}: gate gradients, dh0 "
                  f"and dscale max err over max abs {r_err:.3e} (tol "
                  f"{tol_g}) against the plain sweep | "
                  f"K2-scale{sfx.replace('_', '-')} runs it in {n_ws} "
                  f"workspace chunks", flush=True)

            got = cuda_gru.gru_scan_bwd(w, xs, mask, h_k, dhs_, scale_tm=a_s)
            want = p_bwd(w, xs, mask, h_k, dhs_, None, a_s)
            torch.cuda.synchronize()
            rel, absd = 0.0, 0.0
            for gname, u, v in zip(("dx", "dwx", "dwh", "db", "dh0",
                                    "dscale"), got, want):
                check(u.shape == v.shape and u.dtype == v.dtype
                      and torch.isfinite(u.float()).all().item(),
                      f"K2-scale{sfx} mask={masked}: {gname} shape, dtype or "
                      "non-finite")
                d = (u.float() - v.float()).abs().max().item()
                absd = max(absd, d)
                rel = max(rel, d / max(v.float().abs().max().item(), 1e-30))
            check(len(got) == 6, f"K2-scale{sfx}: no dscale")
            check(rel <= tol_g, f"K2-scale{sfx} mask={masked}: max abs err "
                  f"over max abs {rel:.3e} > {tol_g}")
            ms = cuda_ms(lambda: cuda_gru.gru_scan_bwd(
                w, xs, mask, h_k, dhs_, scale_tm=a_s), 10)
            plain_ms = cuda_ms(lambda: p_bwd(w, xs, mask, h_k, dhs_, None,
                                             a_s), 2)
            b_ms, b_by = bound(*scan_bwd_work(T_d, B_SCAN, 32, masked, es,
                                              scaled=True), peak)
            sc_err[name] = max(sc_err[name], rel)
            sc_abs[name] = max(sc_abs[name], absd)
            sc_rows[name].append((masked, absd, ms, plain_ms, b_ms, b_by))
            print(f"phase 3 kernel gru_bwd_pass{sfx} (K2-scale"
                  f"{sfx.replace('_', '-')}'s second kernel) T={T_d} "
                  f"B={B_SCAN} d_in=32 mask={masked}: kernel {pass_ms:.4f} "
                  f"ms, {100 * pass_ms / ms:.1f}% of K2-scale"
                  f"{sfx.replace('_', '-')}'s {ms:.4f} ms", flush=True)
            print(f"phase 3 kernel gru_scan_bwd_scale{sfx} T={T_d} B={B_SCAN}"
                  f" d_in=32 mask={masked}: max_abs_err {absd:.3e}, over max "
                  f"abs {rel:.3e} (tol {tol_g}; dscale among the outputs) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | library - "
                  f"(nn.GRU has no gate scale) | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
    del x, a, dh_seq, h_k, h_p, got, want, h_prev

    # ----------------------------------------------------------- 4. slice --
    full = make_ctr_dataset(XLONG, N_FULL_USERS, seed=1, min_len_frac=1.0)
    padded = make_ctr_dataset(XLONG, N_PADDED_USERS, seed=2)
    check(full["seq_mask"].min() == 1.0, "full histories have padding")
    check(padded["seq_mask"].min() == 0.0, "padded histories have none")
    full_uids = np.arange(N_FULL_USERS)
    pad_uids = np.arange(N_FULL_USERS, N_FULL_USERS + N_PADDED_USERS)
    rng = np.random.default_rng(3)
    upd_uids = full_uids[:B_SCAN]
    upd_items = rng.integers(1, XLONG.n_items, size=(UPDATE_ROUNDS, B_SCAN))
    upd_cats = (upd_items * 7 % (XLONG.n_cats - 1) + 1)
    rank_uids = full_uids[:RANK_USERS]
    rank_items = rng.integers(1, XLONG.n_items, size=(RANK_USERS, RANK_CANDS))
    rank_cats = rng.integers(1, XLONG.n_cats, size=(RANK_USERS, RANK_CANDS))

    store = UserMemoryStore(cfg, model, device=dev)
    torch.cuda.synchronize()
    cuda_gru.launches = 0
    cuda_readout.launches = 0
    t0 = time.perf_counter()
    for lo in range(0, N_FULL_USERS, B_SCAN):
        sl = slice(lo, lo + B_SCAN)
        store.ingest_histories(full_uids[sl], full["item_seq"][sl],
                               full["cat_seq"][sl])
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    gru_after_full = cuda_gru.launches
    t0 = time.perf_counter()
    store.ingest_histories(pad_uids, padded["item_seq"], padded["cat_seq"],
                           masks=padded["seq_mask"])
    torch.cuda.synchronize()
    t_ingest_pad = time.perf_counter() - t0
    gru_after_pad = cuda_gru.launches
    t0 = time.perf_counter()
    for k in range(UPDATE_ROUNDS):
        store.update(upd_uids, upd_items[k], upd_cats[k])
    torch.cuda.synchronize()
    t_update = time.perf_counter() - t0
    ro_before = cuda_readout.launches
    t_predict = []
    for _ in range(REQUEST_REPS):
        t0 = time.perf_counter()
        pred = store.predict(upd_uids, full["target_item"][:B_SCAN],
                             full["target_cat"][:B_SCAN])
        t_predict.append(time.perf_counter() - t0)
    ro_predict = cuda_readout.launches - ro_before
    t_rank = []
    for _ in range(REQUEST_REPS):
        t0 = time.perf_counter()
        ranked = store.rank(rank_uids, rank_items, rank_cats)
        t_rank.append(time.perf_counter() - t0)
    ro_rank = cuda_readout.launches - ro_before - ro_predict
    launches_gru, launches_ro = cuda_gru.launches, cuda_readout.launches

    n_batches = N_FULL_USERS // B_SCAN
    check(gru_after_full == m.hpmn_layers * n_batches,
          f"gru_scan_fwd launches {gru_after_full} for {n_batches} full "
          f"ingest batches, expected {m.hpmn_layers} per batch")
    check(gru_after_pad - gru_after_full == m.hpmn_layers,
          "the padded ingest did not launch gru_scan_fwd once per layer")
    check(ro_predict >= 1 and ro_rank >= 1,
          f"readout_fwd launches: predict {ro_predict}, rank {ro_rank}")
    for name, s in (("predict", pred), ("rank", ranked)):
        check(np.isfinite(s).all() and (s > 0).all() and (s < 1).all(),
              f"{name} scores not finite in (0, 1)")
    check(pred.shape == (B_SCAN,) and ranked.shape == (RANK_USERS,
                                                      RANK_CANDS),
          "score shapes")

    # rank column c == predict on column c
    col_err = max(np.abs(ranked[:, c] - store.predict(
        rank_uids, rank_items[:, c], rank_cats[:, c])).max()
        for c in range(RANK_CANDS))
    check(col_err <= TOL_READOUT, f"rank vs predict columns: {col_err:.3e}")

    # ingesting T+1 events == ingesting T, then one update
    n = 64
    a_uids, b_uids = 10**6 + np.arange(n), 2 * 10**6 + np.arange(n)
    extra_i, extra_c = full["target_item"][:n], full["target_cat"][:n]
    store.ingest_histories(
        a_uids, np.concatenate([full["item_seq"][:n], extra_i[:, None]], 1),
        np.concatenate([full["cat_seq"][:n], extra_c[:, None]], 1))
    store.ingest_histories(b_uids, full["item_seq"][:n], full["cat_seq"][:n])
    store.update(b_uids, extra_i, extra_c)
    (mem_a, cnt_a), (mem_b, cnt_b) = store._gather(a_uids), \
        store._gather(b_uids)
    step_err = (mem_a - mem_b).abs().max().item()
    check(torch.equal(cnt_a, cnt_b) and int(cnt_a[0]) == XLONG.seq_len + 1,
          "counters after T+1 events")
    check(step_err <= TOL_SLICE, f"T+1 ingest vs T ingest + update: "
          f"{step_err:.3e}")

    # the kernel path against the plain versions on the same state
    with torch.no_grad():
        emb = model.embedding
        ids = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        # padded histories: the masked single-scan oracle
        x = dense_lookup(emb, ids(padded["item_seq"]), ids(padded["cat_seq"]))
        mem_oracle = encode_oracle(model.encoder, x,
                                   ids(padded["seq_mask"]), m.hpmn_period)
        oracle_err = (store._gather(pad_uids)[0] - mem_oracle).abs().max()
        # full histories not updated: the plain time-major hierarchy
        sl = slice(B_SCAN, 2 * B_SCAN)
        x_tm = dense_lookup(emb, ids(full["item_seq"][sl]).T,
                            ids(full["cat_seq"][sl]).T)
        mem_plain = encode_hierarchical_tm(
            model.encoder, x_tm, None, m.hpmn_period,
            gru_seq_tm_fn=lambda p, xs, mk: gru_scan_tm(p, xs, mk))
        hier_err = (store._gather(full_uids[sl])[0] - mem_plain).abs().max()
        # scores of the updated users through the plain readout
        mem_upd = store._gather(upd_uids)[0]
        q = dense_lookup(emb, ids(full["target_item"][:B_SCAN]),
                         ids(full["target_cat"][:B_SCAN]))
        read = attention_readout(model.readout, mem_upd, q)
        pred_plain = torch.sigmoid(apply_tower(
            model.tower, torch.cat([q, read], -1))).cpu().numpy()
    oracle_err, hier_err = oracle_err.item(), hier_err.item()
    score_err = float(np.abs(pred - pred_plain).max())
    check(oracle_err <= TOL_SLICE, f"padded ingest vs oracle: "
          f"{oracle_err:.3e}")
    check(hier_err <= TOL_SLICE, f"full ingest vs plain hierarchy: "
          f"{hier_err:.3e}")
    check(score_err <= TOL_SLICE, f"predict vs plain scores: {score_err:.3e}")

    print(f"phase 4 slice xlong_hpmn T={XLONG.seq_len} L={m.hpmn_layers} "
          f"period={m.hpmn_period}: ingest {N_FULL_USERS / t_ingest:.1f} "
          f"histories/s ({N_FULL_USERS} full, batches of {B_SCAN}) | padded "
          f"ingest {N_PADDED_USERS / t_ingest_pad:.1f} histories/s | update "
          f"{UPDATE_ROUNDS * B_SCAN / t_update:.1f} events/s | predict "
          f"{1e3 * np.median(t_predict):.3f} ms median of {REQUEST_REPS} "
          f"(first {1e3 * t_predict[0]:.3f}) ({B_SCAN} users) | rank "
          f"{1e3 * np.median(t_rank):.3f} ms median of {REQUEST_REPS} (first "
          f"{1e3 * t_rank[0]:.3f}) ({RANK_USERS}x{RANK_CANDS}) | launches "
          f"gru_scan_fwd {launches_gru} readout_fwd {launches_ro} "
          f"(predict {ro_predict}, rank {ro_rank}) | checks: rank==predict "
          f"{col_err:.2e}, T+1 {step_err:.2e}, oracle {oracle_err:.2e}, "
          f"plain hierarchy {hier_err:.2e}, plain scores {score_err:.2e}: ok",
          flush=True)
    phase4 = {"ingest": t_ingest, "update": t_update,
              "predict": np.median(t_predict), "rank": np.median(t_rank)}

    # -------------------------------------------------------- 5. training --
    # bench.py's flags (use_pallas, use_hierarchical_scan, assume_full_mask)
    # and the config's f32 scan; the plain path is the batch-major hierarchy
    # of plain scans and the plain readout, under autograd.
    cfg_k = cfg.with_model(use_pallas=True, assume_full_mask=True)
    n_b = cfg.train.batch_size
    L = m.hpmn_layers
    train_data = make_ctr_dataset(XLONG, N_TRAIN_BATCHES * n_b, seed=4,
                                  min_len_frac=1.0)
    check(train_data["seq_mask"].min() == 1.0, "training histories padded")
    batches = [batch_from_numpy(train_data, np.arange(i * n_b, (i + 1) * n_b),
                                device=dev) for i in range(N_TRAIN_BATCHES)]
    padded_data = make_ctr_dataset(XLONG, n_b, seed=5)
    check(padded_data["seq_mask"].min() == 0.0, "padded batch has no padding")
    padded_batch = batch_from_numpy(padded_data, device=dev)

    def loss_and_grads(c, batch, plain=False, spec=XLONG):
        """-> (loss, parameters with their gradients, seconds, the peak
        device memory of the loss and its backward in MiB)."""
        model_g = init_model(c, spec.n_items, spec.n_cats, seed=cfg.seed,
                             device=dev, n_users=spec.n_users)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _ = loss_fn(model_g, c, batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.item(), dict(model_g.named_parameters()),
                time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev) / 2**20)

    def step_check(phase, form, c_k, batch, c_p, plain, tol_loss, tol_grad,
                   spec=XLONG):
        """The kernel path's loss and every gradient against the plain
        path's (config c_p, ``plain`` flag), same weights and batch."""
        loss_k, p_k, t_k, mib_k = loss_and_grads(c_k, batch, spec=spec)
        loss_p, p_p, t_p, _ = loss_and_grads(c_p, batch, plain, spec)
        check(np.isfinite(loss_k), f"training loss ({form}) not finite")
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        check(loss_rel <= tol_loss, f"step ({form}): loss {loss_k} vs "
              f"plain {loss_p}, relative {loss_rel:.3e} > {tol_loss}")
        worst, worst_name = 0.0, ""
        for name, p in p_p.items():
            gk = p_k[name].grad
            check(gk is not None and gk.dtype == torch.float32
                  and torch.isfinite(gk).all().item(),
                  f"step ({form}): no finite f32 gradient for {name}")
            rel = ((gk - p.grad).abs().max()
                   / p.grad.abs().max().clamp_min(1e-30)).item()
            if rel >= worst:
                worst, worst_name = rel, name
        check(worst <= tol_grad, f"step ({form}): gradient of "
              f"{worst_name} off by {worst:.3e} of its max abs > "
              f"{tol_grad}")
        print(f"phase {phase} step check {form} B={batch.batch_size} "
              f"T={batch.seq_len}: "
              f"loss kernel {loss_k:.7f} plain {loss_p:.7f} (relative "
              f"{loss_rel:.2e}, tol {tol_loss}) | {len(p_p)} gradients,"
              f" worst {worst_name} {worst:.2e} of max abs (tol "
              f"{tol_grad}) | one step, first call: kernel path "
              f"{1e3 * t_k:.1f} ms, plain path {1e3 * t_p:.1f} ms | kernel "
              f"path's peak device memory {mib_k:.1f} MiB", flush=True)
        return loss_k

    # Launch counters, in this order: K1, K2, K1-bf16, K2-bf16, K5, K3, K4,
    # K3-bf16, K4-bf16, K1-scale, K2-scale, K1-scale-bf16, K2-scale-bf16.
    counted = ((cuda_gru, "launches"), (cuda_gru, "bwd_launches"),
               (cuda_gru, "launches_bf16"), (cuda_gru, "bwd_launches_bf16"),
               (cuda_readout, "launches"), (cuda_gru_stride, "launches"),
               (cuda_gru_stride, "bwd_launches"),
               (cuda_gru_stride, "launches_bf16"),
               (cuda_gru_stride, "bwd_launches_bf16"),
               (cuda_gru, "launches_scale"), (cuda_gru, "bwd_launches_scale"),
               (cuda_gru, "launches_scale_bf16"),
               (cuda_gru, "bwd_launches_scale_bf16"))

    def counters():
        return tuple(getattr(mod, var) for mod, var in counted)

    def zero_counters():
        for mod, var in counted:
            setattr(mod, var, 0)

    def timed_train(c_k, stacks_, spec=XLONG):
        """k steps per dispatch, 2 warm-up and 3 timed dispatches, the
        batches cycled; the counters set to 0 just before -> (last step's
        metrics, ms per step, examples/s, launches, the multistep)."""
        model_t = init_model(c_k, spec.n_items, spec.n_cats, seed=cfg.seed,
                             device=dev)
        multistep = make_multistep_train(
            c_k, model_t, make_optimizer(c_k, model_t.parameters()))
        torch.cuda.synchronize()
        zero_counters()
        for i in range(WARMUP_DISPATCHES):
            metrics = multistep(stacks_[i % N_TRAIN_BATCHES])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WARMUP_DISPATCHES,
                       WARMUP_DISPATCHES + TIMED_DISPATCHES):
            metrics = multistep(stacks_[i % N_TRAIN_BATCHES])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = counters()
        metrics = {name: v.item() for name, v in metrics.items()}
        check(all(np.isfinite(v) for v in metrics.values()),
              f"training metrics not finite: {metrics}")
        return (metrics, 1e3 * t_train / (TIMED_DISPATCHES * k),
                TIMED_DISPATCHES * k * n_b / t_train, launches, multistep)

    def profile_work(phase, fn, wall_ms, n, unit, gflop=None):
        """fn() once more under the profiler, doing n units of work (steps
        or requests): the device's kernel time per unit against the
        unprofiled wall time per unit. Only kernels count: a CPU op (or an
        autograd Function's record) that launches a kernel also reports
        that kernel's time as its own, and a user annotation (the
        optimizer's step) spans kernels listed apart. ``gflop``: the
        width-general forms' products' GFLOP per unit (gen_products_gflop);
        a second line then gives each product's and each general
        recurrence's device ms per unit, the products' TFLOP/s beside."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = sorted(((a.self_device_time_total, a.count, a.key)
                       for a in prof.key_averages()
                       if a.device_type == DeviceType.CUDA
                       and not getattr(a, "is_user_annotation", False)
                       and a.self_device_time_total > 0), reverse=True)
        dev_ms = sum(t for t, _, _ in kern) / 1e3 / n
        # Every form of K1 (K1, K1-scale and their bf16 forms) is two
        # kernels: the projection and the recurrence
        # (gru_scan_fwd_xp_kernel with DenseOut, its last template argument
        # kScale false or true); K3 and K3-bf16 the same two (StrideOut);
        # K2, K2-scale and their bf16 forms three: the recurrence
        # (gru_scan_bwd_rec_kernel, its template argument kScale false or
        # true), the pass and the partials; K4 and K4-bf16 four: K1's
        # projection, their recurrence, K2's pass and partials. The stream
        # type tells the dtypes apart. One step may run several families
        # on the same kernels (a DIEN step runs K1 and K1-scale, K2 and
        # K2-scale; a strided step runs the projection for K3 and K4), so
        # each launch counts for a recurrence by its place on the stream: a
        # projection for the recurrence that follows it, which reads its
        # workspace; a pass or a partials launch for the backward
        # recurrence before it, whose gate gradients it reads.
        def fwd_family(name):
            """K1, K1-scale or K3, from a forward recurrence's name."""
            if "StrideOut" in name:
                return "K3"
            return "K1-scale" if ", true>" in name else "K1"

        proj, rec = {}, {}  # (K1, K1-scale, K3 or K4, bf16) -> ms per unit
        for t, _, name in kern:
            if "gru_scan_fwd_xp_kernel" in name:
                key = (fwd_family(name), "bfloat16" in name)
                rec[key] = rec.get(key, 0.0) + t / 1e3 / n
        owner = None
        on_stream = sorted((e for e in prof.events()
                            if e.device_type == DeviceType.CUDA),
                           key=lambda e: e.time_range.start)
        for e in reversed(on_stream):
            if "gru_scan_fwd_xp_kernel" in e.name:
                owner = fwd_family(e.name)
            elif "gru_scan_stride_bwd_rec_kernel" in e.name:
                owner = "K4"
            elif "input_proj_kernel" in e.name and owner is not None:
                key = (owner, "bfloat16" in e.name)
                proj[key] = (proj.get(key, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / n)
        bwd = {}  # (K2, K2-scale or K4, part) -> device ms per unit
        owner = None
        for e in on_stream:
            if "gru_scan_bwd_rec_kernel" in e.name:
                owner = "K2-scale" if ", true>" in e.name else "K2"
                part = "recurrence"
            elif "gru_scan_stride_bwd_rec_kernel" in e.name:
                owner, part = "K4", "recurrence"
            elif "gru_bwd_pass_kernel" in e.name:
                part = "pass"
            elif "wgrad_partials_kernel" in e.name:
                part = "partials"
            else:
                continue
            if owner is not None:
                bwd[owner, part] = (bwd.get((owner, part), 0.0)
                                    + e.time_range.elapsed_us() / 1e3 / n)

        def fwd_split(fam_):
            """A forward family's projection + recurrence, f32 and bf16,
            printed."""
            return f"{fam_} " + ", ".join(
                f"{pr + rc:.3f} = {pr:.3f} + {rc:.3f} "
                f"{'bf16' if b else 'f32'}"
                for b in (False, True)
                for pr, rc in [(proj.get((fam_, b), 0.0),
                                rec.get((fam_, b), 0.0))])

        def bwd_split(fam_):
            """A backward family's recurrence, pass and partials, printed."""
            parts = [bwd.get((fam_, p_), 0.0)
                     for p_ in ("recurrence", "pass", "partials")]
            return f"{fam_} {sum(parts):.3f}: " + ", ".join(
                f"{t:.3f}" for t in parts)

        ro = [(t, c) for t, c, name in kern if "readout_fwd_kernel" in name]
        ro_us = sum(t for t, _ in ro) / n
        ro_n = sum(c for _, c in ro) / n
        if dev_ms > 0:
            top = ", ".join(f"{kernel_label(name)} {t / 1e3 / n:.3f} ms "
                            f"({c / n:g}/{unit})" for t, c, name in kern[:10])
            print(f"phase {phase} profile: device kernel time {dev_ms:.3f} "
                  f"ms per {unit} of {wall_ms:.3f} ms wall: busy "
                  f"{dev_ms / wall_ms:.1%}, idle {1 - dev_ms / wall_ms:.1%} "
                  f"| forward, projection + recurrence: {fwd_split('K1')}; "
                  f"{fwd_split('K1-scale')}; {fwd_split('K3')} | K4's "
                  f"projection {proj.get(('K4', False), 0.0):.3f} f32, "
                  f"{proj.get(('K4', True), 0.0):.3f} bf16 | backward, "
                  f"recurrence, pass, partials: "
                  f"{bwd_split('K2')}; {bwd_split('K2-scale')}; "
                  f"{bwd_split('K4')} | readout (K5) {ro_us:.2f} us per "
                  f"{unit} ({ro_n:g} launches) | top: {top}", flush=True)
        else:
            print(f"phase {phase} profile: the profiler saw no device time; "
                  "device busy share not measured", flush=True)
        if gflop is not None and dev_ms > 0:
            gen = {}
            for t, _, name in kern:
                part = next((lbl for keys, lbl in GEN_PROFILE_PARTS
                             if all(k_ in name for k_ in keys)), None)
                if part is not None:
                    gen[part] = gen.get(part, 0.0) + t / 1e3 / n
            prods = [lbl for _, lbl in GEN_PROFILE_PARTS if lbl in gflop]
            recs = [lbl for _, lbl in GEN_PROFILE_PARTS
                    if lbl not in gflop and gen.get(lbl)]
            total = sum(gen.get(lbl, 0.0) for lbl in prods)
            print(f"phase {phase} profile, the general forms' parts, device "
                  f"ms per {unit}: products " + ", ".join(
                      f"{lbl} {gen.get(lbl, 0.0):.3f} ("
                      + (f"{gflop[lbl] / gen[lbl]:.1f} TFLOP/s"
                         if gen.get(lbl) else "not run") + ")"
                      for lbl in prods)
                  + f", all products {total:.3f} ("
                  + (f"{sum(gflop[lbl] for lbl in prods) / total:.1f} "
                     f"TFLOP/s" if total > 0 else "not run")
                  + ") | recurrences " + ", ".join(
                      f"{lbl} {gen[lbl]:.3f}" for lbl in recs), flush=True)

    def embedding_backward_ms(multistep, stack):
        """Phase 5's dispatch twice more under the profiler: the table
        gradients' device ms per step (the kernels under
        aten::embedding_dense_backward) and the step's, with the
        deterministic sum the port runs on the card
        (models.embedding.rows_backward) and without it (PyTorch's
        default embedding backward, the form before the amazon_rum
        repair). A measurement: nothing is checked."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from hpmn_tpu_torch.models import embedding

        def run():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                multistep(stack)
                torch.cuda.synchronize()
            rows = prof.key_averages()
            emb = sum(a.device_time_total for a in rows
                      if a.key == "aten::embedding_dense_backward")
            total = sum(a.self_device_time_total for a in rows
                        if a.device_type == DeviceType.CUDA
                        and not getattr(a, "is_user_annotation", False))
            return emb / 1e3 / k, total / 1e3 / k

        emb_det, step_det = run()
        keep = embedding._deterministic
        embedding._deterministic = lambda on: contextlib.nullcontext()
        try:
            emb_def, step_def = run()
        finally:
            embedding._deterministic = keep
        print(f"phase 5 table gradients (aten::embedding_dense_backward, "
              f"device ms per step, one profiled dispatch each): "
              f"deterministic sum {emb_det:.4f} of a {step_det:.3f} ms step "
              f"| PyTorch's default (before the repair) {emb_def:.4f} of a "
              f"{step_def:.3f} ms step", flush=True)

    def profile_dispatch(phase, multistep, step_ms, stack, gflop=None):
        """One more k-step dispatch under the profiler (profile_work)."""
        profile_work(phase, lambda: multistep(stack), step_ms, k, "step",
                     gflop)

    k = STEPS_PER_DISPATCH
    stacks = [[batches[(i + j) % N_TRAIN_BATCHES] for j in range(k)]
              for i in range(N_TRAIN_BATCHES)]
    f32_loss = {}
    for form, c_k, batch in (
            ("full", cfg_k, batches[0]),
            ("padded", cfg_k.with_model(assume_full_mask=False),
             padded_batch)):
        f32_loss[form] = step_check(
            5, form, c_k, batch, c_k.with_model(use_pallas=False), False,
            TOL_STEP_LOSS, TOL_STEP_GRAD)
    torch.cuda.empty_cache()

    metrics, step_ms, ex_per_s, train_launches, multistep = timed_train(
        cfg_k, stacks)
    n_steps = (WARMUP_DISPATCHES + TIMED_DISPATCHES) * k
    check(train_launches == (L * n_steps, L * n_steps, 0, 0, n_steps,
                             0, 0, 0, 0) + (0,) * 4,
          f"launches over {n_steps} steps: gru_scan_fwd, gru_scan_bwd, "
          f"gru_scan_fwd_bf16, gru_scan_bwd_bf16, readout_fwd, the four "
          f"strided, the four scale = {train_launches}, expected {L}, {L}, "
          "0, 0, 1 and 0 per step")
    print(f"phase 5 train xlong_hpmn B={n_b} T={XLONG.seq_len} L={L} f32, "
          f"{k} steps per dispatch: {ex_per_s:.1f} examples/s ({step_ms:.3f}"
          f" ms per step, {TIMED_DISPATCHES} dispatches after "
          f"{WARMUP_DISPATCHES} warm-up, {N_TRAIN_BATCHES} batches cycled) | "
          f"last step loss {metrics['loss']:.6f} bce {metrics['bce']:.6f} "
          f"cov_reg {metrics['cov_reg']:.3e} l2 {metrics['l2']:.3f} | "
          f"launches over {n_steps} steps: gru_scan_fwd {train_launches[0]}"
          f" gru_scan_bwd {train_launches[1]} readout_fwd "
          f"{train_launches[4]} ({L}, {L}, 1 per step; bf16 scans "
          f"{train_launches[2]}, {train_launches[3]})", flush=True)
    profile_dispatch(5, multistep, step_ms, stacks[0])
    embedding_backward_ms(multistep, stacks[0])
    del multistep
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 6. bf16 training --
    # bench.py's headline leg: the same flags with scan_dtype="bfloat16".
    # The plain path is the same time-major branch with the plain bf16
    # scans and the plain readout under autograd (loss_fn's plain=True).
    cfg_b = cfg_k.with_model(scan_dtype="bfloat16")
    bf16_loss = {}
    for form, c_b, batch in (
            ("full", cfg_b, batches[0]),
            ("padded", cfg_b.with_model(assume_full_mask=False),
             padded_batch)):
        bf16_loss[form] = step_check(6, form, c_b, batch, c_b, True,
                                     TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16)
    vs_f32 = {form: abs(bf16_loss[form] - f32_loss[form]) / abs(f32_loss[form])
              for form in bf16_loss}
    for form, rel in vs_f32.items():
        check(rel <= TOL_STEP_LOSS_BF16_VS_F32, f"bf16 step ({form}): loss "
              f"{bf16_loss[form]} vs the f32 step's {f32_loss[form]}, "
              f"relative {rel:.3e} > {TOL_STEP_LOSS_BF16_VS_F32}")
    print(f"phase 6 vs f32 step (same weights and batch): loss bf16 "
          f"{bf16_loss['full']:.7f} f32 {f32_loss['full']:.7f} full "
          f"(relative {vs_f32['full']:.2e}), bf16 {bf16_loss['padded']:.7f} "
          f"f32 {f32_loss['padded']:.7f} padded (relative "
          f"{vs_f32['padded']:.2e}) (tol {TOL_STEP_LOSS_BF16_VS_F32})",
          flush=True)
    torch.cuda.empty_cache()

    metrics, step_ms_b, ex_per_s_b, bf16_launches, multistep = \
        timed_train(cfg_b, stacks)
    check(bf16_launches == (0, 0, L * n_steps, L * n_steps, n_steps,
                            0, 0, 0, 0) + (0,) * 4,
          f"launches over {n_steps} steps: gru_scan_fwd, gru_scan_bwd, "
          f"gru_scan_fwd_bf16, gru_scan_bwd_bf16, readout_fwd, the four "
          f"strided, the four scale = {bf16_launches}, expected 0, 0, {L}, "
          f"{L}, 1 and 0 per step")
    print(f"phase 6 train xlong_hpmn B={n_b} T={XLONG.seq_len} L={L} bf16 "
          f"scans, {k} steps per dispatch: {ex_per_s_b:.1f} examples/s "
          f"({step_ms_b:.3f} ms per step; f32, phase 5: {ex_per_s:.1f} "
          f"examples/s, {step_ms:.3f} ms) | last step loss "
          f"{metrics['loss']:.6f} bce {metrics['bce']:.6f} cov_reg "
          f"{metrics['cov_reg']:.3e} l2 {metrics['l2']:.3f} | launches over "
          f"{n_steps} steps: gru_scan_fwd_bf16 {bf16_launches[2]} "
          f"gru_scan_bwd_bf16 {bf16_launches[3]} readout_fwd "
          f"{bf16_launches[4]} ({L}, {L}, 1 per step; f32 scans "
          f"{bf16_launches[0]}, {bf16_launches[1]})", flush=True)
    profile_dispatch(6, multistep, step_ms_b, stacks[0])
    del multistep
    torch.cuda.empty_cache()

    # ------------------------------------------------ 7. strided training --
    # The same legs with pallas_stride_outputs=True: each layer's scan is K3
    # (K3-bf16), its backward K4 (K4-bf16); no dense h_seq. The plain path
    # is the same branch with the plain strided scans under autograd.
    stride_launches = {}
    for leg, c_d, dense_loss, dense_eps, tols in (
            ("f32", cfg_k, f32_loss["full"], ex_per_s,
             (TOL_STEP_LOSS, TOL_STEP_GRAD)),
            ("bf16", cfg_b, bf16_loss["full"], ex_per_s_b,
             (TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16))):
        c_s = c_d.with_model(pallas_stride_outputs=True)
        loss_s = step_check(7, f"strided {leg} full", c_s, batches[0], c_s,
                            True, *tols)
        rel = abs(loss_s - dense_loss) / abs(dense_loss)
        check(rel <= tols[0], f"strided {leg} step: loss {loss_s} vs the "
              f"dense step's {dense_loss}, relative {rel:.3e} > {tols[0]}")
        torch.cuda.empty_cache()
        metrics, step_ms_s, ex_per_s_s, launches, multistep = \
            timed_train(c_s, stacks)
        k3 = L * n_steps
        want = ((0, 0, 0, 0, n_steps, k3, k3, 0, 0) if leg == "f32"
                else (0, 0, 0, 0, n_steps, 0, 0, k3, k3)) + (0,) * 4
        check(launches == want, f"strided {leg} launches over {n_steps} "
              f"steps: gru_scan_fwd, gru_scan_bwd, gru_scan_fwd_bf16, "
              f"gru_scan_bwd_bf16, readout_fwd, gru_stride_fwd, "
              f"gru_stride_bwd, gru_stride_fwd_bf16, gru_stride_bwd_bf16, "
              f"the four scale = {launches}, expected {want}")
        stride_launches[leg] = launches
        sfx = "" if leg == "f32" else "_bf16"
        print(f"phase 7 train xlong_hpmn B={n_b} T={XLONG.seq_len} L={L} "
              f"{leg} scans, strided outputs, {k} steps per dispatch: "
              f"{ex_per_s_s:.1f} examples/s ({step_ms_s:.3f} ms per step; "
              f"dense {leg} step: {dense_eps:.1f} examples/s) | loss vs the "
              f"dense step's (same weights and batch): {loss_s:.7f} vs "
              f"{dense_loss:.7f}, relative {rel:.2e} (tol {tols[0]}) | last "
              f"step loss {metrics['loss']:.6f} bce {metrics['bce']:.6f} | "
              f"launches over {n_steps} steps: gru_stride_fwd{sfx} "
              f"{launches[5] + launches[7]} gru_stride_bwd{sfx} "
              f"{launches[6] + launches[8]} readout_fwd {launches[4]} ({L}, "
              f"{L}, 1 per step; dense scans {sum(launches[:4])})",
              flush=True)
        profile_dispatch(7, multistep, step_ms_s, stacks[0])
        del multistep
        torch.cuda.empty_cache()

    # ------------------------------------------------- 8. DIEN training --
    # taobao_dien with use_pallas at B = 512, T = 300: f32 on left-padded
    # histories (the config's default mask; gru1 through K1/K2, the AUGRU
    # through K1-scale/K2-scale) and bf16 on full ones (the bench flagship,
    # tools/bench_config.py: scan_dtype bfloat16, assume_full_mask; their
    # bf16 forms). The plain path is the same branch with the plain scans
    # under autograd (plain=True). The loss is BCE + the aux loss + 1e-5 L2.
    dien_legs = (
        ("f32 padded", cfg_d, 9, 0.5, (TOL_STEP_LOSS, TOL_STEP_GRAD)),
        ("bf16 full", cfg_d.with_model(scan_dtype="bfloat16",
                                       assume_full_mask=True), 10, 1.0,
         (TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16)))
    n_bd = cfg_d.train.batch_size
    dien_launches, dien_loss, dien_batches = {}, {}, {}
    for form, c_d, seed, min_len, tols in dien_legs:
        data_d = make_ctr_dataset(TAOBAO, N_TRAIN_BATCHES * n_bd, seed=seed,
                                  min_len_frac=min_len)
        check((data_d["seq_mask"].min() == 1.0) == (min_len == 1.0),
              f"DIEN {form} batches: padding not as intended")
        dien_batches[form] = [batch_from_numpy(
            data_d, np.arange(i * n_bd, (i + 1) * n_bd), device=dev)
            for i in range(N_TRAIN_BATCHES)]
        dien_loss[form] = step_check(8, f"taobao_dien {form}", c_d,
                                     dien_batches[form][0], c_d, True, *tols,
                                     spec=TAOBAO)
        torch.cuda.empty_cache()
    # The bf16 step's loss against the f32 kernel path's on the same full
    # batch and weights. Printed only: the aux loss reads gru1's h_seq,
    # which the bf16 chain rounds to bf16, directly.
    loss_f32_full = loss_and_grads(cfg_d.with_model(assume_full_mask=True),
                                   dien_batches["bf16 full"][0],
                                   spec=TAOBAO)[0]
    bf_vs_f32 = abs(dien_loss["bf16 full"] - loss_f32_full) / abs(
        loss_f32_full)
    print(f"phase 8 vs f32 step (same weights and full batch): loss bf16 "
          f"{dien_loss['bf16 full']:.7f} f32 {loss_f32_full:.7f} (relative "
          f"{bf_vs_f32:.2e}, printed only)", flush=True)
    torch.cuda.empty_cache()
    for form, c_d, _, _, _ in dien_legs:
        st = [[dien_batches[form][(i + j) % N_TRAIN_BATCHES]
               for j in range(k)] for i in range(N_TRAIN_BATCHES)]
        metrics, step_ms_d, ex_per_s_d, launches, multistep = timed_train(
            c_d, st, TAOBAO)
        want = ((n_steps, n_steps, 0, 0) + (0,) * 5 + (n_steps, n_steps, 0, 0)
                if form.startswith("f32") else
                (0, 0, n_steps, n_steps) + (0,) * 5 + (0, 0, n_steps,
                                                        n_steps))
        check(launches == want, f"DIEN {form} launches over {n_steps} steps:"
              f" {launches}, expected {want} (K1, K2, K1-bf16, K2-bf16, K5,"
              f" K3, K4, K3-bf16, K4-bf16, K1-scale, K2-scale, "
              f"K1-scale-bf16, K2-scale-bf16)")
        dien_launches[form] = launches
        sfx = "" if form.startswith("f32") else "_bf16"
        f0 = 0 if not sfx else 2
        print(f"phase 8 train taobao_dien B={n_bd} T={T_d} {form}, {k} "
              f"steps per dispatch: {ex_per_s_d:.1f} examples/s "
              f"({step_ms_d:.3f} ms per step, {TIMED_DISPATCHES} dispatches "
              f"after {WARMUP_DISPATCHES} warm-up, {N_TRAIN_BATCHES} batches "
              f"cycled) | last step loss {metrics['loss']:.6f} bce "
              f"{metrics['bce']:.6f} aux_loss {metrics['aux_loss']:.6f} l2 "
              f"{metrics['l2']:.3f} | launches over {n_steps} steps: "
              f"gru_scan_fwd{sfx} {launches[f0]} gru_scan_bwd{sfx} "
              f"{launches[f0 + 1]} gru_scan_fwd_scale{sfx} "
              f"{launches[9 + f0]} gru_scan_bwd_scale{sfx} "
              f"{launches[10 + f0]} (1, 1, 1, 1 per step; others "
              f"{sum(launches) - 4 * n_steps})", flush=True)
        profile_dispatch(8, multistep, step_ms_d, st[0])
        del multistep
        torch.cuda.empty_cache()

    # -------------------------------------------------- 9. DIEN serving --
    # A HistoryStore on the card (taobao_dien, use_pallas, the config's
    # masked f32 scans, W = 300) serves N_FULL_USERS left-padded histories:
    # ingest (host), UPDATE_ROUNDS updates of B_SCAN users (host), then
    # predict for B_SCAN users and rank RANK_USERS x RANK_CANDS, each one
    # scoring call of K1 and K1-scale (rows <= max_score_rows). Held to the
    # plain path and to the same store on the CPU.
    hist = make_ctr_dataset(TAOBAO, N_FULL_USERS, seed=11)
    check(hist["seq_mask"].min() == 0.0, "DIEN histories have no padding")
    h_uids = np.arange(N_FULL_USERS)
    upd_i = rng.integers(1, TAOBAO.n_items, size=(UPDATE_ROUNDS, B_SCAN))
    upd_c = upd_i * 7 % (TAOBAO.n_cats - 1) + 1
    rk_i = rng.integers(1, TAOBAO.n_items, size=(RANK_USERS, RANK_CANDS))
    rk_c = rng.integers(1, TAOBAO.n_cats, size=(RANK_USERS, RANK_CANDS))
    pr_i, pr_c = hist["target_item"][:B_SCAN], hist["target_cat"][:B_SCAN]
    model_cpu = copy.deepcopy(model_d).cpu()
    stores = {d: HistoryStore(cfg_d, m_, device=d)
              for d, m_ in (("cpu", model_cpu), (dev, model_d))}
    timings = {}
    for d, hs in stores.items():
        t0 = time.perf_counter()
        for lo in range(0, N_FULL_USERS, B_SCAN):
            sl = slice(lo, lo + B_SCAN)
            hs.ingest_histories(h_uids[sl], hist["item_seq"][sl],
                                hist["cat_seq"][sl], masks=hist["seq_mask"][sl])
        t_ing = time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in range(UPDATE_ROUNDS):
            hs.update(h_uids[:B_SCAN], upd_i[r], upd_c[r])
        timings[d] = (t_ing, time.perf_counter() - t0)
    store_d = stores[dev]
    torch.cuda.synchronize()
    zero_counters()
    t_pred, t_rank = [], []
    for _ in range(REQUEST_REPS):
        t0 = time.perf_counter()
        pred_d = store_d.predict(h_uids[:B_SCAN], pr_i, pr_c)
        t_pred.append(time.perf_counter() - t0)
    for _ in range(REQUEST_REPS):
        t0 = time.perf_counter()
        rank_d = store_d.rank(h_uids[:RANK_USERS], rk_i, rk_c)
        t_rank.append(time.perf_counter() - t0)
    serve_launches = counters()
    calls = 2 * REQUEST_REPS
    want = (calls,) + (0,) * 8 + (calls, 0, 0, 0)
    check(serve_launches == want, f"DIEN serving launches over {calls} "
          f"scoring calls: {serve_launches}, expected {want}")
    for name, sc in (("predict", pred_d), ("rank", rank_d)):
        check(np.isfinite(sc).all() and (sc > 0).all() and (sc < 1).all(),
              f"DIEN {name} scores not finite in (0, 1)")
    check(pred_d.shape == (B_SCAN,)
          and rank_d.shape == (RANK_USERS, RANK_CANDS), "DIEN score shapes")
    col_d = max(np.abs(rank_d[:, c] - store_d.predict(
        h_uids[:RANK_USERS], rk_i[:, c], rk_c[:, c])).max()
        for c in range(0, RANK_CANDS, 10))
    check(col_d <= TOL_READOUT, f"DIEN rank vs predict columns: {col_d:.3e}")
    # the plain path on the store's own scoring batch
    with torch.no_grad():
        b_plain = batch_from_numpy(store_d._batch_arrays(
            h_uids[:B_SCAN], store_d._rows_for(h_uids[:B_SCAN], False),
            pr_i, pr_c), device=dev)
        plain_scores = torch.sigmoid(apply_model(
            model_d, cfg_d, b_plain, plain=True)[0]).cpu().numpy()
    plain_err = float(np.abs(pred_d - plain_scores).max())
    check(plain_err <= TOL_SLICE, f"DIEN predict vs plain path: "
          f"{plain_err:.3e}")
    # the same store on the CPU (the plain scans on CPU tensors)
    pred_c = stores["cpu"].predict(h_uids[:B_SCAN], pr_i, pr_c)
    rank_c = stores["cpu"].rank(h_uids[:RANK_USERS], rk_i, rk_c)
    cpu_err = max(float(np.abs(pred_d - pred_c).max()),
                  float(np.abs(rank_d - rank_c).max()))
    check(cpu_err <= TOL_SLICE, f"DIEN store on the card vs on the CPU: "
          f"{cpu_err:.3e}")
    t_ing, t_upd = timings[dev]
    print(f"phase 9 serve taobao_dien HistoryStore W={store_d.window} "
          f"use_pallas f32 masked: ingest {N_FULL_USERS / t_ing:.1f} "
          f"histories/s (host; {N_FULL_USERS} left-padded, batches of "
          f"{B_SCAN}) | update {UPDATE_ROUNDS * B_SCAN / t_upd:.1f} events/s"
          f" (host) | predict {1e3 * np.median(t_pred):.3f} ms median of "
          f"{REQUEST_REPS} (first {1e3 * t_pred[0]:.3f}) ({B_SCAN} users) |"
          f" rank {1e3 * np.median(t_rank):.3f} ms median of {REQUEST_REPS} "
          f"(first {1e3 * t_rank[0]:.3f}) ({RANK_USERS}x{RANK_CANDS}) | "
          f"launches over {calls} scoring calls: gru_scan_fwd "
          f"{serve_launches[0]} gru_scan_fwd_scale {serve_launches[9]} | "
          f"checks: rank==predict {col_d:.2e}, plain path {plain_err:.2e}, "
          f"CPU store {cpu_err:.2e}: ok", flush=True)
    profile_work(9, lambda: store_d.predict(h_uids[:B_SCAN], pr_i, pr_c),
                 1e3 * np.median(t_pred), 1, "predict")
    profile_work(9, lambda: store_d.rank(h_uids[:RANK_USERS], rk_i, rk_c),
                 1e3 * np.median(t_rank), 1, "rank")
    del stores, model_cpu  # store_d serves again in phase 12
    torch.cuda.empty_cache()

    # ------------------------------------------------ 10. training driver --
    # The user's entry point, train() (python -m hpmn_tpu_torch.train.train):
    # data, loader, optimizer, eval, checkpoints, on the card with the
    # kernels. (a) amazon_hpmn on tests/test_train.py's _small_cfg settings
    # with use_pallas, against the same train() on the CPU (the kernels'
    # plain versions) from the same seeded weights. (b) xlong_hpmn at full
    # width (B 512, T 1000, six layers), n_examples cut to XLONG_EXAMPLES,
    # 16 steps with warmup, cosine, clipping and EMA, a checkpoint at each
    # improving eval; then a fresh train() resumed from the step-8 snapshot,
    # held to the uninterrupted run.
    driver_launches = {}

    def driver_run(name, c_t, device, log_to=None, capture_at=None,
                   perturb=0.0):
        """train(c_t) on device, the counters set to 0 just before and read
        just after -> (result, log lines, the parameters when step
        capture_at's loss is logged, launches, seconds). With ``perturb``,
        every initial weight w becomes w * (1 + perturb * n), n a seeded
        standard normal draw."""
        lines, held, captured = [], {}, {}

        def init(c_i, spec_i, device_i):
            held["model"] = init_model(c_i, spec_i.n_items, spec_i.n_cats,
                                       device=device_i)
            if perturb:
                g = torch.Generator().manual_seed(c_i.seed + 1)
                with torch.no_grad():
                    for p_ in held["model"].parameters():
                        p_.mul_(1 + perturb * torch.randn(
                            p_.shape, generator=g).to(p_.device))
            held["init"] = {n: p_.detach().clone() for n, p_ in
                            held["model"].named_parameters()}
            return held["model"]

        def log(line):
            lines.append(line)
            words = line.split()
            if capture_at is not None and words[:3] == [
                    "step", str(capture_at), "loss"]:
                captured.update({n: p.detach().clone() for n, p in
                                 held["model"].named_parameters()})
            if log_to is not None:
                log_to(line)

        seam = driver.init_model_for
        driver.init_model_for = init
        try:
            if device != "cpu":
                torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            res = driver.train(c_t, log=log, device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = counters()
        finally:
            driver.init_model_for = seam
        if device != "cpu":
            driver_launches[name] = launches
        res["params_init"] = held["init"]
        return res, lines, captured, launches, secs

    def eval_batches(c_e):
        """Eval batches of one VAL eval and of the TEST eval of c_e."""
        _, val_a, test_a, _ = driver.make_datasets(c_e)
        return tuple(-(-len(a["label"]) // c_e.eval_batch_size)
                     for a in (val_a, test_a))

    def expect(c_e, steps, evals, layers):
        """The launch counters of a run: K1 per layer and K5 once per
        train step and per eval batch, K2 per layer per train step."""
        n_val, n_test = eval_batches(c_e)
        n_eval = evals * n_val + n_test
        return ((layers * (steps + n_eval), layers * steps, 0, 0,
                 steps + n_eval) + (0,) * 8)

    cfg_a = driver.apply_overrides(get_config("amazon_hpmn"), [
        "n_examples=3000", "train.batch_size=64", "train.max_steps=200",
        "train.eval_every=100", "train.log_every=100",
        "train.early_stop_patience=100", "train.steps_per_dispatch=1",
        "eval_steps_per_dispatch=1", "model.use_pallas=true"])
    res_k, lines_k, _, launches_a, secs_k = driver_run(
        "driver_amazon", cfg_a, "cuda")
    res_p, _, _, _, secs_p = driver_run("driver_amazon_cpu", cfg_a, "cpu")
    want = expect(cfg_a, 200, 2, cfg_a.model.hpmn_layers)
    check(launches_a == want, f"phase 10 amazon driver launches "
          f"{launches_a}, expected {want} (K1, K2, K1-bf16, K2-bf16, K5, ...)")
    gaps = {"best_val_auc": abs(res_k["best_val_auc"] - res_p["best_val_auc"]),
            "test_auc": abs(res_k["test"]["auc"] - res_p["test"]["auc"]),
            "test_log_loss": abs(res_k["test"]["log_loss"]
                                 - res_p["test"]["log_loss"])}
    tols = {"best_val_auc": TOL_DRIVER, "test_auc": TOL_DRIVER,
            "test_log_loss": TOL_DRIVER_LOG_LOSS}
    for key, gap in gaps.items():
        check(np.isfinite(gap) and gap < tols[key], f"phase 10 amazon "
              f"driver: {key} on the card vs the CPU differ by {gap} (tol "
              f"{tols[key]})")
    check(res_k["params"].keys() == res_p["params"].keys(),
          "phase 10 amazon driver: the card and CPU runs' parameters differ "
          "in names")
    param_err = max((res_k["params"][n].cpu() - res_p["params"][n]
                     ).abs().max().item() for n in res_p["params"])
    param_max = max(p.abs().max().item() for p in res_p["params"].values())
    check(param_err <= TOL_DRIVER_PARAMS * param_max, f"phase 10 amazon "
          f"driver: step-200 parameters on the card vs the CPU off by "
          f"{param_err:.3e} (max abs {param_max:.3e}, tol "
          f"{TOL_DRIVER_PARAMS} of it)")
    eps_a = [float(line.split()[7]) for line in lines_k
             if line.split()[2:3] == ["loss"]]
    print(f"phase 10 driver amazon_hpmn B=64 T={AMAZON.seq_len} L="
          f"{cfg_a.model.hpmn_layers} 200 steps use_pallas: card "
          f"best_val_auc {res_k['best_val_auc']:.4f} test auc "
          f"{res_k['test']['auc']:.4f} log_loss "
          f"{res_k['test']['log_loss']:.4f} | CPU (plain) "
          f"{res_p['best_val_auc']:.4f} {res_p['test']['auc']:.4f} "
          f"{res_p['test']['log_loss']:.4f} | gaps "
          + ", ".join(f"{k_} {v:.2e} (tol {tols[k_]})"
                      for k_, v in gaps.items())
          + f" | step-200 parameters {param_err:.3e} of max abs "
          f"{param_max:.3e} ({param_err / param_max:.2e}, tol "
          f"{TOL_DRIVER_PARAMS}) | driver ex/s "
          + ", ".join(f"{e:.1f}" for e in eps_a)
          + f" | wall card {secs_k:.1f} s, CPU {secs_p:.1f} s | launches "
          f"gru_scan_fwd {launches_a[0]} gru_scan_bwd {launches_a[1]} "
          f"readout_fwd {launches_a[4]} (= expected) | "
          + " | ".join(line for line in lines_k
                       if line.startswith(("goodput", "eval "))),
          flush=True)
    del res_k, res_p
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    work12 = tempfile.mkdtemp(prefix="chip_smoke_bundles_")
    try:
        cfg_x = driver.apply_overrides(get_config("xlong_hpmn"), [
            f"n_examples={XLONG_EXAMPLES}", "train.max_steps=16",
            "train.eval_every=8", "train.log_every=4",
            "train.early_stop_patience=100", "train.steps_per_dispatch=1",
            "eval_steps_per_dispatch=1", "eval_batch_size=256",
            "model.use_pallas=true", "train.lr_schedule=cosine",
            "train.warmup_steps=4", "train.grad_clip_norm=1.0",
            "train.ema_decay=0.9",
            f"train.ckpt_dir={os.path.join(work, 'whole')}"])
        L_x = cfg_x.model.hpmn_layers

        def show(line):
            print(f"phase 10 driver xlong_hpmn | {line}", flush=True)

        res_w, lines_w, params_w, launches_w, secs_w = driver_run(
            "driver_xlong", cfg_x, "cuda", log_to=show, capture_at=16)
        check(launches_w == expect(cfg_x, 16, 2, L_x),
              f"phase 10 xlong driver launches {launches_w}, expected "
              f"{expect(cfg_x, 16, 2, L_x)}")
        check(os.path.isdir(os.path.join(work, "whole", "8")),
              "phase 10: no step-8 checkpoint")
        # the checkpoints of this run export to bundles in phase 12
        shutil.copytree(os.path.join(work, "whole"),
                        os.path.join(work12, "ckpt"))
        shutil.copytree(os.path.join(work, "whole", "8"),
                        os.path.join(work, "resumed", "8"))
        cfg_r = driver.apply_overrides(cfg_x, [
            f"train.ckpt_dir={os.path.join(work, 'resumed')}"])
        res_r, lines_r, params_r, launches_r, secs_r = driver_run(
            "driver_xlong_resumed", cfg_r, "cuda", capture_at=16)
        check("resumed from step 8" in lines_r, "phase 10: the fresh "
              "train() did not resume from step 8")
        check(launches_r == expect(cfg_x, 8, 1, L_x),
              f"phase 10 resumed launches {launches_r}, expected "
              f"{expect(cfg_x, 8, 1, L_x)}")
        check(params_w.keys() == params_r.keys() and len(params_w) > 0,
              "phase 10: the step-16 parameters were not captured")
        same = all(torch.equal(params_w[n], params_r[n]) for n in params_w)
        resume_err = max((params_w[n] - params_r[n]).abs().max().item()
                         for n in params_w)
        max_abs = max(p.abs().max().item() for p in params_w.values())
        ema_err = max((res_w["ema_params"][n] - res_r["ema_params"][n]
                       ).abs().max().item() for n in params_w)
        check(same or resume_err <= TOL_RESUME * max_abs,
              f"phase 10: resumed step-16 parameters off by {resume_err:.3e}"
              f" (max abs {max_abs:.3e}, tol {TOL_RESUME} of it)")
        for res_ in (res_w, res_r):
            check(all(np.isfinite(res_["test"][k_]) for k_ in
                      ("auc", "log_loss")) and res_["best_step"] in (8, 16),
                  f"phase 10 xlong: test metrics {res_['test']}")
        eps_x = [float(line.split()[7]) for line in lines_w
                 if line.split()[2:3] == ["loss"]]
        good = next(line for line in lines_w if line.startswith("goodput"))
        pauses = next(line for line in lines_w if line.startswith("eval "))
        print(f"phase 10 driver xlong_hpmn B={cfg_x.train.batch_size} "
              f"T={XLONG.seq_len} L={L_x} n_examples={XLONG_EXAMPLES} 16 "
              f"steps (warmup 4, cosine, clip 1.0, EMA 0.9, checkpoints): "
              f"driver ex/s " + ", ".join(f"{e:.1f}" for e in eps_x)
              + f" (steps 4, 8, 12, 16) | {good} | {pauses} | wall "
              f"{secs_w:.1f} s | test auc {res_w['test']['auc']:.4f} "
              f"log_loss {res_w['test']['log_loss']:.4f} | resumed from step"
              f" 8: step-16 parameters "
              + ("bit for bit" if same else
                 f"within {resume_err:.3e} (not bit for bit; tol "
                 f"{TOL_RESUME} of max abs {max_abs:.3e})")
              + f", EMA max abs diff {ema_err:.3e}, test auc "
              f"{res_r['test']['auc']:.4f} | launches gru_scan_fwd "
              f"{launches_w[0]} gru_scan_bwd {launches_w[1]} readout_fwd "
              f"{launches_w[4]}; resumed {launches_r[0]}, {launches_r[1]}, "
              f"{launches_r[4]} (= expected)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # ------------------------------- 11. real data and the baselines --
    # The paper's Amazon comparison on preprocessed logs: (a) a seeded
    # Amazon dump through python -m hpmn_tpu_torch.data.process_amazon, then
    # amazon_gru4rec (K1, K2) and amazon_rum through train() on that
    # data_dir, each against the same run on the CPU; (b) a store per
    # trained model on the test split's histories; (c) a seeded XLong log
    # of about 3.4M rows through process_xlong (the native parser), then
    # xlong_hpmn at full width on it through the native batcher.
    t11 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    work11 = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        def cli(name, *args):
            """python -m hpmn_tpu_torch.data.<name> args -> (its line,
            seconds)."""
            t0_ = time.perf_counter()
            out_ = subprocess.run(
                [sys.executable, "-m", f"hpmn_tpu_torch.data.{name}", *args],
                cwd=repo, capture_output=True, text=True, timeout=300)
            check(out_.returncode == 0, f"phase 11 {name} exited "
                  f"{out_.returncode}: {out_.stderr[-2000:]}")
            return out_.stdout.strip(), time.perf_counter() - t0_

        t0 = time.perf_counter()
        n_reviews = write_amazon_dump(work11, cfg.seed)
        t_write = time.perf_counter() - t0
        amazon_dir = os.path.join(work11, "amazon")
        line_a, t_amazon = cli(
            "process_amazon", "--reviews",
            os.path.join(work11, "reviews.json"), "--meta",
            os.path.join(work11, "meta.json"), "--out",
            os.path.join(amazon_dir, "amazon.npz"))
        print(f"phase 11 data amazon: {AMAZON_USERS} reviewers x "
              f"{AMAZON_REVIEWS[0]}-{AMAZON_REVIEWS[1]} reviews "
              f"({n_reviews} reviews, written in {t_write:.1f} s), "
              f"{AMAZON_ITEMS} items, {AMAZON_CATS} categories | "
              f"process_amazon {t_amazon:.1f} s: {line_a}", flush=True)

        store_launches = {}
        for family in ("gru4rec", "rum"):
            c_b = driver.apply_overrides(get_config(f"amazon_{family}"), [
                f"data_dir={amazon_dir}", f"train.max_steps={BASELINE_STEPS}",
                f"train.eval_every={VAL_CHECK_STEP}",
                f"train.log_every={CAPTURE_STEP}",
                "train.early_stop_patience=100", "train.steps_per_dispatch=1",
                "eval_steps_per_dispatch=1", "model.use_pallas=true"])
            name_b = f"driver_amazon_{family}"
            res_k, lines_k, early_k, launches_b, secs_k = driver_run(
                name_b, c_b, "cuda", capture_at=CAPTURE_STEP)
            res_p, _, early_p, _, secs_p = driver_run(
                name_b + "_cpu", c_b, "cpu", capture_at=CAPTURE_STEP)
            res_q, _, _, _, secs_q = driver_run(
                name_b + "_perturbed", c_b, "cuda", perturb=PERTURB)
            if family == "rum":
                # The same run again in this process: bit for bit.
                res_k2 = driver_run(name_b + "_again", c_b, "cuda")[0]
                repeat = max((res_k2["params"][n] - res_k["params"][n]
                              ).abs().max().item() for n in res_k["params"])
                check(repeat == 0.0, f"phase 11 {name_b}: a second card "
                      f"run's step-{BASELINE_STEPS} parameters differ from "
                      f"the first's by {repeat:.3e}")
                print(f"phase 11 driver amazon_rum: two card runs in one "
                      f"process, step-{BASELINE_STEPS} parameter gap "
                      f"{repeat:.1e} (must be 0)", flush=True)
                del res_k2
            n_val, n_test = eval_batches(c_b)
            n_eval = (BASELINE_STEPS // VAL_CHECK_STEP) * n_val + n_test
            want_b = ((BASELINE_STEPS + n_eval, BASELINE_STEPS)
                      if family == "gru4rec" else (0, 0)) + (0,) * 11
            check(launches_b == want_b, f"phase 11 {name_b} launches "
                  f"{launches_b}, expected {want_b}")

            def param_gap(a_, b_):
                return (max((a_[n].cpu() - b_[n].cpu()).abs().max().item()
                            for n in b_)
                        / max(p.abs().max().item() for p in b_.values()))

            def loss_at(res_, step_):
                return next(h["log_loss"] for h in res_["history"]
                            if h["step"] == step_)

            end_loss = abs(res_k["test"]["log_loss"]
                           - res_p["test"]["log_loss"])
            end_params = param_gap(res_k["params"], res_p["params"])
            floor_loss = max(abs(res_q["test"]["log_loss"]
                                 - res_k["test"]["log_loss"]),
                             abs(loss_at(res_q, BASELINE_STEPS)
                                 - loss_at(res_k, BASELINE_STEPS)))
            floor_params = param_gap(res_q["params"], res_k["params"])
            gaps = {"best_val_auc": (abs(res_k["best_val_auc"]
                                         - res_p["best_val_auc"]), TOL_DRIVER),
                    "test_auc": (abs(res_k["test"]["auc"]
                                     - res_p["test"]["auc"]), TOL_DRIVER),
                    f"step-{VAL_CHECK_STEP} val_log_loss": (abs(
                        loss_at(res_k, VAL_CHECK_STEP)
                        - loss_at(res_p, VAL_CHECK_STEP)),
                        TOL_DRIVER_LOG_LOSS),
                    f"step-{CAPTURE_STEP} parameters over max abs": (
                        param_gap(early_k, early_p), TOL_DRIVER_PARAMS),
                    "test_log_loss": (end_loss, DIVERGENCE_FACTOR * max(
                        floor_loss, TOL_DRIVER_LOG_LOSS)),
                    f"step-{BASELINE_STEPS} parameters over max abs": (
                        end_params, DIVERGENCE_FACTOR * floor_params)}
            for key, (gap, tol) in gaps.items():
                check(np.isfinite(gap) and gap <= tol, f"phase 11 {name_b}: "
                      f"{key} on the card vs the CPU differ by {gap:.3e} "
                      f"(tol {tol:.3e}) | " + ", ".join(
                          f"{k_} {v:.2e} (tol {t_:.2e})"
                          for k_, (v, t_) in gaps.items()))
            eps_b = sorted(float(line.split()[7]) for line in lines_k
                           if line.split()[2:3] == ["loss"])
            n_items_b = res_k["params"]["embedding.item"].shape[0]
            print(f"phase 11 driver amazon_{family} data_dir B="
                  f"{c_b.train.batch_size} T={AMAZON.seq_len} "
                  f"{BASELINE_STEPS} steps use_pallas (tables sized from "
                  f"the data: {n_items_b} items, "
                  f"{res_k['params']['embedding.cat'].shape[0]} cats): card "
                  f"best_val_auc {res_k['best_val_auc']:.4f} test auc "
                  f"{res_k['test']['auc']:.4f} log_loss "
                  f"{res_k['test']['log_loss']:.6f} | CPU "
                  f"{res_p['best_val_auc']:.4f} {res_p['test']['auc']:.4f} "
                  f"{res_p['test']['log_loss']:.6f} | card from weights "
                  f"perturbed by {PERTURB}: {res_q['test']['auc']:.4f} "
                  f"{res_q['test']['log_loss']:.6f}, its distance from the "
                  f"card run: log-loss {floor_loss:.2e} (the larger of "
                  f"TEST and step-{BASELINE_STEPS} VAL), parameters "
                  f"{floor_params:.2e} of max abs | card vs CPU "
                  + ", ".join(f"{k_} {v:.2e} (tol {t_:.2e})"
                              for k_, (v, t_) in gaps.items())
                  + f" | driver ex/s min {eps_b[0]:.1f} median "
                  f"{eps_b[len(eps_b) // 2]:.1f} max {eps_b[-1]:.1f} over "
                  f"{len(eps_b)} windows of {CAPTURE_STEP} steps | wall card "
                  f"{secs_k:.1f} s and {secs_q:.1f} s, CPU {secs_p:.1f} s | "
                  f"launches gru_scan_fwd {launches_b[0]} gru_scan_bwd "
                  f"{launches_b[1]} (= expected)", flush=True)

            # (b) the store of the trained model, on the test split.
            _, _, test_b, spec_b = driver.make_datasets(c_b)
            model_b = init_model(c_b, spec_b.n_items, spec_b.n_cats,
                                 device=dev)
            model_b.load_state_dict(res_k["params"])
            model_c = copy.deepcopy(model_b).cpu()
            first = test_b["label"] > 0.5  # one row per user
            users = test_b["uid"][first]
            hist = {f: test_b[f][first] for f in ("item_seq", "cat_seq",
                                                  "seq_mask")}
            check(len(np.unique(users)) == len(users), "phase 11: a test "
                  "user with two positive rows")
            stores = [UserMemoryStore(c_b, m_, device=m_.embedding.item.device)
                      for m_ in (model_b, model_c)]
            torch.cuda.synchronize()
            zero_counters()
            t0 = time.perf_counter()
            for lo in range(0, len(users), STORE_BATCH):
                sl = slice(lo, lo + STORE_BATCH)
                stores[0].ingest_histories(users[sl], hist["item_seq"][sl],
                                           hist["cat_seq"][sl],
                                           masks=hist["seq_mask"][sl])
            torch.cuda.synchronize()
            t_ingest = time.perf_counter() - t0
            ingest_l = counters()
            n_batches = -(-len(users) // STORE_BATCH)
            check(ingest_l[0] == (n_batches if family == "gru4rec" else 0)
                  and sum(ingest_l) == ingest_l[0], f"phase 11 "
                  f"{family} store ingest launches {ingest_l}, expected "
                  f"K1 once per batch of {STORE_BATCH}")
            store_launches[family] = ingest_l[0]
            stores[1].ingest_histories(users, hist["item_seq"],
                                       hist["cat_seq"],
                                       masks=hist["seq_mask"])
            got = stores[0].predict(test_b["uid"], test_b["target_item"],
                                    test_b["target_cat"])
            with torch.no_grad():
                logits, _ = apply_model(model_b, c_b, batch_from_numpy(
                    test_b, device=dev))
            want_s = torch.sigmoid(logits).cpu().numpy()
            err_train = float(np.abs(got - want_s).max())
            check(err_train <= TOL_STORE, f"phase 11 {family} store scores "
                  f"vs the training path's off by {err_train:.3e}")
            got_cpu = stores[1].predict(test_b["uid"], test_b["target_item"],
                                        test_b["target_cat"])
            err_cpu = float(np.abs(got - got_cpu).max())
            check(err_cpu <= TOL_GRU, f"phase 11 {family} store on the card"
                  f" vs the CPU off by {err_cpu:.3e}")
            # One event at a time for ONE_BY_ONE_USERS users, into fresh
            # rows, against their ingested state.
            one = np.arange(ONE_BY_ONE_USERS)
            fresh = users[one] + 10 ** 7
            for t_ in range(AMAZON.seq_len):
                on = one[hist["seq_mask"][one, t_] > 0]
                if on.size:
                    stores[0].update(fresh[on], hist["item_seq"][on, t_],
                                     hist["cat_seq"][on, t_])
            m_i, c_i = stores[0]._gather(users[one])
            m_u, c_u = stores[0]._gather(fresh)
            err_one = (m_i - m_u).abs().max().item()
            check(err_one <= TOL_STORE and torch.equal(c_i, c_u),
                  f"phase 11 {family}: one-by-one updates vs the ingest off"
                  f" by {err_one:.3e} (counters {torch.equal(c_i, c_u)})")
            cands = test_b["target_item"][:100]
            cand_i = np.tile(cands, (64, 1))
            cand_c = np.tile(test_b["target_cat"][:100], (64, 1))
            t0 = time.perf_counter()
            ranked = stores[0].rank(users[:64], cand_i, cand_c)
            t_rank = time.perf_counter() - t0
            col0 = stores[0].predict(users[:64], cand_i[:, 0], cand_c[:, 0])
            check(np.abs(ranked[:, 0] - col0).max() <= 1e-6, f"phase 11 "
                  f"{family}: rank's column 0 vs predict")
            print(f"phase 11 store amazon_{family}: {len(users)} test users "
                  f"ingested in {n_batches} batches ({t_ingest:.3f} s; "
                  f"gru_scan_fwd launches {ingest_l[0]}) | scores vs the "
                  f"training path's logits {err_train:.2e} (tol {TOL_STORE})"
                  f", vs the CPU store {err_cpu:.2e} (tol {TOL_GRU}) | "
                  f"{ONE_BY_ONE_USERS} users one event at a time vs the "
                  f"ingest {err_one:.2e}, counters equal | rank 64 x 100 "
                  f"{1e3 * t_rank:.3f} ms", flush=True)
            del res_k, res_p, res_q, stores, model_b, model_c
        torch.cuda.empty_cache()

        # (c) XLong through the native parser and batcher, at full width.
        xlong_csv = os.path.join(work11, "xlong.csv")
        t0 = time.perf_counter()
        n_rows = write_xlong_csv(xlong_csv, cfg.seed)
        t_write = time.perf_counter() - t0
        xlong_dir = os.path.join(work11, "xlong")
        line_x, t_xlong = cli("process_xlong", "--log", xlong_csv, "--out",
                              os.path.join(xlong_dir, "xlong.npz"))
        check(native.available(), "phase 11: the native parser is not "
              "built")
        t0 = time.perf_counter()
        events = native.parse_csv(xlong_csv)
        t_parse = time.perf_counter() - t0
        check(len(events["uid"]) == n_rows, f"phase 11: the parser read "
              f"{len(events['uid'])} of {n_rows} rows")
        # The native route interns ids in first-seen order, process_log by
        # frequency: the CLI's arrays equal the native pipeline's, so the
        # CLI took the native parser.
        native_arrays = preprocess.process_events(
            events["uid"], events["item"], events["cat"], events["ts"],
            XLONG.seq_len, min_events=1000)  # process_xlong's defaults
        with np.load(os.path.join(xlong_dir, "xlong.npz")) as z:
            same = all(np.array_equal(z[k_], v_)
                       for k_, v_ in native_arrays.items()) and all(
                int(z[f"_{k_}"]) == events[k_]
                for k_ in ("n_items", "n_cats", "n_users"))
        check(same, "phase 11: process_xlong's arrays are not the native "
              "parser's (it took the Python route)")
        del events, native_arrays
        print(f"phase 11 data xlong: {XLONG_USERS} users x "
              f"{XLONG_EVENTS[0]}-{XLONG_EVENTS[1]} events ({n_rows} rows, "
              f"written in {t_write:.1f} s) | process_xlong {t_xlong:.1f} s "
              f"through the native parser (its arrays = the native "
              f"pipeline's): {line_x} | native.parse_csv "
              f"{t_parse:.3f} s, {n_rows / t_parse:.1f} rows/s", flush=True)

        c_xd = driver.apply_overrides(get_config("xlong_hpmn"), [
            f"data_dir={xlong_dir}", "train.max_steps=16",
            "train.eval_every=8", "train.log_every=4",
            "train.early_stop_patience=100", "train.steps_per_dispatch=1",
            "eval_steps_per_dispatch=1", "eval_batch_size=256",
            "model.use_pallas=true"])
        L_xd = c_xd.model.hpmn_layers
        native_batcher.gathers = 0
        res_xd, lines_xd, _, launches_xd, secs_xd = driver_run(
            "driver_xlong_data_dir", c_xd, "cuda")
        gathers = native_batcher.gathers
        n_val, n_test = eval_batches(c_xd)
        check(launches_xd == expect(c_xd, 16, 2, L_xd), f"phase 11 xlong "
              f"driver launches {launches_xd}, expected "
              f"{expect(c_xd, 16, 2, L_xd)}")
        check(gathers >= 16 + 2 * n_val + n_test, f"phase 11: {gathers} "
              f"native gathers for 16 train and {2 * n_val + n_test} eval "
              "batches")
        check(all(np.isfinite(res_xd["test"][k_]) for k_ in ("auc",
                                                             "log_loss")),
              f"phase 11 xlong: test metrics {res_xd['test']}")
        train_x, _, _, spec_x = driver.make_datasets(c_xd)
        fields = list(train_x)
        rng11 = np.random.default_rng(cfg.seed)
        t_native, t_numpy = [], []
        for _ in range(GATHER_REPS):
            idx = rng11.integers(0, len(train_x["label"]),
                                 c_xd.train.batch_size)
            t0 = time.perf_counter()
            got_n = native_batcher.gather(train_x, idx)
            t_native.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got_p = {f: train_x[f][idx] for f in fields}
            t_numpy.append(time.perf_counter() - t0)
            check(all(np.array_equal(got_n[f], got_p[f]) for f in fields),
                  "phase 11: the native gather differs from numpy's")
        eps_xd = [float(line.split()[7]) for line in lines_xd
                  if line.split()[2:3] == ["loss"]]
        print(f"phase 11 driver xlong_hpmn data_dir B="
              f"{c_xd.train.batch_size} T={XLONG.seq_len} L={L_xd} 16 steps "
              f"use_pallas ({len(train_x['label'])} train examples; tables "
              f"{spec_x.n_items} items, {spec_x.n_cats} cats from the data): "
              f"driver ex/s " + ", ".join(f"{e:.1f}" for e in eps_xd)
              + f" (steps 4, 8, 12, 16) beside phase 5's bare step "
              f"{ex_per_s:.1f} | test auc {res_xd['test']['auc']:.4f} "
              f"log_loss {res_xd['test']['log_loss']:.4f} | wall "
              f"{secs_xd:.1f} s | native gathers {gathers} | batch of "
              f"{c_xd.train.batch_size} on the host, median of "
              f"{GATHER_REPS} alternating: native "
              f"{1e3 * np.median(t_native):.3f} ms "
              f"({native_batcher.n_threads()} threads), numpy "
              f"{1e3 * np.median(t_numpy):.3f} ms | launches gru_scan_fwd "
              f"{launches_xd[0]} gru_scan_bwd {launches_xd[1]} readout_fwd "
              f"{launches_xd[4]} (= expected)", flush=True)
        del res_xd, train_x
    finally:
        shutil.rmtree(work11, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 11 time: {time.perf_counter() - t11:.1f} s", flush=True)

    # ----------------------------------- 12. persistence and bundles --
    # Train to serve: phase 4's store and phase 9's DIEN store through
    # bundles (f32, int8) and the bf16 arena, the use_user_emb step, and
    # phase 10's checkpoint through the export_bundle and serve_batch CLIs.
    # ------------------------------ 13. the daemon and the AOT graphs --
    # Phase 12's bundles served over TCP by the daemon (subprocesses on the
    # card), the checkpoint exported with its graphs and served --aot, a
    # fleet of 2 shards, and the host's cost of the custom ops.
    try:
        p12 = SimpleNamespace(
            dev=dev, cfg=cfg, model=model, store=store, full=full,
            full_uids=full_uids, upd_uids=upd_uids, upd_items=upd_items,
            upd_cats=upd_cats, rank_uids=rank_uids, rank_items=rank_items,
            rank_cats=rank_cats, phase4=phase4, store_d=store_d,
            h_uids=h_uids, pr_i=pr_i, pr_c=pr_c, rk_i=rk_i, rk_c=rk_c,
            cfg_k=cfg_k, batch=batches[0], n_users=XLONG.n_users,
            step_check=step_check, counters=counters,
            zero_counters=zero_counters, work=work12,
            ckpt=os.path.join(work12, "ckpt"),
            ckpt_set=["model.use_pallas=true"], repo=repo, cli_device=[],
            platforms="cpu,cuda", dien_items=TAOBAO.n_items,
            dien_cats=TAOBAO.n_cats, dien_window=store_d.window)
        launches12 = phase_12(p12)
        launches13 = phase_13(p12)
    finally:
        shutil.rmtree(work12, ignore_errors=True)
    enq13 = p12.numbers13["enqueue"]
    store_d_window = store_d.window
    del store, store_d, p12
    torch.cuda.empty_cache()

    # ------------------------------------- 14. the remaining families --
    # xlong_bst's step, taobao_bst's HistoryStore, and the comparison table
    # of the ten families (hpmn, dien and gru4rec with their kernels).
    launches14 = phase_14(SimpleNamespace(
        dev=dev, counters=counters, zero_counters=zero_counters, repo=repo))

    # ---------------------------------- 15. data and model parallelism --
    # The sharded step and train() on 4 ranks of the card against one
    # process, the CLI under torch.distributed.run (NCCL), bf16 BST's
    # gradient gap.
    launches15 = phase_15(SimpleNamespace(dev=dev, repo=repo, card=card))

    # ------------------------------------------ 16. sequence parallelism --
    # The SP steps (xlong_hpmn and taobao_dien on (1, 2, 1), xlong on the
    # composed (1, 2, 2)) and train() on ranks of the card against one
    # process, layer 0's SP scan against the plain one.
    launches16 = phase_16(SimpleNamespace(card=card))

    # ------------------------- 17. the bf16 model and the last options --
    # xlong_hpmn and taobao_dien with model.dtype=bfloat16 through their
    # kernels, train() with log_dir and debug_nans, the quality gate and a
    # sweep.
    launches17 = phase_17(SimpleNamespace(
        dev=dev, seed=cfg.seed, cfg_k=cfg_k, cfg_d=cfg_d, batches=batches,
        stacks=stacks, k=k, timed_train=timed_train,
        profile_dispatch=profile_dispatch,
        dien_batches=dien_batches["f32 padded"], f32_eps=ex_per_s,
        f32_step_ms=step_ms, driver_run=driver_run, expect=expect,
        driver=driver, apply_overrides=driver.apply_overrides,
        get_config=get_config, repo=repo))

    def p17(i):
        """Phase 17's launches of main's counter i, by path."""
        return {k_: v[i] for k_, v in launches17.items() if v[i]}

    # ---------------------------------------------------------- 18. widths --
    # The width-general forms: the grid against the plain versions, their
    # times beside the d_m = 32 kernels and cuDNN, and the wide xlong step,
    # its store, the wide DIEN step and the mem_dim sweep.
    gen_entries, _ = phase_18(SimpleNamespace(
        dev=dev, seed=cfg.seed, k=k, cfg_k=cfg_k, cfg_d=cfg_d,
        batches=batches, stacks=stacks, dien_batches=dien_batches,
        step_check=step_check, counters=counters,
        zero_counters=zero_counters, profile_dispatch=profile_dispatch,
        repo=repo))

    def entry(name, src, rep, row, err, by_path, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": err, "ms": row[0], "plain_ms": row[1],
                "bound_ms": row[3], "bound_by": row[4],
                "library_ms": row[2], **extra}

    fd = dien_launches["f32 padded"]
    bd = dien_launches["bf16 full"]
    g = gru_rows[0]   # T=1000, no mask: the heaviest scan of both paths
    gb = bwd_rows[0]
    g16, gb16 = bf_rows[0], bfb_rows[0]
    r = ro_rows[0]    # B=512: predict's and the training step's shape;
    # ro_rows[1]: a rank chunk's 6400 rows
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s from main's "
          f"start to the kernels line", flush=True)
    print(json.dumps({"kernels": [
        entry("gru_scan_fwd", cuda_gru.SOURCE, cuda_gru.REPLACES,
              (g[3], g[4], g[5], g[6], g[7]), gru_err,
              {"serving": launches_gru, "training": train_launches[0],
               "training_dien": fd[0], "serving_dien": serve_launches[0],
               **{k_: v[0] for k_, v in driver_launches.items()},
               "store_gru4rec": store_launches["gru4rec"],
               **{k_: v[0] for k_, v in launches12.items()},
               **{k_: v["gru_scan_fwd"] for k_, v in launches13.items()
                  if "gru_scan_fwd" in v},
               **{k_: v[0] for k_, v in launches14.items()},
               **{k_: v[0] for k_, v in launches15.items()},
               **{k_: v[0] for k_, v in launches16.items() if v[0]},
               **p17(0)},
              sources=list(cuda_gru.FWD_SOURCES),
              host_us_op=enq13[f"gru_scan_fwd T={store_d_window} "
                               f"B={B_SCAN}"][0],
              host_us_direct=enq13[f"gru_scan_fwd T={store_d_window} "
                                   f"B={B_SCAN}"][1],
              projection_ms=proj_rows[0][2],
              projection_max_err_over_max_abs=proj_err_max),
        entry("gru_scan_bwd", cuda_gru.BWD_SOURCE, cuda_gru.BWD_REPLACES,
              (gb[3], gb[4], gb[5], gb[6], gb[7]), bwd_abs,
              {"training": train_launches[1], "training_dien": fd[1],
               **{k_: v[1] for k_, v in driver_launches.items()},
               "training_user_emb": launches12["training_user_emb"][1],
               **{k_: v[1] for k_, v in launches14.items()},
               **{k_: v[1] for k_, v in launches15.items()},
               **{k_: v[1] for k_, v in launches16.items() if v[1]},
               **p17(1)},
              sources=list(cuda_gru.BWD_SOURCES),
              max_err_over_max_abs=bwd_err,
              pass_ms=pass_first[torch.float32][1],
              pass_max_err_over_max_abs=pass_err[torch.float32]),
        entry("readout_fwd", cuda_readout.SOURCE, cuda_readout.REPLACES,
              (r[2], r[3], None, r[4], r[5]), ro_err,
              {"serving": launches_ro, "training": train_launches[4],
               "training_bf16": bf16_launches[4],
               "training_stride": stride_launches["f32"][4],
               "training_stride_bf16": stride_launches["bf16"][4],
               **{k_: v[4] for k_, v in driver_launches.items()},
               "bundle_hpmn": launches12["bundle_hpmn"][4],
               "training_user_emb": launches12["training_user_emb"][4],
               **{k_: v["readout_fwd"] for k_, v in launches13.items()
                  if "readout_fwd" in v},
               "compare_hpmn": launches14["compare_hpmn"][4],
               **{k_: v[2] for k_, v in launches15.items()}, **p17(4)},
              host_us_op=enq13[f"readout_fwd B={B_SCAN}"][0],
              host_us_direct=enq13[f"readout_fwd B={B_SCAN}"][1],
              host_us_op_rank=enq13[
                  f"readout_fwd B={READOUT_RANK_ROWS}"][0],
              host_us_direct_rank=enq13[
                  f"readout_fwd B={READOUT_RANK_ROWS}"][1],
              call_ms=r[6], host_us=r[7], device_ms_rank=ro_rows[1][2],
              call_ms_rank=ro_rows[1][6], host_us_rank=ro_rows[1][7],
              device_ms_from=f"torch.profiler kernel durations, mean "
                             f"over {READOUT_DEVICE_LAUNCHES} launches"),
        entry("gru_scan_fwd_bf16", cuda_gru.SOURCE_BF16,
              cuda_gru.REPLACES_BF16,
              (g16[3], g16[4], g16[5], g16[6], g16[7]), bf_err,
              {"training_bf16": bf16_launches[2],
               "training_dien_bf16": bd[2], **p17(2)},
              sources=list(cuda_gru.FWD_SOURCES),
              projection_ms=proj16_rows[0][3],
              projection_max_err_over_max_abs=proj16_err_max,
              projection_c_share_off_rounding=proj16_off_max,
              max_abs_diff_from_f32_kernel=bf_drift),
        entry("gru_scan_bwd_bf16", cuda_gru.BWD_SOURCE_BF16,
              cuda_gru.BWD_REPLACES_BF16,
              (gb16[3], gb16[4], gb16[5], gb16[6], gb16[7]), bfb_abs,
              {"training_bf16": bf16_launches[3],
               "training_dien_bf16": bd[3], **p17(3)},
              sources=list(cuda_gru.BWD_SOURCES),
              max_err_over_max_abs=bfb_err,
              diff_from_f32_kernel_over_max_abs=bfb_drift,
              pass_ms=pass_first[torch.bfloat16][1],
              pass_max_err_over_max_abs=pass_err[torch.bfloat16]),
        *(entry(f"gru_stride_{name}",
                cuda_gru_stride.BWD_SOURCE if "bwd" in name
                else cuda_gru_stride.SOURCE,
                cuda_gru_stride.BWD_REPLACES if "bwd" in name
                else cuda_gru_stride.REPLACES,
                st_rows[name][0][2:], st_abs[name],
                {f"training_stride{'_bf16' if 'bf16' in name else ''}":
                 stride_launches["bf16" if "bf16" in name else "f32"][
                     5 + ("bwd" in name) + 2 * ("bf16" in name)]},
                max_err_over_max_abs=st_err[name],
                diff_from_dense_kernel=st_vs_dense[name],
                **({"sources": [cuda_gru_stride.PROJ_SOURCE,
                                cuda_gru_stride.BWD_SOURCE,
                                cuda_gru_stride.PASS_SOURCE],
                    "recurrence_max_err_over_max_abs": rec_err[name],
                    "recurrence_h_prev_max_abs_err": rec_h_err[name]}
                   if "bwd" in name else
                   {"sources": [cuda_gru_stride.PROJ_SOURCE,
                                cuda_gru_stride.SOURCE],
                    "projection_ms": (proj16_rows if "bf16" in name
                                      else proj_rows)[0][-1]}))
          for name in ("fwd", "bwd", "fwd_bf16", "bwd_bf16")),
        # The AUGRU kernels at their path's form: f32 masked (the DIEN
        # config's default), bf16 without a mask (the flagship).
        *(entry(f"gru_scan_{name.replace('_bf16', '')}_scale"
                f"{'_bf16' if 'bf16' in name else ''}",
                cuda_gru.BWD_SOURCE_SCALE if "bwd" in name
                else cuda_gru.SOURCE_SCALE,
                cuda_gru.BWD_REPLACES_SCALE if "bwd" in name
                else cuda_gru.REPLACES_SCALE,
                (row[2], row[3], None, row[4], row[5]), sc_abs[name],
                ({"training_dien_bf16": bd[9 + idx]} if "bf16" in name
                 else {"training_dien": fd[9 + idx],
                       "compare_dien": launches14["compare_dien"][9 + idx],
                       **{k_: v[3 + idx] for k_, v in launches16.items()
                          if v[3 + idx]}, **p17(9 + idx),
                       **(
                     {"serving_dien": serve_launches[9],
                      "bundle_dien": launches12["bundle_dien"][9],
                      **{k_: v["gru_scan_fwd_scale"]
                         for k_, v in launches13.items()
                         if "gru_scan_fwd_scale" in v}}
                     if idx == 0 else {})}),
                **({"max_err_over_max_abs": sc_err[name],
                    "sources": list(cuda_gru.BWD_SOURCES),
                    "pass_ms": sc_pass[name, row[0]],
                    "recurrence_max_err_over_max_abs": sc_rec_err[name]}
                   if "bwd" in name else
                   {"sources": list(cuda_gru.FWD_SOURCES),
                    "projection_ms": sc_proj[name][1],
                    "projection_max_err_over_max_abs": sc_proj[name][0]}),
                masked=row[0])
          for idx, name in enumerate(("fwd", "bwd", "fwd_bf16", "bwd_bf16"))
          for row in [sc_rows[name][0 if "bf16" in name else 1]]),
        *gen_entries,
    ]}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
