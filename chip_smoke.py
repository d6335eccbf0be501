#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's xlong_hpmn serving path and training step
once on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a GPU

Phases, one line each (a failed check prints ``FAIL ...`` and exits 1
before the last line):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: compile the CUDA kernels from ``hpmn_tpu_torch/csrc`` (nvcc).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the paths' shapes, with its tolerance, its time, the plain time, the
   time of the one PyTorch call that computes the same (cuDNN's GRU for the
   scans), and the least time the card could take (bound).
4. serving: a ``UserMemoryStore`` on the card at the full width of
   xlong_hpmn (random seeded weights) ingests histories, takes updates,
   predicts and ranks; launch counters prove the path ran the kernels, and
   the outputs are checked against plain versions and each other.
5. training: the xlong_hpmn training step at B = 512, T = 1000 with the
   kernels (bench.py's flags), held against the plain path's loss and
   gradients, full and left-padded; then k = 8 steps per dispatch, timed,
   with launch counters; then one profiled dispatch for the device's
   busy share.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Without a CUDA device,
or away from the repo, it exits nonzero and prints no result. Imports
nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

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

# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W; the printed
# power limit says whether this card runs at it): float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

B_SCAN = 512  # the JAX config's batch, also the ingest batch below
N_FULL_USERS = 8192
N_PADDED_USERS = 512
UPDATE_ROUNDS = 4
RANK_USERS, RANK_CANDS = 64, 100
REQUEST_REPS = 5  # predict and rank calls, timed one by one
STEPS_PER_DISPATCH = 8
WARMUP_DISPATCHES, TIMED_DISPATCHES = 2, 3
N_TRAIN_BATCHES = 4  # distinct batches, cycled as bench.py does


def fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def bound(flops, n_bytes):
    """-> (ms, "operations" or "bytes"): the least time for the work."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def scan_fwd_work(T, B, d_in, masked):
    """K1: x@wx and h@wh per row-step; x and the mask read, h_seq written."""
    flops = 2 * T * B * (d_in + 32) * 96
    n_bytes = 4 * (T * B * (d_in + 32) + (T * B if masked else 0)
                   + (d_in + 33) * 96)
    return flops, n_bytes


def scan_bwd_work(T, B, d_in, masked):
    """K2: the recompute, dh, dx, dWx and dWh products per row-step; x,
    h_seq, dh_seq and the mask read; dx, dh0 and the gradients written."""
    flops = 2 * T * B * 96 * (3 * d_in + 3 * 32)
    n_bytes = 4 * (T * B * (2 * d_in + 64) + (T * B if masked else 0)
                   + B * 32 + 2 * (d_in + 33) * 96)
    return flops, n_bytes


def readout_work(B, L, d_q):
    """K5: memory and query through wm, wq and the scores; memory and query
    read, the read written."""
    flops = 2 * B * 32 * (L * 32 + d_q + L) + 2 * B * L * 32
    n_bytes = 4 * (B * (L * 32 + d_q + 32) + (32 + d_q + 2) * 32)
    return flops, n_bytes


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hpmn_tpu_torch.configs import get_config
        from hpmn_tpu_torch.data.synthetic import XLONG, make_ctr_dataset
        from hpmn_tpu_torch.models.embedding import dense_lookup
        from hpmn_tpu_torch.models.hpmn import (encode_hierarchical_tm,
                                                encode_oracle)
        from hpmn_tpu_torch.data.schema import batch_from_numpy
        from hpmn_tpu_torch.models.model import init_model, loss_fn
        from hpmn_tpu_torch.models.readout import attention_readout
        from hpmn_tpu_torch.models.tower import apply_tower
        from hpmn_tpu_torch.ops import _build, cuda_gru, cuda_readout
        from hpmn_tpu_torch.ops.gru import gru_scan_tm, gru_scan_tm_bwd
        from hpmn_tpu_torch.serving.lifelong import UserMemoryStore
        from hpmn_tpu_torch.train.train import (make_multistep_train,
                                                make_optimizer)
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

    def left_pad_mask(T, B):
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        pos = torch.arange(T, device=dev)[:, None]
        return (pos >= T - lens[None, :]).float().contiguous()  # [T, B]

    def cudnn_gru(layer, d_in):
        """The library yardstick: torch.nn.GRU (cuDNN) computing the same
        scan as K1: our z is torch's 1 - z, so the z blocks of wx, wh and b
        are negated, and the hidden-side bias is 0. Timed only."""
        g = torch.nn.GRU(d_in, 32).to(dev)
        neg = torch.ones(96, 1, device=dev)
        neg[32:64] = -1.0
        with torch.no_grad():
            g.weight_ih_l0.copy_(layer.wx.T * neg)
            g.weight_hh_l0.copy_(layer.wh.T * neg)
            g.bias_ih_l0.copy_(layer.b * neg[:, 0])
            g.bias_hh_l0.zero_()
        return g

    T_l = [XLONG.seq_len]
    for _ in range(m.hpmn_layers - 1):
        T_l.append(T_l[-1] // m.hpmn_period)
    gru_err, gru_rows = 0.0, []
    bwd_err, bwd_abs, bwd_rows = 0.0, 0.0, []
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
            print(f"phase 3 kernel gru_scan_fwd T={T} B={B_SCAN} d_in={d_in} "
                  f"mask={masked}: max_abs_err {err:.3e} (tol {TOL_GRU}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | library "
                  f"{'-' if lib_t is None else f'{lib_t:.4f}'} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)

            # K2 on K1's output, against the plain backward.
            got = cuda_gru.gru_scan_bwd(layer, x, mask, h_k, dh_seq)
            want = gru_scan_tm_bwd(layer, x, mask, h_k, dh_seq)
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
            print(f"phase 3 kernel gru_scan_bwd T={T} B={B_SCAN} d_in={d_in} "
                  f"mask={masked}: max_abs_err {absd:.3e}, over max abs "
                  f"{rel:.3e} (tol {TOL_GRAD}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | library "
                  f"{'-' if lib_t is None else f'{lib_t:.4f}'} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
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
        ms = cuda_ms(lambda: cuda_readout.fused_attention_readout(
            model.readout, mem, q), 50, warmup=3)
        plain_ms = cuda_ms(lambda: attention_readout(model.readout, mem, q),
                           50, warmup=3)
        b_ms, b_by = bound(*readout_work(B, m.hpmn_layers, 2 * m.emb_dim))
        ro_err = max(ro_err, err)
        ro_rows.append((B, err, ms, plain_ms, b_ms, b_by))
        print(f"phase 3 kernel readout_fwd B={B} L={m.hpmn_layers}: "
              f"max_abs_err {err:.3e} (tol {TOL_READOUT}) | kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms | library - | bound "
              f"{b_ms:.5f} ms ({b_by})", flush=True)

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

    # -------------------------------------------------------- 5. training --
    del store
    torch.cuda.empty_cache()
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

    def loss_and_grads(c, batch):
        model_g = init_model(c, XLONG.n_items, XLONG.n_cats, seed=cfg.seed,
                             device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model_g, c, batch)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.item(), dict(model_g.named_parameters()),
                time.perf_counter() - t0)

    step_rows = []
    for form, c_k, batch in (
            ("full", cfg_k, batches[0]),
            ("padded", cfg_k.with_model(assume_full_mask=False),
             padded_batch)):
        loss_k, p_k, t_k = loss_and_grads(c_k, batch)
        loss_p, p_p, t_p = loss_and_grads(c_k.with_model(use_pallas=False),
                                          batch)
        check(np.isfinite(loss_k), f"training loss ({form}) not finite")
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        check(loss_rel <= TOL_STEP_LOSS, f"step ({form}): loss {loss_k} vs "
              f"plain {loss_p}, relative {loss_rel:.3e} > {TOL_STEP_LOSS}")
        worst, worst_name = 0.0, ""
        for name, p in p_p.items():
            gk = p_k[name].grad
            check(gk is not None and torch.isfinite(gk).all().item(),
                  f"step ({form}): no finite gradient for {name}")
            rel = ((gk - p.grad).abs().max()
                   / p.grad.abs().max().clamp_min(1e-30)).item()
            if rel >= worst:
                worst, worst_name = rel, name
        check(worst <= TOL_STEP_GRAD, f"step ({form}): gradient of "
              f"{worst_name} off by {worst:.3e} of its max abs > "
              f"{TOL_STEP_GRAD}")
        step_rows.append((form, loss_rel, worst, worst_name))
        print(f"phase 5 step check {form} B={n_b} T={XLONG.seq_len}: loss "
              f"kernel {loss_k:.7f} plain {loss_p:.7f} (relative "
              f"{loss_rel:.2e}, tol {TOL_STEP_LOSS}) | {len(p_p)} gradients,"
              f" worst {worst_name} {worst:.2e} of max abs (tol "
              f"{TOL_STEP_GRAD}) | one step, first call: kernel path "
              f"{1e3 * t_k:.1f} ms, plain path {1e3 * t_p:.1f} ms", flush=True)
        del p_k, p_p
    torch.cuda.empty_cache()

    model_t = init_model(cfg_k, XLONG.n_items, XLONG.n_cats, seed=cfg.seed,
                         device=dev)
    multistep = make_multistep_train(cfg_k, model_t,
                                     make_optimizer(cfg_k,
                                                    model_t.parameters()))
    k = STEPS_PER_DISPATCH
    stacks = [[batches[(i + j) % N_TRAIN_BATCHES] for j in range(k)]
              for i in range(N_TRAIN_BATCHES)]
    torch.cuda.synchronize()
    cuda_gru.launches = cuda_gru.bwd_launches = cuda_readout.launches = 0
    for i in range(WARMUP_DISPATCHES):
        metrics = multistep(stacks[i % N_TRAIN_BATCHES])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP_DISPATCHES, WARMUP_DISPATCHES + TIMED_DISPATCHES):
        metrics = multistep(stacks[i % N_TRAIN_BATCHES])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    train_launches = (cuda_gru.launches, cuda_gru.bwd_launches,
                      cuda_readout.launches)
    n_steps = (WARMUP_DISPATCHES + TIMED_DISPATCHES) * k
    metrics = {name: v.item() for name, v in metrics.items()}
    check(all(np.isfinite(v) for v in metrics.values()),
          f"training metrics not finite: {metrics}")
    check(train_launches == (L * n_steps, L * n_steps, n_steps),
          f"launches over {n_steps} steps: gru_scan_fwd, gru_scan_bwd, "
          f"readout_fwd = {train_launches}, expected {L}, {L} and 1 per step")
    step_ms = 1e3 * t_train / (TIMED_DISPATCHES * k)
    ex_per_s = TIMED_DISPATCHES * k * n_b / t_train
    print(f"phase 5 train xlong_hpmn B={n_b} T={XLONG.seq_len} L={L} f32, "
          f"{k} steps per dispatch: {ex_per_s:.1f} examples/s ({step_ms:.3f}"
          f" ms per step, {TIMED_DISPATCHES} dispatches after "
          f"{WARMUP_DISPATCHES} warm-up, {N_TRAIN_BATCHES} batches cycled) | "
          f"last step loss {metrics['loss']:.6f} bce {metrics['bce']:.6f} "
          f"cov_reg {metrics['cov_reg']:.3e} l2 {metrics['l2']:.3f} | "
          f"launches over {n_steps} steps: gru_scan_fwd {train_launches[0]}"
          f" gru_scan_bwd {train_launches[1]} readout_fwd "
          f"{train_launches[2]} ({L}, {L}, 1 per step)", flush=True)

    # One more dispatch under the profiler: the device's kernel time per
    # step against the unprofiled wall time per step above.
    # Only kernels count: a CPU op (or an autograd Function's record) that
    # launches a kernel also reports that kernel's time as its own, and a
    # user annotation (the optimizer's step) spans kernels listed apart.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        multistep(stacks[0])
        torch.cuda.synchronize()
    kern = sorted(((a.self_device_time_total, a.count, a.key)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA
                   and not getattr(a, "is_user_annotation", False)
                   and a.self_device_time_total > 0), reverse=True)
    dev_ms = sum(t for t, _, _ in kern) / 1e3 / k
    if dev_ms > 0:
        top = ", ".join(f"{name[:48]} {t / 1e3 / k:.3f} ms ({n / k:g}/step)"
                        for t, n, name in kern[:10])
        print(f"phase 5 profile: device kernel time {dev_ms:.3f} ms per step"
              f" of {step_ms:.3f} ms wall: busy {dev_ms / step_ms:.1%}, idle "
              f"{1 - dev_ms / step_ms:.1%} | top: {top}", flush=True)
    else:
        print("phase 5 profile: the profiler saw no device time; device "
              "busy share not measured", flush=True)

    def entry(name, src, rep, row, err, by_path, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": err, "ms": row[0], "plain_ms": row[1],
                "bound_ms": row[3], "bound_by": row[4],
                "library_ms": row[2], **extra}

    g = gru_rows[0]   # T=1000, no mask: the heaviest scan of both paths
    gb = bwd_rows[0]
    r = ro_rows[0]    # B=512: predict's and the training step's shape
    print(json.dumps({"kernels": [
        entry("gru_scan_fwd", cuda_gru.SOURCE, cuda_gru.REPLACES,
              (g[3], g[4], g[5], g[6], g[7]), gru_err,
              {"serving": launches_gru, "training": train_launches[0]}),
        entry("gru_scan_bwd", cuda_gru.BWD_SOURCE, cuda_gru.BWD_REPLACES,
              (gb[3], gb[4], gb[5], gb[6], gb[7]), bwd_abs,
              {"training": train_launches[1]},
              max_err_over_max_abs=bwd_err),
        entry("readout_fwd", cuda_readout.SOURCE, cuda_readout.REPLACES,
              (r[2], r[3], None, r[4], r[5]), ro_err,
              {"serving": launches_ro, "training": train_launches[2]}),
    ]}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
