#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's xlong_hpmn serving path once on one GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a GPU

Phases, one line each (a failed check prints ``FAIL ...`` and exits 1
before the last line):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: compile the CUDA kernels from ``hpmn_tpu_torch/csrc`` (nvcc).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the slice's shapes, with its tolerance, its time and the plain time.
4. slice: a ``UserMemoryStore`` on the card at the full width of
   xlong_hpmn (random seeded weights) ingests histories, takes updates,
   predicts and ranks; launch counters prove the path ran the kernels, and
   the outputs are checked against plain versions and each other.

Then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or away from the
repo, it exits nonzero and prints no result. Imports nothing of JAX.
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

B_SCAN = 512  # the JAX config's batch, also the ingest batch below
N_FULL_USERS = 8192
N_PADDED_USERS = 512
UPDATE_ROUNDS = 4
RANK_USERS, RANK_CANDS = 64, 100
REQUEST_REPS = 5  # predict and rank calls, timed one by one


def fail(msg):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


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
        from hpmn_tpu_torch.models.model import init_model
        from hpmn_tpu_torch.models.readout import attention_readout
        from hpmn_tpu_torch.models.tower import apply_tower
        from hpmn_tpu_torch.ops import _build, cuda_gru, cuda_readout
        from hpmn_tpu_torch.ops.gru import gru_scan_tm
        from hpmn_tpu_torch.serving.lifelong import UserMemoryStore
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

    T_l = [XLONG.seq_len]
    for _ in range(m.hpmn_layers - 1):
        T_l.append(T_l[-1] // m.hpmn_period)
    gru_err, gru_rows = 0.0, []
    for l, T in enumerate(T_l):
        layer = model.encoder.layers[l]
        d_in = layer.wx.shape[0]
        x = torch.randn(T, B_SCAN, d_in, generator=gen, device=dev)
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
            gru_err = max(gru_err, err)
            gru_rows.append((T, masked, err, ms, plain_ms))
            print(f"phase 3 kernel gru_scan_fwd T={T} B={B_SCAN} d_in={d_in} "
                  f"mask={masked}: max_abs_err {err:.3e} (tol {TOL_GRU}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms", flush=True)

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
        ro_err = max(ro_err, err)
        ro_rows.append((B, err, ms, plain_ms))
        print(f"phase 3 kernel readout_fwd B={B} L={m.hpmn_layers}: "
              f"max_abs_err {err:.3e} (tol {TOL_READOUT}) | kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms", flush=True)

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

    g = gru_rows[0]  # T=1000, no mask: the heaviest launch of the path
    r = ro_rows[0]   # B=512: predict's shape
    print(json.dumps({"kernels": [
        {"name": "gru_scan_fwd", "route": "cuda", "source": cuda_gru.SOURCE,
         "replaces": cuda_gru.REPLACES, "launches": launches_gru,
         "max_abs_err": gru_err, "ms": g[3], "plain_ms": g[4]},
        {"name": "readout_fwd", "route": "cuda",
         "source": cuda_readout.SOURCE, "replaces": cuda_readout.REPLACES,
         "launches": launches_ro, "max_abs_err": ro_err, "ms": r[2],
         "plain_ms": r[3]},
    ]}), flush=True)
    print(f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
