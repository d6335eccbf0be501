"""Hyperparameter sweep — counterpart of ``tools/sweep.py``: the cartesian
grid of config overrides, one ``train()`` per point, the best by a
metric.

    python -m hpmn_tpu_torch.tools.sweep --config amazon_hpmn \\
        --grid train.lr=1e-3,3e-4 model.mem_dim=16,32 \\
        [--set n_examples=20000 train.max_steps=2000] \\
        [--metric best_val_auc] [--out sweep.jsonl] [--device cuda|cpu]

The JAX tool's flags, with ``--device`` (default ``cuda``; it raises when
there is no card, ``--device cpu`` trains on the CPU) in place of
``--force_cpu``. One JSON line per trial (appended to ``--out`` if given),
then a ``{"best": ..., "metric": ...}`` line. Values are cast against the
config as ``--set`` casts them. ``steps_per_dispatch`` and
``eval_steps_per_dispatch`` of 0 (the JAX probes) run as 1, as there.
Each trial also prints, on stderr, ``{"trial": ..., "launches": ...}``:
its run's kernel launches by kernel (the fixed-width kernels and the
width-general forms apart), those that ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

# Kernel name -> (module under hpmn_tpu_torch.ops, its launch counter).
_COUNTERS = {
    "gru_scan_fwd": ("cuda_gru", "launches"),
    "gru_scan_bwd": ("cuda_gru", "bwd_launches"),
    "gru_scan_fwd_bf16": ("cuda_gru", "launches_bf16"),
    "gru_scan_bwd_bf16": ("cuda_gru", "bwd_launches_bf16"),
    "gru_scan_fwd_scale": ("cuda_gru", "launches_scale"),
    "gru_scan_bwd_scale": ("cuda_gru", "bwd_launches_scale"),
    "gru_gen_fwd": ("cuda_gru", "gen_launches"),
    "gru_gen_bwd": ("cuda_gru", "gen_bwd_launches"),
    "gru_gen_fwd_bf16": ("cuda_gru", "gen_launches_bf16"),
    "gru_gen_bwd_bf16": ("cuda_gru", "gen_bwd_launches_bf16"),
    "gru_gen_fwd_scale": ("cuda_gru", "gen_launches_scale"),
    "gru_gen_bwd_scale": ("cuda_gru", "gen_bwd_launches_scale"),
    "readout_fwd": ("cuda_readout", "launches"),
    "readout_gen_fwd": ("cuda_readout", "gen_launches"),
}


def _launch_counts():
    import importlib
    return {name: getattr(importlib.import_module(
        f"hpmn_tpu_torch.ops.{mod}"), var)
        for name, (mod, var) in _COUNTERS.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--grid", nargs="+", required=True,
                    help="key=v1,v2,... axes (cartesian product)")
    ap.add_argument("--set", nargs="*", default=[],
                    help="fixed overrides applied to every trial")
    ap.add_argument("--metric", default="best_val_auc")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..train.train import apply_overrides, resolve_device, train

    device = resolve_device(args.device, "sweep")
    axes = []
    for spec in args.grid:
        key, vals = spec.split("=", 1)
        axes.append([(key, v) for v in vals.split(",") if v])

    best = None
    sink = open(args.out, "a") if args.out else None
    for point in itertools.product(*axes):
        overrides = args.set + [f"{k}={v}" for k, v in point]
        cfg = apply_overrides(get_config(args.config), overrides)
        cfg = dataclasses.replace(
            cfg, eval_steps_per_dispatch=cfg.eval_steps_per_dispatch or 1,
            train=dataclasses.replace(
                cfg.train,
                steps_per_dispatch=cfg.train.steps_per_dispatch or 1))
        before = _launch_counts()
        res = train(cfg, log=lambda s: None, device=device)
        row = {"trial": dict(point),
               "best_val_auc": res["best_val_auc"],
               "test_auc": res["test"]["auc"],
               "test_gauc": res["test"]["gauc"],
               "test_log_loss": res["test"]["log_loss"],
               "best_step": res["best_step"]}
        print(json.dumps({"trial": dict(point), "launches": {
            n: v - before[n] for n, v in _launch_counts().items()
            if v > before[n]}}), file=sys.stderr, flush=True)
        if args.metric not in row:
            raise SystemExit(f"--metric {args.metric!r} is not reported; "
                             f"choose from {sorted(set(row) - {'trial'})}")
        score = row[args.metric]
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        if score == score and (best is None or score > best[0]):
            best = (score, row)
    if sink:
        sink.close()
    print(json.dumps({"best": best[1] if best else None,
                      "metric": args.metric}))


if __name__ == "__main__":
    main()
