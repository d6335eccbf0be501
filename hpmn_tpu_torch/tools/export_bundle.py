"""Export a training checkpoint of the port as a self-contained serving
bundle — counterpart of ``tools/export_bundle.py``, with its flags, its
bundle files and its closing line.

    python -m hpmn_tpu_torch.tools.export_bundle --ckpt_dir DIR \
        --config xlong_hpmn [--set key=value ...] --out BUNDLE_DIR
        [--step N]              # default: the best-val-AUC step, else latest
        [--histories hist.npz]  # bootstrap users in one batched encode:
                                # uids [U], item_seqs [U, T], cat_seqs
                                # [U, T], optional masks [U, T]
        [--quantize]            # int8 per-row embedding tables
        [--ema]                 # serve the checkpoint's EMA shadow
        [--export_compiled]     # + update/predict/rank (DIEN: score) as
                                # torch.export graphs (serve --aot)
        [--platforms cpu,cuda]  # the graphs' platforms (default: both)
        [--device cuda|cuda:N|cpu] [--force_cpu]

It reads the port's checkpoints (``train/checkpoint.py``, what ``train()``
writes under ``train.ckpt_dir``); ``--set`` must give the run's model
fields. The store follows the family: ``UserMemoryStore`` for
``O1_FAMILIES`` (hpmn, gru4rec, rum), ``HistoryStore`` for DIEN. The
bundle is the JAX package's format, so either package serves it
(``python -m hpmn_tpu_torch.tools.serve_batch``, ``tools/serve_batch.py``).
``--export_compiled`` adds the request functions as ``torch.export``
graphs, one file per kind and platform (``serving/aot.py``), which
``python -m hpmn_tpu_torch.tools.serve --aot`` serves with no model code;
exporting for ``cuda`` needs a card. It runs on the card unless
``--device cpu`` (or ``--force_cpu``) is given, and raises when there is
no card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--histories", default="")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--ema", action="store_true",
                    help="serve the EMA-averaged weights from the "
                         "checkpoint's optimizer state (the run must have "
                         "trained with train.ema_decay > 0)")
    ap.add_argument("--export_compiled", action="store_true",
                    help="also export update/predict/rank (a history "
                         "bundle: score) as torch.export graphs, so the "
                         "daemon can serve with --aot (no model code)")
    ap.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated export platforms, cpu and cuda "
                         "(with --export_compiled)")
    ap.add_argument("--device", default="cuda",
                    help="where the store runs: cuda (default), cuda:N or "
                         "cpu")
    ap.add_argument("--force_cpu", action="store_true",
                    help="the same as --device cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..models.model import build_model
    from ..serving import O1_FAMILIES, HistoryStore, UserMemoryStore
    from ..train.checkpoint import CheckpointManager
    from ..train.train import apply_overrides, resolve_device

    device = resolve_device("cpu" if args.force_cpu else args.device,
                            "export_bundle")
    cfg = apply_overrides(get_config(args.config), args.set)
    if not os.path.isdir(args.ckpt_dir):
        sys.exit(f"no checkpoints in {args.ckpt_dir}")
    mngr = CheckpointManager(args.ckpt_dir)
    step = args.step
    if step is None:
        step = mngr.best_step()
    if step is None:
        step = mngr.latest_step()
    if step is None:
        sys.exit(f"no checkpoints in {args.ckpt_dir}")
    state = mngr.restore(step)
    mngr.close()

    params = state["params"]
    users = params.get("embedding.user", params.get("encoder.p_u"))
    n_users = 0 if users is None else users.shape[0]
    model = build_model(cfg, params["embedding.item"].shape[0],
                        params["embedding.cat"].shape[0], n_users)
    model.load_state_dict(params)
    if args.ema:
        shadow = state["opt_state"].get("ema")
        if shadow is None:
            sys.exit("--ema: checkpoint's opt state carries no EMA shadow "
                     "(was the run trained with train.ema_decay > 0? pass "
                     "the same --set train.ema_decay=...)")
        with torch.no_grad():
            for p, e in zip(model.parameters(), shadow, strict=True):
                p.copy_(e)
    model = model.to(device)

    if cfg.model.name in O1_FAMILIES:
        store = UserMemoryStore(cfg, model, device=device)
    else:
        store = HistoryStore(cfg, model, device=device)
    if args.histories:
        with np.load(args.histories) as z:
            store.ingest_histories(z["uids"], z["item_seqs"], z["cat_seqs"],
                                   masks=z["masks"] if "masks" in z.files
                                   else None)
    os.makedirs(args.out, exist_ok=True)
    store.save_bundle(args.out, quantize_embeddings=args.quantize,
                      export_compiled=args.export_compiled,
                      export_platforms=tuple(args.platforms.split(",")))
    kind = "memory" if isinstance(store, UserMemoryStore) else "history"
    print(f"exported step {step} -> {args.out} (store={kind}, "
          f"n_users={store.n_users}, quantized={args.quantize}, "
          f"ema={args.ema}, aot={args.export_compiled})")


if __name__ == "__main__":
    main()
