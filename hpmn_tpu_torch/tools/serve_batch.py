"""Batch scorer over a serving bundle, the offline serving entry point —
counterpart of ``tools/serve_batch.py``, with its request and output npz.

    python -m hpmn_tpu_torch.tools.serve_batch --bundle DIR \
        --requests req.npz --out out.npz [--update] \
        [--device cuda|cuda:N|cpu] [--force_cpu]

Loads any bundle (the port's or the JAX package's; the memory or the
history store, by the bundle's store kind) and scores candidates for
users. Request npz:
  uids        int32 [B]
  cand_items  int32 [B] (predict) or [B, C] (rank)
  cand_cats   int32, same shape as cand_items
  (with --update) item_ids, cat_ids  int32 [B]: one new event per user,
  ingested before scoring; the advanced state is then saved back into the
  bundle.

Output npz: scores float32 [B] or [B, C]. It runs on the card unless
``--device cpu`` (or ``--force_cpu``) is given, and raises when there is
no card.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bundle", required=True)
    ap.add_argument("--requests", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device_resident", action="store_true",
                    help="accepted for the JAX command line; changes "
                         "nothing: the port's arena always lives on "
                         "--device")
    ap.add_argument("--update", action="store_true",
                    help="apply item_ids/cat_ids as one new event per user "
                         "before scoring, and save the state back")
    ap.add_argument("--device", default="cuda",
                    help="where the store runs: cuda (default), cuda:N or "
                         "cpu")
    ap.add_argument("--force_cpu", action="store_true",
                    help="the same as --device cpu")
    args = ap.parse_args(argv)

    from ..serving import load_bundle
    from ..train.train import resolve_device

    device = resolve_device("cpu" if args.force_cpu else args.device,
                            "serve_batch")
    store = load_bundle(args.bundle, device=device)
    with np.load(args.requests) as req:
        req = dict(req)
    uids = req["uids"]
    if args.update:
        store.update(uids, req["item_ids"], req["cat_ids"])
    cand_i, cand_c = req["cand_items"], req["cand_cats"]
    if cand_i.ndim == 2:
        scores = store.rank(uids, cand_i, cand_c)
    else:
        scores = store.predict(uids, cand_i, cand_c)
    np.savez(args.out, scores=np.asarray(scores, np.float32))
    if args.update:
        store.save(args.bundle)
    print(f"scored {scores.shape} -> {args.out}")


if __name__ == "__main__":
    main()
