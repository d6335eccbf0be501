"""Taobao preprocessing CLI — counterpart of
``hpmn_tpu/data/process_taobao.py``: the same flags, and the same ``.npz``
bit for bit.

Reference equivalent: the Taobao UserBehavior script (SURVEY.md §2.1
"Taobao preprocessing", [P §5.1.1], [B:8]): parse the UserBehavior.csv
click log (``user_id,item_id,category_id,behavior_type,timestamp``), keep
click/pv events, emit T=300 sequences through the shared pipeline.

Usage:
    python -m hpmn_tpu_torch.data.process_taobao \
        --log UserBehavior.csv --out data/taobao.npz
"""

from __future__ import annotations

import argparse
import csv


def load_rows(log_path: str, behavior_filter: str = "pv"):
    rows = []
    with open(log_path, newline="") as f:
        for rec in csv.reader(f):
            if len(rec) < 5:
                continue
            user, item, cat, btype, ts = rec[:5]
            if behavior_filter and btype != behavior_filter:
                continue
            rows.append((user, item, cat, int(ts)))
    return rows


def main(argv=None):
    from . import native
    from .preprocess import (process_csv_native, process_log,
                             save_preprocessed)
    from .synthetic import TAOBAO

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--behavior", default="pv",
                   help="behavior type to keep ('' = all)")
    p.add_argument("--seq_len", type=int, default=TAOBAO.seq_len)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-native", action="store_true",
                   help="force the pure-Python parser")
    args = p.parse_args(argv)
    if not args.no_native and native.available():
        # C++ parse + vectorized assembly (SURVEY.md §3.1 hot loop).
        arrays = process_csv_native(args.log, args.seq_len, behavior_col=3,
                                    behavior_keep=args.behavior,
                                    seed=args.seed)
    else:
        rows = load_rows(args.log, args.behavior)
        arrays = process_log(rows, seq_len=args.seq_len, seed=args.seed)
    save_preprocessed(args.out, arrays)
    print(f"{args.out}: {arrays['label'].shape[0]} examples, "
          f"{int(arrays['_n_items'])} items, {int(arrays['_n_cats'])} cats")


if __name__ == "__main__":
    main()
