"""XLong preprocessing CLI — counterpart of
``hpmn_tpu/data/process_xlong.py``: the same flags, and the same ``.npz``
bit for bit.

Reference equivalent: the XLong script (SURVEY.md §2.1 "XLong
preprocessing", [P §5.1.1], [B:9]): users sampled from Alibaba logs
specifically because their histories are >= ~1000 events — the
lifelong-modeling stress set, T=1000. Accepts the same CSV event-log
format as Taobao (``user,item,category[,behavior],timestamp``) and keeps
only users with at least ``--min_events`` behaviors.

Usage:
    python -m hpmn_tpu_torch.data.process_xlong --log xlong.csv --out data/xlong.npz
"""

from __future__ import annotations

import argparse
import csv
from collections import defaultdict


def load_rows(log_path: str, min_events: int):
    by_user = defaultdict(list)
    with open(log_path, newline="") as f:
        for rec in csv.reader(f):
            if len(rec) == 4:
                user, item, cat, ts = rec
            elif len(rec) >= 5:
                user, item, cat, _, ts = rec[:5]
            else:
                continue
            by_user[user].append((user, item, cat, int(ts)))
    rows = []
    for user, events in by_user.items():
        # The defining XLong filter: lifelong histories only [P §5.1.1].
        if len(events) >= min_events:
            rows.extend(events)
    return rows


def main(argv=None):
    from .preprocess import process_log, save_preprocessed
    from .synthetic import XLONG

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seq_len", type=int, default=XLONG.seq_len)
    p.add_argument("--min_events", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-native", action="store_true",
                   help="force the pure-Python parser (required for 5-column"
                        " logs with a behavior field)")
    args = p.parse_args(argv)
    from . import native
    from .preprocess import process_csv_native

    if not args.no_native and native.available():
        arrays = process_csv_native(args.log, args.seq_len, seed=args.seed,
                                    min_events=args.min_events)
    else:
        rows = load_rows(args.log, args.min_events)
        arrays = process_log(rows, seq_len=args.seq_len, seed=args.seed,
                             min_events=args.min_events)
    save_preprocessed(args.out, arrays)
    print(f"{args.out}: {arrays['label'].shape[0]} examples, "
          f"{int(arrays['_n_items'])} items, {int(arrays['_n_cats'])} cats")


if __name__ == "__main__":
    main()
