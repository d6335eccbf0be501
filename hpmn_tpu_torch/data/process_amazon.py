"""Amazon preprocessing CLI — counterpart of
``hpmn_tpu/data/process_amazon.py``: the same flags, and the same ``.npz``
bit for bit.

Reference equivalent: the ``process_amazon.py``-style script (SURVEY.md
§2.1 "Amazon preprocessing", [P §5.1.1], [B:7]): parse an Amazon
product-reviews dump (Electronics-style subset), join item -> category
metadata, build vocabs, emit per-user chronological sequences truncated/
left-padded to T=100 with next-behavior positives and sampled negatives.

Input formats accepted (auto-detected per line):
- reviews: JSON lines with ``reviewerID``, ``asin``, ``unixReviewTime``
  (the public loose-JSON dump also parses via ast.literal_eval);
- metadata (``--meta``): JSON lines with ``asin`` and ``categories``
  (first leaf category is used, as in the reference pipeline).

Usage:
    python -m hpmn_tpu_torch.data.process_amazon \
        --reviews reviews_Electronics_5.json --meta meta_Electronics.json \
        --out data/amazon.npz
"""

from __future__ import annotations

import argparse
import ast
import json


def _iter_json_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                yield ast.literal_eval(line)


def load_rows(reviews_path: str, meta_path: str | None):
    """-> list of (user, item_token, cat_token, timestamp)."""
    item_cat = {}
    if meta_path:
        for m in _iter_json_lines(meta_path):
            cats = m.get("categories") or m.get("category") or []
            if cats and isinstance(cats[0], list):
                cats = cats[0]
            item_cat[m["asin"]] = cats[-1] if cats else "unknown"
    rows = []
    for r in _iter_json_lines(reviews_path):
        asin = r["asin"]
        rows.append((r["reviewerID"], asin,
                     item_cat.get(asin, "unknown"),
                     int(r.get("unixReviewTime", 0))))
    return rows


def main(argv=None):
    from .preprocess import process_log, save_preprocessed
    from .synthetic import AMAZON

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reviews", required=True)
    p.add_argument("--meta", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--seq_len", type=int, default=AMAZON.seq_len)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    rows = load_rows(args.reviews, args.meta)
    arrays = process_log(rows, seq_len=args.seq_len, seed=args.seed)
    save_preprocessed(args.out, arrays)
    print(f"{args.out}: {arrays['label'].shape[0]} examples, "
          f"{int(arrays['_n_items'])} items, {int(arrays['_n_cats'])} cats")


if __name__ == "__main__":
    main()
