"""Model comparison table — counterpart of ``tools/compare_models.py``, the
reference's core experiment: every encoder family trained on one dataset
with an equal budget through the port's ``train()``, then a table of test
AUC and log-loss (the paper's §5.2 comparison, on the synthetic
generators; ``--data_dir`` points it at preprocessed real data).

    python -m hpmn_tpu_torch.tools.compare_models --dataset taobao \
        --task periodic --steps 500 [--models hpmn,gru4rec,dien] \
        [--data_dir DIR] [--use_pallas] [--json out.json] \
        [--device cuda|cuda:N|cpu]

The JAX tool's flags, plus ``--device`` (default ``cuda``; it raises when
there is no card, ``--device cpu`` trains on the CPU). Each family takes
the dataset's hpmn config with ``model.name`` replaced, as in JAX. Steps
run one per dispatch: in the port the grouping changes no number, so the
JAX tool's per-config dispatch knees have nothing to set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Callable, Dict, Optional, Sequence

DEFAULT_MODELS = "hpmn,gru4rec,dien,rum,dnn,lstm,caser,shan,svdpp,bst"
BASE = {"amazon": "amazon_hpmn", "taobao": "taobao_hpmn",
        "xlong": "xlong_hpmn"}


def family_config(name: str, dataset: str = "taobao", task: str = "ctr",
                  steps: int = 500, n_examples: int = 20000,
                  batch_size: int = 128, data_dir: str = "",
                  use_pallas: bool = False, seed: int = 0):
    """The config one family of the table trains with: the dataset's hpmn
    config, ``model.name`` replaced, four evals over the run, no early
    stop and no step logs."""
    from ..configs import get_config

    cfg = get_config(BASE[dataset])
    return dataclasses.replace(
        cfg.with_model(name=name, use_pallas=use_pallas),
        synthetic_task=task, n_examples=n_examples, data_dir=data_dir,
        seed=seed, train=dataclasses.replace(
            cfg.train, batch_size=batch_size, max_steps=steps,
            eval_every=max(steps // 4, 1), log_every=10 ** 9,
            early_stop_patience=10 ** 9, steps_per_dispatch=1))


def compare(models: Sequence[str], device="cuda",
            report: Optional[Callable[[str], None]] = print,
            **options) -> Dict[str, Dict]:
    """Train each family of ``models`` (``family_config(name,
    **options)``) on ``device`` -> {name: ``train()``'s result}; ``report``
    gets one line per family as it finishes."""
    from ..train.train import train

    results = {}
    for name in models:
        res = train(family_config(name, **options), log=lambda s: None,
                    device=device)
        results[name] = res
        if report is not None:
            report(f"{name:>8}: test AUC {res['test']['auc']:.4f}  "
                   f"log-loss {res['test']['log_loss']:.4f}  "
                   f"(best val {res['best_val_auc']:.4f})")
    return results


def format_table(results: Dict[str, Dict]) -> str:
    """The final table, sorted by test AUC."""
    lines = ["== final table (sorted by test AUC) ==",
             f"{'model':>8}  {'AUC':>7}  {'log-loss':>8}"]
    for name, res in sorted(results.items(),
                            key=lambda kv: -kv[1]["test"]["auc"]):
        lines.append(f"{name:>8}  {res['test']['auc']:.4f}  "
                     f"{res['test']['log_loss']:.4f}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="taobao",
                   choices=["amazon", "taobao", "xlong"])
    p.add_argument("--task", default="ctr", choices=["ctr", "periodic"])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--n_examples", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--models", default=DEFAULT_MODELS)
    p.add_argument("--data_dir", default="")
    p.add_argument("--use_pallas", action="store_true",
                   help="the hand-written CUDA kernels where a family has "
                        "them (hpmn, gru4rec, dien; their plain versions "
                        "on the CPU)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default="",
                   help="also write the table as JSON to this path")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card), "
                        "cuda:N or cpu")
    args = p.parse_args(argv)

    results = compare(
        args.models.split(","), device=args.device,
        report=lambda line: print(line, flush=True), dataset=args.dataset,
        task=args.task, steps=args.steps, n_examples=args.n_examples,
        batch_size=args.batch_size, data_dir=args.data_dir,
        use_pallas=args.use_pallas, seed=args.seed)
    print("\n" + format_table(results))
    if args.json:
        def num(x):  # nan/inf (a single-class split) -> null, as in JAX
            x = float(x)
            return x if math.isfinite(x) else None

        with open(args.json, "w") as f:
            json.dump({
                "dataset": args.dataset, "task": args.task,
                "steps": args.steps, "seed": args.seed,
                "results": {name: {"auc": num(res["test"]["auc"]),
                                   "log_loss": num(res["test"]["log_loss"]),
                                   "best_val_auc": num(res["best_val_auc"])}
                            for name, res in results.items()},
            }, f, indent=2, allow_nan=False)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
