"""Quality regression gate — counterpart of ``tools/quality_gate.py``:
one model per tier on ``taobao_hpmn``'s planted long-range task (the
``periodic`` synthetic, seed 0, B 128, 2000 steps, an eval every quarter),
each held to a floor of test AUC:

- **hpmn** (the recurrent tier), with its kernels (K1, K2, K5) unless
  ``--no_pallas``: floor 0.55. A kernel, config or data fault that breaks
  the periodic hierarchy shows here first;
- **dnn** (pooling reads every position, so it solves the task by
  construction): floor 0.85. A pipeline or label fault that breaks every
  model shows here even when hpmn's recurrence is sound.

    python -m hpmn_tpu_torch.tools.quality_gate [--steps 2000] \\
        [--no_pallas] [--device cuda|cpu]

The JAX tool's flags, with ``--device`` (default ``cuda``; it raises when
there is no card) in place of ``--force_cpu``. Steps run 8 per dispatch,
as in JAX (the port's k-step loop). Exit 0 with one JSON line; exit 1,
the failing numbers on stderr, when a floor is missed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

FLOORS = {"hpmn": 0.55, "dnn": 0.85}


def gate_config(name: str, steps: int = 2000, use_pallas: bool = True,
                seed: int = 0, batch_size: int = 128):
    """The config one model of the gate trains with."""
    from ..configs import get_config

    cfg = get_config("taobao_hpmn")
    return dataclasses.replace(
        cfg.with_model(name=name, use_pallas=use_pallas and name == "hpmn"),
        synthetic_task="periodic", seed=seed, eval_steps_per_dispatch=1,
        train=dataclasses.replace(
            cfg.train, batch_size=batch_size, max_steps=steps,
            eval_every=max(steps // 4, 1), log_every=10 ** 9,
            early_stop_patience=10 ** 9, steps_per_dispatch=8))


def run(steps: int = 2000, use_pallas: bool = True, seed: int = 0,
        batch_size: int = 128, device="cuda"):
    """-> {model: test AUC} for the models of :data:`FLOORS`."""
    from ..train.train import train

    return {name: float(train(gate_config(name, steps, use_pallas, seed,
                                          batch_size),
                              log=lambda s: None, device=device)
                        ["test"]["auc"])
            for name in FLOORS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--no_pallas", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    from ..train.train import resolve_device

    device = resolve_device(args.device, "quality_gate")
    results = run(steps=args.steps, use_pallas=not args.no_pallas,
                  device=device)
    failures = {m: (auc, FLOORS[m]) for m, auc in results.items()
                if auc < FLOORS[m]}
    out = {"metric": "quality_gate", "steps": args.steps,
           "auc": {m: round(a, 4) for m, a in results.items()},
           "floors": FLOORS, "passed": not failures}
    print(json.dumps(out))
    if failures:
        print(f"QUALITY GATE FAILED: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
