"""Hold the sharded training path on a grid of ranks of this machine to the
same work in one process.

    python -m hpmn_tpu_torch.tools.parallel_check           # 4 ranks, 2 x 2
    python -m hpmn_tpu_torch.tools.parallel_check --backend nccl --ranks 2
    python -m hpmn_tpu_torch.tools.parallel_check --ranks 2 \
        --seq_parallel 2 --model_parallel 1                 # (1, 2, 1)

Each rank is a process of its own, in a grid of ``--ranks /
(seq_parallel * model_parallel)`` data rows, ``--seq_parallel`` seq ranks
and ``--model_parallel`` model columns (default 1 and 2); the ranks share
the cards round-robin (``cuda:LOCAL_RANK`` modulo the card count: several
ranks on one card need ``--backend gloo``, which takes CUDA tensors
through the host). On ``xlong_hpmn`` (``use_pallas``; with a seq axis the
batch-major path with the kernels as the SP chunk scan,
``mesh.sp_inner=pallas``; ``--seq_len``, ``--items`` and ``--cats``
shrink its data for a rehearsal on the CPU) each rank:

1. runs ``--steps`` SGD steps (lr 1e-2) of ``parallel.make_shardmap_steps``
   from the seeded weights (``init_sharded_model``) on its rows of the same
   global batches (with model columns: batch over data and model, the a2a
   exchange with the capacity factor derived from the batches' ids unless
   given), counting the kernel launches of each step and timing it; then
   one profiled step, whose ``embedding_exchange`` and
   ``exchange_queue_wait`` spans (one each per collective of the lookups)
   :func:`compare` splits into the wait for this rank's queued kernels,
   the transfer and the wait for the model group's other ranks, and whose
   seq collectives' spans (``seq_handoff``, ``seq_gather``,
   ``seq_queue_wait``) it sums;
2. with model columns and no seq axis, one psum-mode step, and one step
   with the capacity factor forced to 0.01, which must take the exact
   fallback (``a2a_overflow`` 1); with a seq axis and no model columns,
   layer 0's T-sharded scan on the first batch with the kernels against
   the plain chunk scan (values and the x and weight gradients), then
   ``--steps`` steps of ``taobao_dien`` (T 300, left-padded: the AUGRU's
   dscale crosses the handoffs);
3. ``train()`` on the same ranks, with evaluation and a checkpoint,
   recording what it wrote into the checkpoint directory.

Then a process of its own runs the same steps and ``train()`` on one
device (``use_pallas``: the kernels, time-major), and :func:`run` returns
both sides' numbers; :func:`compare` measures the distances that
``chip_smoke.py`` phases 15 and 16 hold to their tolerances.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG, DATASET = "xlong_hpmn", "xlong"
DIEN_CONFIG, DIEN_DATASET = "taobao_dien", "taobao"
LR, SEED = 1e-2, 0
THREADS = 2  # per rank: 4 ranks fill the card machine's 8 cores
# K1, K2, K5 (a step's ``launches``) and K1-scale, K2-scale
# (``launches_scale``)
COUNTED = (("cuda_gru", "launches"), ("cuda_gru", "bwd_launches"),
           ("cuda_readout", "launches"), ("cuda_gru", "launches_scale"),
           ("cuda_gru", "bwd_launches_scale"))
SPANS = ("embedding_exchange", "exchange_queue_wait", "seq_handoff",
         "seq_gather", "seq_queue_wait")


def _counters():
    from ..ops import cuda_gru, cuda_readout

    mods = {"cuda_gru": cuda_gru, "cuda_readout": cuda_readout}
    return mods, lambda: tuple(getattr(mods[m], v) for m, v in COUNTED)


def _zero(mods):
    for m, v in COUNTED:
        setattr(mods[m], v, 0)


def _spec(args, dataset=DATASET):
    from ..data import synthetic

    base = synthetic.SPECS[dataset]
    return dataclasses.replace(base, seq_len=args.seq_len or base.seq_len,
                               n_items=args.items or base.n_items,
                               n_cats=args.cats or base.n_cats)


def _use_spec(spec) -> None:
    """train() draws its data from ``synthetic.SPECS``: the processes of
    this tool (ranks and reference alike, each its own) put the run's
    sizes there."""
    from ..data import synthetic

    synthetic.SPECS[DATASET] = spec


def _grid(args, reference=False):
    """The overrides of the grid (none for the one-process reference):
    the model columns, and a seq axis with the kernels as its chunk scan
    on the batch-major path (``use_pallas`` off, as the seq axis needs)."""
    if reference:
        return ["model.use_pallas=true"]
    out = [f"mesh.model_parallel={args.model_parallel}"]
    if args.seq_parallel > 1:
        return out + ["model.use_pallas=false",
                      f"mesh.seq_parallel={args.seq_parallel}",
                      "mesh.sp_inner=pallas"]
    return out + ["model.use_pallas=true"]


def _step_config(args, mode="a2a", bom=True, factor=None, reference=False,
                 config=CONFIG):
    from ..configs import get_config
    from ..train.train import apply_overrides

    factor = args.capacity_factor if factor is None else factor
    tables = ([] if args.model_parallel == 1 or reference else [
        f"mesh.embedding_mode={mode}", f"mesh.batch_over_model={bom}",
        f"mesh.a2a_capacity_factor={factor}"])
    return apply_overrides(get_config(config), [
        *_grid(args, reference), *tables, "train.steps_per_dispatch=1"])


def _batches(args, spec, min_len_frac=1.0):
    """The global batches every rank and the reference share."""
    from ..data.synthetic import make_ctr_dataset

    arrays = make_ctr_dataset(spec, args.batch * args.steps, seed=SEED,
                              min_len_frac=min_len_frac)
    return [{k: v[i * args.batch:(i + 1) * args.batch]
             for k, v in arrays.items()} for i in range(args.steps)]


def _train_config(args, ckpt_dir, reference=False):
    from ..configs import get_config
    from ..train.train import apply_overrides

    return apply_overrides(get_config(CONFIG), [
        *_grid(args, reference),
        f"n_examples={args.train_examples}", "train.max_steps=16",
        "train.eval_every=8", "train.log_every=4",
        "train.early_stop_patience=100", "train.steps_per_dispatch=1",
        "eval_steps_per_dispatch=1", f"eval_batch_size={args.eval_batch}",
        f"train.batch_size={args.batch}", f"train.ckpt_dir={ckpt_dir}"])


def _host(params: Dict) -> Dict:
    """Copies on the CPU, apart from the live parameters."""
    return {n: p.detach().to("cpu", copy=True) for n, p in params.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record_writes(directory: str) -> List[str]:
    """-> a list that fills with what this process writes under
    ``directory`` from now on: the paths it opens for writing, the
    directories it makes below it and the paths it renames into it (an
    audit hook, which only observes)."""
    root = os.path.abspath(directory)
    seen: List[str] = []

    def under(path) -> bool:
        if not isinstance(path, (str, bytes, os.PathLike)):
            return False
        path = os.path.abspath(os.fsdecode(path))
        return path.startswith(root + os.sep)

    def hook(event, a):
        if event == "open" and under(a[0]) and (
                any(c in (a[1] or "") for c in "wax+")
                or (a[1] is None and a[2] & (os.O_WRONLY | os.O_RDWR))):
            seen.append(f"open {a[0]}")
        elif event == "os.mkdir" and under(a[0]):
            seen.append(f"mkdir {a[0]}")
        elif event == "os.rename" and under(a[1]):
            seen.append(f"rename {a[1]}")

    sys.addaudithook(hook)
    return seen


def _run_steps(step, placed, device, mods, counters, on_first=None):
    """The steps, one per placed batch, each timed and its launches
    counted -> {"losses", "ms", "launches" (K1, K2, K5 per step),
    "launches_scale" (K1-scale, K2-scale per step), "overflow" (each
    step's a2a fallback flag, None without the exchange)}."""
    out = {"losses": [], "ms": [], "launches": [], "launches_scale": [],
           "overflow": []}
    for i, b in enumerate(placed):
        _sync(device)
        _zero(mods)
        t0 = time.perf_counter()
        m = step(b)
        out["losses"].append(m["loss"].item())  # syncs
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        n = counters()
        out["launches"].append(n[:3])
        out["launches_scale"].append(n[3:])
        out["overflow"].append(m["a2a_overflow"].item()
                               if "a2a_overflow" in m else None)
        if i == 0 and on_first is not None:
            on_first()
    return out


def _sp_scan_check(model, cfg, mesh, batch, device, mods, counters):
    """Layer 0's T-sharded scan on this rank over the first batch's
    embeddings, with the kernels (``cuda_gru.gru_sequence``) and with the
    plain chunk scan: the gradients of sum(h^2) + sum(h_T^2) with respect
    to x and the layer's weights (this rank's share, before the mean over
    seq) -> their distances, each leg's ms and launches."""
    from ..models.embedding import dense_lookup
    from ..ops import cuda_gru
    from ..parallel.seq_parallel import sp_gru_sequence

    layer = model.encoder.layers[0]
    with torch.no_grad():
        x = dense_lookup(model.embedding, batch.item_seq, batch.cat_seq)
    x.requires_grad_()
    mask = batch.seq_mask.to(x.dtype)
    legs = {}
    for name, inner in (("pallas", cuda_gru.gru_sequence), ("jnp", None)):
        _sync(device)
        _zero(mods)
        t0 = time.perf_counter()
        h, h_T = sp_gru_sequence(
            layer, x, mask, n_shards=mesh.n_seq, mesh=mesh,
            microbatches=cfg.mesh.sp_microbatches,
            min_local_steps=cfg.mesh.sp_min_local_steps, inner=inner)
        grads = torch.autograd.grad((h ** 2).sum() + (h_T ** 2).sum(),
                                    [x, layer.wx, layer.wh, layer.b])
        _sync(device)
        legs[name] = ([h.detach(), h_T.detach(), *grads],
                      1e3 * (time.perf_counter() - t0), counters())
    got, want = legs["pallas"][0], legs["jnp"][0]
    errs = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            for g, w in zip(got, want)]
    return {"h_err": (got[0] - want[0]).abs().max().item(),
            "h_max": want[0].abs().max().item(),
            "h_T_err": (got[1] - want[1]).abs().max().item(),
            "grad_rel": max(errs[2:]), "T": x.shape[1],
            "ms": {k: v[1] for k, v in legs.items()},
            "launches": {k: v[2] for k, v in legs.items()}}


def worker(args) -> None:
    """One rank: see the module docstring; writes ``rank<r>.pt``."""
    from ..data.schema import batch_from_numpy
    from ..ops import _build
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh, shard_batch
    from ..parallel.train_step import (gather_params, gather_rows,
                                       init_sharded_model,
                                       make_shardmap_steps, table_names)
    from ..train import train as driver

    torch.set_num_threads(THREADS)
    distributed.initialize(args.init, args.ranks, args.rank,
                           backend=args.backend, device=args.device)
    device = distributed.rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        _build.load_library()
    mesh = make_mesh(args.model_parallel, args.seq_parallel)
    mods, counters = _counters()
    spec = _spec(args)
    batches = _batches(args, spec)
    tables_on = args.model_parallel > 1
    out: Dict = {"rank": args.rank,
                 "grid": (mesh.n_data, mesh.n_seq, mesh.n_model)}

    def place(arrays, over):
        b = batch_from_numpy(arrays, device="cpu")
        return driver.place_batch(shard_batch(mesh, b, over=over), device)

    def fresh(cfg, spec_=spec):
        model = init_sharded_model(cfg, spec_.n_items, spec_.n_cats, mesh,
                                   seed=SEED, device=device)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        return model, make_shardmap_steps(cfg, model, opt, mesh)[0]

    bom = ("data", "model") if tables_on else ("data",)
    cfg = _step_config(args)
    if tables_on:
        # capacity factor 0: derived from these batches' ids, as the
        # driver derives it from the training set's
        cfg = driver.resolve_capacity_factor(
            cfg, {k: np.concatenate([b[k] for b in batches])
                  for k in batches[0]}, spec, args.model_parallel, True,
            mesh.n_data, log=lambda line: None)
    out["capacity_factor"] = cfg.mesh.a2a_capacity_factor
    model, step = fresh(cfg)
    out["tables"] = table_names(model)
    out["params0"] = _host(gather_params(model, mesh))
    placed = [place(b, bom) for b in batches]

    def first():
        out["params_step1"] = _host(gather_params(model, mesh))
        out["table_grad1"] = _host({
            n: gather_rows(p.grad, mesh)
            for n, p in model.named_parameters() if n in out["tables"]})

    out.update(_run_steps(step, placed, device, mods, counters, first))
    out["params"] = _host(gather_params(model, mesh))
    tables = set(out["tables"])
    out["dense"] = _host({n: p for n, p in model.named_parameters()
                          if n not in tables})
    # one profiled step: the collectives' spans, in the order they ran
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        step(placed[0])["loss"].item()
        wall = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.name, e.cpu_time_total / 1e3)
                   for e in prof.events() if e.name in SPANS)
    out["profile"] = {"wall_ms": wall, **{
        name: [t for _, n, t in spans if n == name] for name in SPANS}}
    if args.seq_parallel > 1 and not tables_on:
        out["sp_scan"] = _sp_scan_check(model, cfg, mesh, placed[0], device,
                                        mods, counters)
    del model, step, placed

    if tables_on and args.seq_parallel == 1:
        for name, c in (("psum", _step_config(args, "psum", False)),
                        ("fallback", _step_config(args, factor=0.01))):
            model, step = fresh(c)
            m = step(place(batches[0],
                           ("data",) if name == "psum" else bom))
            out[name] = {"loss": m["loss"].item(),
                         "overflow": (m["a2a_overflow"].item()
                                      if "a2a_overflow" in m else None),
                         "params": _host(gather_params(model, mesh))}
            del model, step
    if args.seq_parallel > 1 and not tables_on:
        # DIEN: both of its scans T-sharded, the AUGRU's scale included
        dspec = _spec(args, DIEN_DATASET)
        model, step = fresh(_step_config(args, config=DIEN_CONFIG), dspec)
        dien = _run_steps(step, [place(b, bom) for b in _batches(
            args, dspec, min_len_frac=0.5)], device, mods, counters)
        out["dien"] = dict(dien, params=_host(gather_params(model, mesh)))
        del model, step

    # train() on the ranks, every rank with the one checkpoint directory;
    # rank 0 alone may write there
    _use_spec(spec)
    ckpt = os.path.join(args.out, "ckpt")
    writes = _record_writes(ckpt)
    lines: List[str] = []
    _sync(device)
    _zero(mods)
    t0 = time.perf_counter()
    res = driver.train(_train_config(args, ckpt), log=lines.append,
                       device=device)
    _sync(device)
    out["train"] = {"seconds": time.perf_counter() - t0,
                    "launches": counters()[:3],
                    "launches_scale": counters()[3:],
                    "writes": list(writes),
                    "lines": lines, "test": res["test"],
                    "best_val_auc": res["best_val_auc"],
                    "best_step": res["best_step"],
                    "params": _host(res["params"])}
    torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
    distributed.shutdown()


def reference(args) -> None:
    """The same steps and train() in one process on one device, with the
    kernels (``use_pallas``); writes ``reference.pt``."""
    from ..data.schema import batch_from_numpy
    from ..models.model import init_model
    from ..ops import _build
    from ..train import train as driver

    device = torch.device(args.device if args.device == "cpu" else "cuda")
    if device.type == "cuda":
        _build.load_library()
    mods, counters = _counters()

    def fresh(cfg, spec):
        model = init_model(cfg, spec.n_items, spec.n_cats, seed=SEED,
                           device=device)
        return model, driver.make_train_step(
            cfg, model, torch.optim.SGD(model.parameters(), lr=LR))

    def place(arrays):
        return driver.place_batch(batch_from_numpy(arrays, device="cpu"),
                                  device)

    spec = _spec(args)
    model, step = fresh(_step_config(args, reference=True), spec)
    out: Dict = {"params0": _host(dict(model.named_parameters()))}

    def first():
        out["params_step1"] = _host(dict(model.named_parameters()))
        out["grad1"] = _host({  # None: unused, the ranks' zeros
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()})

    out.update(_run_steps(step, [place(b) for b in _batches(args, spec)],
                          device, mods, counters, first))
    out["params"] = _host(dict(model.named_parameters()))
    if args.seq_parallel > 1 and args.model_parallel == 1:
        dspec = _spec(args, DIEN_DATASET)
        model, step = fresh(_step_config(args, reference=True,
                                         config=DIEN_CONFIG), dspec)
        dien = _run_steps(step, [place(b) for b in _batches(
            args, dspec, min_len_frac=0.5)], device, mods, counters)
        out["dien"] = dict(dien, params=_host(dict(
            model.named_parameters())))
    _use_spec(spec)
    lines: List[str] = []
    res = driver.train(_train_config(args, os.path.join(
        args.out, "ckpt_reference"), reference=True), log=lines.append,
        device=device)
    out["train"] = {"lines": lines, "test": res["test"],
                    "best_val_auc": res["best_val_auc"],
                    "params": _host(res["params"])}
    torch.save(out, os.path.join(args.out, "reference.pt"))


def _max_err(got: Dict, want: Dict, names=None):
    """(max abs difference over the parameters ``names``, default every
    one of ``want``, the largest max abs of ``want``'s)."""
    names = list(want) if names is None else names
    err = max((got[n].float() - want[n].float()).abs().max().item()
              for n in names)
    return err, max(want[n].abs().max().item() for n in names)


def _rel_err(got: Dict, want: Dict, names) -> float:
    """The largest, over the parameters ``names``, of the max abs
    difference over ``want``'s own max abs (0 where both are 0)."""
    def rel(n):
        err = (got[n].float() - want[n].float()).abs().max().item()
        top = want[n].abs().max().item()
        return err / top if top else (0.0 if err == 0 else float("inf"))
    return max(rel(n) for n in names)


def _delta_err(got: Dict, got0: Dict, want: Dict, want0: Dict, names):
    """The tables' change over a run against the reference's -> (the
    largest over the tables of the max abs difference of (got - got0) and
    (want - want0) over the max abs of (want - want0), {table: that max
    abs})."""
    d_got = {n: got[n].float() - got0[n].float() for n in names}
    d_want = {n: want[n].float() - want0[n].float() for n in names}
    return (_rel_err(d_got, d_want, names),
            {n: d_want[n].abs().max().item() for n in names})


def _exchange_split(ranks: Sequence[Dict]) -> List[Dict]:
    """Each rank's profiled step, split: ``queue_ms`` the wait for its own
    queued kernels before the lookups' collectives, ``exchange_ms`` those
    collectives' spans, of which ``transfer_ms`` is the sum over the
    collectives of the shortest span of the model group (its last rank to
    arrive waited for no one) and ``peer_wait_ms`` the rest: the wait for
    the group's other ranks; ``seq_handoff_ms``, ``seq_gather_ms`` and
    ``seq_queue_ms`` the seq collectives' spans, summed, and
    ``seq_collectives`` their count."""
    prof = [r["profile"] for r in ranks]
    n_model = ranks[0]["grid"][2]
    out = []
    for i, p in enumerate(prof):
        row = i // n_model * n_model
        spans = [q["embedding_exchange"] for q in prof[row:row + n_model]]
        if len({len(s) for s in spans}) != 1:
            raise ValueError(f"rank {i}'s model group ran "
                             f"{[len(s) for s in spans]} exchanges")
        mine = p["embedding_exchange"]
        transfer = sum(min(s[k] for s in spans) for k in range(len(mine)))
        out.append({"wall_ms": p["wall_ms"],
                    "queue_ms": sum(p["exchange_queue_wait"]),
                    "exchange_ms": sum(mine), "transfer_ms": transfer,
                    "peer_wait_ms": sum(mine) - transfer,
                    "collectives": len(mine),
                    "seq_handoff_ms": sum(p["seq_handoff"]),
                    "seq_gather_ms": sum(p["seq_gather"]),
                    "seq_queue_ms": sum(p["seq_queue_wait"]),
                    "seq_collectives": len(p["seq_handoff"])
                    + len(p["seq_gather"])})
    return out


def _loss_rel(ranks: Sequence[Dict], ref: Dict) -> float:
    return max(abs(a - b) / abs(b) for r in ranks
               for a, b in zip(r["losses"], ref["losses"]))


def compare(ranks: Sequence[Dict], ref: Dict) -> Dict:
    """The distances between the ranks' run and one process's."""
    r0 = ranks[0]
    tables = r0["tables"]
    step_err, step_max = _max_err(r0["params"], ref["params"])
    tab_rel, tab_max = _delta_err(r0["params"], r0["params0"],
                                  ref["params"], ref["params0"], tables)
    tr_err, tr_max = _max_err(r0["train"]["params"],
                              ref["train"]["params"])
    dense_same = all(torch.equal(r["dense"][n], r0["dense"][n])
                     for r in ranks[1:] for n in r0["dense"])
    out = {
        "loss_rel": _loss_rel(ranks, ref),
        "params_err": step_err, "params_max": step_max,
        "table_grad_rel": max(_rel_err(r["table_grad1"], ref["grad1"],
                                       tables) for r in ranks),
        "table_delta_rel": tab_rel, "table_delta_max": tab_max,
        "dense_identical": dense_same,
        "train_params_err": tr_err, "train_params_max": tr_max,
        "train_auc_gap": abs(r0["train"]["test"]["auc"]
                             - ref["train"]["test"]["auc"]),
        "train_log_loss_gap": abs(r0["train"]["test"]["log_loss"]
                                  - ref["train"]["test"]["log_loss"]),
        "train_best_val_gap": abs(r0["train"]["best_val_auc"]
                                  - ref["train"]["best_val_auc"]),
        "writes": [r["train"]["writes"] for r in ranks],
        "exchange": _exchange_split(ranks),
    }
    if "psum" in r0:
        fb_err, fb_max = _max_err(r0["fallback"]["params"],
                                  r0["params_step1"])
        fb_tab_rel, fb_tab_max = _delta_err(
            r0["fallback"]["params"], r0["params0"], r0["params_step1"],
            r0["params0"], tables)
        ps_err, ps_max = _max_err(r0["psum"]["params"], ref["params_step1"])
        ps_tab_rel, ps_tab_max = _delta_err(
            r0["psum"]["params"], r0["params0"], ref["params_step1"],
            ref["params0"], tables)
        out.update({
            "psum_loss_rel": abs(r0["psum"]["loss"] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "psum_params_err": ps_err, "psum_params_max": ps_max,
            "psum_table_delta_rel": ps_tab_rel,
            "psum_table_delta_max": ps_tab_max,
            "fallback_overflow": [r["fallback"]["overflow"] for r in ranks],
            "fallback_params_err": fb_err, "fallback_params_max": fb_max,
            "fallback_table_delta_rel": fb_tab_rel,
            "fallback_table_delta_max": fb_tab_max,
            "fallback_loss_diff": abs(r0["fallback"]["loss"]
                                      - r0["losses"][0])})
    if "dien" in r0:
        d_err, d_max = _max_err(r0["dien"]["params"], ref["dien"]["params"])
        out.update({"dien_loss_rel": _loss_rel([r["dien"] for r in ranks],
                                               ref["dien"]),
                    "dien_params_err": d_err, "dien_params_max": d_max,
                    "dien_identical": all(
                        torch.equal(r["dien"]["params"][n],
                                    r0["dien"]["params"][n])
                        for r in ranks[1:] for n in r0["dien"]["params"])})
    return out


def _checkpoint_matches(ckpt: str, r0: Dict) -> bool:
    """Whether the best snapshot in ``ckpt``, the one train() tested, holds
    rank 0's returned parameters bit for bit (the whole padded tables)."""
    from ..train.checkpoint import CheckpointManager

    mngr = CheckpointManager(ckpt)
    state = mngr.restore(mngr.best_step())["params"]
    got = r0["train"]["params"]
    return (set(state) == set(got)
            and all(torch.equal(state[n], got[n]) for n in got))


def _spawn(argv, extra, n, env):
    procs = []
    for r in range(n):
        cmd = [sys.executable, "-m", "hpmn_tpu_torch.tools.parallel_check",
               *argv, *extra(r)]
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, env=dict(env, LOCAL_RANK=str(r),
                                    LOCAL_WORLD_SIZE=str(n)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, timeout, what):
    """Wait for every process; a failed one raises, with its output."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{what} {r} exited {p.returncode}:\n"
                               f"{logs[r][-4000:]}")


def run(argv: Sequence[str] = (), timeout: float = 900) -> Dict:
    """Spawn the ranks, wait for them, then the reference -> {"args",
    "ranks": [each rank's numbers], "reference", "compare" (with
    "checkpoint_matches"), "ckpt": the checkpoint directory, or None when
    the caller gave no ``--out``: the temporary directory is removed}. A
    process that fails raises, with its output."""
    args = parse(argv)
    work = args.out or tempfile.mkdtemp(prefix="parallel_check_")
    argv = [*argv, "--out", work] if not args.out else list(argv)
    try:
        os.makedirs(work, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        init = f"tcp://127.0.0.1:{_free_port()}"
        _wait(_spawn(argv, lambda r: ["--worker", "--rank", str(r),
                                      "--init", init], args.ranks, env),
              timeout, "rank")
        _wait(_spawn(argv, lambda r: ["--reference"], 1, env), timeout,
              "the reference")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(args.ranks)]
        ref = torch.load(os.path.join(work, "reference.pt"),
                         weights_only=False)
        ckpt = os.path.join(work, "ckpt")
        c = dict(compare(ranks, ref),
                 checkpoint_matches=_checkpoint_matches(ckpt, ranks[0]))
    finally:
        if not args.out:
            shutil.rmtree(work, ignore_errors=True)
    return {"args": args, "ranks": ranks, "reference": ref, "compare": c,
            "ckpt": ckpt if args.out else None}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse(argv: Sequence[str]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4,
                   help="a multiple of seq_parallel * model_parallel")
    p.add_argument("--seq_parallel", type=int, default=1)
    p.add_argument("--model_parallel", type=int, default=2)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=512, help="global batch")
    p.add_argument("--capacity_factor", type=float, default=0.0,
                   help="the a2a steps' factor; 0 derives it from the "
                   "batches' ids, as the driver does")
    # smaller data than xlong's, for a rehearsal (0: xlong's own)
    p.add_argument("--seq_len", type=int, default=0)
    p.add_argument("--items", type=int, default=0)
    p.add_argument("--cats", type=int, default=0)
    p.add_argument("--train_examples", type=int, default=6144)
    p.add_argument("--eval_batch", type=int, default=256)
    p.add_argument("--out", default="", help="directory for the results "
                   "and the checkpoint (default: a temporary one)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--reference", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--init", default="", help=argparse.SUPPRESS)
    return p.parse_args(list(argv))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    if args.worker:
        worker(args)
        return
    if args.reference:
        reference(args)
        return
    res = run(argv)
    for r in res["ranks"]:
        print(json.dumps({"rank": r["rank"], "step_ms": r["ms"],
                          "launches": r["launches"],
                          "launches_scale": r["launches_scale"],
                          "overflow": r["overflow"], "losses": r["losses"],
                          "train_seconds": r["train"]["seconds"],
                          "train_launches": r["train"]["launches"]}))
    ref = res["reference"]
    print(json.dumps({"reference_step_ms": ref["ms"],
                      "reference_losses": ref["losses"]}))
    print(json.dumps(res["compare"], default=str))


if __name__ == "__main__":
    main()
