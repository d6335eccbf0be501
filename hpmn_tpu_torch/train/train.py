"""The training driver — counterpart of ``hpmn_tpu/train/train.py``: the
optimizer, the training step, the data, evaluation, checkpoints,
``train()`` and the CLI, on one device or over a grid of ranks.

    python -m hpmn_tpu_torch.train.train --config amazon_hpmn \\
        --set n_examples=4000 train.max_steps=150 train.eval_every=50
    python -m hpmn_tpu_torch.train.train --config amazon_gru4rec \\
        --set data_dir=data      # data/amazon.npz from process_amazon
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m hpmn_tpu_torch.train.train --config xlong_hpmn \\
        --set mesh.model_parallel=2   # 2 x 2 ranks, tables row-sharded
    python -m torch.distributed.run --nproc_per_node 2 \\
        -m hpmn_tpu_torch.train.train --config xlong_hpmn \\
        --set mesh.seq_parallel=2 mesh.sp_inner=pallas \\
              model.use_pallas=false  # T sharded over 2 ranks

    opt = make_optimizer(cfg, model.parameters())   # train/optim.py
    step = make_train_step(cfg, model, opt)
    metrics = step(batch)                 # one forward, backward, update
    multi = make_multistep_train(cfg, model, opt)
    metrics = multi(batches)              # k steps, the last step's metrics
    result = train(cfg)                   # the whole run, on the card

The driver runs where ``device`` says, the card by default, and raises
without one (``device="cpu"`` trains on the CPU). With ``use_pallas`` a
training step runs the CUDA scan kernels forward and backward and the
readout kernel forward, and an eval step the scan kernels forward and the
readout kernel.

Several ranks run the JAX driver's mesh branches (``parallel/``, see
:func:`train`). Its loop is the JAX driver's: log, eval and
checkpoint boundaries crossed by ``step % every < k``, early stop on
``early_stop_patience``, the best checkpoint restored before the test
eval, a preemption snapshot on SIGTERM, the goodput line, and the JAX
driver's log lines. Three differences: ``steps_per_dispatch`` 0 (the JAX
startup probe) runs as 1, eval scores batch by batch whatever
``eval_steps_per_dispatch`` says, and a snapshot saves the loader's
position after the last batch trained on, not after the batches
prefetched, so that a resumed run continues the interrupted one bit for
bit.

``train.log_dir`` writes the JAX driver's TensorBoard scalars from rank 0
(``train/<metric>`` and ``train/examples_per_sec`` at each log step,
``val/auc`` and ``val/log_loss`` at each eval, ``test/auc`` and
``test/log_loss`` at the end) into an event file written by hand
(``train/events.py``). ``train.debug_nans`` (JAX's ``jax_debug_nans``)
checks each step's loss and logits, every gradient and every updated
parameter, and each eval batch's logits, and raises FloatingPointError
naming the step and the tensor at the first NaN; it only reads, so a
clean run keeps its bits. Off, nothing is checked and nothing syncs. The
step's own builder checks (``make_train_step``, and
``parallel.make_shardmap_steps`` on a mesh, where the ranks merge their
flags so that every rank raises at the same check).
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import os
import signal
import tempfile
import threading
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import torch

from ..configs import Config, get_config
from ..data import preprocess, synthetic
from ..data.loader import DataLoader
from ..data.schema import Batch
from ..models.model import apply_model, init_model, loss_fn
from ..utils.asserts import validate_batch
from .checkpoint import CheckpointManager
from .evaluate import evaluate as run_evaluate
from .optim import Optimizer


def make_optimizer(cfg: Config, params: Iterable[torch.Tensor]) -> Optimizer:
    """The JAX make_optimizer's transform on ``params`` (train/optim.py):
    Adam, or AdamW, with the config's schedule, clipping, accumulation and
    EMA."""
    return Optimizer(cfg, params)


def check_nans(what: str, named: Iterable,
               reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
               = None) -> None:
    """Raise FloatingPointError naming the first (name, tensor) of
    ``named`` that holds a NaN (``train.debug_nans``), after one read of
    the flags. ``reduce`` (flags [n] float32 -> flags [n]) merges them over
    the ranks of a mesh, so that every rank raises at the same check."""
    named = [(name, t) for name, t in named if t is not None]
    if not named:
        return
    flags = torch.stack([torch.isnan(t).any().float() for _, t in named])
    if reduce is not None:
        flags = reduce(flags)
    hit = flags.nonzero().flatten().tolist()
    if hit:
        raise FloatingPointError(f"NaN in {what} {named[hit[0]][0]}")


def make_train_step(cfg: Config, model: torch.nn.Module, opt: Optimizer,
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """-> step(batch) -> metrics (bce, cov_reg, l2, loss; detached tensors
    on the model's device). One forward and backward and one optimizer
    micro-step, as the JAX ``_raw_train_step``; the parameters are updated
    in place. With ``train.debug_nans`` the loss and the logits, then every
    gradient, then every updated parameter are checked (:func:`check_nans`)."""
    debug = cfg.train.debug_nans

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, cfg, batch)
        if debug:
            check_nans("the forward's", [("loss", loss),
                                         ("logits", metrics["logits"])])
        loss.backward()
        if debug:
            check_nans("the gradient of", ((n, p.grad) for n, p in
                                           model.named_parameters()))
        opt.step()
        if debug:
            check_nans("the updated parameter", model.named_parameters())
        del metrics["logits"]
        return {k: v.detach() for k, v in metrics.items()}

    return step


def fuse_steps(step: Callable[[Batch], Dict[str, torch.Tensor]]
               ) -> Callable[[Sequence[Batch]], Dict[str, torch.Tensor]]:
    """step(batch) -> metrics, made multistep(batches): k = len(batches)
    steps, one per batch, in order (the JAX ``fuse_steps``, there one
    dispatch of a ``lax.scan``; here a Python loop). -> the last step's
    metrics, except ``a2a_overflow``, summed over the k steps (an event
    count: the steps whose exchange took the fallback). A FloatingPointError
    of step i (0-based) leaves with ``offset`` i."""

    def multistep(batches: Sequence[Batch]) -> Dict[str, torch.Tensor]:
        if not batches:
            raise ValueError("a multistep needs at least one batch")
        overflow = []
        for i, batch in enumerate(batches):
            try:
                metrics = step(batch)
            except FloatingPointError as e:
                e.offset = i
                raise
            if "a2a_overflow" in metrics:
                overflow.append(metrics["a2a_overflow"])
        if overflow:
            metrics = dict(metrics, a2a_overflow=torch.stack(overflow).sum())
        return metrics

    return multistep


def make_multistep_train(cfg: Config, model: torch.nn.Module, opt: Optimizer,
                         ) -> Callable[[Sequence[Batch]],
                                       Dict[str, torch.Tensor]]:
    """-> multistep(batches) -> the last step's metrics: k = len(batches)
    steps of :func:`make_train_step`, through :func:`fuse_steps`."""
    return fuse_steps(make_train_step(cfg, model, opt))


def make_datasets(cfg: Config):
    """-> (train, val, test, spec), split 80/10/10 by example index. With
    ``cfg.data_dir``, the preprocessed ``<data_dir>/<dataset>.npz``
    (``preprocess.load_preprocessed``, memory-mapped where it is
    uncompressed), and a spec that carries the data's own vocab sizes, so
    that the tables are sized to the data; otherwise the synthetic task of
    ``cfg.synthetic_task`` (``ctr`` or ``periodic``) at ``n_examples`` from
    ``cfg.seed``."""
    spec = synthetic.SPECS[cfg.dataset]
    if cfg.data_dir:
        arrays = preprocess.load_preprocessed(cfg.data_dir, spec)
        spec = dataclasses.replace(spec, n_items=int(arrays.pop("_n_items")),
                                   n_cats=int(arrays.pop("_n_cats")),
                                   n_users=int(arrays.pop("_n_users")))
    else:
        gen = (synthetic.make_periodic_dataset
               if cfg.synthetic_task == "periodic"
               else synthetic.make_ctr_dataset)
        arrays = gen(spec, cfg.n_examples, seed=cfg.seed)
    return (*synthetic.train_val_test_split(arrays), spec)


def place_batch(batch: Batch, device) -> Batch:
    """Check a host batch's contract (``validate_batch``) and move it to
    ``device``; to the card through pinned memory, without blocking."""
    validate_batch(batch)
    device = torch.device(device)
    if device.type == "cpu":
        return batch
    return Batch(**{f.name: getattr(batch, f.name).pin_memory().to(
        device, non_blocking=True) for f in dataclasses.fields(Batch)})


def prefetch_to_device(iterator: Iterable, place: Callable,
                       size: int = 2) -> Iterator:
    """Keep ``size`` items placed ahead of the consumer, so each batch's
    copy to the card is queued while the step before it runs."""
    queue = collections.deque()
    for item in iterator:
        queue.append(place(item))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def make_eval_step(cfg: Config, device) -> Callable:
    """-> eval_step(model, host batch) -> logits [B] on ``device``: the
    forward alone (``apply_model`` under ``torch.no_grad()``), the logits
    checked with ``train.debug_nans``."""

    def eval_step(model, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = apply_model(model, cfg, place_batch(batch, device))
        if cfg.train.debug_nans:
            check_nans("the eval batch's", [("logits", logits)])
        return logits

    return eval_step


def init_model_for(cfg: Config, spec: synthetic.DatasetSpec,
                   device) -> torch.nn.Module:
    """The driver's model at the start of a run: the port's seeded init
    (``init_model``) for the dataset's vocab and ``spec.n_users`` (the
    user table's rows with ``use_user_emb``, SVD++'s ``p_u``'s; the other
    families ignore it), as the JAX driver passes. The one place the
    driver initialises a model, so a caller can start it from other
    weights (for example the JAX package's, through
    ``convert.model_from_flat``)."""
    return init_model(cfg, spec.n_items, spec.n_cats, device=device,
                      n_users=spec.n_users)


def resolve_capacity_factor(cfg: Config, arrays, spec, n_model: int,
                            bom: bool, n_data: int, n_hosts: int = 1,
                            log: Callable[[str], None] = print) -> Config:
    """``mesh.a2a_capacity_factor == 0`` (the default) is auto: derive it
    from the training ids (``derive_capacity_factor``) at the per-rank
    query counts of the train and the eval exchanges, as the JAX
    driver's ``resolve_capacity_factor``. -> the config with the factor
    (unchanged for an explicit factor or another mode)."""
    if cfg.mesh.embedding_mode != "a2a" or \
            float(cfg.mesh.a2a_capacity_factor) != 0.0:
        return cfg
    import numpy as np

    from ..parallel.embedding_sharding import derive_capacity_factor
    from ..parallel.embedding_sharding import pad_vocab

    T = spec.seq_len
    sizes = []
    for B in (cfg.train.batch_size, cfg.eval_batch_size):
        b_glob = B * n_hosts
        if bom:  # ids arrive rank-local: examples per rank x T
            ex = max(1, b_glob // (n_data * n_model))
            sizes += [ex, ex * T]
        else:  # replicated ids: each rank exchanges a 1/S chunk
            ex = max(1, b_glob // n_data)
            sizes += [-(-ex // n_model), -(-ex * T // n_model)]
    sizes = sorted(set(sizes))
    rows = min(2000, len(arrays["target_item"]))
    samples = []
    for seq_f, tgt_f, n_vocab in (("item_seq", "target_item", spec.n_items),
                                  ("cat_seq", "target_cat", spec.n_cats)):
        ids = np.concatenate([
            np.asarray(arrays[seq_f][:rows]).reshape(-1).astype(np.int64),
            np.asarray(arrays[tgt_f][:rows]).astype(np.int64)])
        samples.append((ids, pad_vocab(int(n_vocab), n_model) // n_model))
    factor = derive_capacity_factor(samples, n_model, sizes)
    log(f"derived a2a_capacity_factor={factor:.2f} from the id "
        f"distribution (slice sizes {sizes})")
    return dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, a2a_capacity_factor=factor))


def resolve_mesh(cfg: Config, mesh, arrays, spec,
                 log: Callable[[str], None] = print):
    """The JAX driver's mesh branch's choices -> (cfg, batch_over_model):
    ``batch_over_model`` holds with more than one model rank unless the
    mode is an explicit ``psum``; ``replicated`` becomes ``a2a`` under it,
    else ``psum``; then the a2a capacity factor is resolved."""
    from ..parallel import distributed

    m = cfg.mesh
    bom = (m.batch_over_model and mesh.n_model > 1
           and m.embedding_mode in ("replicated", "a2a"))
    if mesh.n_model > 1 and m.embedding_mode == "replicated":
        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            m, embedding_mode="a2a" if bom else "psum"))
    cfg = resolve_capacity_factor(cfg, arrays, spec, mesh.n_model, bom,
                                  mesh.n_data, distributed.host_count(), log)
    return cfg, bom


def resolve_device(device, what: str = "train()") -> torch.device:
    """``device`` as a torch.device; a card that is absent raises (no
    fallback to the CPU), and so does a device other than cpu or cuda.
    ``what`` names the entry point in the message."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the card by default and "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    return device


def _with_position(loader: DataLoader) -> Iterator:
    """(batch, the loader's state once that batch is taken) per batch."""
    for batch in loader:
        yield batch, loader.state_dict()


def _grouped(items: Iterator, k: int) -> Iterator[List]:
    buf = []
    for item in items:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []


def _setup_mesh(cfg: Config, device: torch.device):
    """-> (mesh or None, this rank's device). One process (no process
    group) trains on ``device``, whatever ``seq_parallel`` says (the JAX
    driver on one device); a process group of ranks (``initialize`` joined
    it, or ``torch.distributed.run`` set its variables) trains over the
    (data, model) or (data, seq, model) grid of them."""
    import torch.distributed as dist

    from ..parallel import distributed
    from ..parallel.mesh import make_mesh

    distributed.initialize(device=device)
    if not dist.is_initialized():
        if cfg.mesh.model_parallel > 1:
            raise ValueError(
                f"mesh.model_parallel={cfg.mesh.model_parallel} shards the "
                "tables over that many ranks: run under python -m "
                "torch.distributed.run")
        return None, device
    if not cfg.mesh.enable:
        raise ValueError("mesh.enable=false with a process group of "
                         f"{dist.get_world_size()} ranks")
    device = distributed.rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return make_mesh(cfg.mesh.model_parallel, cfg.mesh.seq_parallel), device


def train(cfg: Config, log: Callable[[str], None] = print,
          device="cuda") -> Dict:
    """Run one config end to end on ``device``. -> {"test": the test
    metrics, "best_val_auc", "best_step", "history": the VAL metrics per
    eval, "params" and "ema_params" ({name: tensor}; None without EMA),
    "goodput"}, and "preempted": True after a SIGTERM (the test metrics
    nan).

    In a process group of several ranks (``python -m
    torch.distributed.run``, or ``parallel.initialize`` called first)
    every rank calls it: the JAX driver's mesh branches. The ranks form a
    (data, model) grid (``mesh.model_parallel``), or with
    ``mesh.seq_parallel > 1`` a (data, seq, model) grid whose seq groups
    shard the long scans' T axis (``parallel/seq_parallel.py``): without
    a model group that is ``make_sp_steps`` on replicated tables (JAX's
    (data, seq) branch), else the composed step. The tables are
    row-sharded over the model group (vocab padded to a multiple of it),
    each step is ``parallel.make_shardmap_steps`` on this rank's rows of
    its host's batch (``train.batch_size`` per host, as in JAX; the seq
    ranks of a cell take the same rows), each cell evaluates its own rows
    (counted once, by its seq rank 0) and the metrics are merged over
    every rank, and only rank 0 logs and writes: its checkpoint holds the
    whole tables (the single-device format, padded rows), which a resume
    on the same grid shards again. A device of ``cuda`` is
    ``cuda:LOCAL_RANK`` modulo the card count. "params" and "ema_params"
    are whole on every rank."""
    from ..parallel import distributed

    mesh, device = _setup_mesh(cfg, resolve_device(device))
    primary = distributed.is_primary()
    if not primary:
        log = lambda line: None  # noqa: E731 - only rank 0 logs
    train_arrays, val_arrays, test_arrays, spec = make_datasets(cfg)
    host, hosts = distributed.host_index(), distributed.host_count()
    # Each cell of the grid (the ranks of a seq group) scores its own
    # eval rows; its seq rank 0 counts them.
    cell, cells, counted = 0, 1, True
    sp_only = mesh is not None and mesh.n_seq > 1 and mesh.n_model == 1
    if mesh is not None:
        from ..parallel.embedding_sharding import pad_vocab

        cell = mesh.data_index * mesh.n_model + mesh.model_index
        cells, counted = mesh.n_data * mesh.n_model, mesh.seq_index == 0
        bom = False
        if not sp_only:
            cfg, bom = resolve_mesh(cfg, mesh, train_arrays, spec, log)
        over = ("data", "model") if bom else ("data",)
        s = mesh.n_model
        spec_init = dataclasses.replace(
            spec, n_items=pad_vocab(spec.n_items, s),
            n_cats=pad_vocab(spec.n_cats, s),
            n_users=pad_vocab(spec.n_users, s))
        if sp_only:
            log(f"mesh: {mesh.shape}, seq_parallel={mesh.n_seq} "
                f"(microbatches={cfg.mesh.sp_microbatches})")
        else:
            sp = (f", sp_microbatches={cfg.mesh.sp_microbatches}"
                  if mesh.n_seq > 1 else "")
            log(f"mesh: {mesh.shape}, embedding_mode="
                f"{cfg.mesh.embedding_mode}, batch_over_model={bom}{sp}")
    train_loader = DataLoader(train_arrays, cfg.train.batch_size,
                              shuffle=True, seed=cfg.seed,
                              process_index=host, process_count=hosts)
    val_loader = DataLoader(val_arrays, cfg.eval_batch_size, shuffle=False,
                            process_index=cell, process_count=cells)
    test_loader = DataLoader(test_arrays, cfg.eval_batch_size,
                             shuffle=False, process_index=cell,
                             process_count=cells)

    if mesh is None:
        model = init_model_for(cfg, spec, device)
    else:
        from ..parallel.train_step import shard_model

        model = shard_model(init_model_for(cfg, spec_init, "cpu"),
                            mesh).to(device)
    opt = make_optimizer(cfg, model.parameters())
    names = [n for n, _ in model.named_parameters()]
    ema_on = cfg.train.ema_decay > 0
    eval_model = copy.deepcopy(model) if ema_on else model

    def params_for_eval():
        """The EMA shadow when EMA is on (the weights that would be
        served), else the trained parameters."""
        if ema_on:
            with torch.no_grad():
                for p, e in zip(eval_model.parameters(), opt.ema_params()):
                    p.copy_(e)
        return eval_model

    k = cfg.train.steps_per_dispatch
    if k == 0:
        log("steps_per_dispatch=0 (the JAX startup probe) runs as 1 here")
        k = 1
    if mesh is None:
        train_step = make_multistep_train(cfg, model, opt)
        eval_step = make_eval_step(cfg, device)

        def place(group):
            return ([place_batch(b, device) for b, _ in group], group[-1][1])
    else:
        from ..parallel.mesh import shard_batch
        from ..parallel.seq_parallel import make_sp_steps
        from ..parallel.train_step import (gather_state, make_shardmap_steps,
                                           shard_state)

        make_steps = make_sp_steps if sp_only else make_shardmap_steps
        train_step, sharded_eval = make_steps(cfg, model, opt, mesh)

        def eval_step(model_, batch):
            return sharded_eval(model_, place_batch(batch, device))

        def place(group):
            return ([place_batch(shard_batch(mesh, b, over=over), device)
                     for b, _ in group], group[-1][1])
    merge_group = None if mesh is None else mesh.cpu_group

    def evaluate(loader):
        return run_evaluate(eval_step, params_for_eval(), loader,
                            cfg.eval_streaming_bins, cfg.eval_gauc_bins,
                            cfg.eval_gauc_max_users, group=merge_group,
                            counted=counted)

    def barrier():
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier(group=mesh.cpu_group)

    def load(restored):
        params, opt_state = restored["params"], restored["opt_state"]
        if mesh is not None:
            params, opt_state = shard_state(model, params, opt_state, mesh)
        model.load_state_dict(params)
        opt.load_state_dict(opt_state)

    mngr = None
    start_step = 0
    if cfg.train.ckpt_dir:
        mngr = CheckpointManager(
            cfg.train.ckpt_dir, cfg.train.keep_best_k,
            async_checkpointing=cfg.train.async_checkpoint)
        restored = mngr.restore()
        if restored is not None:
            load(restored)
            train_loader.load_state_dict(restored["loader"])
            start_step = int(restored["step"])
            log(f"resumed from step {start_step}")

    # Graceful preemption: on SIGTERM, snapshot at the next step boundary
    # (without metrics, so the best-k rotation keeps it) and return.
    stop_signal: list = []
    prev_sigterm = None
    if (mngr is not None
            and threading.current_thread() is threading.main_thread()):
        prev_sigterm = signal.signal(
            signal.SIGTERM, lambda s, f: stop_signal.append(s))

    def stopping() -> bool:
        """A SIGTERM seen here, or, in a process group, by any rank (every
        rank then stops at the same step)."""
        if mesh is None or mngr is None:
            return bool(stop_signal)
        import torch.distributed as dist

        flag = torch.tensor([int(bool(stop_signal))])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.cpu_group)
        return bool(flag.item())

    best_auc, best_step, evals_since_best = -1.0, -1, 0
    preempted = False
    history = []
    step = start_step
    # Goodput: the share of the wall time spent training; eval and
    # checkpoint pauses are the rest.
    t_run_start = time.time()
    nonproductive_s = eval_s = ckpt_s = 0.0
    n_evals = n_saves = 0
    t_last, n_since = time.time(), 0
    position = train_loader.state_dict()
    # The a2a exchange's fallback counter: the per-call flags (steps that
    # fell back) are pulled at log boundaries only.
    of_pending, overflow_steps, of_seen = [], 0, False

    def fold_overflow() -> int:
        nonlocal overflow_steps
        overflow_steps += int(sum(float(x) for x in of_pending))
        of_pending.clear()
        return overflow_steps

    it = prefetch_to_device(_grouped(_with_position(train_loader), k), place)
    writer = None
    if cfg.train.log_dir and primary:
        from .events import EventWriter

        writer = EventWriter(cfg.train.log_dir)
    profiler, profiled = None, False
    trace_dir = os.path.join(cfg.train.ckpt_dir or tempfile.gettempdir(),
                             "hpmn_torch_trace")

    def save(metrics=None):
        nonlocal ckpt_s, n_saves
        t0 = time.time()
        if mesh is None:
            model_state, opt_state = model.state_dict(), opt.state_dict()
        else:  # every rank gathers, rank 0 writes
            model_state, opt_state = gather_state(model, opt, mesh)
        if primary and metrics is None:
            mngr.save_preemption(step, model_state, opt_state, position)
        elif primary:
            mngr.save(step, model_state, opt_state, position, metrics)
        ckpt_s += time.time() - t0
        n_saves += 1

    try:
        while step < cfg.train.max_steps:
            batches, position = next(it)
            if cfg.train.profile_steps and step >= 5 and profiler is None \
                    and not profiled:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            try:
                metrics = train_step(batches)
            except FloatingPointError as e:
                raise FloatingPointError(
                    f"train step {step + getattr(e, 'offset', 0) + 1}: {e}"
                ) from e
            step += k
            n_since += k
            if "a2a_overflow" in metrics:
                of_pending.append(metrics["a2a_overflow"])
                of_seen = True
            if stopping():
                save()
                log(f"SIGTERM: checkpoint saved at step {step}; exiting")
                preempted = True
                break
            if profiler is not None and step >= 5 + cfg.train.profile_steps:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                if primary:
                    os.makedirs(trace_dir, exist_ok=True)
                    profiler.export_chrome_trace(
                        os.path.join(trace_dir, "trace.json"))
                profiler, profiled = None, True
                log(f"profile trace written to {trace_dir}")
            if step % cfg.train.log_every < k:  # crossed a log boundary
                loss_v = float(metrics["loss"])  # syncs before the clock
                dt = time.time() - t_last
                eps = n_since * cfg.train.batch_size / dt
                of_line = (f" a2a_overflow_steps {fold_overflow()}"
                           if of_seen else "")
                log(f"step {step} loss {loss_v:.4f} "
                    f"bce {float(metrics['bce']):.4f} ex/s {eps:.1f}"
                    f"{of_line}")
                if writer is not None:  # JAX's: its metrics come sorted
                    for name in sorted(metrics):
                        writer.add_scalar(f"train/{name}",
                                          float(metrics[name]), step)
                    writer.add_scalar("train/examples_per_sec", eps, step)
                t_last, n_since = time.time(), 0
            if step % cfg.train.eval_every < k or step >= cfg.train.max_steps:
                t_pause = time.time()
                val = evaluate(val_loader)
                eval_s += time.time() - t_pause
                n_evals += 1
                log(f"step {step} VAL auc {val['auc']:.4f} "
                    f"gauc {val['gauc']:.4f} log_loss {val['log_loss']:.4f} "
                    f"calib {val['calib']:.3f}")
                if writer is not None:
                    writer.add_scalar("val/auc", val["auc"], step)
                    writer.add_scalar("val/log_loss", val["log_loss"], step)
                history.append({"step": step, **val})
                if val["auc"] > best_auc:
                    best_auc, best_step, evals_since_best = val["auc"], step, 0
                    if mngr is not None:
                        save({"val_auc": val["auc"],
                              "val_log_loss": val["log_loss"]})
                else:
                    evals_since_best += 1
                    if evals_since_best >= cfg.train.early_stop_patience:
                        log(f"early stop at step {step} (best {best_auc:.4f} "
                            f"@ {best_step})")
                        nonproductive_s += time.time() - t_pause
                        break
                nonproductive_s += time.time() - t_pause
                t_last, n_since = time.time(), 0
    except BaseException:
        if writer is not None:
            writer.close()
        raise
    finally:
        if profiler is not None:
            profiler.stop()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    total_s = max(time.time() - t_run_start, 1e-9)
    goodput = max(0.0, 1.0 - nonproductive_s / total_s)
    fold_overflow()
    if overflow_steps:
        log(f"a2a_overflow_steps {overflow_steps} total (chronic fallback "
            f"-> raise mesh.a2a_capacity_factor)")
    if step > start_step:
        log(f"goodput {100 * goodput:.1f}% (train "
            f"{total_s - nonproductive_s:.1f}s, eval+ckpt "
            f"{nonproductive_s:.1f}s of {total_s:.1f}s)")
        log(f"eval {eval_s:.2f}s in {n_evals} evals, checkpoint "
            f"{ckpt_s:.2f}s in {n_saves} saves")

    def named(tensors):
        out = {n: t.detach() for n, t in zip(names, tensors)}
        if mesh is not None:  # whole tables on every rank
            from ..parallel.train_step import gather_rows, table_names

            for n in table_names(model):
                out[n] = gather_rows(out[n], mesh)
        return out

    def ema_params():
        return named(opt.ema_params()) if ema_on else None

    if mngr is not None:  # rank 0's writes are on disk before any read
        if primary:
            mngr.wait_until_finished()
        barrier()
    if preempted:
        # Fast exit: no test eval; the restarted run resumes from here.
        if writer is not None:
            writer.close()
        mngr.close()
        nan = float("nan")
        return {"test": {"auc": nan, "gauc": nan, "log_loss": nan,
                         "calib": nan, "n": 0.0},
                "best_val_auc": best_auc, "best_step": best_step,
                "history": history, "params": named(model.parameters()),
                "preempted": True, "goodput": goodput,
                "ema_params": ema_params()}

    # The final test eval with the best checkpoint if there is one.
    if mngr is not None and mngr.best_step() is not None:
        load(mngr.restore(mngr.best_step()))  # carries the EMA shadow
    test = evaluate(test_loader)
    log(f"TEST auc {test['auc']:.4f} gauc {test['gauc']:.4f} "
        f"log_loss {test['log_loss']:.4f} calib {test['calib']:.3f}")
    if writer is not None:
        writer.add_scalar("test/auc", test["auc"], step)
        writer.add_scalar("test/log_loss", test["log_loss"], step)
        writer.close()
    if mngr is not None:
        mngr.close()
    return {"test": test, "best_val_auc": best_auc, "best_step": best_step,
            "history": history, "params": named(model.parameters()),
            "goodput": goodput, "ema_params": ema_params()}


def _cast(old, val: str):
    if isinstance(old, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(old, tuple):
        return tuple(int(x) for x in val.split(",") if x)
    return (type(old) if old is not None else str)(val)


def apply_overrides(cfg: Config, kvs: Sequence[str]) -> Config:
    """Dotted ``key=value`` overrides (``train.max_steps=100``), each value
    cast to the type of the one it replaces, as the JAX
    ``apply_overrides`` does. -> a new Config (they are frozen)."""

    def replace(obj, parts, val):
        old = getattr(obj, parts[0])  # AttributeError names a wrong key
        new = (_cast(old, val) if len(parts) == 1
               else replace(old, parts[1:], val))
        return dataclasses.replace(obj, **{parts[0]: new})

    for kv in kvs:
        key, val = kv.split("=", 1)
        cfg = replace(cfg, key.split("."), val)
    return cfg


def main(argv=None):
    """CLI: python -m hpmn_tpu_torch.train.train --config amazon_hpmn
    [--device cuda|cpu|cuda:N] [--set key=value ...]. Under ``python -m
    torch.distributed.run --nproc_per_node N -m
    hpmn_tpu_torch.train.train ...`` every rank runs it (NCCL on the card,
    gloo with ``--device cpu``), and leaves the process group at the
    end."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default), cuda:N or cpu")
    p.add_argument("--set", nargs="*", default=[],
                   help="dotted config overrides, e.g. train.max_steps=100")
    args = p.parse_args(argv)
    from ..parallel import distributed

    try:
        return train(apply_overrides(get_config(args.config), args.set),
                     device=args.device)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
