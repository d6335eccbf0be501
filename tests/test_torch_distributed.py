"""The port's multi-rank driver on the CPU: ``parallel/distributed.py``,
the eval merges of ``train/evaluate.py`` and ``train()`` over a grid of
ranks, with its checkpoints.

Four gloo ranks (worker processes that import only torch, numpy and the
port, started with the variables ``python -m torch.distributed.run``
sets) run every case once (module fixture):

- ``initialize()`` from the environment, idempotent; ``is_primary`` on
  rank 0 alone;
- ``_merge_across_hosts`` on ragged shards with uids above 2^40, bit for
  bit, and its metrics against the JAX package's; the streaming AUC and
  GAUC merges against one accumulator over every shard;
- ``evaluate()`` with ``DataLoader(process_index=rank,
  process_count=4)``: every rank reports the one-process metrics;
- ``train()`` on a 2 x 2 grid (amazon_hpmn, a small spec, batch over
  data and model, a2a, checkpoints): only rank 0 writes; a fresh run
  resumed from the step-10 checkpoint on the same grid ends bit for bit
  where the uninterrupted run ends; in this process, the run on one
  process from the same weights ends within 1e-4 of max abs (parameters)
  and at phase 10's tolerances (AUC 0.02, log-loss 1e-5), and the 4-rank
  checkpoint loads on one device and resumes there.
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hpmn_tpu.train import metrics as j_metrics
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.parallel import distributed
from hpmn_tpu_torch.train import train as T
from hpmn_tpu_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TINY_SPEC = synthetic.DatasetSpec("amazon", seq_len=20, n_items=300,
                                  n_cats=20, n_users=40)
TINY = ["n_examples=400", "train.batch_size=16", "train.max_steps=20",
        "train.eval_every=10", "train.log_every=5",
        "train.early_stop_patience=100", "train.steps_per_dispatch=1",
        "eval_steps_per_dispatch=1", "eval_batch_size=32",
        "model.hpmn_layers=2", "train.lr=0.01", "train.keep_best_k=5"]
GRID = ["mesh.model_parallel=2"]  # replicated -> a2a, batch over model
TOL_AUC, TOL_LOG_LOSS, TOL_PARAMS = 0.02, 1e-5, 1e-4

WORKER = r"""
import os, shutil, sys
import numpy as np
import torch
torch.set_num_threads(1)
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.loader import DataLoader
from hpmn_tpu_torch.parallel import distributed
from hpmn_tpu_torch.train import checkpoint, evaluate as E, metrics as M
from hpmn_tpu_torch.train import train as T

work, tiny, grid = sys.argv[1], sys.argv[2].split(), sys.argv[3].split()
distributed.initialize(device="cpu")  # RANK, WORLD_SIZE, MASTER_* set
distributed.initialize(device="cpu")  # a no-op now
rank = distributed.process_index()
out = {"primary": np.asarray(distributed.is_primary()),
       "world": np.asarray(distributed.process_count()),
       "device": np.asarray(str(distributed.rank_device("cpu")))}


def shard_data(h):
    r = np.random.default_rng(100 + h)
    n = 13 + 5 * h  # ragged on purpose
    return (r.normal(size=n), (r.random(n) > 0.5).astype(np.float64),
            r.integers(0, 7, size=n) + (1 << 40))


lg, lb, ui = shard_data(rank)
g = E._merge_across_hosts(lg, lb, ui)
out.update({"merged_logits": g[0], "merged_labels": g[1],
            "merged_uids": g[2]})
acc, gacc = M.StreamingAUC(64), M.StreamingGAUC(16)
acc.update(lg, lb)
gacc.update(lg, lb, ui)
acc = E._merge_streaming_across_hosts(acc, 64)
gacc = E._merge_gauc_across_hosts(gacc, 16, 0)
out["stream_auc"] = np.asarray([acc.result()[k] for k in
                                ("auc", "log_loss", "calib", "n")])
out["stream_gauc"] = np.asarray(gacc.result())

spec = synthetic.DatasetSpec("amazon", seq_len=20, n_items=300, n_cats=20,
                             n_users=40)
arrays = synthetic.make_ctr_dataset(spec, 203, seed=4)
for streaming in (0, 64):
    loader = DataLoader(arrays, 16, shuffle=False, process_index=rank,
                        process_count=distributed.process_count())

    def eval_step(model, batch):
        return (batch.item_seq.float().mean(1) - 150.0) / 50.0

    res = E.evaluate(eval_step, None, loader, streaming_bins=streaming)
    out[f"eval{streaming}"] = np.asarray([res[k] for k in
                                          ("auc", "gauc", "log_loss",
                                           "calib", "n")])

synthetic.SPECS["amazon"] = spec
writes = []
write = checkpoint.CheckpointManager._write


def counted(self, step, *a):
    writes.append(step)
    return write(self, step, *a)


checkpoint.CheckpointManager._write = counted
lines = []
cfg = T.apply_overrides(configs.get_config("amazon_hpmn"),
                        tiny + grid + [f"train.ckpt_dir={work}/whole"])
res = T.train(cfg, log=lines.append, device="cpu")
out["writes"] = np.asarray(writes + [-1])
out["lines"] = np.asarray(lines + [""])
for n, p in res["params"].items():
    out[f"param/{n}"] = p.numpy()
out["test"] = np.asarray([res["test"][k] for k in ("auc", "log_loss")])
out["best_val_auc"] = np.asarray(res["best_val_auc"])
if rank == 0:
    shutil.copytree(f"{work}/whole/10", f"{work}/resumed/10")
torch.distributed.barrier()
cfg_r = T.apply_overrides(cfg, [f"train.ckpt_dir={work}/resumed"])
lines_r = []
res_r = T.train(cfg_r, log=lines_r.append, device="cpu")
out["lines_resumed"] = np.asarray(lines_r + [""])
for n, p in res_r["params"].items():
    out[f"resumed/{n}"] = p.numpy()
np.savez(os.path.join(work, f"out{rank}.npz"), **out)
distributed.shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(synthetic.SPECS, "amazon", TINY_SPEC)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("distributed")
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(work), " ".join(TINY),
             " ".join(GRID)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return work, [dict(np.load(work / f"out{r}.npz")) for r in range(WORLD)]


def test_initialize_is_a_no_op_on_one_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize(device="cpu")
    distributed.initialize(num_processes=1, device="cpu")
    assert not dist.is_initialized()
    assert distributed.is_primary() and distributed.process_count() == 1
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda") == "nccl"
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")


def test_initialize_reads_the_launcher_environment(ranks):
    _, outs = ranks
    assert [bool(o["primary"]) for o in outs] == [True, False, False, False]
    assert all(int(o["world"]) == WORLD and str(o["device"]) == "cpu"
               for o in outs)


def _shard_data(h):
    r = np.random.default_rng(100 + h)
    n = 13 + 5 * h
    return (r.normal(size=n), (r.random(n) > 0.5).astype(np.float64),
            r.integers(0, 7, size=n) + (1 << 40))


def test_merge_across_hosts_is_bit_exact(ranks):
    """Ragged shards, uids above 2^40: every rank gets the concatenation
    in rank order, bit for bit (float64 logits, int64 uids)."""
    _, outs = ranks
    want = [np.concatenate(a) for a in zip(*map(_shard_data, range(WORLD)))]
    for o in outs:
        np.testing.assert_array_equal(o["merged_logits"], want[0])
        np.testing.assert_array_equal(o["merged_labels"], want[1])
        np.testing.assert_array_equal(o["merged_uids"], want[2])
        assert o["merged_uids"].dtype == np.int64


def test_streaming_merges_equal_one_accumulator(ranks):
    from hpmn_tpu_torch.train import metrics as M

    _, outs = ranks
    lg, lb, ui = [np.concatenate(a)
                  for a in zip(*map(_shard_data, range(WORLD)))]
    acc, gacc = M.StreamingAUC(64), M.StreamingGAUC(16)
    acc.update(lg, lb)
    gacc.update(lg, lb, ui)
    want = acc.result()
    for o in outs:
        got = dict(zip(("auc", "log_loss", "calib", "n"), o["stream_auc"]))
        for k in ("auc", "calib", "n"):
            assert got[k] == want[k], k
        assert abs(got["log_loss"] - want["log_loss"]) <= 1e-15
        assert float(o["stream_gauc"]) == gacc.result()


def test_merged_metrics_match_jax(ranks):
    """The metrics of the merged shards == the JAX package's metrics of
    the concatenation (what JAX's ``evaluate`` computes after its merge)."""
    from hpmn_tpu_torch.train import metrics as M

    _, outs = ranks
    lg, lb, ui = [np.concatenate(a)
                  for a in zip(*map(_shard_data, range(WORLD)))]
    o = outs[1]
    got = (o["merged_logits"], o["merged_labels"], o["merged_uids"])
    for name in ("auc", "log_loss", "calibration"):
        assert getattr(M, name)(*got[:2]) == getattr(j_metrics, name)(lg, lb)
    assert M.gauc(*got) == j_metrics.gauc(lg, lb, ui)


@pytest.mark.parametrize("streaming", [0, 64])
def test_evaluate_over_ranks_equals_one_process(ranks, streaming):
    from hpmn_tpu_torch.data.loader import DataLoader
    from hpmn_tpu_torch.train.evaluate import evaluate

    _, outs = ranks
    arrays = synthetic.make_ctr_dataset(TINY_SPEC, 203, seed=4)
    loader = DataLoader(arrays, 16, shuffle=False)
    want = evaluate(lambda m, b: (b.item_seq.float().mean(1) - 150.0) / 50.0,
                    None, loader, streaming_bins=streaming)
    for o in outs:
        got = o[f"eval{streaming}"]
        np.testing.assert_allclose(
            got, [want[k] for k in ("auc", "gauc", "log_loss", "calib",
                                    "n")], rtol=1e-12, atol=0)


def test_only_rank_zero_writes_checkpoints(ranks):
    work, outs = ranks
    assert len(outs[0]["writes"]) > 1  # step 10, and 20 if it improved
    assert all(list(o["writes"]) == [-1] for o in outs[1:])
    lines = [list(o["lines"][:-1]) for o in outs]
    assert lines[1:] == [[], [], []]  # only rank 0 logs
    assert any(line.startswith("mesh: {'data': 2, 'model': 2}, "
                               "embedding_mode=a2a, batch_over_model=True")
               for line in lines[0])
    assert any("a2a_overflow_steps 0" in line for line in lines[0])


def test_resume_on_the_same_grid_continues_bit_for_bit(ranks):
    _, outs = ranks
    assert "resumed from step 10" in list(outs[0]["lines_resumed"])
    for o in outs:
        for k in o:
            if k.startswith("param/"):
                np.testing.assert_array_equal(
                    o[k], o[k.replace("param/", "resumed/")], err_msg=k)
    for k in outs[0]:  # every rank returns the whole parameters
        if k.startswith("param/"):
            for o in outs[1:]:
                np.testing.assert_array_equal(o[k], outs[0][k])


def test_train_over_ranks_matches_one_process(ranks, tiny):
    """The same config on one process (the same seeded weights: the
    vocab needs no padding) against the 2 x 2 run."""
    _, outs = ranks
    res = T.train(T.apply_overrides(configs.get_config("amazon_hpmn"), TINY),
                  log=lambda s: None, device="cpu")
    got = outs[0]
    max_abs = max(p.abs().max().item() for p in res["params"].values())
    for n, p in res["params"].items():
        err = np.abs(got[f"param/{n}"] - p.numpy()).max()
        assert err <= TOL_PARAMS * max_abs, (n, err)
    auc, log_loss = got["test"]
    assert abs(auc - res["test"]["auc"]) < TOL_AUC
    assert abs(log_loss - res["test"]["log_loss"]) < TOL_LOG_LOSS
    assert abs(float(got["best_val_auc"]) - res["best_val_auc"]) < TOL_AUC


def test_rank_zero_checkpoint_loads_and_resumes_on_one_device(ranks, tiny,
                                                               tmp_path):
    work, outs = ranks
    shutil.copytree(work / "whole", tmp_path / "ckpt")
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    latest = mngr.latest_step()
    state = mngr.restore(latest)
    model = T.init_model_for(T.apply_overrides(
        configs.get_config("amazon_hpmn"), TINY), TINY_SPEC, "cpu")
    model.load_state_dict(state["params"])  # whole tables: 300 x 16 rows
    assert state["params"]["embedding.item"].shape == (300, 16)
    if latest == 20:
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          outs[0][f"param/{n}"])
    lines = []
    res = T.train(T.apply_overrides(configs.get_config("amazon_hpmn"), TINY +
                                    ["train.max_steps=30",
                                     f"train.ckpt_dir={tmp_path / 'ckpt'}"]),
                  log=lines.append, device="cpu")
    assert f"resumed from step {latest}" in lines
    assert np.isfinite(res["test"]["log_loss"])
