"""The port's training driver (``hpmn_tpu_torch/train/train.py``) on the
CPU: the golden run against the JAX package's, resume, preemption,
checkpoint rotation, early stop, EMA evaluation, the overrides and the CLI.

- The golden run: ``train()`` on the settings of ``tests/test_train.py``'s
  ``_small_cfg`` (amazon_hpmn, 3000 examples, B 64, 200 steps, eval every
  100, one step and one eval batch per dispatch), started through the
  driver's init seam (``init_model_for``) from the JAX package's
  initialised parameters (``convert.model_from_flat``), meets
  ``tests/golden_amazon_hpmn.json`` within its 0.02 on best_val_auc,
  test_auc and test_log_loss.
- A run resumed from its step-100 checkpoint ends with the parameters of
  the uninterrupted run at step 200, bit for bit; so does a run resumed
  from a SIGTERM snapshot.
- The checkpoint rotation is held to the JAX package's (orbax) on the
  same saves: the same steps kept, best and latest.

The other runs use a small stand-in for the Amazon spec (T 20, 300
items) and take a second or two each. Every run here uses one intra-op
thread (about 20 s for a 200-step golden run), so that it takes as long
beside other test processes as alone.
"""

import dataclasses
import inspect
import json
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu.train import checkpoint as j_checkpoint
from hpmn_tpu.train.train import apply_overrides as j_apply_overrides
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.loader import DataLoader
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.train import checkpoint
from hpmn_tpu_torch.train import train as T
from hpmn_tpu_torch.train.evaluate import evaluate

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_amazon_hpmn.json")
GOLDEN_TOL = 0.02
# tests/test_train.py _small_cfg, and a log line at every eval (logging
# does not touch the numbers).
SMALL = ["n_examples=3000", "train.batch_size=64", "train.max_steps=200",
         "train.eval_every=100", "train.log_every=100",
         "train.early_stop_patience=100", "train.steps_per_dispatch=1",
         "eval_steps_per_dispatch=1"]
TINY_SPEC = synthetic.DatasetSpec("amazon", seq_len=20, n_items=300,
                                  n_cats=20, n_users=40)
TINY = ["n_examples=400", "train.batch_size=16", "train.max_steps=30",
        "train.eval_every=10", "train.log_every=1",
        "train.early_stop_patience=100", "train.steps_per_dispatch=1",
        "eval_steps_per_dispatch=1", "eval_batch_size=64"]


def _cfg(overrides, *more):
    return T.apply_overrides(configs.get_config("amazon_hpmn"),
                             list(overrides) + list(more))


class _Run:
    """One train() call with its model in reach: the model is the one the
    init seam builds, and ``params_at[n]`` the parameters when the driver
    logs step n's loss."""

    def __init__(self, monkeypatch, flat=None, sigterm_at=None):
        self.model, self.lines, self.params_at = None, [], {}
        self.sigterm_at = sigterm_at

        def init(cfg, spec, device):
            if flat is None:
                self.model = init_model(cfg, spec.n_items, spec.n_cats,
                                        device=device)
            else:
                self.model = model_from_flat(cfg, flat, device=device)
            return self.model

        monkeypatch.setattr(T, "init_model_for", init)

    def log(self, line):
        self.lines.append(line)
        words = line.split()
        if words[0] == "step" and words[2] == "loss":
            n = int(words[1])
            self.params_at[n] = {k: p.detach().clone()
                                 for k, p in self.model.named_parameters()}
            if n == self.sigterm_at:
                signal.raise_signal(signal.SIGTERM)

    def __call__(self, cfg):
        return T.train(cfg, log=self.log, device="cpu")


def _same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    """The golden run from the JAX init, once for the module."""
    cfg = _cfg(SMALL)
    spec = synthetic.SPECS["amazon"]
    params = j_init_model(jax.random.key(cfg.seed),
                          j_get_config("amazon_hpmn"), spec.n_items,
                          spec.n_cats, n_users=spec.n_users)
    keys, leaves, _ = flatten_with_keys(params)
    flat = {k: np.asarray(v) for k, v in zip(keys, leaves)}
    with pytest.MonkeyPatch.context() as mp:
        run = _Run(mp, flat)
        res = run(cfg)
    return cfg, flat, run, res


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(synthetic.SPECS, "amazon", TINY_SPEC)


def test_golden_run_from_the_jax_init(golden):
    _, _, run, res = golden
    with open(GOLDEN_PATH) as f:
        want = json.load(f)
    got = {"best_val_auc": res["best_val_auc"],
           "test_auc": res["test"]["auc"],
           "test_log_loss": res["test"]["log_loss"]}
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) < GOLDEN_TOL, (k, got[k], want[k])
    assert [h["step"] for h in res["history"]] == [100, 200]
    assert any(line.startswith("TEST auc") for line in run.lines)


def test_resume_from_the_step_100_checkpoint_is_bit_for_bit(
        golden, tmp_path, monkeypatch):
    cfg, flat, uninterrupted, res = golden
    ckpt = [f"train.ckpt_dir={tmp_path}"]
    first = _Run(monkeypatch, flat)
    first(T.apply_overrides(cfg, ckpt + ["train.max_steps=100"]))
    assert checkpoint.CheckpointManager(str(tmp_path)).latest_step() == 100
    resumed = _Run(monkeypatch, flat)
    out = resumed(T.apply_overrides(cfg, ckpt))
    assert "resumed from step 100" in resumed.lines
    assert 100 not in resumed.params_at
    _same_params(resumed.params_at[200], uninterrupted.params_at[200])
    assert out["history"][-1] == res["history"][-1]  # the VAL at step 200


def test_sigterm_snapshot_and_resume(tiny, tmp_path, monkeypatch):
    assert threading.current_thread() is threading.main_thread()
    handler = signal.getsignal(signal.SIGTERM)
    cfg = _cfg(TINY, f"train.ckpt_dir={tmp_path}")
    whole = _Run(monkeypatch)
    whole(_cfg(TINY))
    cut = _Run(monkeypatch, sigterm_at=12)
    res = cut(cfg)
    assert res["preempted"] and np.isnan(res["test"]["auc"])
    assert "SIGTERM: checkpoint saved at step 13; exiting" in cut.lines
    assert signal.getsignal(signal.SIGTERM) == handler
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    assert mngr.latest_step() == 13 and mngr.best_step() == 10
    with open(tmp_path / "preempt_step.txt") as f:
        assert f.read() == "13"
    resumed = _Run(monkeypatch)
    resumed(cfg)
    assert "resumed from step 13" in resumed.lines
    _same_params(resumed.params_at[30], whole.params_at[30])


def _state(step):
    return {"w": torch.full((2, 3), float(step))}


@pytest.mark.parametrize("async_checkpointing", [False, True])
def test_rotation_keeps_the_preemption_snapshot(tmp_path,
                                                async_checkpointing):
    """Best-k by val_auc, the preemption snapshot outside the ranking and
    rotated: the steps kept, best and latest after each save equal the
    JAX manager's (orbax) on the same saves."""
    mine = checkpoint.CheckpointManager(str(tmp_path / "torch"), 2,
                                        async_checkpointing)
    theirs = j_checkpoint.CheckpointManager(str(tmp_path / "jax"), 2)
    saves = [(1, 0.5), (2, 0.7), (3, 0.6), (4, None), (5, 0.9), (6, None),
             (7, 0.55)]
    loader = {"epoch": 0, "step": 0, "seed": 0, "global_batch": 4}
    opt = {"w": np.zeros((2, 3), np.float32)}
    for step, auc in saves:
        params = {"w": np.full((2, 3), float(step), np.float32)}
        if auc is None:
            mine.save_preemption(step, _state(step), _state(0), loader)
            theirs.save_preemption(step, params, opt, loader)
        else:
            metrics = {"val_auc": auc}
            mine.save(step, _state(step), _state(0), loader, metrics)
            theirs.save(step, params, opt, loader, metrics)
        theirs._mngr.wait_until_finished()
        assert mine.all_steps() == list(theirs._mngr.all_steps())
        assert mine.best_step() == theirs.best_step()
        assert mine.latest_step() == theirs.latest_step()
    assert mine.all_steps() == [2, 5, 6]  # the best two and the snapshot
    latest = mine.restore()
    assert latest["step"] == 6 and torch.equal(latest["params"]["w"],
                                               _state(6)["w"])
    assert mine.restore(5)["params"]["w"][0, 0].item() == 5.0
    mine.close()
    theirs.close()


def test_early_stop(tiny):
    """lr 0: the val AUC never improves, so patience 1 stops at the second
    eval, and the test eval uses the best (first) checkpoint."""
    lines = []
    res = T.train(_cfg(TINY, "train.lr=0.0", "train.early_stop_patience=1"),
                  log=lines.append, device="cpu")
    assert [h["step"] for h in res["history"]] == [10, 20]
    assert res["best_step"] == 10
    assert any(line.startswith("early stop at step 20 (best")
               for line in lines)
    assert not any(line.startswith("step 21 ") for line in lines)


def test_eval_uses_the_ema_params(tiny):
    cfg = _cfg(TINY, "train.ema_decay=0.9")
    res = T.train(cfg, log=lambda s: None, device="cpu")
    ema, raw = res["ema_params"], res["params"]
    assert ema.keys() == raw.keys()
    assert any(not torch.equal(ema[k], raw[k]) for k in ema)
    _, _, test_arrays, spec = T.make_datasets(cfg)
    scores = []
    for params in (ema, raw):
        model = init_model(cfg, spec.n_items, spec.n_cats, device="cpu")
        model.load_state_dict(params)
        scores.append(evaluate(T.make_eval_step(cfg, "cpu"), model,
                               DataLoader(test_arrays, cfg.eval_batch_size,
                                          shuffle=False)))
    assert scores[0] == res["test"]
    assert scores[1]["log_loss"] != res["test"]["log_loss"]


def test_dispatch_groups_change_only_the_boundaries(tiny, monkeypatch):
    """steps_per_dispatch 3: the same 30 steps (the same parameters, bit
    for bit), evals where a group crosses a boundary (12, 21, 30)."""
    runs = {}
    for k in (1, 3):
        run = _Run(monkeypatch)
        res = run(_cfg(TINY, f"train.steps_per_dispatch={k}"))
        runs[k] = (run, res)
    _same_params(runs[3][0].params_at[30], runs[1][0].params_at[30])
    assert [h["step"] for h in runs[3][1]["history"]] == [12, 21, 30]
    assert sorted(runs[3][0].params_at) == list(range(3, 31, 3))


def test_profile_steps_writes_a_trace(tiny, tmp_path):
    lines = []
    T.train(_cfg(TINY, "train.profile_steps=2", f"train.ckpt_dir={tmp_path}"),
            log=lines.append, device="cpu")
    trace = tmp_path / "hpmn_torch_trace" / "trace.json"
    assert trace.is_file() and trace.stat().st_size > 0
    assert f"profile trace written to {trace.parent}" in lines


def test_apply_overrides_matches_jax():
    kvs = ["n_examples=4000", "train.max_steps=150", "train.lr=0.01",
           "model.use_pallas=true", "model.tower_hidden=64,32",
           "train.async_checkpoint=1", "eval_batch_size=128",
           "model.scan_dtype=bfloat16", "train.lr_schedule=cosine",
           "train.ckpt_dir=/x/y", "mesh.enable=false", "seed=3",
           "model.hpmn_period=5", "loss.cov_weight=0.25"]
    got = T.apply_overrides(configs.get_config("xlong_hpmn"), kvs)
    want = j_apply_overrides(j_get_config("xlong_hpmn"), kvs)
    for kv in kvs:
        ref_got, ref_want = got, want
        for part in kv.split("=")[0].split("."):
            ref_got, ref_want = getattr(ref_got, part), ref_want[part]
        assert ref_got == ref_want and type(ref_got) is type(ref_want), kv
    with pytest.raises(AttributeError):
        T.apply_overrides(got, ["train.no_such_field=1"])


def test_main_prints_the_jax_log_lines(tiny, capsys):
    T.main(["--config", "amazon_hpmn", "--device", "cpu", "--set", *TINY,
            "train.log_every=10", "synthetic_task=periodic"])
    out = capsys.readouterr().out.splitlines()
    words = [line.split() for line in out]
    loss = [w for w in words if w[2:3] == ["loss"]]
    assert [w[1] for w in loss] == ["10", "20", "30"]
    assert all(w[4] == "bce" and w[6] == "ex/s" for w in loss)
    assert [w[1] for w in words if w[2:4] == ["VAL", "auc"]] == \
        ["10", "20", "30"]
    assert sum(line.startswith("TEST auc ") and "log_loss" in line
               for line in out) == 1
    assert any(line.startswith("goodput ") for line in out)


def test_train_runs_on_the_card_by_default(tiny, monkeypatch):
    """No card: an error, not a run on the CPU."""
    assert inspect.signature(T.train).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.train(_cfg(TINY), log=lambda s: None)
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(["--config", "amazon_hpmn", "--set", *TINY])


@pytest.mark.parametrize("config,family", [
    ("taobao_bst", "bst"), ("amazon_hpmn", "svdpp"), ("amazon_hpmn", "dnn"),
    ("amazon_hpmn", "lstm"), ("amazon_hpmn", "caser"),
    ("amazon_hpmn", "shan")])
def test_main_trains_the_remaining_families(tiny, monkeypatch, capsys,
                                            config, family):
    """``python -m hpmn_tpu_torch.train.train --config taobao_bst`` and
    ``--config amazon_hpmn --set model.name=svdpp`` (and the other
    extra_baselines families) train to a TEST line; SVD++'s p_u takes the
    dataset's users (init_model_for passes spec.n_users)."""
    monkeypatch.setitem(synthetic.SPECS, "taobao", dataclasses.replace(
        TINY_SPEC, name="taobao", seq_len=30))
    seen = {}
    seam = T.init_model_for

    def init(cfg, spec, device):
        seen["model"] = seam(cfg, spec, device)
        return seen["model"]

    monkeypatch.setattr(T, "init_model_for", init)
    T.main(["--config", config, "--device", "cpu", "--set",
            f"model.name={family}", *TINY, "train.max_steps=10",
            "train.eval_every=5"])
    out = capsys.readouterr().out
    assert sum(line.startswith("TEST auc ") for line in out.splitlines()) == 1
    if family == "svdpp":
        assert seen["model"].encoder.p_u.shape[0] == TINY_SPEC.n_users


@pytest.mark.parametrize("override,error,match", [
    pytest.param(o, NotImplementedError, "ROADMAP", id=o) for o in (
        "model.scan_dtype=float16", "model.dtype=float16")] + [
    pytest.param("mesh.model_parallel=2", ValueError,
                 "torch.distributed.run", id="mesh.model_parallel=2")] + [
    pytest.param(o, None, None, id=o) for o in (
        "mesh.embedding_mode=a2a", "mesh.seq_parallel=2",
        "train.log_dir=/some/events", "train.debug_nans=true",
        "model.dtype=bfloat16")])
def test_unported_driver_options_raise(tiny, tmp_path, override, error,
                                       match):
    """The options the port does not run raise, naming ROADMAP.md (float16,
    which the JAX package takes). On one process, model_parallel > 1
    raises (the tables shard over ranks: parallel/); an exchange mode
    alone, or seq_parallel > 1 alone, trains on the one device, as the JAX
    driver does on one; log_dir (its directory here under tmp_path),
    debug_nans and a bf16 model train (tests/test_torch_driver_options.py,
    tests/test_torch_dtype.py hold them to JAX)."""
    if override.startswith("train.log_dir="):
        override = f"train.log_dir={tmp_path / 'events'}"
    cfg = _cfg(TINY, override, "train.max_steps=2", "train.eval_every=2")
    if error is None:
        assert np.isfinite(T.train(cfg, log=lambda s: None,
                                   device="cpu")["test"]["log_loss"])
        return
    with pytest.raises(error, match=match):
        T.train(cfg, log=lambda s: None, device="cpu")


def test_user_memory_files_round_trip_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    uids = rng.permutation(9).astype(np.int64) + 100
    memory = rng.standard_normal((9, 3, 32)).astype(np.float32)
    counters = rng.integers(0, 1000, 9)
    checkpoint.save_user_memory(str(tmp_path / "a"), uids, memory, counters)
    j_checkpoint.save_user_memory(str(tmp_path / "b"), uids, memory,
                                  counters)
    for got, want in ((checkpoint.load_user_memory(str(tmp_path / "b")),
                       j_checkpoint.load_user_memory(str(tmp_path / "a"))),
                      (checkpoint.load_user_memory(str(tmp_path / "a")),
                       (np.sort(uids), memory[np.argsort(uids)],
                        counters[np.argsort(uids)]))):
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    empty = checkpoint.load_user_memory(str(tmp_path / "none"))
    assert [a.shape for a in empty] == [(0,), (0, 0, 0), (0,)]
