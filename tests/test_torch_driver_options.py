"""The driver's last options and tools in the port against the JAX
package on the CPU: ``train.log_dir`` (TensorBoard event files written by
``hpmn_tpu_torch/train/events.py``), ``train.debug_nans``, and the
``sweep`` and ``quality_gate`` tools.

- ``log_dir``: JAX's ``train()`` writes through a stand-in
  ``tensorboardX`` module (put in ``sys.modules``; the package is not
  installed) that records each ``add_scalar``; the port's ``train()``,
  from the JAX init through the driver's init seam, writes an event file,
  read back here: the same (tag, step) in the same order, and the same
  values (examples/s aside, a clock's) within the driver tolerances:
  1e-4 relative on the training metrics and the log-loss, 2e-3 on AUC
  (measured: 4e-7 and 2e-5 after 30 steps of B 16).
- ``debug_nans``: a NaN weight raises FloatingPointError in the first
  train step in both packages (JAX's ``jax_debug_nans``), before the
  first log line; a clean run with it on gives the bits of the run with
  it off. On a grid of two gloo ranks, a NaN in one rank's copy of a
  weight raises on both, in the same step at the same check.
- ``sweep`` and ``quality_gate --no_pallas`` at a few steps print the
  JAX tools' JSON: the same keys, trials and best step, the numbers
  within the tolerances above.

The runs use small stand-ins for the Amazon and Taobao specs in both
packages (T 20 and 40, 300 items) and take a few seconds each.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import hpmn_tpu.data.synthetic as j_synthetic
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.tools import quality_gate, sweep
from hpmn_tpu_torch.train import events
from hpmn_tpu_torch.train import train as T

J = importlib.import_module("hpmn_tpu.train.train")  # the module, not train()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4  # training metrics and log-loss, relative
AUC_TOL = 2e-3
TINY = ["n_examples=400", "train.batch_size=16", "train.max_steps=30",
        "train.eval_every=10", "train.log_every=5",
        "train.early_stop_patience=100", "train.steps_per_dispatch=1",
        "eval_steps_per_dispatch=1", "eval_batch_size=64"]


@pytest.fixture(autouse=True)
def small_specs(monkeypatch):
    """Both packages' amazon and taobao specs cut to T 20 and 40."""
    for name, seq_len in (("amazon", 20), ("taobao", 40)):
        spec = dataclasses.replace(synthetic.SPECS[name], seq_len=seq_len,
                                   n_items=300, n_cats=20, n_users=40)
        monkeypatch.setitem(synthetic.SPECS, name, spec)
        monkeypatch.setitem(j_synthetic.SPECS, name, j_synthetic.DatasetSpec(
            name, seq_len=seq_len, n_items=300, n_cats=20, n_users=40))


@pytest.fixture
def from_jax_init(monkeypatch):
    """The port's driver starts from the JAX package's init of the same
    config and seed (the JAX driver's ``init_model(key(cfg.seed))``)."""

    def init(cfg, spec, device):
        j_cfg = j_get_config("amazon_hpmn")
        for field in dataclasses.fields(cfg.model):
            value = getattr(cfg.model, field.name)
            setattr(j_cfg.model, field.name,
                    list(value) if isinstance(value, tuple) else value)
        j_cfg.dataset = cfg.dataset
        params = j_init_model(jax.random.key(cfg.seed), j_cfg, spec.n_items,
                              spec.n_cats, n_users=spec.n_users)
        keys, leaves, _ = flatten_with_keys(params)
        return model_from_flat(cfg, {k: np.asarray(v)
                                     for k, v in zip(keys, leaves)}, device)

    monkeypatch.setattr(T, "init_model_for", init)


def test_crc32c_and_the_record_frame():
    """CRC-32C's check value; a frame's length and data CRCs masked as
    TFRecord masks them; an event encoded and decoded."""
    assert events.crc32c(b"123456789") == 0xE3069283
    assert events.crc32c(b"") == 0
    data = events.encode_event(1.5, 7, tag="train/loss", value=0.25)
    rec = events.frame(data)
    assert rec[:8] == len(data).to_bytes(8, "little")
    assert int.from_bytes(rec[8:12], "little") == events.masked_crc32c(
        rec[:8])
    assert rec[12:-4] == data
    assert int.from_bytes(rec[-4:], "little") == events.masked_crc32c(data)
    assert events.decode_event(data) == {
        "wall_time": 1.5, "step": 7, "values": [("train/loss", 0.25)]}
    assert events.decode_event(events.encode_event(
        2.0, file_version="brain.Event:2")) == {
        "wall_time": 2.0, "step": 0, "file_version": "brain.Event:2"}


def test_event_file_reads_back_and_checks_its_crcs(tmp_path):
    writer = events.EventWriter(str(tmp_path))
    assert os.path.basename(writer.path).startswith("events.out.tfevents.")
    writer.add_scalar("a", 1.0, 3)
    writer.add_scalar("b", -2.5, 2 ** 40)
    writer.close()
    got = events.read_events(writer.path)
    assert got[0]["file_version"] == "brain.Event:2"
    assert events.scalars(writer.path) == [("a", 3, 1.0),
                                           ("b", 2 ** 40, -2.5)]
    with open(writer.path, "r+b") as f:  # one flipped bit of the last value
        f.seek(-5, os.SEEK_END)
        byte = f.read(1)[0]
        f.seek(-5, os.SEEK_END)
        f.write(bytes([byte ^ 1]))
    with pytest.raises(ValueError, match="CRC"):
        events.read_events(writer.path)


def _recording_tensorboardx():
    """A stand-in ``tensorboardX`` whose SummaryWriter records
    (tag, step, value) per add_scalar."""
    written = []

    class SummaryWriter:
        def __init__(self, log_dir):
            self.log_dir = log_dir

        def add_scalar(self, tag, value, step):
            written.append((tag, int(step), float(value)))

        def close(self):
            pass

    module = types.ModuleType("tensorboardX")
    module.SummaryWriter = SummaryWriter
    return module, written


def _close(tag, got, want):
    if tag.endswith("examples_per_sec"):
        return np.isfinite(got) and got > 0
    tol = AUC_TOL if tag.endswith("auc") else REL_TOL * max(1.0, abs(want))
    return abs(got - want) <= tol


def test_log_dir_writes_what_the_jax_driver_writes(tmp_path, monkeypatch,
                                                   from_jax_init):
    fake, want = _recording_tensorboardx()
    monkeypatch.setitem(sys.modules, "tensorboardX", fake)
    j_cfg = J.apply_overrides(j_get_config("amazon_hpmn"),
                              TINY + [f"train.log_dir={tmp_path / 'jax'}"])
    J.train(j_cfg, log=lambda s: None)
    cfg = T.apply_overrides(configs.get_config("amazon_hpmn"),
                            TINY + [f"train.log_dir={tmp_path / 'port'}"])
    T.train(cfg, log=lambda s: None, device="cpu")
    files = os.listdir(tmp_path / "port")
    assert len(files) == 1
    got = events.scalars(str(tmp_path / "port" / files[0]))
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    assert {t for t, _, _ in got} == {
        "train/bce", "train/cov_reg", "train/l2", "train/loss",
        "train/examples_per_sec", "val/auc", "val/log_loss", "test/auc",
        "test/log_loss"}
    bad = [(t, s, g, w) for (t, s, g), (_, _, w) in zip(got, want)
           if not _close(t, g, w)]
    assert not bad, bad[:5]


def test_debug_nans_raises_in_the_first_step_as_jax_does(monkeypatch,
                                                         from_jax_init):
    """One NaN in the first tower weight: FloatingPointError in train
    step 1, before any log line, in both packages."""
    j_init = J.init_model

    def j_nan_init(*a, **k):
        params = j_init(*a, **k)
        w = np.array(params["tower"]["layers"][0]["w"])
        w[0, 0] = np.nan  # placed as is: no jax op yields the NaN
        params["tower"]["layers"][0]["w"] = jax.device_put(w)
        return params

    seam = T.init_model_for

    def nan_init(cfg, spec, device):
        model = seam(cfg, spec, device)
        with torch.no_grad():
            model.tower.layers[0].w[0, 0] = float("nan")
        return model

    monkeypatch.setattr(J, "init_model", j_nan_init)
    monkeypatch.setattr(T, "init_model_for", nan_init)
    # One device for JAX (its mesh branch inits elsewhere), as the port.
    opts = TINY + ["train.debug_nans=true", "train.log_every=1",
                   "mesh.enable=false"]
    j_lines, lines = [], []
    try:
        with pytest.raises(FloatingPointError):
            J.train(J.apply_overrides(j_get_config("amazon_hpmn"), opts),
                    log=j_lines.append)
    finally:
        jax.config.update("jax_debug_nans", False)
    cfg = T.apply_overrides(configs.get_config("amazon_hpmn"), opts)
    with pytest.raises(FloatingPointError, match=r"^train step 1: NaN in "
                       r"the forward's loss"):
        T.train(cfg, log=lines.append, device="cpu")
    assert not any(line.startswith("step") for line in j_lines + lines)


@pytest.mark.parametrize("k", [1, 3])
def test_debug_nans_changes_no_bit_of_a_clean_run(k):
    """With and without debug_nans (k steps per dispatch): the same
    parameters, bit for bit, and the same log lines but the clock's."""
    out = []
    for flag in ("false", "true"):
        cfg = T.apply_overrides(configs.get_config("amazon_hpmn"), TINY + [
            f"train.debug_nans={flag}", f"train.steps_per_dispatch={k}"])
        lines = []
        res = T.train(cfg, log=lines.append, device="cpu")
        out.append((res, [line.split(" ex/s")[0] for line in lines
                          if not line.startswith(("goodput", "eval "))]))
    (a, lines_a), (b, lines_b) = out
    assert lines_a == lines_b
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


MESH_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.parallel import distributed
from hpmn_tpu_torch.train import train as T

distributed.initialize(device="cpu")
rank = distributed.process_index()
synthetic.SPECS["amazon"] = synthetic.DatasetSpec(
    "amazon", seq_len=20, n_items=300, n_cats=20, n_users=40)
cfg = T.apply_overrides(configs.get_config("amazon_hpmn"),
                        json.loads(sys.argv[1]))
params = [T.train(T.apply_overrides(cfg, [f"train.debug_nans={flag}"]),
                  log=lambda s: None, device="cpu")["params"]
          for flag in ("false", "true")]
same = all(torch.equal(params[0][n], params[1][n]) for n in params[0])
seam = T.init_model_for


def nan_init(c, spec, device):
    model = seam(c, spec, device)
    if rank == 1:  # this rank's copy alone
        with torch.no_grad():
            model.tower.layers[0].w[0, 0] = float("nan")
    return model


T.init_model_for = nan_init
try:
    T.train(T.apply_overrides(cfg, ["train.debug_nans=true"]),
            log=lambda s: None, device="cpu")
    msg = None
except FloatingPointError as e:
    msg = str(e)
print(json.dumps({"same": same, "msg": msg}))
distributed.shutdown()
"""


def test_debug_nans_on_a_mesh_raises_on_every_rank_at_the_same_step():
    """Two gloo ranks, a (1, 2) grid: with debug_nans a clean run keeps
    the bits of the run without it; a NaN in one rank's copy of a tower
    weight raises FloatingPointError on both ranks in train step 1, at
    the forward's check (the sharded step merges the ranks' flags)."""
    import socket
    import subprocess
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    opts = json.dumps(TINY + ["train.max_steps=6", "train.eval_every=6",
                              "mesh.model_parallel=2"])
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER, opts], cwd=ROOT, env=dict(
            os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(r),
            WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    for log in logs:
        got = json.loads(log.strip().splitlines()[-1])
        assert got["same"]
        assert got["msg"] == "train step 1: NaN in the forward's loss"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_sweep_prints_the_jax_tools_json(capsys, from_jax_init):
    args = ["--config", "amazon_hpmn", "--grid", "train.lr=1e-3,3e-3",
            "--set", *TINY[:3], "train.eval_every=10",
            "eval_batch_size=64", "train.steps_per_dispatch=0"]
    _jax_tool("sweep").main(args + ["--force_cpu"])
    want = _json_lines(capsys.readouterr().out)
    sweep.main(args + ["--device", "cpu"])
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2] + [got[2]["best"]], want[:2] + [want[2]["best"]]):
        assert g.keys() == w.keys() and g["trial"] == w["trial"]
        assert g["best_step"] == w["best_step"]
        for key in ("best_val_auc", "test_auc"):
            assert abs(g[key] - w[key]) <= AUC_TOL, (key, g, w)
        assert abs(g["test_log_loss"] - w["test_log_loss"]) <= REL_TOL
    assert got[2]["metric"] == want[2]["metric"] == "best_val_auc"


def test_quality_gate_prints_the_jax_tools_json(capsys, monkeypatch,
                                                from_jax_init):
    """--no_pallas at 16 steps (two dispatches of 8): both tools miss the
    floors, print the same JSON and exit 1. JAX's runs on one device, as
    the port's (conftest's eight would take its mesh branch)."""
    import hpmn_tpu.configs as j_configs

    def one_device(name):
        cfg = j_get_config(name)
        cfg.mesh.enable = False
        return cfg

    monkeypatch.setattr(j_configs, "get_config", one_device)
    with pytest.raises(SystemExit) as j_exit:
        _jax_tool("quality_gate").main(["--steps", "16", "--no_pallas",
                                        "--force_cpu"])
    want = _json_lines(capsys.readouterr().out)[-1]
    with pytest.raises(SystemExit) as exit_:
        quality_gate.main(["--steps", "16", "--no_pallas", "--device",
                           "cpu"])
    got = _json_lines(capsys.readouterr().out)[-1]
    assert exit_.value.code == j_exit.value.code == 1
    assert {k: v for k, v in got.items() if k != "auc"} == {
        k: v for k, v in want.items() if k != "auc"}
    assert got["auc"].keys() == want["auc"].keys()
    for m in want["auc"]:
        assert abs(got["auc"][m] - want["auc"][m]) <= AUC_TOL, (m, got, want)


def test_the_tools_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (sweep.main, quality_gate.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--config", "amazon_hpmn", "--grid", "train.lr=1e-3"]
                 if main is sweep.main else [])
