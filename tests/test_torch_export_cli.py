"""Train to serve as commands, with the port on the CPU: ``train()`` with a
``ckpt_dir`` and an EMA, then ``python -m hpmn_tpu_torch.tools.export_bundle``
(history bootstrap, int8 tables, the EMA weights) and ``python -m
hpmn_tpu_torch.tools.serve_batch`` (update, score, persist) as
subprocesses — the counterparts of tests/test_serving.py's
``test_train_to_serve_pipeline``, ``test_export_bundle_cli`` and
``test_serve_batch_cli``, small enough for tier-1. The bundles are the JAX
package's format: the JAX ``load_bundle`` scores them within 1e-5 of the
port's store. A DIEN checkpoint exports a history-store bundle."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hpmn_tpu.serving import load_bundle as j_load_bundle
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.models.model import init_model
from hpmn_tpu_torch.serving import HistoryStore, UserMemoryStore, load_bundle
from hpmn_tpu_torch.tools import export_bundle, serve_batch
from hpmn_tpu_torch.train import train as T
from hpmn_tpu_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_TOL = 1e-5
USERS, HIST_T = 12, 40


def _cli(tool, *args):
    out = subprocess.run(
        [sys.executable, "-m", f"hpmn_tpu_torch.tools.{tool}", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """amazon_hpmn, 30 steps of B 64 on the CPU with checkpoints and an
    EMA of 0.9 (tests/test_serving.py's export run), and a histories file
    of 12 users x 40 events."""
    d = tmp_path_factory.mktemp("export")
    cfg = T.apply_overrides(configs.get_config("amazon_hpmn"), [
        "n_examples=1500", "train.batch_size=64", "train.max_steps=30",
        "train.eval_every=15", "train.log_every=1000000000",
        "train.steps_per_dispatch=1", "eval_steps_per_dispatch=1",
        "train.ema_decay=0.9", f"train.ckpt_dir={d / 'ckpt'}"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        T.train(cfg, log=lambda s: None, device="cpu")
    finally:
        torch.set_num_threads(n)
    rng = np.random.default_rng(0)
    hist = rng.integers(1, 1000, size=(USERS, HIST_T)).astype(np.int32)
    np.savez(d / "hist.npz", uids=np.arange(USERS, dtype=np.int64),
             item_seqs=hist, cat_seqs=(hist % 50).astype(np.int32))
    return d, hist


def test_export_bundle_and_serve_batch(trained):
    """export_bundle --histories --quantize, then serve_batch --update:
    12 users with counters 40, scores in (0, 1), the counter +1 saved
    back; the JAX package serves the same bundle within 1e-5."""
    d, hist = trained
    bundle = d / "bundle"
    line = _cli("export_bundle", "--ckpt_dir", str(d / "ckpt"), "--config",
                "amazon_hpmn", "--out", str(bundle), "--histories",
                str(d / "hist.npz"), "--quantize", "--device", "cpu")
    assert "store=memory" in line and f"n_users={USERS}" in line
    assert "quantized=True" in line and "ema=False" in line
    assert "aot=False" in line
    with np.load(bundle / "params.npz") as z:
        assert "__q8__['embedding']['item']" in z.files
    store = load_bundle(str(bundle), device="cpu")
    uids = np.arange(USERS)
    np.testing.assert_array_equal(store._gather(uids)[1].numpy(), HIST_T)
    ci, cc = hist[:, 0], hist[:, 0] % 50
    scores = store.predict(uids, ci, cc)
    assert ((scores > 0) & (scores < 1)).all()
    np.testing.assert_allclose(
        np.asarray(j_load_bundle(str(bundle)).predict(uids, ci, cc)),
        scores, atol=SERVE_TOL)

    cand = np.random.default_rng(1).integers(1, 1000, size=(USERS, 3))
    np.savez(d / "req.npz", uids=uids.astype(np.int32),
             cand_items=cand.astype(np.int32),
             cand_cats=(cand % 50).astype(np.int32),
             item_ids=cand[:, 0].astype(np.int32),
             cat_ids=(cand[:, 0] % 50).astype(np.int32))
    line = _cli("serve_batch", "--bundle", str(bundle), "--requests",
                str(d / "req.npz"), "--out", str(d / "scores.npz"),
                "--update", "--device_resident", "--force_cpu")
    assert "scored (12, 3)" in line
    served = np.load(d / "scores.npz")["scores"]
    assert served.shape == (USERS, 3) and served.dtype == np.float32
    assert ((served > 0) & (served < 1)).all()
    store.update(uids, cand[:, 0], cand[:, 0] % 50)
    np.testing.assert_allclose(served, store.rank(uids, cand, cand % 50),
                               atol=1e-6, rtol=0)
    back = load_bundle(str(bundle), device="cpu")
    np.testing.assert_array_equal(back._gather(uids)[1].numpy(), HIST_T + 1)


def test_export_the_ema_weights(trained):
    """--ema: the bundle's item table is the checkpoint's EMA shadow (f32,
    not quantized), not its raw weights."""
    d, _ = trained
    line = _cli("export_bundle", "--ckpt_dir", str(d / "ckpt"), "--config",
                "amazon_hpmn", "--set", "train.ema_decay=0.9", "--out",
                str(d / "bundle_ema"), "--ema", "--force_cpu")
    assert "ema=True" in line and "n_users=0" in line
    mngr = CheckpointManager(str(d / "ckpt"))
    best = mngr.best_step()
    state = mngr.restore(best)
    assert f"exported step {best} " in line
    names = list(state["params"])  # model.parameters()' order
    shadow = dict(zip(names, state["opt_state"]["ema"]))
    served = load_bundle(str(d / "bundle_ema"), device="cpu")
    item = served.model.embedding.item.detach()
    assert torch.equal(item, shadow["embedding.item"])
    assert not torch.equal(item, state["params"]["embedding.item"])


def test_unported_and_missing_options_raise(trained, tmp_path):
    """The AOT export refuses a platform other than cpu and cuda, and
    without a card the cuda platform (its default) raises; a run without
    EMA has no shadow to export; an empty directory has no checkpoint;
    and without a card both CLIs raise by default (no fallback to the
    CPU)."""
    d, _ = trained
    base = ["--ckpt_dir", str(d / "ckpt"), "--config", "amazon_hpmn",
            "--out", str(tmp_path / "b"), "--device", "cpu"]
    with pytest.raises(ValueError, match="platforms are cpu and cuda"):
        export_bundle.main(base + ["--export_compiled", "--platforms",
                                   "cpu,tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exporting for cuda"):
            export_bundle.main(base + ["--export_compiled"])
    with pytest.raises(SystemExit, match="no checkpoints"):
        export_bundle.main(["--ckpt_dir", str(tmp_path / "none"),
                            "--config", "amazon_hpmn", "--out",
                            str(tmp_path / "b"), "--device", "cpu"])
    cfg = configs.get_config("amazon_rum")
    model = init_model(cfg, 300, 30, seed=0, device="cpu")
    mngr = CheckpointManager(str(tmp_path / "rum"))
    mngr.save(3, model.state_dict(), {"ema": None}, {})
    with pytest.raises(SystemExit, match="no EMA shadow"):
        export_bundle.main(["--ckpt_dir", str(tmp_path / "rum"), "--config",
                            "amazon_rum", "--out", str(tmp_path / "b"),
                            "--ema", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="export_bundle runs on the"):
            export_bundle.main(base[:-2])
        with pytest.raises(RuntimeError, match="serve_batch runs on the"):
            serve_batch.main(["--bundle", str(d / "bundle"), "--requests",
                              str(d / "req.npz"), "--out",
                              str(tmp_path / "s.npz")])


def test_a_dien_checkpoint_exports_a_history_bundle(tmp_path, capsys):
    """taobao_dien is not an O(1) family: export_bundle writes a history
    store's bundle (the config's window), which serve_batch reads."""
    cfg = configs.get_config("taobao_dien")
    model = init_model(cfg, 300, 30, seed=1, device="cpu")
    CheckpointManager(str(tmp_path / "ckpt")).save(
        5, model.state_dict(), {"ema": None}, {}, {"val_auc": 0.5})
    hist = np.random.default_rng(2).integers(1, 300, size=(4, 20))
    np.savez(tmp_path / "hist.npz", uids=np.arange(4), item_seqs=hist,
             cat_seqs=hist % 30, masks=np.ones((4, 20), np.float32))
    export_bundle.main(["--ckpt_dir", str(tmp_path / "ckpt"), "--config",
                        "taobao_dien", "--out", str(tmp_path / "b"),
                        "--histories", str(tmp_path / "hist.npz"),
                        "--device", "cpu"])
    assert capsys.readouterr().out.strip() == (
        f"exported step 5 -> {tmp_path / 'b'} (store=history, n_users=4, "
        "quantized=False, ema=False, aot=False)")
    store = load_bundle(str(tmp_path / "b"), device="cpu")
    assert isinstance(store, HistoryStore) and store.window == 300
    np.savez(tmp_path / "req.npz", uids=np.arange(5, dtype=np.int32),
             cand_items=hist[:, :1].repeat(5, 0)[:5, 0].astype(np.int32),
             cand_cats=(hist[:, :1].repeat(5, 0)[:5, 0] % 30).astype(
                 np.int32))
    serve_batch.main(["--bundle", str(tmp_path / "b"), "--requests",
                      str(tmp_path / "req.npz"), "--out",
                      str(tmp_path / "s.npz"), "--device", "cpu"])
    scores = np.load(tmp_path / "s.npz")["scores"]
    assert scores.shape == (5,) and ((scores > 0) & (scores < 1)).all()
    assert not isinstance(store, UserMemoryStore)
