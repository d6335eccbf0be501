"""``model.dtype="bfloat16"`` in the port against the JAX package on the
CPU, on the plain path of every family: the loss, the metrics' dtypes,
every gradient, and the parameters after three Adam steps; the optimizer
on bf16 parameters against optax on the same gradients; the bf16 init;
``convert.py``'s bf16 arrays both ways; a resumed bf16 run bit for bit.
The kernel path (Pallas in interpret mode) and the stores are
tests/test_torch_dtype_kernels.py.

JAX parameters reach the port through ``hpmn_tpu_torch.convert`` (bf16 as
its bits); batches come from ``make_ctr_dataset`` with a seed: B 16, T
16, vocab 200/20, 40 users, the amazon config with 3 hpmn layers of
period 2.

Tolerances, each over the norm of the JAX tensor (measured worst in
brackets; JAX's loss and gradients compiled, as its driver runs them):
- the loss, float32 (bce + l2): rtol 2^-7 (5.0e-3, gru4rec and BST with
  bf16 matmuls; 8.3e-7 the others): ``bce`` is bf16 here, and XLA fuses
  its ops in float32 and rounds once where PyTorch rounds each op, so the
  two land a bf16 ulp (2^-8 of it) apart;
- every gradient, and the update of three Adam steps (p3 - p0), each
  within its family's bound in ``BOUNDS``: about 1.2 times that family's
  measured worst over its tensors (the same with 2 and 8 CPU threads).
  The gradients' bounds are wider than the repo's bf16 scan bound (2e-2)
  where a family has a kink: every op here rounds to bf16, XLA keeps a
  fused chain (a scan body, a softmax) in float32, so values differ by
  bf16 ulps; a PReLU or a masked softmax near its kink (SHAN's
  ``attn_long``: 0.124; hpmn 0.097, DIEN 0.062) then sends a cotangent
  down the other branch, and in a 16-row batch one such row is a large
  share of a small gradient. The updates' bounds
  are wide for every family: a bf16 parameter moves a few ulps a step,
  so a rounding of p + u that flips on the gradients' ulps is a large
  share of the update (DIEN's ``attn.b``, a few numbers: 0.377). Every
  bound is below 0.5, which an update of half JAX's size would read. The
  optimizer itself is held bit for bit to optax on the same gradients
  (:func:`test_low_precision_adam_matches_optax_bit_for_bit`).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu.train.train import get_ema_params
from hpmn_tpu.train.train import make_optimizer as j_make_optimizer
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import (BF16_BYTES, flat_from_model, jax_key,
                                    model_from_flat)
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.model import init_model, loss_fn
from hpmn_tpu_torch.train import optim
from hpmn_tpu_torch.train import train as T

LOSS_RTOL = 2.0 ** -7
N_ITEMS, N_CATS, N_USERS, B, SEQ = 200, 20, 40, 16, 16
SMALL = synthetic.DatasetSpec("small", seq_len=SEQ, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=N_USERS)
# The plain path of every family (bst also with bst_dtype=bfloat16).
PLAIN = {"hpmn": ("hpmn", {}),
         "hpmn_oracle": ("hpmn", {"use_hierarchical_scan": False}),
         "gru4rec": ("gru4rec", {}), "dien": ("dien", {}),
         "rum": ("rum", {}), "dnn": ("dnn", {}), "lstm": ("lstm", {}),
         "caser": ("caser", {}), "shan": ("shan", {}),
         "svdpp": ("svdpp", {}), "bst": ("bst", {}),
         "bst_bf16_matmuls": ("bst", {"bst_dtype": "bfloat16"})}
# (gradient, 3-step update) bounds, each over the norm of JAX's tensor;
# the measured worst in the comment.
BOUNDS = {"hpmn": (0.12, 0.35),  # 0.0974, 0.2918
          "hpmn_oracle": (0.12, 0.35),  # 0.0974, 0.2888
          "gru4rec": (0.035, 0.2),  # 0.0274, 0.1644
          "dien": (0.075, 0.45),  # 0.0623, 0.3774
          "rum": (0.085, 0.23),  # 0.0702, 0.1919
          "dnn": (0.006, 0.09),  # 0.0049, 0.0715
          "lstm": (0.04, 0.14),  # 0.0328, 0.1159
          "caser": (0.0065, 0.09),  # 0.0054, 0.0751
          "shan": (0.15, 0.24),  # 0.1238, 0.1986
          "svdpp": (0.015, 0.1),  # 0.0117, 0.0833
          "bst": (0.06, 0.26),  # 0.0469, 0.2170
          "bst_bf16_matmuls": (0.08, 0.25)}  # 0.0636, 0.2099


def flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def bf16_configs(family, **model):
    """(JAX config, port config): amazon_hpmn with ``model.name`` =
    family, a bf16 model, 3 hpmn layers of period 2, and ``model``."""
    j_cfg = j_get_config("amazon_hpmn")
    model = dict(name=family, dtype="bfloat16", hpmn_layers=3,
                 hpmn_period=2, **model)
    for k, v in model.items():
        setattr(j_cfg.model, k, v)
    return j_cfg, configs.get_config("amazon_hpmn").with_model(**model)


def data(full=False, seed=0):
    return synthetic.make_ctr_dataset(SMALL, B, seed=seed,
                                      min_len_frac=1.0 if full else 0.4)


def rel_norm(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_against_jax(family, model_opts, loss_rtol, grad_tol, update_tol):
    """The port's bf16 model against JAX's from the same weights: the loss
    and its metrics' dtypes, every gradient, then the parameters after
    three Adam steps (JAX's loss gradient and optax update, jitted) on
    three batches."""
    j_cfg, cfg = bf16_configs(family, **model_opts)
    full = model_opts.get("assume_full_mask", False)
    batches = [data(full, seed) for seed in range(3)]
    params = j_init_model(jax.random.key(1), j_cfg, N_ITEMS, N_CATS,
                          n_users=N_USERS)
    model = model_from_flat(cfg, flat(params), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    # Compiled, as the JAX driver's train step (in two jits: the loss's
    # gradients, then optax's update).
    j_grad = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, j_cfg, b), has_aux=True))
    (j_loss, j_metrics), j_grads = j_grad(params,
                                          j_batch_from_numpy(batches[0]))
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(batches[0],
                                                         device="cpu"))
    loss.backward()
    assert {k: str(v.dtype) for k, v in j_metrics.items()} == {
        k: str(v.dtype).replace("torch.", "") for k, v in metrics.items()}
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=loss_rtol)
    want = flat(j_grads)
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(want)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.bfloat16, name
        gap = rel_norm(p.grad.float().numpy(), f32(want[jax_key(name)]))
        assert gap <= grad_tol, (name, gap)

    tx = j_make_optimizer(j_cfg)
    j_update = jax.jit(tx.update)
    j_params, j_state = params, tx.init(params)
    for b in batches:
        _, g = j_grad(j_params, j_batch_from_numpy(b))
        u, j_state = j_update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, u)
    opt = T.make_optimizer(cfg, model.parameters())
    for b in batches:
        opt.zero_grad()
        loss, _ = loss_fn(model, cfg, batch_from_numpy(b, device="cpu"))
        loss.backward()
        opt.step()
    p0, p3 = flat(params), flat(j_params)
    for name, p in model.named_parameters():
        key = jax_key(name)
        assert p.dtype == torch.bfloat16, name
        gap = rel_norm(p.detach().float().numpy() - f32(p0[key]),
                       f32(p3[key]) - f32(p0[key]))
        assert gap <= update_tol, (name, gap)


@pytest.mark.parametrize("setting", list(PLAIN))
def test_bf16_plain_path_matches_jax(setting):
    family, opts = PLAIN[setting]
    check_against_jax(family, opts, LOSS_RTOL, *BOUNDS[setting])


OPTIMIZER_OPTIONS = {
    "adam": {}, "adamw": {"weight_decay": 1e-2},
    "warmup_cosine": {"lr_schedule": "cosine", "warmup_steps": 2,
                      "max_steps": 6},
    "clip": {"grad_clip_norm": 0.01}, "accumulation": {"grad_accum": 2},
    "ema": {"ema_decay": 0.9},
    "all": {"weight_decay": 1e-2, "lr_schedule": "cosine",
            "warmup_steps": 1, "max_steps": 6, "grad_clip_norm": 0.05,
            "grad_accum": 2, "ema_decay": 0.9}}


@pytest.mark.parametrize("options", list(OPTIMIZER_OPTIONS))
def test_low_precision_adam_matches_optax_bit_for_bit(options):
    """bf16 parameters through six updates of the same bf16 gradients
    (four decades of scale): ``Optimizer`` (``LowPrecisionAdam``, the
    accumulation, clip and EMA in bf16) against the JAX
    ``make_optimizer``'s jitted optax update, every parameter and the EMA
    shadow bit for bit."""
    opts = OPTIMIZER_OPTIONS[options]
    j_cfg = j_get_config("amazon_hpmn")
    for k, v in opts.items():
        setattr(j_cfg.train, k, v)
    cfg = configs.get_config("amazon_hpmn")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **opts))
    rng = np.random.default_rng(0)
    shapes = [(50, 8), (8,), (3, 4, 5)]
    p0 = [(rng.standard_normal(s) * 0.3).astype(ml_dtypes.bfloat16)
          for s in shapes]
    grads = [[(rng.standard_normal(s) * 10 ** rng.uniform(-4, 0)).astype(
        ml_dtypes.bfloat16) for s in shapes] for _ in range(6)]
    tx = j_make_optimizer(j_cfg)
    update = jax.jit(tx.update)
    params = [jnp.asarray(a) for a in p0]
    state = tx.init(params)
    for g in grads:
        u, state = update([jnp.asarray(a) for a in g], state, params)
        params = optax.apply_updates(params, u)

    def bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)

    mine = [bf16(a).requires_grad_() for a in p0]
    opt = optim.Optimizer(cfg, mine)
    assert isinstance(opt.inner, optim.LowPrecisionAdam)
    for g in grads:
        for p, a in zip(mine, g):
            p.grad = bf16(a)
        opt.step()
    for got, want in zip(mine, params):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.detach().float().numpy(), f32(want))
    if opts.get("ema_decay"):
        for got, want in zip(opt.ema_params(), get_ema_params(state)):
            np.testing.assert_array_equal(got.float().numpy(), f32(want))


def test_bf16_init_is_the_f32_draw_rounded():
    """``init_model`` of a bf16 model: the f32 model's seeded draw, each
    weight rounded to bf16 (JAX draws in bf16: other numbers, the same
    distributions)."""
    cfg = configs.get_config("xlong_hpmn")
    a = init_model(cfg, N_ITEMS, N_CATS, seed=3, device="cpu")
    b = init_model(cfg.with_model(dtype="bfloat16"), N_ITEMS, N_CATS,
                   seed=3, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert pb.dtype == torch.bfloat16, name
        assert torch.equal(pa.to(torch.bfloat16), pb), name


@pytest.mark.parametrize("family", ["hpmn", "rum", "bst"])
def test_convert_moves_bf16_bits_both_ways(family, tmp_path):
    """JAX's bf16 arrays (``ml_dtypes``) -> ``model_from_flat`` -> bf16
    parameters with the same bits; ``flat_from_model`` -> ``|V2`` bytes
    that view back as the same JAX arrays; the ``|V2`` arrays that
    ``np.savez`` writes for JAX's bf16 arrays load into the same model.
    RUM has a 0-d parameter (beta)."""
    j_cfg, cfg = bf16_configs(family)
    params = j_init_model(jax.random.key(2), j_cfg, N_ITEMS, N_CATS,
                          n_users=N_USERS)
    want = flat(params)
    model = model_from_flat(cfg, want, device="cpu")
    for name, p in model.named_parameters():
        ref = want[jax_key(name)]
        assert p.dtype == torch.bfloat16 and p.shape == ref.shape, name
        assert np.array_equal(p.detach().view(torch.int16).numpy(),
                              ref.view(np.int16)), name
    back = flat_from_model(model)
    assert back.keys() == want.keys()
    for key, a in back.items():
        assert a.dtype == BF16_BYTES, key
        assert np.array_equal(a.view(ml_dtypes.bfloat16).view(np.int16),
                              want[key].view(np.int16)), key
    np.savez(tmp_path / "p.npz", **want)
    with np.load(tmp_path / "p.npz") as z:
        assert z[next(iter(want))].dtype == BF16_BYTES  # JAX's file form
        again = model_from_flat(cfg, {k: z[k] for k in z.files}, "cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p.view(torch.int16), q.view(torch.int16)), name


def test_resumed_bf16_run_continues_bit_for_bit(tmp_path, monkeypatch):
    """train() with a bf16 model (clipping, accumulation, EMA and a
    cosine schedule: the whole low-precision optimizer state), resumed
    from its step-8 checkpoint: its step-16 parameters and EMA shadow are
    the uninterrupted run's, bit for bit."""
    monkeypatch.setitem(synthetic.SPECS, "amazon", dataclasses.replace(
        synthetic.SPECS["amazon"], seq_len=20, n_items=300, n_cats=30))
    seam = T.init_model_for

    def run(cfg):
        """-> (log lines, {name: parameter} and the EMA shadow when step
        16's line is logged)."""
        held, at16, lines = {}, {}, []

        def init(c, spec, device):
            held["model"] = seam(c, spec, device)
            return held["model"]

        def log(line):
            lines.append(line)
            if line.startswith("step 16 loss"):
                at16["params"] = {n: p.detach().clone() for n, p in
                                  held["model"].named_parameters()}

        monkeypatch.setattr(T, "init_model_for", init)
        T.train(cfg, log=log, device="cpu")
        return lines, at16["params"]

    base = ["n_examples=800", "train.batch_size=32", "train.max_steps=16",
            "train.eval_every=8", "train.log_every=8",
            "train.steps_per_dispatch=1", "model.dtype=bfloat16",
            "train.grad_clip_norm=0.5", "train.grad_accum=2",
            "train.ema_decay=0.9", "train.lr_schedule=cosine",
            "train.warmup_steps=2", "train.early_stop_patience=100"]
    whole = str(tmp_path / "whole")
    cfg = T.apply_overrides(configs.get_config("amazon_hpmn"),
                            base + [f"train.ckpt_dir={whole}"])
    _, want = run(cfg)
    assert os.path.isdir(os.path.join(whole, "8"))
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    os.rename(os.path.join(whole, "8"), os.path.join(resumed, "8"))
    lines, got = run(T.apply_overrides(cfg, [f"train.ckpt_dir={resumed}"]))
    assert "resumed from step 8" in lines
    for name, p in want.items():
        assert p.dtype == torch.bfloat16, name
        assert torch.equal(p, got[name]), name
