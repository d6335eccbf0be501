"""The port's optimizer (``hpmn_tpu_torch/train/optim.py``) against the JAX
``make_optimizer`` transform (optax) on the CPU.

The same numpy parameters and gradients go through both: the port's
``Optimizer.step()`` after setting ``.grad``, and optax's ``update`` then
``apply_updates``. Each option alone and all together, over at least
three real updates (six micro-steps with accumulation of 2). Tolerances:

- the parameters and the EMA shadow after every micro-step: atol 2e-5
  (lr 1e-2; the two sides round Adam's, the clip's and the decay's
  arithmetic in other orders);
- the lr of each update against the optax schedule that the JAX
  make_optimizer builds, at counts 0 to 12: atol 1e-7 (double here, f32
  in optax);
- a state_dict taken mid-run and loaded into a fresh optimizer continues
  bit for bit.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.train.train import get_ema_params
from hpmn_tpu.train.train import make_optimizer as j_make_optimizer
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.train import train
from hpmn_tpu_torch.train.optim import make_schedule

TOL, LR_TOL = 2e-5, 1e-7
SHAPES = {"a": (5, 4), "b": (7,), "c": (3, 2, 2)}
# One config per case: the options, each alone and all together, and the
# six values that the port refused before it had them.
CASES = {
    "cosine": dict(lr_schedule="cosine", lr_min_ratio=0.1),
    "exponential": dict(lr_schedule="exponential", lr_min_ratio=0.05),
    "warmup_cosine": dict(lr_schedule="cosine", warmup_steps=3),
    "warmup_constant": dict(warmup_steps=3),
    "clip": dict(grad_clip_norm=1.0),
    "adamw": dict(weight_decay=0.05),
    "accum2": dict(grad_accum=2),
    "ema0.9": dict(ema_decay=0.9),
    "all": dict(lr_schedule="cosine", warmup_steps=2, decay_steps=8,
                lr_min_ratio=0.1, grad_clip_norm=1.0, weight_decay=0.05,
                grad_accum=2, ema_decay=0.9),
    "was_refused_cosine": dict(lr_schedule="cosine"),
    "was_refused_warmup": dict(warmup_steps=10),
    "was_refused_clip": dict(grad_clip_norm=1.0),
    "was_refused_adamw": dict(weight_decay=1e-4),
    "was_refused_accum": dict(grad_accum=2),
    "was_refused_ema": dict(ema_decay=0.99),
}


def _configs(change, lr=1e-2, max_steps=10):
    j_cfg = j_get_config("amazon_hpmn")
    j_cfg.train.lr = lr
    j_cfg.train.max_steps = max_steps
    for k, v in change.items():
        j_cfg.train[k] = v
    cfg = configs.get_config("amazon_hpmn")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr=lr, max_steps=max_steps, **change))
    return j_cfg, cfg


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(n, seed=1):
    """n gradient trees; their global norms straddle the clip's 1.0."""
    rng = np.random.default_rng(seed)
    scales = [3.0, 0.05, 1.0, 0.2, 5.0, 0.1, 2.0, 0.01]
    return [{k: (rng.standard_normal(s) * scales[i % len(scales)]
                 ).astype(np.float32) for k, s in SHAPES.items()}
            for i in range(n)]


def _torch_params(params):
    return [torch.from_numpy(params[k].copy()).requires_grad_(True)
            for k in sorted(SHAPES)]


def _step(opt, tparams, g):
    for p, k in zip(tparams, sorted(SHAPES)):
        p.grad = torch.from_numpy(g[k].copy())
    return opt.step()


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    change = CASES[case]
    j_cfg, cfg = _configs(change)
    n = 4 * max(2, change.get("grad_accum", 1))  # >= 3 real updates
    tx = j_make_optimizer(j_cfg)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(params)
    tparams = _torch_params(_params())
    opt = train.make_optimizer(cfg, tparams)
    real = 0
    for i, g in enumerate(_grads(n)):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        real += _step(opt, tparams, g)
        for p, k in zip(tparams, sorted(SHAPES)):
            np.testing.assert_allclose(p.detach().numpy(), params[k],
                                       atol=TOL, rtol=0,
                                       err_msg=f"{k} after micro-step {i}")
        ema = get_ema_params(state)
        assert (ema is None) == (opt.ema_params() is None)
        if ema is not None:
            for e, k in zip(opt.ema_params(), sorted(SHAPES)):
                np.testing.assert_allclose(e.numpy(), ema[k], atol=TOL,
                                           rtol=0)
    assert real >= 3 and opt.count == real
    if change.get("lr_schedule", "constant") == "constant" \
            and not change.get("warmup_steps"):
        assert make_schedule(cfg) is None


def _optax_schedule(j_cfg):
    """The schedule that the JAX make_optimizer builds, by its own
    construction (hpmn_tpu/train/train.py make_optimizer)."""
    t = j_cfg.train
    lr, warmup = t.lr, t.warmup_steps
    horizon = t.decay_steps or t.max_steps
    end = lr * t.lr_min_ratio
    if t.lr_schedule == "cosine":
        body = optax.cosine_decay_schedule(lr, max(1, horizon - warmup),
                                           alpha=end / lr)
    elif t.lr_schedule == "exponential":
        body = optax.exponential_decay(lr, max(1, horizon - warmup),
                                       decay_rate=max(end / lr, 1e-8))
    else:
        body = optax.constant_schedule(lr)
    if warmup > 0:
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup), body], [warmup])
    return body


@pytest.mark.parametrize("change", [
    dict(lr_schedule="cosine", lr_min_ratio=0.1),
    dict(lr_schedule="exponential", lr_min_ratio=0.05),
    dict(lr_schedule="cosine", warmup_steps=3, decay_steps=9),
    dict(warmup_steps=4),
    dict(lr_schedule="exponential", warmup_steps=2)])
def test_lr_sequence_matches_the_optax_schedule(change):
    j_cfg, cfg = _configs(change, lr=1e-3)
    want = _optax_schedule(j_cfg)
    got = make_schedule(cfg)
    for count in range(13):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   atol=LR_TOL, rtol=0, err_msg=str(count))
    if change.get("warmup_steps"):
        assert got(0) == 0.0  # the first update has lr 0


@pytest.mark.parametrize("case", ["all", "warmup_constant"])
def test_state_dict_round_trip_continues_bit_for_bit(case):
    _, cfg = _configs(CASES[case])
    grads = _grads(10)
    tparams = _torch_params(_params())
    opt = train.make_optimizer(cfg, tparams)
    for g in grads[:5]:  # mid-accumulation with grad_accum 2
        _step(opt, tparams, g)
    saved = copy.deepcopy(opt.state_dict())
    resumed = [p.detach().clone().requires_grad_(True) for p in tparams]
    opt2 = train.make_optimizer(cfg, resumed)
    opt2.load_state_dict(saved)
    for g in grads[5:]:
        _step(opt, tparams, g)
        _step(opt2, resumed, g)
    for a, b in zip(tparams, resumed):
        assert torch.equal(a, b)
    assert opt.count == opt2.count and opt.mini_step == opt2.mini_step
    for a, b in zip(opt.ema_params() or [], opt2.ema_params() or []):
        assert torch.equal(a, b)
