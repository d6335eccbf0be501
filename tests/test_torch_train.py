"""The port's losses, loss gradients and training step against the JAX
package on the CPU.

JAX parameters reach the port through ``hpmn_tpu_torch.convert``; batches
are drawn with numpy from a seed (``make_ctr_dataset``) and handed to both
sides. The Pallas kernels run in interpret mode. The config is
``xlong_hpmn`` cut to 3 layers (scans of 29, 9 and 3 steps) at B = 6.

Tolerances, f32:
- losses: rtol 1e-5 (the same formulas, other summation orders);
- the loss of ``loss_fn``: rtol 1e-5, and every parameter's gradient:
  atol 1e-5 * max(1, max |grad|) plus rtol 1e-4. The gradients sum over
  B*T row-steps through three scans, in other orders on the two sides,
  and the Pallas scan writes sigmoid through tanh;
- parameters after three Adam steps: atol 2e-5 (see that test).

With the bf16 scan chain (``scan_dtype="bfloat16"``, bench.py's headline
leg): the loss at rtol 1e-3 and every gradient within 2e-2 of its max abs,
the bf16 scans' tolerances of tests/test_torch_bf16.py (a flipped bf16
rounding runs on through the recurrences as a few bf16 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.models import losses as j_losses
from hpmn_tpu.models import total_loss as j_total_loss
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu.train.train import _raw_train_step
from hpmn_tpu.train.train import make_optimizer as j_make_optimizer
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models import losses
from hpmn_tpu_torch.models.model import loss_fn, total_loss
from hpmn_tpu_torch.ops import cuda_gru, cuda_readout
from hpmn_tpu_torch.train import train

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 2e-2  # of each gradient's max abs
N_ITEMS, N_CATS, B = 200, 20, 6
SMALL = synthetic.DatasetSpec("small", seq_len=29, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=50)
# (use_pallas, use_hierarchical_scan, assume_full_mask)
SETTINGS = {"pallas_full": (True, True, True),
            "pallas_padded": (True, True, False),
            "plain_hierarchy": (False, True, False),
            "oracle": (False, False, False)}


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(setting, scan_dtype="float32"):
    use_pallas, hierarchical, full_mask = SETTINGS[setting]
    j_cfg = j_get_config("xlong_hpmn")
    j_cfg.model.hpmn_layers = 3
    j_cfg.model.use_pallas = use_pallas
    j_cfg.model.use_hierarchical_scan = hierarchical
    j_cfg.model.assume_full_mask = full_mask
    j_cfg.model.scan_dtype = scan_dtype
    cfg = configs.get_config("xlong_hpmn").with_model(
        hpmn_layers=3, use_pallas=use_pallas,
        use_hierarchical_scan=hierarchical, assume_full_mask=full_mask,
        scan_dtype=scan_dtype)
    return j_cfg, cfg


def _data(setting, seed, n=B):
    full = SETTINGS[setting][2]
    return synthetic.make_ctr_dataset(SMALL, n, seed=seed,
                                      min_len_frac=1.0 if full else 0.5)


def _close_grad(got, want, name):
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_with_logits_matches_jax(weighted):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(64) * 8).astype(np.float32)
    labels = (rng.random(64) > 0.5).astype(np.float32)
    w = rng.random(64).astype(np.float32) if weighted else None
    want = j_losses.bce_with_logits(
        jnp.asarray(logits), jnp.asarray(labels),
        None if w is None else jnp.asarray(w))
    got = losses.bce_with_logits(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


def test_covariance_regularizer_matches_jax():
    rng = np.random.default_rng(1)
    mem = rng.standard_normal((7, 6, 32)).astype(np.float32)
    want = j_losses.covariance_regularizer(jnp.asarray(mem))
    got = losses.covariance_regularizer(torch.from_numpy(mem))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


def test_l2_regularizer_and_total_loss_match_jax():
    """L2 over every >= 2-D parameter (both embedding tables included),
    and total_loss on the same logits, memory and labels."""
    j_cfg, cfg = _configs("pallas_full")
    params = j_init_model(jax.random.key(2), j_cfg, N_ITEMS, N_CATS)
    model = model_from_flat(cfg, _flat(params), device="cpu")
    want = j_losses.l2_regularizer(params)
    got = losses.l2_regularizer(model.parameters())
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal(B).astype(np.float32)
    labels = (rng.random(B) > 0.5).astype(np.float32)
    mem = rng.standard_normal((B, 3, 32)).astype(np.float32)
    j_loss, j_metrics = j_total_loss(params, j_cfg, jnp.asarray(logits),
                                     {"memory": jnp.asarray(mem)},
                                     jnp.asarray(labels))
    loss, metrics = total_loss(model, cfg, torch.from_numpy(logits),
                               {"memory": torch.from_numpy(mem)},
                               torch.from_numpy(labels))
    assert metrics.keys() == j_metrics.keys() == {"bce", "cov_reg", "l2",
                                                  "loss"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_loss_fn_gradients_match_jax(interpret, setting):
    """The loss and every parameter's gradient == jax.value_and_grad of the
    JAX loss_fn, from the same JAX init and batch."""
    j_cfg, cfg = _configs(setting)
    params = j_init_model(jax.random.key(3), j_cfg, N_ITEMS, N_CATS)
    data = _data(setting, seed=3)
    if not SETTINGS[setting][2]:
        assert data["seq_mask"].min() == 0.0  # left padding is exercised
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        j_loss_fn, has_aux=True)(params, j_cfg, j_batch_from_numpy(data))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    for k in ("bce", "cov_reg", "l2"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **LOSS_TOL, err_msg=k)
    want = _flat(j_grads)
    names = [n for n, _ in model.named_parameters()]
    assert {jax_key(n) for n in names} == set(want)
    for name, p in model.named_parameters():
        _close_grad(p.grad.numpy(), want[jax_key(name)], name)


@pytest.mark.parametrize("setting", ["pallas_full", "pallas_padded"])
def test_loss_fn_gradients_match_jax_bf16(interpret, setting):
    """bench.py's headline leg: scan_dtype="bfloat16". The loss and every
    parameter's gradient (f32 parameters; the scans' weight gradients
    rounded to bf16 inside, as the JAX custom_vjp does) ==
    jax.value_and_grad of the JAX loss_fn, full and left-padded."""
    j_cfg, cfg = _configs(setting, "bfloat16")
    params = j_init_model(jax.random.key(8), j_cfg, N_ITEMS, N_CATS)
    data = _data(setting, seed=8)
    (j_loss, _), j_grads = jax.value_and_grad(j_loss_fn, has_aux=True)(
        params, j_cfg, j_batch_from_numpy(data))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, _ = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss),
                               rtol=BF16_LOSS_RTOL)
    want = _flat(j_grads)
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        ref = want[jax_key(name)]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= BF16_GRAD_TOL * np.abs(ref).max(), name


def test_three_adam_steps_match_jax(interpret):
    """Parameters after three steps of the port's Adam == JAX's
    make_optimizer + _raw_train_step, from one JAX init, on three batches.

    atol 2e-5, looser than the gradients': Adam divides by sqrt(v), so an
    element whose gradient is near zero moves by up to lr = 1e-3 on tiny
    differences between the two sides' gradients."""
    j_cfg, cfg = _configs("pallas_padded")
    params = j_init_model(jax.random.key(4), j_cfg, N_ITEMS, N_CATS)
    tx = j_make_optimizer(j_cfg)
    opt_state = tx.init(params)
    j_step = jax.jit(_raw_train_step(j_cfg, tx))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    step = train.make_train_step(
        cfg, model, train.make_optimizer(cfg, model.parameters()))
    for k in range(3):
        data = _data("pallas_padded", seed=40 + k)
        params, opt_state, j_metrics = j_step(params, opt_state,
                                              j_batch_from_numpy(data))
        metrics = step(batch_from_numpy(data, device="cpu"))
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(j_metrics["loss"]), rtol=1e-5)
    want = _flat(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[jax_key(name)],
                                   atol=2e-5, rtol=0, err_msg=name)


def test_multistep_train_equals_single_steps():
    """make_multistep_train(k=3) == three single steps, bit for bit, and it
    returns the last step's metrics."""
    j_cfg, cfg = _configs("pallas_padded")
    params = j_init_model(jax.random.key(5), j_cfg, N_ITEMS, N_CATS)
    batches = [batch_from_numpy(_data("pallas_padded", seed=50 + k),
                                device="cpu") for k in range(3)]
    models = [model_from_flat(cfg, _flat(params), device="cpu")
              for _ in range(2)]
    opts = [train.make_optimizer(cfg, m.parameters()) for m in models]
    multi = train.make_multistep_train(cfg, models[0], opts[0])(batches)
    step = train.make_train_step(cfg, models[1], opts[1])
    singles = [step(b) for b in batches]
    assert multi.keys() == singles[-1].keys() == {"bce", "cov_reg", "l2",
                                                  "loss"}
    for k in multi:
        assert torch.equal(multi[k], singles[-1][k]), k
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(a, b), name


def test_train_step_uses_the_scan_and_readout_functions():
    """On CPU tensors the step runs the scan's and the readout's autograd
    Functions (their plain versions: the launch counters stay put), and
    every parameter receives a gradient."""
    j_cfg, cfg = _configs("pallas_full")
    params = j_init_model(jax.random.key(6), j_cfg, N_ITEMS, N_CATS)
    model = model_from_flat(cfg, _flat(params), device="cpu")
    batch = batch_from_numpy(_data("pallas_full", seed=6), device="cpu")
    loss, _ = loss_fn(model, cfg, batch)
    seen, stack, nodes = [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in nodes:
            continue
        nodes.add(node)
        seen.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    assert seen.count("GRUScanBackward") == cfg.model.hpmn_layers
    assert seen.count("AttentionReadoutBackward") == 1
    counts = (cuda_gru.launches, cuda_gru.bwd_launches,
              cuda_readout.launches)
    loss.backward()
    assert (cuda_gru.launches, cuda_gru.bwd_launches,
            cuda_readout.launches) == counts
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_port_adam_is_optax_adam():
    """One update of the port's Adam == optax.adam on the same gradients
    (the update the JAX make_optimizer builds with default options)."""
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((5, 4)).astype(np.float32)
    grads = [rng.standard_normal((5, 4)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(1e-3)
    jw, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    tw = torch.from_numpy(w0.copy()).requires_grad_(True)
    opt = train.make_optimizer(configs.get_config("xlong_hpmn"), [tw])
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        tw.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                               rtol=1e-6, atol=1e-7)
