"""The port's DIEN (``taobao_dien``) against the JAX package on the CPU: the
plain AUGRU scans (the gate-scaled form of the scan and its backward, with
dscale) and ``GRUScan`` with a scale, the encoders, ``loss_fn`` and every
gradient, three Adam steps, the parameter conversion, and serving through
``HistoryStore``. JAX parameters reach the port through
``hpmn_tpu_torch.convert``; inputs are drawn with numpy from a seed. The
Pallas kernels run in interpret mode, and the JAX side of each comparison
is jitted. The model size is tests/test_pallas.py's: T = 24, B = 8, vocab
300/30.

Tolerances:
- the f32 scaled scan: h at 1e-5 abs, every gradient (dx, dscale, dwx,
  dwh, db) at 1e-5 of max(1, its max abs); the bf16 chain (a rounded to
  bf16, zs one bf16 mul) at tests/test_torch_bf16.py's 2e-2: h abs,
  gradients of their max abs, errors printed. Both sides round at the same places; the bf16
  dscale is an f32 sum of the exact products dzs*z rounded once, as XLA
  computes the TPU kernel's ``jnp.sum(dzs * z)`` in interpret mode.
- the encoders: 1e-5 (atol and rtol); the loss of ``loss_fn`` rtol 1e-5
  and every gradient atol 1e-5 * max(1, max |grad|) plus rtol 1e-4, as
  tests/test_torch_train.py; parameters after three Adam steps 2e-5 abs.
- the bf16 step (scan_dtype="bfloat16", full sequences: the bench
  flagship): the loss at rtol 1e-3, every gradient within 5e-2 of its max
  abs. Wider than the scans' 2e-2: in the no-mask backward XLA on the CPU
  skips the bf16 rounding of the carry gcell - gcell*zs (ROADMAP.md §3),
  and the AUGRU's small bias gradient feels that most (printed).
- serving: the port's store against the port's own apply_model at 1e-6
  (the same arithmetic), and against the JAX ``HistoryStore`` at 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import dien as j_dien
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu.serving import HistoryStore as JHistoryStore
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu.train.train import _raw_train_step
from hpmn_tpu.train.train import make_optimizer as j_make_optimizer
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models import dien
from hpmn_tpu_torch.models.model import apply_model, init_model, loss_fn
from hpmn_tpu_torch.models.tower import apply_tower
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.ops.gru import (GRUWeights, gru_scan_tm, gru_scan_tm_bf16,
                                    gru_scan_tm_bwd, gru_scan_tm_bwd_bf16)
from hpmn_tpu_torch.serving.history import HistoryStore
from hpmn_tpu_torch.serving.lifelong import UserMemoryStore
from hpmn_tpu_torch.train import train

SCAN_TOL = 1e-5
BF16_TOL = 2e-2  # h abs; gradients of their max abs
BF16_STEP_GRAD_TOL = 5e-2  # of each gradient's max abs (see above)
ENC_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
SERVE_TOL = 1e-5
N_ITEMS, N_CATS, B = 300, 30, 8
SMALL = synthetic.DatasetSpec("small", seq_len=24, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=50)
# (use_pallas, assume_full_mask, scan_dtype, dien_use_aux_loss)
SETTINGS = {"pallas_padded": (True, False, "float32", True),
            "pallas_full": (True, True, "float32", True),
            "pallas_full_bf16": (True, True, "bfloat16", True),
            "plain_padded": (False, False, "float32", True),
            "pallas_padded_no_aux": (True, False, "float32", False)}
BF16 = torch.bfloat16


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


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------- the scaled scan --

SCAN_T, SCAN_B, SCAN_D = 19, 4, 32  # T not a multiple of the TPU's 8


def _scan_inputs(use_mask):
    rng = np.random.default_rng(21 + use_mask)
    w = dict(wx=rng.uniform(-0.5, 0.5, (SCAN_D, 96)).astype(np.float32),
             wh=rng.uniform(-0.5, 0.5, (32, 96)).astype(np.float32),
             b=rng.uniform(-0.1, 0.1, (96,)).astype(np.float32))
    T, Bs = SCAN_T, SCAN_B
    x_all = rng.standard_normal((3 * T, Bs, SCAN_D)).astype(np.float32)
    scale = rng.uniform(0.0, 1.0, (T, Bs)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=Bs)
    mask = ((np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
            if use_mask else None)
    dh_seq = rng.standard_normal((T, Bs, 32)).astype(np.float32)
    return w, x_all, scale, mask, dh_seq


@functools.lru_cache(maxsize=None)
def _pallas_scan(dtype, use_mask):
    """pallas_gru_sequence_tm(gate_scale_tm=...) in interpret mode on the
    strided view x_all[2::3], and its jax.vjp (the backward kernel) with a
    cotangent on h_seq -> numpy (h_seq, dx_all, dscale, dwx, dwh, db)."""
    w, x_all, scale, mask, dh_seq = _scan_inputs(use_mask)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    m = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(p, xa, a, dh):
        h, vjp = jax.vjp(lambda p_, x_, a_: pg.pallas_gru_sequence_tm(
            p_, x_[2::3], m, a_, dtype=jd)[0], p, xa, a)
        dp, dx, da = vjp(dh.astype(jd))
        return h, dx, da, dp.wx, dp.wh, dp.b

    prev = pg._INTERPRET
    pg._INTERPRET = True
    try:
        out = run(JGRUParams(**w), jnp.asarray(x_all), jnp.asarray(scale),
                  jnp.asarray(dh_seq))
    finally:
        pg._INTERPRET = prev
    return tuple(_f32(o) for o in out)


def _check_scan(dtype, got_h, got_grads, want):
    """got_grads: dx (on the strided rows), dscale, dwx, dwh, db."""
    want_h, want_dx_all, *want_rest = want
    want_grads = [want_dx_all[2::3], *want_rest]
    names = ("dx", "dscale", "dwx", "dwh", "db")
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got_h), want_h, atol=SCAN_TOL, rtol=0)
        for name, g, ref in zip(names, got_grads, want_grads):
            np.testing.assert_allclose(
                _f32(g), ref, rtol=0,
                atol=SCAN_TOL * max(1.0, np.abs(ref).max()), err_msg=name)
        return
    err_h = np.abs(_f32(got_h) - want_h).max()
    rel = {name: _rel(g, ref) for name, g, ref in zip(names, got_grads,
                                                      want_grads)}
    print(f"bf16 scaled scan: h {err_h:.3e} abs; of max abs "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    assert err_h <= BF16_TOL
    for name, r in rel.items():
        assert r <= BF16_TOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_plain_scaled_scan_matches_pallas(dtype, use_mask):
    """gru_scan_tm(scale_tm=...) and gru_scan_tm_bwd(scale_tm=...) (or
    their bf16 forms) called directly == the Pallas has_scale kernels and
    their vjp."""
    w, x_all, scale, mask, dh_seq = _scan_inputs(use_mask)
    want = _pallas_scan(dtype, use_mask)
    dt = BF16 if dtype == "bfloat16" else torch.float32
    fwd, bwd = ((gru_scan_tm_bf16, gru_scan_tm_bwd_bf16) if dt == BF16
                else (gru_scan_tm, gru_scan_tm_bwd))
    p = GRUWeights(*(torch.from_numpy(w[k]).to(dt) for k in ("wx", "wh", "b")))
    x = torch.from_numpy(x_all[2::3].copy()).to(dt)
    a = torch.from_numpy(scale).to(dt)
    m = None if mask is None else torch.from_numpy(mask).to(dt)
    h_seq, h_T = fwd(p, x, m, None, a)
    assert torch.equal(h_T, h_seq[-1])
    dx, dwx, dwh, db, _, dscale = bwd(p, x, m, h_seq,
                                      torch.from_numpy(dh_seq).to(dt), None, a)
    assert dscale.shape == (SCAN_T, SCAN_B) and dscale.dtype == dt
    _check_scan(dtype, h_seq, (dx, dscale, dwx, dwh, db), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_scan_function_with_scale_matches_pallas(dtype, use_mask):
    """GRUScan with a scale on CPU tensors (``cuda_gru.gru_sequence_tm``:
    the plain versions under the autograd Function), on a strided time
    view of x, the scale differentiable from f32 through a cast as in
    apply_model == the Pallas kernels and their vjp; no launch counted."""
    w, x_all, scale, mask, dh_seq = _scan_inputs(use_mask)
    want = _pallas_scan(dtype, use_mask)
    dt = BF16 if dtype == "bfloat16" else torch.float32
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in w.items()}
    x_leaf = torch.from_numpy(x_all).requires_grad_(True)
    a_leaf = torch.from_numpy(scale).requires_grad_(True)
    counts = (cuda_gru.launches_scale, cuda_gru.bwd_launches_scale,
              cuda_gru.launches_scale_bf16, cuda_gru.bwd_launches_scale_bf16)
    h_seq, _ = cuda_gru.gru_sequence_tm(
        GRUWeights(*(leaves[k].to(dt) for k in ("wx", "wh", "b"))),
        x_leaf.to(dt)[2::3],
        None if mask is None else torch.from_numpy(mask).to(dt),
        scale_tm=a_leaf.to(dt))
    assert h_seq.grad_fn.name() == "GRUScanBackward"
    dx_all, da, dwx, dwh, db = torch.autograd.grad(
        h_seq, [x_leaf, a_leaf, leaves["wx"], leaves["wh"], leaves["b"]],
        torch.from_numpy(dh_seq).to(dt))
    assert da.dtype == torch.float32 and da.shape == (SCAN_T, SCAN_B)
    assert (cuda_gru.launches_scale, cuda_gru.bwd_launches_scale,
            cuda_gru.launches_scale_bf16,
            cuda_gru.bwd_launches_scale_bf16) == counts
    _check_scan(dtype, h_seq, (dx_all[2::3], da, dwx, dwh, db), want)
    assert not dx_all[0::3].any() and not dx_all[1::3].any()


# ------------------------------------------------------------ encoders --

def _encoder_pair(seed):
    """A JAX DIEN encoder and the port's, holding the same weights."""
    jp = j_dien.init_dien(jax.random.key(seed), 32, 32, 32)
    enc = dien.DIENEncoder(32, 32, 32).requires_grad_(False)
    flat = _flat({"encoder": jp})
    for name, p in enc.named_parameters():
        p.copy_(torch.from_numpy(np.array(flat[jax_key("encoder." + name)])))
    return jp, enc


def _encoder_inputs(seed, T=SMALL.seq_len, Bs=B):
    rng = np.random.default_rng(seed)
    x, x_neg = (rng.standard_normal((2, Bs, T, 32)) * 0.5).astype(np.float32)
    target = rng.standard_normal((Bs, 32)).astype(np.float32)
    lens = rng.integers(0, T + 1, size=Bs)  # an empty history included
    lens[0] = 0
    mask = (np.arange(T)[None, :] >= T - lens[:, None]).astype(np.float32)
    return x, x_neg, target, mask


@pytest.mark.parametrize("use_aux_loss", [False, True])
def test_encode_matches_jax(use_aux_loss):
    """The batch-major plain encoder (use_pallas=False) == JAX encode, an
    empty history (alpha 0, not NaN) included."""
    jp, enc = _encoder_pair(1)
    x, x_neg, target, mask = _encoder_inputs(1)
    want_h, want_aux = j_dien.encode(
        jp, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(target),
        x_neg=jnp.asarray(x_neg), use_aux_loss=use_aux_loss)
    got_h, got_aux = dien.encode(
        enc, torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(target), torch.from_numpy(x_neg), use_aux_loss)
    assert torch.isfinite(got_h).all()
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **ENC_TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **ENC_TOL)
    assert not got_h[0].any()  # no valid step: nothing evolves


@pytest.mark.parametrize("use_mask", [False, True])
def test_encode_tm_matches_jax(interpret, use_mask):
    """The time-major encoder through the scan Function (its plain
    versions on CPU tensors) == JAX encode_tm through the Pallas scan."""
    jp, enc = _encoder_pair(2)
    x, x_neg, target, mask = _encoder_inputs(2)
    x_tm, xn_tm = x.transpose(1, 0, 2).copy(), x_neg.transpose(1, 0, 2).copy()
    m_tm = mask.T.copy() if use_mask else None
    want_h, want_aux = jax.jit(lambda p, a, b, c: j_dien.encode_tm(
        p, a, None if m_tm is None else jnp.asarray(m_tm), c, b, True,
        pg.pallas_gru_sequence_tm))(jp, jnp.asarray(x_tm),
                                    jnp.asarray(xn_tm), jnp.asarray(target))
    got_h, got_aux = dien.encode_tm(
        enc, torch.from_numpy(x_tm),
        None if m_tm is None else torch.from_numpy(m_tm),
        torch.from_numpy(target), torch.from_numpy(xn_tm), True,
        cuda_gru.gru_sequence_tm)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **ENC_TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **ENC_TOL)


# -------------------------------------------------- the loss and the step --

def _configs(setting):
    use_pallas, full, scan_dtype, aux = SETTINGS[setting]
    j_cfg = j_get_config("taobao_dien")
    j_cfg.model.use_pallas = use_pallas
    j_cfg.model.assume_full_mask = full
    j_cfg.model.scan_dtype = scan_dtype
    j_cfg.model.dien_use_aux_loss = aux
    cfg = configs.get_config("taobao_dien").with_model(
        use_pallas=use_pallas, assume_full_mask=full, scan_dtype=scan_dtype,
        dien_use_aux_loss=aux)
    return j_cfg, cfg


def _data(setting, seed, n=B):
    return synthetic.make_ctr_dataset(
        SMALL, n, seed=seed, min_len_frac=1.0 if SETTINGS[setting][1] else 0.5)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_loss_fn_gradients_match_jax(interpret, setting):
    """The loss, its parts and every parameter's gradient ==
    jax.value_and_grad of the JAX loss_fn, from one JAX init and batch."""
    j_cfg, cfg = _configs(setting)
    params = j_init_model(jax.random.key(3), j_cfg, N_ITEMS, N_CATS)
    data = _data(setting, seed=3)
    if not SETTINGS[setting][1]:
        assert data["seq_mask"].min() == 0.0  # left padding is exercised
    (j_loss, j_metrics), j_grads = jax.jit(
        lambda p, b: jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, j_cfg, b))(params, j_batch_from_numpy(data))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    assert metrics.keys() == j_metrics.keys() == {"bce", "aux_loss", "l2",
                                                  "loss", "logits"}
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(want)
    if SETTINGS[setting][2] == "bfloat16":
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-3)
        rel = {n: _rel(p.grad, want[jax_key(n)])
               for n, p in model.named_parameters()}
        worst = max(rel, key=rel.get)
        print(f"bf16 step: worst gradient {worst} {rel[worst]:.3e} of max abs")
        for name, p in model.named_parameters():
            assert p.grad.dtype == torch.float32, name
            assert rel[name] <= BF16_STEP_GRAD_TOL, name
        return
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    for k in ("bce", "aux_loss", "l2"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **LOSS_TOL, err_msg=k)
    for name, p in model.named_parameters():
        ref = want[jax_key(name)]
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


def test_step_runs_the_scan_function_for_both_grus():
    """With use_pallas the loss's graph holds two GRUScan nodes (gru1 and
    the AUGRU); on CPU tensors no launch is counted; every parameter gets
    a finite gradient."""
    _, cfg = _configs("pallas_padded")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=1, device="cpu")
    loss, _ = loss_fn(model, cfg, batch_from_numpy(_data("pallas_padded", 1),
                                                   device="cpu"))
    seen, stack, nodes = [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in nodes:
            continue
        nodes.add(node)
        seen.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    assert seen.count("GRUScanBackward") == 2
    counts = (cuda_gru.launches, cuda_gru.bwd_launches,
              cuda_gru.launches_scale, cuda_gru.bwd_launches_scale)
    loss.backward()
    assert (cuda_gru.launches, cuda_gru.bwd_launches,
            cuda_gru.launches_scale, cuda_gru.bwd_launches_scale) == counts
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_three_adam_steps_match_jax(interpret):
    """Parameters after three steps of the port's Adam == JAX's
    make_optimizer + _raw_train_step, left-padded batches (atol 2e-5, as
    tests/test_torch_train.py: Adam divides by sqrt(v))."""
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


def test_multistep_train_runs_dien():
    """make_multistep_train(k=2) on taobao_dien == two single steps, bit
    for bit, the last step's metrics with the aux loss."""
    _, cfg = _configs("pallas_padded")
    batches = [batch_from_numpy(_data("pallas_padded", 60 + k),
                                device="cpu") for k in range(2)]
    models = [init_model(cfg, N_ITEMS, N_CATS, seed=5, device="cpu")
              for _ in range(2)]
    opts = [train.make_optimizer(cfg, m.parameters()) for m in models]
    multi = train.make_multistep_train(cfg, models[0], opts[0])(batches)
    step = train.make_train_step(cfg, models[1], opts[1])
    singles = [step(b) for b in batches]
    assert multi.keys() == {"bce", "aux_loss", "l2", "loss"}
    for k in multi:
        assert torch.equal(multi[k], singles[-1][k]), k
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(a, b), name


def test_convert_round_trip_and_init_shapes():
    """Every key of the JAX DIEN tree fills one parameter with its values
    (the attention's bias b a dict entry, the GRUs' b attributes), and the
    port's own init has the same names and shapes."""
    j_cfg, cfg = _configs("pallas_padded")
    flat = _flat(j_init_model(jax.random.key(7), j_cfg, N_ITEMS, N_CATS))
    model = model_from_flat(cfg, flat, device="cpu")
    assert jax_key("encoder.attn.b") == "['encoder']['attn']['b']"
    assert jax_key("encoder.augru.b") == "['encoder']['augru'].b"
    assert jax_key("encoder.layers.2.b") == "['encoder']['layers'][2].b"
    names = [n for n, _ in model.named_parameters()]
    assert sorted(jax_key(n) for n in names) == sorted(flat)
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), flat[jax_key(name)]), name
    mine = init_model(cfg, N_ITEMS, N_CATS, seed=7, device="cpu")
    assert [n for n, _ in mine.named_parameters()] == names
    for name, p in mine.named_parameters():
        assert tuple(p.shape) == flat[jax_key(name)].shape, name
    assert not hasattr(mine, "readout")


# ------------------------------------------------------------ serving --

W = 12
S_ITEMS, S_CATS = 200, 40


def _serve_cfg():
    return configs.get_config("taobao_dien").with_model(use_pallas=True)


@pytest.fixture(scope="module")
def serve_model():
    return init_model(_serve_cfg(), S_ITEMS, S_CATS, seed=11, device="cpu")


def _ref_scores(model, items, cats, mask, cand_i, cand_c):
    n = len(items)
    z = np.zeros((n, items.shape[1]), np.int32)
    batch = batch_from_numpy(dict(
        uid=np.zeros(n, np.int32), item_seq=items.astype(np.int32),
        cat_seq=cats.astype(np.int32), seq_mask=mask.astype(np.float32),
        target_item=np.asarray(cand_i, np.int32),
        target_cat=np.asarray(cand_c, np.int32),
        label=np.zeros(n, np.float32), neg_item_seq=z, neg_cat_seq=z),
        device="cpu")
    with torch.no_grad():
        logits, _ = apply_model(model, _serve_cfg(), batch)
    return torch.sigmoid(logits).numpy()


def test_history_predict_matches_apply_model(serve_model):
    """Feeding n <= W events one at a time == apply_model on the
    left-padded [W] window."""
    store = HistoryStore(_serve_cfg(), serve_model, window=W, device="cpu")
    rng = np.random.default_rng(0)
    n_events = [W, 5, 1, W - 1]
    items = np.zeros((4, W), np.int32)
    cats = np.zeros((4, W), np.int32)
    mask = np.zeros((4, W), np.float32)
    for i, n in enumerate(n_events):
        items[i, W - n:] = rng.integers(1, S_ITEMS, size=n)
        cats[i, W - n:] = rng.integers(1, S_CATS, size=n)
        mask[i, W - n:] = 1.0
        for t in range(W - n, W):
            store.update([i], [items[i, t]], [cats[i, t]])
    cand_i = rng.integers(1, S_ITEMS, size=4)
    cand_c = rng.integers(1, S_CATS, size=4)
    want = _ref_scores(serve_model, items, cats, mask, cand_i, cand_c)
    np.testing.assert_allclose(store.predict(np.arange(4), cand_i, cand_c),
                               want, atol=1e-6)


def test_history_window_slides(serve_model):
    """W + 7 events: the window holds exactly the last W, full mask."""
    store = HistoryStore(_serve_cfg(), serve_model, window=W, device="cpu")
    rng = np.random.default_rng(1)
    ev_i = rng.integers(1, S_ITEMS, size=W + 7)
    ev_c = rng.integers(1, S_CATS, size=W + 7)
    for t in range(W + 7):
        store.update([42], [ev_i[t]], [ev_c[t]])
    want = _ref_scores(serve_model, ev_i[None, -W:], ev_c[None, -W:],
                       np.ones((1, W)), [3], [4])
    np.testing.assert_allclose(store.predict([42], [3], [4]), want,
                               atol=1e-6)


def test_history_ingest_equals_sequential_updates(serve_model):
    """ingest_histories == replaying update per valid event, histories
    longer than the window and masked pads included."""
    rng = np.random.default_rng(2)
    T = W + 4
    items = rng.integers(1, S_ITEMS, size=(3, T))
    cats = rng.integers(1, S_CATS, size=(3, T))
    masks = np.ones((3, T), np.float32)
    masks[1, :T - 3] = 0.0  # only 3 valid events
    s1 = HistoryStore(_serve_cfg(), serve_model, window=W, device="cpu")
    s1.ingest_histories([1, 2, 3], items, cats, masks=masks)
    s2 = HistoryStore(_serve_cfg(), serve_model, window=W, device="cpu")
    for i, u in enumerate([1, 2, 3]):
        for t in range(T):
            if masks[i, t]:
                s2.update([u], [items[i, t]], [cats[i, t]])
    rows = np.array([1, 2, 3])
    np.testing.assert_array_equal(s1._items[s1._rows_for(rows, False)],
                                  s2._items[s2._rows_for(rows, False)])
    c = rng.integers(1, S_ITEMS, size=3)
    np.testing.assert_array_equal(s1.predict(rows, c, c % S_CATS),
                                  s2.predict(rows, c, c % S_CATS))


def test_history_rank_matches_predict_columns_and_chunks(serve_model):
    """rank's column c == predict on column c; a store that scores at most
    16 rows per call (42 rows: chunks of 16 and a ragged tail) gives the
    same scores."""
    cfg = _serve_cfg()
    big = HistoryStore(cfg, serve_model, window=W, device="cpu")
    small = HistoryStore(cfg, serve_model, window=W, max_score_rows=16,
                         device="cpu")
    rng = np.random.default_rng(3)
    uids = np.arange(6)
    for _ in range(5):
        ev_i, ev_c = rng.integers(1, S_ITEMS, 6), rng.integers(1, S_CATS, 6)
        big.update(uids, ev_i, ev_c)
        small.update(uids, ev_i, ev_c)
    ci = rng.integers(1, S_ITEMS, size=(6, 7))
    cc = rng.integers(1, S_CATS, size=(6, 7))
    ranked = big.rank(uids, ci, cc)
    assert ranked.shape == (6, 7)
    for c in range(7):
        np.testing.assert_allclose(ranked[:, c],
                                   big.predict(uids, ci[:, c], cc[:, c]),
                                   atol=1e-6)
    np.testing.assert_allclose(small.rank(uids, ci, cc), ranked, atol=1e-6)


def test_history_cold_start_scores_an_empty_history(serve_model):
    """An unknown user scores with an all-masked window: alpha is 0 (not
    NaN), the evolved interest is 0, and the score is the tower's on
    [target; 0]; predict creates no state."""
    store = HistoryStore(_serve_cfg(), serve_model, window=W, device="cpu")
    out = store.predict([999], [5], [6])
    emb = serve_model.embedding
    with torch.no_grad():
        q = torch.cat([emb.item[[5]], emb.cat[[6]]], -1)
        want = torch.sigmoid(apply_tower(
            serve_model.tower, torch.cat([q, torch.zeros(1, 32)], -1)))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want.numpy(), atol=1e-6)
    assert store.n_users == 0


def test_history_max_users_eviction(serve_model):
    store = HistoryStore(_serve_cfg(), serve_model, window=W, max_users=8,
                         device="cpu")
    for u in range(20):
        store.update([u], [1 + u % (S_ITEMS - 1)], [1])
    assert store.n_users <= 8
    assert 19 in store._row  # the most recent user survived
    assert np.isfinite(store.predict([19], [2], [2])).all()


def test_history_store_matches_jax_store():
    """The port's HistoryStore (use_pallas: the scan Function's plain
    versions here) and the JAX HistoryStore (its plain path), built from
    the same parameters and fed the same ingests, updates and requests,
    give the same scores."""
    j_cfg = j_get_config("taobao_dien")
    params = j_init_model(jax.random.key(9), j_cfg, S_ITEMS, S_CATS)
    model = model_from_flat(_serve_cfg(), _flat(params), device="cpu")
    js = JHistoryStore(j_cfg, params, window=W)
    ts = HistoryStore(_serve_cfg(), model, window=W, device="cpu")
    rng = np.random.default_rng(5)
    T = W + 3
    items = rng.integers(1, S_ITEMS, size=(5, T)).astype(np.int32)
    cats = (items % (S_CATS - 1) + 1).astype(np.int32)
    masks = np.ones((5, T), np.float32)
    masks[2, :T - 4] = 0.0
    ev_i = rng.integers(1, S_ITEMS, size=3)
    for s in (js, ts):
        s.ingest_histories(np.arange(5), items, cats, masks=masks)
        s.update([0, 2, 7], ev_i, ev_i % S_CATS)
    uids = np.array([0, 1, 2, 3, 4, 7, 99])  # 7: three updates; 99: unknown
    ci = rng.integers(1, S_ITEMS, size=(len(uids), 3))
    np.testing.assert_allclose(ts.predict(uids, ci[:, 0], ci[:, 0] % S_CATS),
                               np.asarray(js.predict(uids, ci[:, 0],
                                                     ci[:, 0] % S_CATS)),
                               atol=SERVE_TOL)
    np.testing.assert_allclose(ts.rank(uids, ci, ci % S_CATS),
                               np.asarray(js.rank(uids, ci, ci % S_CATS)),
                               atol=SERVE_TOL)


def test_memory_store_refuses_dien(serve_model):
    """UserMemoryStore has no O(1) state for a target-dependent encoder: it
    raises a ValueError that names HistoryStore, as the JAX store does."""
    with pytest.raises(ValueError, match="HistoryStore"):
        UserMemoryStore(_serve_cfg(), serve_model, device="cpu")


def test_history_store_defaults_to_the_card():
    import inspect
    assert inspect.signature(HistoryStore).parameters["device"].default \
        == "cuda"
