"""The port's GRU4Rec and RUM (``amazon_gru4rec``, ``amazon_rum``) against
the JAX package on the CPU: the logits, ``loss_fn`` and every gradient,
three Adam steps, the parameter conversion, and serving through
``UserMemoryStore`` (the O(1) protocol's contract per family, and the
store against the JAX store). JAX parameters reach the port through
``hpmn_tpu_torch.convert``; inputs are drawn with numpy from a seed. The
Pallas kernels run in interpret mode. The model size is
tests/test_torch_dien.py's: T = 24, B = 8, vocab 300/30.

Tolerances: the logits 1e-4 abs; the loss and its parts rtol 1e-5; every
gradient atol 1e-5 * max(1, max |grad|) plus rtol 1e-4, as
tests/test_torch_train.py; the parameters after three Adam steps 2e-5
abs. Serving: the store against the port's own apply_model at 1e-5 (one
GRU cell or one write per event against the scan), and against the JAX
store at 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.serving import UserMemoryStore as JStore
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu.train.train import _raw_train_step
from hpmn_tpu.train.train import make_optimizer as j_make_optimizer
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.model import apply_model, init_model, loss_fn
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.serving import protocol
from hpmn_tpu_torch.serving.lifelong import UserMemoryStore
from hpmn_tpu_torch.train import train

LOGIT_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
ADAM_TOL = 2e-5
SERVE_TOL = 1e-5
N_ITEMS, N_CATS, B = 300, 30, 8
SMALL = synthetic.DatasetSpec("small", seq_len=24, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=50)
# name: (family, use_pallas, assume_full_mask); rum has no kernel, so its
# use_pallas runs the same plain path, as in JAX.
SETTINGS = {"gru4rec_plain": ("gru4rec", False, False),
            "gru4rec_pallas_padded": ("gru4rec", True, False),
            "gru4rec_pallas_full": ("gru4rec", True, True),
            "rum_plain": ("rum", False, False),
            "rum_pallas": ("rum", True, False)}


@pytest.fixture
def interpret():
    pg._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = False


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _configs(setting, rum_slots=8):
    family, use_pallas, full = SETTINGS[setting]
    j_cfg = j_get_config(f"amazon_{family}")
    j_cfg.model.use_pallas = use_pallas
    j_cfg.model.assume_full_mask = full
    j_cfg.model.rum_slots = rum_slots
    cfg = configs.get_config(f"amazon_{family}").with_model(
        use_pallas=use_pallas, assume_full_mask=full, rum_slots=rum_slots)
    return j_cfg, cfg


def _data(setting, seed, n=B):
    return synthetic.make_ctr_dataset(
        SMALL, n, seed=seed, min_len_frac=1.0 if SETTINGS[setting][2] else 0.5)


# -------------------------------------------------- the loss and the step --

@pytest.mark.parametrize("setting", list(SETTINGS))
def test_loss_fn_gradients_match_jax(interpret, setting):
    """The logits, the loss, its parts and every parameter's gradient ==
    jax.value_and_grad of the JAX loss_fn, from one JAX init and batch."""
    j_cfg, cfg = _configs(setting)
    params = j_init_model(jax.random.key(3), j_cfg, N_ITEMS, N_CATS)
    data = _data(setting, seed=3)
    if not SETTINGS[setting][2]:
        assert data["seq_mask"].min() == 0.0  # left padding is exercised
    (j_loss, j_metrics), j_grads = jax.jit(
        lambda p, b: jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, j_cfg, b))(params, j_batch_from_numpy(data))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    loss, metrics = loss_fn(model, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    assert metrics.keys() == j_metrics.keys() == {"bce", "l2", "loss",
                                                  "logits"}
    np.testing.assert_allclose(metrics["logits"].detach().numpy(),
                               np.asarray(j_metrics["logits"]),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    for k in ("bce", "l2"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **LOSS_TOL, err_msg=k)
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(want)
    for name, p in model.named_parameters():
        ref = want[jax_key(name)]
        np.testing.assert_allclose(
            p.grad.numpy(), ref, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


@pytest.mark.parametrize("setting", ["gru4rec_plain",
                                     "gru4rec_pallas_padded", "rum_pallas"])
def test_step_runs_the_scan_function_only_for_gru4rec_pallas(setting):
    """gru4rec with use_pallas puts one GRUScan node in the loss's graph
    (K1 forward, K2 backward on the card); its plain form and rum none. On
    CPU tensors no launch is counted; every gradient is finite."""
    _, cfg = _configs(setting)
    model = init_model(cfg, N_ITEMS, N_CATS, seed=1, device="cpu")
    loss, _ = loss_fn(model, cfg, batch_from_numpy(_data(setting, 1),
                                                   device="cpu"))
    seen, stack, nodes = [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in nodes:
            continue
        nodes.add(node)
        seen.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    assert seen.count("GRUScanBackward") == (
        setting == "gru4rec_pallas_padded")
    counts = (cuda_gru.launches, cuda_gru.bwd_launches)
    loss.backward()
    assert (cuda_gru.launches, cuda_gru.bwd_launches) == counts
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("setting", ["gru4rec_pallas_padded", "rum_plain"])
def test_three_adam_steps_match_jax(interpret, setting):
    """Parameters after three steps of the port's Adam == JAX's
    make_optimizer + _raw_train_step, left-padded batches (atol 2e-5, as
    tests/test_torch_train.py: Adam divides by sqrt(v))."""
    j_cfg, cfg = _configs(setting)
    params = j_init_model(jax.random.key(4), j_cfg, N_ITEMS, N_CATS)
    tx = j_make_optimizer(j_cfg)
    opt_state = tx.init(params)
    j_step = jax.jit(_raw_train_step(j_cfg, tx))
    model = model_from_flat(cfg, _flat(params), device="cpu")
    step = train.make_train_step(
        cfg, model, train.make_optimizer(cfg, model.parameters()))
    for k in range(3):
        data = _data(setting, seed=40 + k)
        params, opt_state, j_metrics = j_step(params, opt_state,
                                              j_batch_from_numpy(data))
        metrics = step(batch_from_numpy(data, device="cpu"))
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(j_metrics["loss"]), rtol=1e-5)
    want = _flat(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[jax_key(name)],
                                   atol=ADAM_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("family", ["gru4rec", "rum"])
def test_convert_round_trip_and_init_shapes(family):
    """Every key of the JAX tree fills one parameter with its values (the
    GRU's weights attributes, RUM's 0-d beta a dict entry); the port's own
    init has the JAX init's shapes, draws the JAX distributions' scales
    and repeats for a seed."""
    j_cfg, cfg = _configs(f"{family}_plain", rum_slots=5)
    j_flat = _flat(j_init_model(jax.random.key(5), j_cfg, N_ITEMS, N_CATS))
    model = model_from_flat(cfg, j_flat, device="cpu")
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), j_flat[jax_key(name)]), name
    a, b = (init_model(cfg, N_ITEMS, N_CATS, seed=6, device="cpu")
            for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert tuple(pa.shape) == j_flat[jax_key(name)].shape, name
    if family == "rum":
        enc = a.encoder
        assert enc.beta.shape == () and enc.beta.item() == 1.0
        assert enc.keys.shape == (5, 32)
        assert abs(enc.keys.std().item() - 32 ** -0.5) < 0.05
        assert enc.proj.abs().max().item() <= (6.0 / 64) ** 0.5
    else:
        assert not a.encoder.gru.b.any()


def test_l2_skips_rum_beta():
    """RUM's 0-d beta is no weight matrix: the L2 term skips it, as JAX's
    l2_regularizer does; keys and the projections are counted."""
    _, cfg = _configs("rum_plain")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=7, device="cpu")
    _, metrics = loss_fn(model, cfg, batch_from_numpy(_data("rum_plain", 7),
                                                      device="cpu"))
    want = sum(float((p.detach().double() ** 2).sum()) for p in
               model.parameters() if p.dim() >= 2)
    with torch.no_grad():
        model.encoder.beta.fill_(5.0)
    _, again = loss_fn(model, cfg, batch_from_numpy(_data("rum_plain", 7),
                                                    device="cpu"))
    np.testing.assert_allclose(metrics["l2"].item(), want, rtol=1e-6)
    assert again["l2"].item() == metrics["l2"].item()


# ------------------------------------------------------------- serving --

S_T = 12


def _events(rng, Bs, padded):
    items = rng.integers(1, N_ITEMS, size=(Bs, S_T)).astype(np.int32)
    mask = np.ones((Bs, S_T), np.float32)
    if padded:
        lens = rng.integers(1, S_T + 1, size=Bs)
        mask = (np.arange(S_T)[None, :] >= S_T - lens[:, None]).astype(
            np.float32)
        items = (items * mask).astype(np.int32)
    return items, (items % N_CATS).astype(np.int32), mask


def _serve(family, seed):
    """A JAX store and the port's (on the CPU), holding the same JAX-init
    weights; rum with 5 slots."""
    j_cfg, cfg = _configs(f"{family}_plain", rum_slots=5)
    params = j_init_model(jax.random.key(seed), j_cfg, N_ITEMS, N_CATS)
    model = model_from_flat(cfg, _flat(params), device="cpu")
    return (JStore(j_cfg, params),
            UserMemoryStore(cfg, model, device="cpu"), cfg, model)


def _training_scores(cfg, model, items, cats, mask, ci, cc):
    Bs = items.shape[0]
    data = {"uid": np.zeros(Bs, np.int32), "item_seq": items,
            "cat_seq": cats, "seq_mask": mask, "target_item": ci,
            "target_cat": cc, "label": np.zeros(Bs, np.float32),
            "neg_item_seq": np.zeros_like(items),
            "neg_cat_seq": np.zeros_like(items)}
    with torch.no_grad():
        logits, _ = apply_model(model, cfg,
                                batch_from_numpy(data, device="cpu"))
    return torch.sigmoid(logits).numpy()


@pytest.mark.parametrize("family", ["gru4rec", "rum"])
def test_feed_one_by_one_matches_training(family):
    """S_T events through update() == the training forward on the whole
    history; the state has n_state_slots rows."""
    _, store, cfg, model = _serve(family, 10)
    rng = np.random.default_rng(10)
    items, cats, mask = _events(rng, 4, padded=False)
    uids = np.arange(4)
    for t in range(S_T):
        store.update(uids, items[:, t], cats[:, t])
    ci = rng.integers(1, N_ITEMS, size=4).astype(np.int32)
    np.testing.assert_allclose(
        store.predict(uids, ci, ci % N_CATS),
        _training_scores(cfg, model, items, cats, mask, ci, ci % N_CATS),
        atol=SERVE_TOL)
    assert store._mem.shape[1] == protocol.n_state_slots(cfg) == (
        1 if family == "gru4rec" else 5)
    assert store._gather(uids)[1].tolist() == [S_T] * 4


@pytest.mark.parametrize("family", ["gru4rec", "rum"])
def test_ingest_equals_sequential_updates(family):
    """A batched ingest of left-padded histories == their valid events
    through update() one at a time; the counter is the count of valid
    events; the scores are the training forward's on the padded rows."""
    _, store, cfg, model = _serve(family, 11)
    rng = np.random.default_rng(11)
    items, cats, mask = _events(rng, 5, padded=True)
    store.ingest_histories(np.arange(5), items, cats, masks=mask)
    for b in range(5):
        for t in np.flatnonzero(mask[b]):
            store.update([100 + b], items[b, t:t + 1], cats[b, t:t + 1])
    m_a, c_a = store._gather(np.arange(5))
    m_b, c_b = store._gather(np.arange(100, 105))
    np.testing.assert_allclose(m_a.numpy(), m_b.numpy(), atol=SERVE_TOL)
    assert c_a.tolist() == c_b.tolist() == mask.sum(1).astype(int).tolist()
    ci = rng.integers(1, N_ITEMS, size=5).astype(np.int32)
    np.testing.assert_allclose(
        store.predict(np.arange(5), ci, ci % N_CATS),
        _training_scores(cfg, model, items, cats, mask, ci, ci % N_CATS),
        atol=SERVE_TOL)


@pytest.mark.parametrize("family", ["gru4rec", "rum"])
def test_store_matches_jax_store(family):
    """Full and left-padded ingests, updates, predict and rank == the JAX
    UserMemoryStore on the same events: states, counters and scores; rank's
    columns == predict."""
    js, ts, _, _ = _serve(family, 12)
    rng = np.random.default_rng(12)
    items, cats, _ = _events(rng, 4, padded=False)
    for s in (js, ts):
        s.ingest_histories(np.arange(4), items, cats)
    items, cats, mask = _events(rng, 4, padded=True)
    for s in (js, ts):
        s.ingest_histories(np.arange(10, 14), items, cats, masks=mask)
    uids = np.array([0, 1, 2, 3, 10, 11, 12, 13])
    for _ in range(3):
        ev = rng.integers(1, N_ITEMS, size=6).astype(np.int32)
        upd = uids[rng.permutation(8)[:6]]
        for s in (js, ts):
            s.update(upd, ev, ev % N_CATS)
    m_j, c_j = js._gather(uids)
    m_t, c_t = ts._gather(uids)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=SERVE_TOL)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    ci = rng.integers(1, N_ITEMS, size=8).astype(np.int32)
    np.testing.assert_allclose(ts.predict(uids, ci, ci % N_CATS),
                               js.predict(uids, ci, ci % N_CATS),
                               atol=SERVE_TOL)
    cm = rng.integers(1, N_ITEMS, size=(8, 5)).astype(np.int32)
    ranked = ts.rank(uids, cm, cm % N_CATS)
    np.testing.assert_allclose(ranked, js.rank(uids, cm, cm % N_CATS),
                               atol=SERVE_TOL)
    for c in range(5):
        np.testing.assert_allclose(
            ranked[:, c], ts.predict(uids, cm[:, c], cm[:, c] % N_CATS),
            atol=1e-6)
    cold = np.array([500, 501])  # unknown users score from an empty state
    np.testing.assert_allclose(ts.predict(cold, ci[:2], ci[:2] % N_CATS),
                               js.predict(cold, ci[:2], ci[:2] % N_CATS),
                               atol=SERVE_TOL)


@pytest.mark.parametrize("family", ["dien", "dnn", "lstm", "caser", "shan",
                                    "svdpp", "bst"])
def test_target_dependent_families_still_refused(family):
    """Every family outside protocol.O1_FAMILIES has no O(1) state:
    UserMemoryStore raises the JAX store's ValueError, which names
    HistoryStore."""
    assert family not in protocol.O1_FAMILIES
    cfg = configs.get_config("amazon_gru4rec")
    model = init_model(cfg, N_ITEMS, N_CATS, seed=0, device="cpu")
    with pytest.raises(ValueError, match="HistoryStore"):
        UserMemoryStore(cfg.with_model(name=family), model, device="cpu")
    with pytest.raises(ValueError, match="HistoryStore"):
        protocol.n_state_slots(cfg.with_model(name=family))
