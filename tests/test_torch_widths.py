"""The port at every width the Pallas kernels take, against the JAX package
on the CPU.

The card runs the fixed-width kernels at d_m = 32, d_in <= 96 (and K5 at A
= d_m = 32, L <= 16, d_q <= 256) and the width-general forms
(``csrc/gru_general_*.cu``, ``csrc/readout_general.cu``) everywhere else.
On CPU tensors the wrappers run the plain versions at any width, so here
the port's side is ``GRUScan`` and ``fused_attention_readout`` on CPU
tensors, and the JAX side the Pallas kernels in interpret mode
(``pallas_gru_sequence_tm`` and its ``jax.vjp``,
``pallas_attention_readout``), as tests/test_pallas.py runs them. Inputs
and weights are drawn with numpy from a seed and handed to both sides.

Tolerances (ROADMAP's): values at 1e-5; gradients within 1e-5 of their max
abs plus rtol 1e-4 (sums over the row-steps taken in other orders, and
the Pallas scan writes sigmoid through tanh); the bf16 chain at
tests/test_torch_bf16.py's, h at 2e-2 abs and gradients at 2e-2 of their
max abs (a bf16 rounding that flips runs on as a few bf16 ulps).

Then small xlong_hpmn and taobao_dien models with ``use_pallas`` at
mem_dim 16, readout_dim 24 and emb_dim 20 (layer 0's d_in 40) against
JAX's loss and its gradients, a store at mem_dim 16 exported with
``torch.export`` against the eager store, and the wrappers' pure-Python
limits and workspace sizes at the new widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models import loss_fn as j_loss_fn
from hpmn_tpu.ops.gru import GRUParams as JGRUParams
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.model import init_model, loss_fn
from hpmn_tpu_torch.models.readout import Readout
from hpmn_tpu_torch.ops import cuda_gru, cuda_gru_stride, cuda_readout
from hpmn_tpu_torch.ops.gru import GRUWeights
from hpmn_tpu_torch.serving import UserMemoryStore, load_bundle
from hpmn_tpu_torch.serving.aot import load_aot_store

VAL_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # atol of each gradient's max abs
BF16_H_TOL, BF16_GRAD_TOL = 2e-2, 2e-2
BF16 = torch.bfloat16
GRU_WIDTHS = [(1, 1), (3, 4), (8, 8), (40, 48), (128, 64)]
READOUT_WIDTHS = [(16, 24, 3, 8), (64, 64, 20, 128)]
# (mask, scale): without both, and with both
FORMS = [(False, False), (True, True)]
NARROW = dict(mem_dim=16, readout_dim=24, emb_dim=20)
N_ITEMS, N_CATS = 200, 20


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close_grad(got, want, name):
    got, want = _f32(got), _f32(want)
    atol = GRAD_ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=name)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked,scaled", FORMS)
@pytest.mark.parametrize("d_in,d_m", GRU_WIDTHS)
def test_gru_scan_matches_pallas_at_width(interpret, d_in, d_m, masked,
                                          scaled, dtype):
    """h_seq and every gradient (x, wx, wh, b, h0, the scale) through
    GRUScan on CPU tensors == pallas_gru_sequence_tm and its jax.vjp, with
    an h0 and cotangents on h_seq and h_T."""
    rng = np.random.default_rng(d_in * 7 + d_m + 2 * masked + scaled)
    T, B = 9, 3
    w = dict(wx=rng.uniform(-0.5, 0.5, (d_in, 3 * d_m)).astype(np.float32),
             wh=rng.uniform(-0.5, 0.5, (d_m, 3 * d_m)).astype(np.float32),
             b=rng.uniform(-0.1, 0.1, (3 * d_m,)).astype(np.float32))
    x = rng.standard_normal((T, B, d_in)).astype(np.float32)
    h0 = rng.standard_normal((B, d_m)).astype(np.float32) * 0.5
    lens = rng.integers(1, T + 1, size=B)
    mask = ((np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
            if masked else None)
    scale = (rng.uniform(0.0, 1.0, (T, B)).astype(np.float32) if scaled
             else None)
    dh_seq = rng.standard_normal((T, B, d_m)).astype(np.float32)
    dh_T = rng.standard_normal((B, d_m)).astype(np.float32)
    j_dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    t_dt = BF16 if dtype == "bfloat16" else torch.float32

    def j_fn(p, xa, ha, sa):
        return pg.pallas_gru_sequence_tm(
            p, xa, None if mask is None else jnp.asarray(mask),
            sa if scaled else None, ha, dtype=j_dt)

    (h_j, hT_j), vjp = jax.vjp(
        j_fn, JGRUParams(**w), jnp.asarray(x), jnp.asarray(h0),
        jnp.asarray(scale if scaled else np.ones((T, B), np.float32)))
    j_dp, j_dx, j_dh0, j_ds = vjp((jnp.asarray(dh_seq, j_dt),
                                   jnp.asarray(dh_T, j_dt)))

    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in dict(w, x=x, h0=h0).items()}
    if scaled:
        leaves["scale"] = torch.from_numpy(scale).requires_grad_(True)
    h_seq, h_T = cuda_gru.gru_sequence_tm(
        GRUWeights(*(leaves[k].to(t_dt) for k in ("wx", "wh", "b"))),
        leaves["x"].to(t_dt),
        None if mask is None else torch.from_numpy(mask).to(t_dt),
        leaves["h0"].to(t_dt),
        leaves["scale"].to(t_dt) if scaled else None)
    assert h_seq.shape == (T, B, d_m) and h_seq.dtype == t_dt
    names = ["x", "wx", "wh", "b", "h0"] + (["scale"] if scaled else [])
    got = torch.autograd.grad(
        (h_seq, h_T), [leaves[k] for k in names],
        (torch.from_numpy(dh_seq).to(t_dt), torch.from_numpy(dh_T).to(t_dt)))
    want = dict(x=j_dx, wx=j_dp.wx, wh=j_dp.wh, b=j_dp.b, h0=j_dh0,
                scale=j_ds)
    if dtype == "bfloat16":
        assert np.abs(_f32(h_seq) - _f32(h_j)).max() <= BF16_H_TOL
        assert np.abs(_f32(h_T) - _f32(hT_j)).max() <= BF16_H_TOL
        for name, g in zip(names, got):
            assert _rel(g, want[name]) <= BF16_GRAD_TOL, name
        return
    np.testing.assert_allclose(_f32(h_seq), _f32(h_j), rtol=0, atol=VAL_TOL)
    np.testing.assert_allclose(_f32(h_T), _f32(hT_j), rtol=0, atol=VAL_TOL)
    for name, g in zip(names, got):
        _close_grad(g, want[name], name)


@pytest.mark.parametrize("d_m,A,L,d_q", READOUT_WIDTHS)
def test_readout_matches_pallas_at_width(interpret, d_m, A, L, d_q):
    """fused_attention_readout on CPU tensors, and its gradients ==
    pallas_attention_readout and its jax.vjp."""
    rng = np.random.default_rng(d_m + A + L + d_q)
    B = 5
    w = dict(wm=rng.uniform(-0.5, 0.5, (d_m, A)).astype(np.float32),
             wq=rng.uniform(-0.5, 0.5, (d_q, A)).astype(np.float32),
             b=rng.uniform(-0.1, 0.1, (A,)).astype(np.float32),
             v=rng.uniform(-0.5, 0.5, (A,)).astype(np.float32))
    mem = rng.standard_normal((B, L, d_m)).astype(np.float32)
    q = rng.standard_normal((B, d_q)).astype(np.float32)
    d_read = rng.standard_normal((B, d_m)).astype(np.float32)
    j_read, vjp = jax.vjp(
        lambda p, m, qq: pr.pallas_attention_readout(p, m, qq),
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(mem),
        jnp.asarray(q))
    j_dp, j_dm, j_dq = vjp(jnp.asarray(d_read))
    r = Readout(d_m, d_q, A)
    with torch.no_grad():
        for k, v in w.items():
            getattr(r, k).copy_(torch.from_numpy(v))
    mem_t = torch.from_numpy(mem).requires_grad_(True)
    q_t = torch.from_numpy(q).requires_grad_(True)
    read = cuda_readout.fused_attention_readout(r, mem_t, q_t)
    np.testing.assert_allclose(_f32(read), _f32(j_read), rtol=0,
                               atol=VAL_TOL)
    got = torch.autograd.grad(read, [mem_t, q_t, r.wm, r.wq, r.b, r.v],
                              torch.from_numpy(d_read))
    for name, g, ref in zip(("memory", "query", "wm", "wq", "b", "v"), got,
                            (j_dm, j_dq, j_dp["wm"], j_dp["wq"], j_dp["b"],
                             j_dp["v"])):
        _close_grad(g, ref, name)


def _flat(tree):
    keys, leaves, _ = flatten_with_keys(tree)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _narrow_configs(name, **model):
    j_cfg = j_get_config(name)
    for k, v in dict(NARROW, use_pallas=True, **model).items():
        setattr(j_cfg.model, k, v)
    return j_cfg, configs.get_config(name).with_model(
        use_pallas=True, **NARROW, **model)


@pytest.mark.parametrize("name,model,seq_len", [
    ("xlong_hpmn", dict(hpmn_layers=3), 29), ("taobao_dien", {}, 12)])
def test_narrow_model_matches_jax(interpret, name, model, seq_len):
    """The loss and every parameter's gradient of a use_pallas model at
    mem_dim 16, readout_dim 24, emb_dim 20 == jax.value_and_grad of the
    JAX loss_fn, from one JAX init (carried across by convert.py) and one
    batch."""
    j_cfg, cfg = _narrow_configs(name, **model)
    spec = synthetic.DatasetSpec("small", seq_len=seq_len, n_items=N_ITEMS,
                                 n_cats=N_CATS, n_users=50)
    data = synthetic.make_ctr_dataset(
        spec, 6, seed=4, min_len_frac=1.0 if cfg.model.assume_full_mask
        else 0.5)
    params = j_init_model(jax.random.key(5), j_cfg, N_ITEMS, N_CATS)
    (j_loss, _), j_grads = jax.jit(
        lambda p, b: jax.value_and_grad(j_loss_fn, has_aux=True)(
            p, j_cfg, b))(params, j_batch_from_numpy(data))
    model_t = model_from_flat(cfg, _flat(params), device="cpu")
    loss, _ = loss_fn(model_t, cfg, batch_from_numpy(data, device="cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5,
                               atol=1e-7)
    want = _flat(j_grads)
    assert {jax_key(n) for n, _ in model_t.named_parameters()} == set(want)
    for n, p in model_t.named_parameters():
        _close_grad(p.grad, want[jax_key(n)], n)


def test_narrow_store_exports_match_eager(tmp_path):
    """A UserMemoryStore at mem_dim 16 (taobao_hpmn, 3 layers of period 3,
    readout_dim 24, emb_dim 20) saved with its torch.export graphs for the
    CPU: the AOT store's predict, rank and update == the eager store's."""
    cfg = configs.get_config("taobao_hpmn").with_model(**NARROW)
    store = UserMemoryStore(cfg, init_model(cfg, N_ITEMS, N_CATS, seed=0,
                                            device="cpu"), device="cpu")
    rng = np.random.default_rng(3)
    uids = np.arange(12)
    hist = rng.integers(1, N_ITEMS, size=(12, 13)).astype(np.int32)
    store.ingest_histories(uids, hist, (hist % N_CATS).astype(np.int32))
    store.save_bundle(str(tmp_path), export_compiled=True,
                      export_platforms=("cpu",))
    eager = load_bundle(str(tmp_path), device="cpu")
    aot = load_aot_store(str(tmp_path), device="cpu")
    ci = rng.integers(1, N_ITEMS, size=12).astype(np.int32)
    np.testing.assert_allclose(aot.predict(uids, ci, ci % N_CATS),
                               eager.predict(uids, ci, ci % N_CATS),
                               atol=1e-6)
    ri = rng.integers(1, N_ITEMS, size=(12, 5)).astype(np.int32)
    np.testing.assert_allclose(aot.rank(uids, ri, ri % N_CATS),
                               eager.rank(uids, ri, ri % N_CATS), atol=1e-6)
    up = np.array([0, 5, 13], np.int64)
    items = rng.integers(1, N_ITEMS, size=3).astype(np.int32)
    for s in (aot, eager):
        s.update(up, items, items % N_CATS)
    np.testing.assert_allclose(aot.predict(uids, ci, ci % N_CATS),
                               eager.predict(uids, ci, ci % N_CATS),
                               atol=1e-6)


def test_wrapper_limits_and_workspaces_at_the_new_widths():
    """Which widths take the fixed-width kernels, the general forms'
    workspace chunks and partials, and the ValueError past each limit."""
    assert cuda_gru.fixed_width(96, 32) and cuda_gru.fixed_width(1, 32)
    for d_in, d_m in ((97, 32), (32, 16), (32, 64), (1, 1), (512, 256)):
        assert not cuda_gru.fixed_width(d_in, d_m)
    assert cuda_readout.fixed_width(32, 32, 16, 256)
    for shape in ((32, 32, 17, 32), (32, 32, 6, 257), (64, 32, 6, 32),
                  (32, 64, 6, 32)):
        assert not cuda_readout.fixed_width(*shape)
    # K1's f32 workspace [Tc, B, 3*d_m] in 64 MiB; K2-general's xp and
    # h_prev @ wh (f32) and dg (x's dtype) together.
    assert cuda_gru.workspace_steps(1000, 512) == 341
    assert cuda_gru.workspace_steps(1000, 512, 64) == 170
    assert cuda_gru.workspace_steps(1000, 512, 128) == 85
    assert cuda_gru.workspace_steps(10, 512, 1) == 10
    assert cuda_gru.gen_bwd_workspace_steps(1000, 512, 64,
                                            torch.float32) == 51
    assert cuda_gru.gen_bwd_workspace_steps(1000, 512, 64, BF16) == 64
    assert cuda_gru.gen_bwd_workspace_steps(300, 512, 16, BF16) == 256
    assert cuda_gru.gen_bwd_workspace_steps(5, 10 ** 6, 256, BF16) == 1
    # about 256 blocks of 64 x 64 tiles over the x half's (d_in + 1, 3 d_m)
    assert cuda_gru.gen_splits(128, 64) == 28
    assert cuda_gru.gen_splits(1, 1) == 64
    assert cuda_gru.gen_splits(512, 256) == 2
    w = GRUWeights(torch.zeros(8, 3 * 257), torch.zeros(257, 3 * 257),
                   torch.zeros(3 * 257))
    with pytest.raises(ValueError, match="d_m <= 256 and d_in <= 512"):
        cuda_gru._check_cuda_args(w, torch.zeros(3, 2, 8), None, None, "k")
    w = GRUWeights(torch.zeros(513, 12), torch.zeros(4, 12), torch.zeros(12))
    with pytest.raises(ValueError, match="d_m <= 256 and d_in <= 512"):
        cuda_gru._check_cuda_args(w, torch.zeros(3, 2, 513), None, None, "k")
    w = GRUWeights(torch.zeros(16, 48), torch.zeros(16, 48), torch.zeros(48))
    cuda_gru._check_cuda_args(w, torch.zeros(3, 2, 16), None, None, "k")
    # The strided forms (K3/K4 and K3-general/K4-general) take the same
    # widths, and K4-general's workspace chunk (xp and the replay's h @ wh
    # in f32, dg and h_prev in x's dtype) is a multiple of the boundaries'
    # 16 steps that fits 64 MiB.
    for d_in, d_m in ((16, 16), (1, 1), (128, 64), (128, 32), (512, 256)):
        w = GRUWeights(torch.zeros(d_in, 3 * d_m), torch.zeros(d_m, 3 * d_m),
                       torch.zeros(3 * d_m))
        cuda_gru_stride._check_args(w, torch.zeros(6, 2, d_in), None, 3,
                                    "K3")
    for d_in, d_m in ((8, 257), (513, 4)):
        w = GRUWeights(torch.zeros(d_in, 3 * d_m), torch.zeros(d_m, 3 * d_m),
                       torch.zeros(3 * d_m))
        with pytest.raises(ValueError, match="d_m <= 256 and d_in <= 512"):
            cuda_gru_stride._check_args(w, torch.zeros(6, 2, d_in), None, 3,
                                        "K3")
    for dt, es, want in ((torch.float32, 4, 32), (BF16, 2, 48)):
        n = cuda_gru_stride.bwd_workspace_steps(1000, 512, dt, 16, 64, 64)
        row = 64 * (2 * 3 * 4 + 5 * es)  # bytes per row-step
        assert n == want and n % 16 == 0
        assert n * 512 * row <= 64 << 20 < (n + 16) * 512 * row
    # K4-general's partials: batch slices, the fewest divisors of B (up to
    # 64) that reach K2-general's count, else the largest below it.
    assert cuda_gru_stride.gen_splits(512, 128, 64) == 32
    assert cuda_gru_stride.gen_splits(512, 64, 64) == 64
    assert cuda_gru_stride.gen_splits(37, 128, 64) == 37
    assert cuda_gru_stride.gen_splits(1009, 128, 64) == 1
    assert cuda_gru_stride.gen_splits(6, 1, 1) == 6
    for d_m, A, L, d_q in ((257, 8, 2, 8), (8, 257, 2, 8), (8, 8, 65, 8),
                           (8, 8, 2, 513), (8, 8, 0, 8)):
        with pytest.raises(ValueError, match="L <= 64"):
            cuda_readout.check_shapes(d_m, A, L, d_q, "readout")
    cuda_readout.check_shapes(256, 256, 64, 512, "readout")


# The weight gradients' bits depend on how many partials each chunk's rows
# are summed in (each partial one fmaf chain per output) and, for
# K2-general, on the workspace chunk; the products' tiles do not enter.
# (d_in, d_m): K2-general's partials, K4-general's at B = 512, 33 and 509,
# and at T = 1000, B = 512 the chunks of K1-general, of K2-general in f32
# and bf16 and of K4-general in f32 and bf16: the wide xlong_hpmn's layers
# (128, 64) and (64, 64), taobao_dien's at mem_dim 64 (32, 64), the mem_dim
# 16 sweep's (32, 16) and (16, 16), and the card tests' and the A/B grid's.
PINNED_PARTIALS = [
    ((128, 64), 28, (32, 33, 1), (170, 51, 64, 32, 48)),
    ((64, 64), 42, (64, 33, 1), (170, 51, 64, 32, 48)),
    ((32, 64), 64, (64, 33, 1), (170, 51, 64, 32, 48)),
    ((32, 16), 64, (64, 33, 1), (682, 204, 256, 176, 240)),
    ((16, 16), 64, (64, 33, 1), (682, 204, 256, 176, 240)),
    ((1, 1), 64, (64, 33, 1), (1000, 1000, 1000, 1008, 1008)),
    ((40, 48), 64, (64, 33, 1), (227, 68, 85, 48, 80)),
    ((129, 43), 28, (32, 33, 1), (254, 76, 95, 64, 80)),
    ((127, 43), 42, (64, 33, 1), (254, 76, 95, 64, 80)),
    ((128, 128), 14, (16, 33, 1), (85, 25, 32, 16, 16)),
    ((512, 256), 2, (2, 3, 1), (42, 12, 16, 16, 16)),
    ((512, 43), 9, (16, 11, 1), (254, 76, 95, 64, 80)),
]


@pytest.mark.parametrize("shape,splits,stride_splits,chunks",
                         PINNED_PARTIALS)
def test_general_partials_and_chunks_are_pinned(shape, splits,
                                                stride_splits, chunks):
    d_in, d_m = shape
    assert cuda_gru.gen_splits(d_in, d_m) == splits
    assert tuple(cuda_gru_stride.gen_splits(B_, d_in, d_m)
                 for B_ in (512, 33, 509)) == stride_splits
    assert (cuda_gru.workspace_steps(1000, 512, d_m),
            *(cuda_gru.gen_bwd_workspace_steps(1000, 512, d_m, dt)
              for dt in (torch.float32, BF16)),
            *(cuda_gru_stride.bwd_workspace_steps(1000, 512, dt, 16, d_m,
                                                  d_in)
              for dt in (torch.float32, BF16))) == chunks
