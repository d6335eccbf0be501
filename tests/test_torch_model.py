"""The port's configs, data, parameter conversion, HPMN encoders and forward
against the JAX package on the CPU. JAX parameters reach the port through
``hpmn_tpu_torch.convert``; inputs are drawn with numpy from a seed.
Tolerances: encoders atol = rtol = 1e-5 in f32; logits atol = rtol = 1e-4
(a tower of three products over the memory's 1e-5). With the bf16 scan
chain (``scan_dtype="bfloat16"``) the memory is held at 2e-2 abs, the bf16
scans' tolerance in tests/test_torch_bf16.py, and the logits at 5e-2 abs
(the tower's products over that memory)."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.configs import get_config as j_get_config
from hpmn_tpu.data import synthetic as j_synthetic
from hpmn_tpu.data.schema import batch_from_numpy as j_batch_from_numpy
from hpmn_tpu.models import apply_model as j_apply_model
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.models.hpmn import encode_oracle as j_encode_oracle
from hpmn_tpu.models.hpmn import init_hpmn as j_init_hpmn
from hpmn_tpu.serving.lifelong import flatten_with_keys
from hpmn_tpu_torch import configs
from hpmn_tpu_torch.convert import jax_key, model_from_flat
from hpmn_tpu_torch.data import synthetic
from hpmn_tpu_torch.data.schema import batch_from_numpy
from hpmn_tpu_torch.models.hpmn import (HPMNEncoder, encode_hierarchical,
                                        encode_hierarchical_tm, encode_oracle)
from hpmn_tpu_torch.models.model import apply_model, init_model
from hpmn_tpu_torch.ops import cuda_gru
from hpmn_tpu_torch.serving.lifelong import UserMemoryStore

ENC_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ENC_TOL = dict(atol=2e-2, rtol=0)
BF16_LOGIT_TOL = dict(atol=5e-2, rtol=0)
N_ITEMS, N_CATS = 200, 20
SMALL = synthetic.DatasetSpec("small", seq_len=29, n_items=N_ITEMS,
                              n_cats=N_CATS, n_users=50)


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


def _flat(params):
    keys, leaves, _ = flatten_with_keys(params)
    return {k: np.asarray(v) for k, v in zip(keys, leaves)}


def _encoder_pair(d_in, d_m, L, seed):
    """A JAX HPMN encoder and the port's, holding the same weights."""
    jp = j_init_hpmn(jax.random.key(seed), d_in, d_m, L)
    enc = HPMNEncoder(d_in, d_m, L).requires_grad_(False)
    for l, layer in enumerate(jp["layers"]):
        for f in ("wx", "wh", "b"):
            getattr(enc.layers[l], f).copy_(torch.from_numpy(
                np.array(getattr(layer, f))))
    return jp, enc


def _inputs(rng, B, T, d_in):
    x = rng.standard_normal((B, T, d_in)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    mask = (np.arange(T)[None, :] >= T - lens[:, None]).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("name", configs.list_configs())
def test_configs_match_jax(name):
    mine, theirs = configs.get_config(name), j_get_config(name)
    assert mine.seed == theirs.seed and mine.dataset == theirs.dataset
    for part in ("model", "loss", "train"):
        for f in dataclasses.fields(getattr(mine, part)):
            assert (getattr(getattr(mine, part), f.name)
                    == getattr(getattr(theirs, part), f.name)), \
                f"{part}.{f.name}"


@pytest.mark.parametrize("spec_name,n,min_len_frac", [
    ("amazon", 3, 0.5), ("taobao", 2, 0.5), ("xlong", 2, 1.0),
    ("small", 40, 0.5)])
def test_make_ctr_dataset_matches_jax(spec_name, n, min_len_frac):
    spec = SMALL if spec_name == "small" else synthetic.SPECS[spec_name]
    j_spec = j_synthetic.DatasetSpec(*dataclasses.astuple(spec))
    mine = synthetic.make_ctr_dataset(spec, n, seed=11,
                                      min_len_frac=min_len_frac)
    theirs = j_synthetic.make_ctr_dataset(j_spec, n, seed=11,
                                          min_len_frac=min_len_frac)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("T,L,period", [
    (17, 3, 2), (10, 3, 3), (29, 2, 3), (5, 4, 2)])  # (5, 4, 2): top layer
def test_encode_oracle_matches_jax(T, L, period):       # never fires
    rng = np.random.default_rng(T * 7 + L)
    d_in, d_m, B = 6, 5, 4
    jp, enc = _encoder_pair(d_in, d_m, L, seed=T)
    x, mask = _inputs(rng, B, T, d_in)
    want = j_encode_oracle(jp, jnp.asarray(x), jnp.asarray(mask), period)
    got = encode_oracle(enc, torch.from_numpy(x), torch.from_numpy(mask),
                        period)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    got_h = encode_hierarchical(enc, torch.from_numpy(x),
                                torch.from_numpy(mask), period)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want), **ENC_TOL)


@pytest.mark.parametrize("T,L,period,use_mask", [
    (17, 3, 2, True), (29, 3, 3, True), (29, 3, 3, False), (5, 4, 2, True)])
def test_encode_hierarchical_tm_matches_jax_oracle(T, L, period, use_mask):
    """The time-major hierarchy through the scan kernel's wrapper (its
    plain version on CPU tensors) == the JAX oracle, T not divisible by
    period**l, and zero slots for layers that never fire."""
    rng = np.random.default_rng(T + L)
    d_in, d_m, B = 6, 5, 3
    jp, enc = _encoder_pair(d_in, d_m, L, seed=T + 1)
    x, mask = _inputs(rng, B, T, d_in)
    if not use_mask:
        mask = np.ones_like(mask)
    want = j_encode_oracle(jp, jnp.asarray(x), jnp.asarray(mask), period)
    x_tm = torch.from_numpy(x).transpose(0, 1).contiguous()
    mask_tm = torch.from_numpy(mask).T.contiguous() if use_mask else None
    got = encode_hierarchical_tm(enc, x_tm, mask_tm, period,
                                 gru_seq_tm_fn=cuda_gru.gru_sequence_tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    if period ** (L - 1) > T:
        assert not got[:, -1].any()


def _apply_model_against_jax(use_pallas, hierarchical, full_mask,
                             scan_dtype, enc_tol, logit_tol):
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
    params = j_init_model(jax.random.key(5), j_cfg, N_ITEMS, N_CATS)
    model = model_from_flat(cfg, _flat(params),
                            device="cpu").requires_grad_(False)
    data = synthetic.make_ctr_dataset(
        SMALL, 6, seed=5, min_len_frac=1.0 if full_mask else 0.5)
    want, want_aux = j_apply_model(params, j_cfg, j_batch_from_numpy(data))
    got, aux = apply_model(model, cfg, batch_from_numpy(data, device="cpu"))
    assert got.shape == (6,)
    assert aux["memory"].dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **logit_tol)
    np.testing.assert_allclose(aux["memory"].numpy(),
                               np.asarray(want_aux["memory"]), **enc_tol)


@pytest.mark.parametrize("use_pallas,hierarchical,full_mask", [
    (True, True, False), (True, True, True), (False, True, False),
    (False, False, False)])
def test_apply_model_matches_jax(interpret, use_pallas, hierarchical,
                                 full_mask):
    _apply_model_against_jax(use_pallas, hierarchical, full_mask, "float32",
                             ENC_TOL, LOGIT_TOL)


@pytest.mark.parametrize("full_mask", [False, True])
def test_apply_model_bf16_matches_jax(interpret, full_mask):
    """scan_dtype="bfloat16" on the use_pallas path: the scans in the bf16
    chain, the memory back in f32 for the readout (JAX apply_model)."""
    _apply_model_against_jax(True, True, full_mask, "bfloat16",
                             BF16_ENC_TOL, BF16_LOGIT_TOL)


def test_convert_consumes_every_key_and_fills_every_parameter():
    j_cfg = j_get_config("taobao_hpmn")
    cfg = configs.get_config("taobao_hpmn")
    flat = _flat(j_init_model(jax.random.key(6), j_cfg, N_ITEMS, N_CATS))
    model = model_from_flat(cfg, flat, device="cpu")
    assert {jax_key(n) for n, _ in model.named_parameters()} == set(flat)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[jax_key(name)])
    extra = dict(flat, **{"['encoder']['layers'][9].wx": np.zeros((1, 1))})
    with pytest.raises(KeyError, match="no parameter"):
        model_from_flat(cfg, extra, device="cpu")
    missing = {k: v for k, v in flat.items() if k != "['readout']['v']"}
    with pytest.raises(KeyError, match="no JAX array"):
        model_from_flat(cfg, missing, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        model_from_flat(cfg.with_model(hpmn_layers=3, mem_dim=8), flat,
                        device="cpu")


def test_init_model_is_seeded_and_shaped_like_jax():
    cfg = configs.get_config("xlong_hpmn")
    a = init_model(cfg, N_ITEMS, N_CATS, seed=3, device="cpu")
    b = init_model(cfg, N_ITEMS, N_CATS, seed=3, device="cpu")
    c = init_model(cfg, N_ITEMS, N_CATS, seed=4, device="cpu")
    j_flat = _flat(j_init_model(jax.random.key(0), j_get_config("xlong_hpmn"),
                                N_ITEMS, N_CATS))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb)
        assert tuple(pa.shape) == j_flat[jax_key(name)].shape
    assert not torch.equal(a.encoder.layers[0].wx, c.encoder.layers[0].wx)


@pytest.mark.parametrize("change", [
    dict(scan_dtype="float16"), dict(dtype="float16")])
def test_unported_options_raise(change):
    """float16, which the JAX package takes, is not ported (bfloat16 is:
    tests/test_torch_dtype.py)."""
    cfg = configs.get_config("xlong_hpmn").with_model(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_model(cfg, N_ITEMS, N_CATS, device="cpu")


def test_unknown_family_raises():
    """Every JAX family builds; another name raises ValueError("unknown
    encoder ..."), as the JAX init_model does."""
    from hpmn_tpu.models import ENCODERS as J_ENCODERS
    from hpmn_tpu_torch.models.model import ENCODERS

    assert ENCODERS == J_ENCODERS
    cfg = configs.get_config("amazon_hpmn").with_model(name="transformer")
    with pytest.raises(ValueError, match="unknown encoder 'transformer'"):
        init_model(cfg, N_ITEMS, N_CATS, device="cpu")
    j_cfg = j_get_config("amazon_hpmn")
    j_cfg.model.name = "transformer"
    with pytest.raises(ValueError, match="unknown encoder"):
        j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS)


@pytest.mark.parametrize("entry", [init_model, model_from_flat,
                                   batch_from_numpy, UserMemoryStore])
def test_entry_points_default_to_the_card(entry):
    """The port runs on the card unless the caller asks for the CPU (the
    tests here pass device="cpu"); nothing falls back to the CPU."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"
