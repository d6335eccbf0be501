"""``model.dtype="bfloat16"`` on the kernel path and in the serving stores,
the port against the JAX package on the CPU. The kernel path (hpmn with
the hierarchy of scans and the readout kernel, f32 and bf16 scans, the
strided form; gru4rec; DIEN's two scans and the AUGRU): the Pallas
kernels in interpret mode, the port's CUDA wrappers on CPU tensors (their
plain versions), with JAX's casts at JAX's places. The stores:
``UserMemoryStore`` (hpmn, gru4rec, rum) and ``HistoryStore`` (dien plain
and use_pallas, dnn) event by event, predict and rank, and
``ingest_histories``, which raises where JAX's raises; a bf16 bundle in
JAX's file. Sizes and helpers are tests/test_torch_dtype.py's.

Tolerances (measured worst in brackets):
- the kernel path's loss rtol 1e-6 (3.3e-7), every gradient within 3e-2
  of its norm (1.30e-2, DIEN's ``attn.b`` with bf16 scans) and the update
  of three Adam steps within 0.15 of its norm (0.103, hpmn's with bf16
  scans): the kernels take float32 or the scan dtype, as on the TPU, so
  the loss is float32 and only the bf16 parameters' gradients and
  updates round;
- the stores' scores: hpmn and gru4rec 1e-6 (1.8e-7: f32 memory, and
  the bf16 weights promoted to f32 at each product, as in JAX); rum's
  memory 5e-3 (1.6e-3: its write runs in bf16 and reads an f32 memory)
  and its scores 1e-4 (6.5e-5); HistoryStore's plain bf16 scores 2^-7,
  two bf16 ulps of a score in [0.5, 1) (one ulp, 3.9e-3, measured); with
  use_pallas 1e-6 (0: float32 past the scans).
"""

import os

import jax
import numpy as np
import pytest
import torch

import hpmn_tpu.ops.pallas_gru as pg
import hpmn_tpu.ops.pallas_readout as pr
from hpmn_tpu.models import init_model as j_init_model
from hpmn_tpu.serving.history import HistoryStore as JHistoryStore
from hpmn_tpu.serving.lifelong import UserMemoryStore as JUserMemoryStore
from hpmn_tpu_torch.convert import model_from_flat
from hpmn_tpu_torch.serving.history import HistoryStore
from hpmn_tpu_torch.serving.lifelong import UserMemoryStore

from test_torch_dtype import (N_CATS, N_ITEMS, N_USERS, bf16_configs,
                              check_against_jax, flat)

LOSS_RTOL = 1e-6
GRAD_TOL = 3e-2
UPDATE_TOL = 0.15
KERNELS = {
    "hpmn": ("hpmn", {"use_pallas": True}),
    "hpmn_bf16_scans": ("hpmn", {"use_pallas": True,
                                 "scan_dtype": "bfloat16",
                                 "assume_full_mask": True}),
    "hpmn_strided": ("hpmn", {"use_pallas": True, "assume_full_mask": True,
                              "pallas_stride_outputs": True}),
    "gru4rec": ("gru4rec", {"use_pallas": True}),
    "dien": ("dien", {"use_pallas": True}),
    "dien_bf16_scans": ("dien", {"use_pallas": True,
                                 "scan_dtype": "bfloat16",
                                 "assume_full_mask": True})}


@pytest.fixture
def interpret():
    pg._INTERPRET = pr._INTERPRET = True
    try:
        yield
    finally:
        pg._INTERPRET = pr._INTERPRET = False


@pytest.mark.parametrize("setting", list(KERNELS))
def test_bf16_kernel_path_matches_jax(interpret, setting):
    family, opts = KERNELS[setting]
    check_against_jax(family, opts, LOSS_RTOL, GRAD_TOL, UPDATE_TOL)


B, T, C = 8, 12, 5
# (store kind, family, model options, score tolerance)
STORES = {
    "hpmn": ("memory", "hpmn", {}, 1e-6),
    "hpmn_use_pallas": ("memory", "hpmn", {"use_pallas": True}, 1e-6),
    "gru4rec": ("memory", "gru4rec", {}, 1e-6),
    "rum": ("memory", "rum", {}, 1e-4),
    "dien": ("history", "dien", {}, 2.0 ** -7),
    "dien_use_pallas": ("history", "dien", {"use_pallas": True}, 1e-6),
    "dnn": ("history", "dnn", {}, 2.0 ** -7)}
RUM_MEMORY_TOL = 5e-3


@pytest.mark.parametrize("setting", list(STORES))
def test_bf16_store_matches_jax(interpret, setting):
    """B users' T events one at a time, then predict and rank (C
    candidates) against JAX's store on the same bf16 weights (the memory
    too where it is one); ``ingest_histories`` raises TypeError where
    JAX's does (hpmn and gru4rec: the JAX scan's carry changes dtype),
    else the ingested users score as JAX's."""
    kind, family, opts, tol = STORES[setting]
    j_cfg, cfg = bf16_configs(family, **opts)
    params = j_init_model(jax.random.key(0), j_cfg, N_ITEMS, N_CATS,
                          n_users=N_USERS)
    model = model_from_flat(cfg, flat(params), device="cpu")
    if kind == "memory":
        want, got = (JUserMemoryStore(j_cfg, params),
                     UserMemoryStore(cfg, model, device="cpu"))
    else:
        want, got = (JHistoryStore(j_cfg, params, window=T),
                     HistoryStore(cfg, model, window=T, device="cpu"))
    rng = np.random.default_rng(1)
    items = rng.integers(1, N_ITEMS, (B, T)).astype(np.int32)
    cats = rng.integers(1, N_CATS, (B, T)).astype(np.int32)
    cand_i = rng.integers(1, N_ITEMS, (B, C)).astype(np.int32)
    cand_c = rng.integers(1, N_CATS, (B, C)).astype(np.int32)
    uids = np.arange(B)
    for t in range(T):
        for store in (want, got):
            store.update(uids, items[:, t], cats[:, t])
    if kind == "memory":
        mem_tol = RUM_MEMORY_TOL if family == "rum" else 1e-6
        np.testing.assert_allclose(got._gather(uids)[0].numpy(),
                                   np.asarray(want._gather(uids)[0]),
                                   rtol=0, atol=mem_tol)

    def same_scores(a, b):
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=0,
                                   atol=tol)

    same_scores(want.predict(uids, cand_i[:, 0], cand_c[:, 0]),
                got.predict(uids, cand_i[:, 0], cand_c[:, 0]))
    same_scores(want.rank(uids, cand_i, cand_c),
                got.rank(uids, cand_i, cand_c))
    fresh = uids + 100
    if family in ("hpmn", "gru4rec"):
        with pytest.raises(TypeError):
            want.ingest_histories(fresh, items, cats)
        with pytest.raises(TypeError, match="ingest_histories"):
            got.ingest_histories(fresh, items, cats)
        return
    for store in (want, got):
        store.ingest_histories(fresh, items, cats)
    same_scores(want.predict(fresh, cand_i[:, 0], cand_c[:, 0]),
                got.predict(fresh, cand_i[:, 0], cand_c[:, 0]))


@pytest.mark.parametrize("quantize", [False, True])
def test_bf16_bundle_is_jax_file(tmp_path, quantize):
    """A bf16 hpmn store's bundle: the port's params.npz holds JAX's
    arrays byte for byte (bf16 as the ``|V2`` bytes JAX's ``np.savez``
    writes; int8 tables and their f32 scales from the bf16 values in f32
    arithmetic, as JAX's ``ml_dtypes`` promotes them), and the port loads JAX's bundle
    into the same bf16 weights and scores. (JAX's own loader raises
    TypeError on a bf16 bundle, ``|V2`` not being a JAX dtype; ROADMAP.md
    §3.)"""
    j_cfg, cfg = bf16_configs("hpmn")
    params = j_init_model(jax.random.key(3), j_cfg, N_ITEMS, N_CATS)
    model = model_from_flat(cfg, flat(params), device="cpu")
    want = JUserMemoryStore(j_cfg, params)
    got = UserMemoryStore(cfg, model, device="cpu")
    uids = np.arange(4)
    for store in (want, got):
        store.update(uids, np.arange(1, 5), np.arange(1, 5))
    want.save_bundle(str(tmp_path / "jax"), quantize_embeddings=quantize)
    got.save_bundle(str(tmp_path / "port"), quantize_embeddings=quantize)
    with np.load(tmp_path / "jax" / "params.npz") as a, \
            np.load(tmp_path / "port" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    loaded = UserMemoryStore.load_bundle(str(tmp_path / "jax"),
                                         device="cpu")
    if not quantize:
        for (name, p), q in zip(model.named_parameters(),
                                loaded.model.parameters()):
            assert q.dtype == torch.bfloat16 and torch.equal(p, q), name
    np.testing.assert_allclose(
        loaded.predict(uids, np.arange(5, 9), np.arange(5, 9)),
        np.asarray(want.predict(uids, np.arange(5, 9), np.arange(5, 9)),
                   np.float32), rtol=0, atol=1e-6 if not quantize else 0.03)
    assert os.path.exists(tmp_path / "port" / "serving_config.json")
