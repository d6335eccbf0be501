"""Every model family of the JAX package and its loss — counterpart of
``hpmn_tpu/models/model.py``: ``cfg.model.name`` in :data:`ENCODERS`.

    model = init_model(cfg, n_items, n_cats)             # on the card
    logits, aux = apply_model(model, cfg, batch)
    loss, metrics = loss_fn(model, cfg, batch)           # differentiable

``apply_model`` has the JAX function's three hpmn branches:

- ``use_pallas`` (with the hierarchical scan): embeddings gathered straight
  into time-major [T, B, 2d], the hierarchy of scans through the CUDA scan
  kernels (forward K1, backward K2; with ``scan_dtype="bfloat16"`` their
  bf16 chain, K1-bf16 and K2-bf16) and the readout through the CUDA
  readout kernel (on CPU tensors, their plain versions). With full
  sequences (``assume_full_mask``), ``pallas_stride_outputs`` and a period
  above 1, the scans are the strided-output kernels instead (K3 and K4, or
  K3-bf16 and K4-bf16), as in JAX;
- the batch-major hierarchy of plain scans;
- the masked single-scan oracle (``use_hierarchical_scan=False``).

the JAX function's two dien branches: with ``use_pallas`` the
time-major ``dien.encode_tm``, both scans through the CUDA scan kernels
(``gru1``: K1 and K2; the AUGRU: K1-scale and K2-scale; or their bf16
forms), the negatives gathered time-major too; otherwise the batch-major
plain ``dien.encode``. DIEN has no readout and returns aux["aux_loss"],
which ``total_loss`` weighs by ``aux_weight``.

its gru4rec and rum branches: gru4rec with ``use_pallas`` runs its GRU
time-major through the CUDA scan kernels (K1 forward, K2 backward, or
their bf16 forms), otherwise the batch-major plain ``gru4rec.encode``; rum
is plain tensor ops in either case (``rum.encode``), as in JAX. Neither
has a readout or an aux output: the tower reads [target embedding; state].

and its last branch, the six families of ``extra_baselines.py`` (dnn,
lstm, caser, shan, svdpp, bst): plain tensor ops whatever
``use_pallas`` says, as JAX computes them in no Pallas kernel; SVD++ reads
``batch.uid``. No aux output.

With ``use_user_emb`` every family's tower reads the user table's row of
``batch.uid`` after [target embedding; state], as in JAX.

``model.dtype`` (float32 or bfloat16) is the parameters' dtype, and the
plain paths compute in it. The use_pallas branches cast at JAX's places:
x, the mask, the scale and the weights to ``scan_dtype`` at each scan
(differentiably, so the gradients come back in the parameters' dtype),
the memory and the states back to float32, and the readout's six
operands to float32 (``cuda_readout.fused_attention_readout``); the tower
and DIEN's attention then meet float32 operands and bf16 weights, whose
products run in float32 (``dtypes.matmul``, JAX's promotion).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import Config
from ..data.schema import Batch
from ..ops import cuda_gru, cuda_gru_stride, cuda_readout
from ..ops.gru import (GRUWeights, gru_scan_stride_tm, gru_scan_stride_tm_bf16,
                       gru_scan_tm, gru_scan_tm_bf16)
from . import dien as dien_mod
from . import extra_baselines
from . import gru4rec as gru4rec_mod
from . import hpmn as hpmn_mod
from . import rum as rum_mod
from .dtypes import DTYPES
from .embedding import Embedding, dense_lookup, user_lookup
from .losses import bce_with_logits, covariance_regularizer, l2_regularizer
from .readout import Readout, attention_readout
from .tower import Tower, apply_tower


ENCODERS = ("hpmn", "gru4rec", "dien", "rum", "dnn", "lstm", "caser", "shan",
            "svdpp", "bst")


def _embedding(cfg: Config, n_items: int, n_cats: int,
               n_users: int) -> Embedding:
    """The tables of every family; the user table with use_user_emb."""
    m = cfg.model
    return Embedding(n_items, n_cats, m.emb_dim,
                     n_users if m.use_user_emb else 0)


def _tower(cfg: Config, d_state: int) -> Tower:
    """The tower of every family, over [target embedding (2 emb_dim);
    state (d_state)] and with use_user_emb the user embedding (emb_dim)."""
    m = cfg.model
    d_in = 2 * m.emb_dim + d_state + (m.emb_dim if m.use_user_emb else 0)
    return Tower(d_in, m.tower_hidden)


class HPMNModel(nn.Module):
    """embedding, encoder, readout and tower, each in the JAX layout (see
    ``convert.py`` for the parameter names on both sides)."""

    def __init__(self, cfg: Config, n_items: int, n_cats: int,
                 n_users: int = 0):
        super().__init__()
        m = cfg.model
        d_beh = 2 * m.emb_dim
        self.embedding = _embedding(cfg, n_items, n_cats, n_users)
        self.encoder = hpmn_mod.HPMNEncoder(d_beh, m.mem_dim, m.hpmn_layers)
        self.readout = Readout(m.mem_dim, d_beh, m.readout_dim)
        self.tower = _tower(cfg, m.mem_dim)


class DIENModel(nn.Module):
    """embedding, encoder (``dien.DIENEncoder``) and tower; no readout: the
    tower reads [target embedding; the evolved interest]."""

    def __init__(self, cfg: Config, n_items: int, n_cats: int,
                 n_users: int = 0):
        super().__init__()
        m = cfg.model
        d_beh = 2 * m.emb_dim
        self.embedding = _embedding(cfg, n_items, n_cats, n_users)
        self.encoder = dien_mod.DIENEncoder(d_beh, m.mem_dim, m.readout_dim)
        self.tower = _tower(cfg, m.mem_dim)


class GRU4RecModel(nn.Module):
    """embedding, encoder (``gru4rec.GRU4RecEncoder``) and tower; no
    readout: the tower reads [target embedding; the GRU's final state]."""

    def __init__(self, cfg: Config, n_items: int, n_cats: int,
                 n_users: int = 0):
        super().__init__()
        m = cfg.model
        d_beh = 2 * m.emb_dim
        self.embedding = _embedding(cfg, n_items, n_cats, n_users)
        self.encoder = gru4rec_mod.GRU4RecEncoder(d_beh, m.mem_dim)
        self.tower = _tower(cfg, m.mem_dim)


class RUMModel(nn.Module):
    """embedding, encoder (``rum.RUMEncoder``, ``rum_slots`` slots) and
    tower; no readout: the tower reads [target embedding; the memory's
    read]."""

    def __init__(self, cfg: Config, n_items: int, n_cats: int,
                 n_users: int = 0):
        super().__init__()
        m = cfg.model
        d_beh = 2 * m.emb_dim
        self.embedding = _embedding(cfg, n_items, n_cats, n_users)
        self.encoder = rum_mod.RUMEncoder(d_beh, m.mem_dim, m.rum_slots)
        self.tower = _tower(cfg, m.mem_dim)


class ExtraBaselineModel(nn.Module):
    """embedding, encoder (``extra_baselines.build_encoder`` of the
    family: dnn, lstm, caser, shan, svdpp or bst) and tower over [target
    embedding; the family's state]. SVD++'s user factors are the
    encoder's ``p_u`` [n_users, 2 emb_dim], apart from the
    ``use_user_emb`` table, as in JAX."""

    def __init__(self, cfg: Config, n_items: int, n_cats: int,
                 n_users: int = 0):
        super().__init__()
        m = cfg.model
        self.embedding = _embedding(cfg, n_items, n_cats, n_users)
        self.encoder, d_state = extra_baselines.build_encoder(
            m.name, cfg, 2 * m.emb_dim, n_users)
        self.tower = _tower(cfg, d_state)


_MODELS = {"hpmn": HPMNModel, "dien": DIENModel, "gru4rec": GRU4RecModel,
           "rum": RUMModel,
           **{f: ExtraBaselineModel for f in extra_baselines.FAMILIES}}


def model_n_users(model: nn.Module) -> int:
    """The users a model has rows for: its user table's (use_user_emb) or
    SVD++'s ``p_u``'s; 0 without either."""
    if model.embedding.user is not None:
        return model.embedding.user.shape[0]
    p_u = getattr(model.encoder, "p_u", None)
    return 0 if p_u is None else p_u.shape[0]


def check_supported(cfg: Config) -> None:
    """Raise on config choices the port does not cover: an unknown family
    (ValueError, as JAX), or an option not ported yet."""
    m = cfg.model
    if m.name not in _MODELS:
        raise ValueError(f"unknown encoder {m.name!r}")
    todo = {"dtype": m.dtype not in DTYPES,
            "scan_dtype": m.scan_dtype not in DTYPES}
    for field, unsupported in todo.items():
        if unsupported:
            raise NotImplementedError(
                f"model.{field}={getattr(m, field)!r} is not ported yet "
                "(ROADMAP.md)")


def build_model(cfg: Config, n_items: int, n_cats: int,
                n_users: int = 0) -> nn.Module:
    """The model class of ``cfg.model.name`` (``HPMNModel``, ``DIENModel``,
    ``GRU4RecModel``, ``RUMModel`` or ``ExtraBaselineModel``), its
    parameters allocated on the CPU, not initialised. With
    ``use_user_emb`` it has a user table of ``n_users`` rows (the
    dataset's user vocab), and svdpp has ``p_u`` of as many; either raises
    when ``n_users`` is not positive, as the JAX ``init_model`` does;
    otherwise ``n_users`` is ignored."""
    check_supported(cfg)
    if cfg.model.use_user_emb and n_users <= 0:
        raise ValueError("use_user_emb needs n_users > 0 passed to "
                         "init_model (the dataset spec's user-vocab size)")
    return _MODELS[cfg.model.name](cfg, n_items, n_cats, n_users)


def init_model(cfg: Config, n_items: int, n_cats: int,
               seed: Optional[int] = None, device="cuda",
               n_users: int = 0) -> nn.Module:
    """The port's own seeded init, drawn in float32 on the CPU from a
    ``torch.Generator`` (so the weights do not depend on the device), then
    cast to ``model.dtype`` and moved to ``device``. Same distributions as
    the JAX init, other numbers (JAX draws a bf16 model's weights in bf16;
    here a bf16 weight is the rounding of the f32 draw); the parts are
    drawn in their order in the model (embedding, encoder, readout where
    there is one, tower). ``n_users`` as for :func:`build_model`."""
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model = build_model(cfg, n_items, n_cats, n_users)
    for part in model.children():
        part.reset_parameters(gen)
    return model.to(device=device, dtype=DTYPES[cfg.model.dtype])


def _scan_weights(enc: hpmn_mod.HPMNEncoder, dtype: torch.dtype):
    """The encoder's layers with their weights cast to the scan's dtype
    where theirs differs, differentiably (autograd carries the gradients
    back to the parameters' dtype, as the VJP of the JAX ``astype``
    does)."""
    if enc.layers[0].wx.dtype == dtype:
        return enc
    return SimpleNamespace(layers=[
        GRUWeights(layer.wx.to(dtype), layer.wh.to(dtype), layer.b.to(dtype))
        for layer in enc.layers])


def _tm_scan(dtype: torch.dtype, plain: bool):
    """The use_pallas scan of DIEN and GRU4Rec: (params, x_tm, mask_tm,
    scale_tm=None) -> (h_seq, h_T) in ``dtype``. x, the mask, the scale
    and the weights are cast to it here, differentiably (as
    ``pallas_gru_sequence_tm`` casts them inside); then the CUDA scan
    (``cuda_gru.gru_sequence_tm``) or, with ``plain``, its plain version
    under autograd."""
    plain_scan = gru_scan_tm_bf16 if dtype == torch.bfloat16 else gru_scan_tm

    def scan(p, x_tm, mask_tm, scale_tm=None):
        w = GRUWeights(p.wx.to(dtype), p.wh.to(dtype), p.b.to(dtype))
        m = None if mask_tm is None else mask_tm.to(dtype)
        a = None if scale_tm is None else scale_tm.to(dtype)
        if plain:
            return plain_scan(w, x_tm.to(dtype), m, None, a)
        return cuda_gru.gru_sequence_tm(w, x_tm.to(dtype), m, scale_tm=a)

    return scan


def _apply_dien(model: DIENModel, cfg: Config, batch: Batch,
                q: torch.Tensor, plain: bool, lookup=dense_lookup,
                gru_seq_fn=None):
    """DIEN's two branches of the JAX apply_model -> (state [B, d_m]
    float32, the aux loss). The negatives feed only the aux loss, so
    without it they are not gathered: JAX's jit drops that dead work,
    eager PyTorch would run it."""
    m = cfg.model
    emb = model.embedding
    aux_on = m.dien_use_aux_loss
    if m.use_pallas:
        x_tm = lookup(emb, batch.item_seq.T, batch.cat_seq.T)
        x_neg_tm = (lookup(emb, batch.neg_item_seq.T,
                                 batch.neg_cat_seq.T) if aux_on else None)
        mask_tm = (None if m.assume_full_mask
                   else batch.seq_mask.T.to(x_tm.dtype).contiguous())
        state, aux_loss = dien_mod.encode_tm(
            model.encoder, x_tm, mask_tm, q, x_neg_tm, aux_on,
            gru_seq_tm_fn=_tm_scan(DTYPES[m.scan_dtype], plain))
        return state.float(), aux_loss
    x = lookup(emb, batch.item_seq, batch.cat_seq)  # [B, T, 2d]
    x_neg = (lookup(emb, batch.neg_item_seq, batch.neg_cat_seq)
             if aux_on else None)
    return dien_mod.encode(model.encoder, x, batch.seq_mask.to(x.dtype), q,
                           x_neg=x_neg, use_aux_loss=aux_on,
                           gru_seq_fn=gru_seq_fn)


def _apply_baseline(model: nn.Module, cfg: Config, batch: Batch,
                    q: torch.Tensor, plain: bool, lookup=dense_lookup,
                    gru_seq_fn=None) -> torch.Tensor:
    """The gru4rec, rum and extra_baselines branches of the JAX
    apply_model -> the state [B, d_state] (float32) the tower reads beside
    q."""
    m = cfg.model
    emb = model.embedding
    if m.name == "gru4rec" and m.use_pallas:
        x_tm = lookup(emb, batch.item_seq.T, batch.cat_seq.T)
        mask_tm = (None if m.assume_full_mask
                   else batch.seq_mask.T.to(x_tm.dtype).contiguous())
        scan = _tm_scan(DTYPES[m.scan_dtype], plain)
        _, state = scan(model.encoder.gru, x_tm, mask_tm)
        return state.float()
    x = lookup(emb, batch.item_seq, batch.cat_seq)  # [B, T, 2d]
    mask = batch.seq_mask.to(x.dtype)
    if m.name == "gru4rec":
        return gru4rec_mod.encode(model.encoder, x, mask,
                                  gru_seq_fn=gru_seq_fn)
    if m.name == "rum":
        return rum_mod.encode(model.encoder, x, mask, q)
    return extra_baselines.encode(model.encoder, m.name, cfg, x, mask, q,
                                  uid=batch.uid)


def _logits(model: nn.Module, cfg: Config, batch: Batch, q: torch.Tensor,
            state: torch.Tensor, lookup=dense_lookup) -> torch.Tensor:
    """The tower over [q; state], with use_user_emb [q; state; the user
    embedding of batch.uid] (the JAX apply_model's tower_in), the user
    rows through ``lookup.user`` where the lookup has one."""
    parts = [q, state]
    if cfg.model.use_user_emb:
        user = getattr(lookup, "user", user_lookup)
        parts.append(user(model.embedding, batch.uid))
    return apply_tower(model.tower, torch.cat(parts, dim=-1))


def _resolve_gru_seq_fn(cfg: Config, gru_seq_fn):
    """The batch-major branches' scan, as the JAX ``_resolve_gru_seq_fn``:
    the one given, else the plain scan (None), or with ``use_pallas`` the
    CUDA scan kernels' batch-major wrapper (``cuda_gru.gru_sequence``).
    The families that take the time-major ``use_pallas`` branch never
    read it, there as in JAX."""
    if gru_seq_fn is not None or not cfg.model.use_pallas:
        return gru_seq_fn
    return lambda p, xs, m, a=None: cuda_gru.gru_sequence(  # noqa: E731
        p, xs, mask=m, gate_scale=a)


def apply_model(model: nn.Module, cfg: Config, batch: Batch,
                plain: bool = False, lookup=None, gru_seq_fn=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (logits [B], aux): for hpmn aux["memory"] is the slots [B, L,
    d_m] (float32) that the covariance regularizer reads; for dien
    aux["aux_loss"] is the auxiliary loss; the other families return no
    aux.

    ``plain=True`` runs the ``use_pallas`` branch with the kernels' plain
    versions under autograd (``gru_scan_tm`` or ``gru_scan_tm_bf16``, with
    the scale for DIEN's AUGRU, the strided ``gru_scan_stride_tm``/``_bf16``,
    the plain readout; GRU4Rec's scan likewise) on any device: the
    reference that chip_smoke.py holds the kernel path to on the card.

    ``lookup`` (JAX's ``lookup_fn``) replaces ``dense_lookup`` at every
    gather, and its ``.user`` replaces ``user_lookup``: the row-sharded
    lookups of ``parallel/embedding_sharding.py``. The flags a lookup
    appends to its ``overflow_sink`` come back as aux["a2a_overflow"]
    (float32, 1.0 iff any exchange of this call took the fallback).

    ``gru_seq_fn`` (JAX's): (params, x [B, T, d], mask [B, T],
    gate_scale=None) -> (h_seq, h_T), the scan of the batch-major branches
    (hpmn's hierarchy, gru4rec, both of DIEN's scans), for example the
    sequence-parallel scan (``parallel/seq_parallel.py``); the
    ``use_pallas`` time-major branches ignore it, as JAX's do."""
    check_supported(cfg)
    sink = getattr(lookup, "overflow_sink", None)
    if sink is not None:
        sink.clear()
    logits, aux = _apply(model, cfg, batch, plain, lookup or dense_lookup,
                         _resolve_gru_seq_fn(cfg, gru_seq_fn))
    if sink:
        aux["a2a_overflow"] = torch.stack(sink).max().float()
        sink.clear()
    return logits, aux


def _apply(model: nn.Module, cfg: Config, batch: Batch, plain: bool,
           lookup, gru_seq_fn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.model
    emb = model.embedding
    q = lookup(emb, batch.target_item, batch.target_cat)  # [B, 2d]
    if m.name == "dien":
        state, aux_loss = _apply_dien(model, cfg, batch, q, plain, lookup,
                                      gru_seq_fn)
        return (_logits(model, cfg, batch, q, state, lookup),
                {"aux_loss": aux_loss})
    if m.name != "hpmn":
        state = _apply_baseline(model, cfg, batch, q, plain, lookup,
                                gru_seq_fn)
        return _logits(model, cfg, batch, q, state, lookup), {}
    if m.use_pallas and m.use_hierarchical_scan:
        # Transposing the int32 ids, not the activations, gives time-major
        # embeddings. The scans run in scan_dtype: x, the mask and the
        # weights are cast to it here (pallas_gru_sequence_tm casts them
        # inside), and the memory comes back to float32 for the readout
        # and the covariance regularizer, as the JAX apply_model does.
        dtype = DTYPES[m.scan_dtype]
        x_tm = lookup(emb, batch.item_seq.T, batch.cat_seq.T)
        mask_tm = (None if m.assume_full_mask
                   else batch.seq_mask.T.to(dtype).contiguous())
        bf16 = dtype == torch.bfloat16
        enc = _scan_weights(model.encoder, dtype)
        readout = (cuda_readout.plain_attention_readout if plain
                   else cuda_readout.fused_attention_readout)
        if mask_tm is None and m.pallas_stride_outputs and m.hpmn_period > 1:
            if plain:
                stride = gru_scan_stride_tm_bf16 if bf16 else gru_scan_stride_tm
            else:
                stride = cuda_gru_stride.gru_stride_tm
            memory = hpmn_mod.encode_hierarchical_stride_tm(
                enc, x_tm.to(dtype), m.hpmn_period, stride_fn=stride)
        else:
            if plain:
                scan = gru_scan_tm_bf16 if bf16 else gru_scan_tm
            else:
                scan = cuda_gru.gru_sequence_tm
            memory = hpmn_mod.encode_hierarchical_tm(
                enc, x_tm.to(dtype), mask_tm, m.hpmn_period,
                gru_seq_tm_fn=scan)
        memory = memory.float()
        state = readout(model.readout, memory, q)
    else:
        x = lookup(emb, batch.item_seq, batch.cat_seq)  # [B, T, 2d]
        mask = batch.seq_mask.to(x.dtype)
        if m.use_hierarchical_scan:
            memory = hpmn_mod.encode_hierarchical(model.encoder, x, mask,
                                                  m.hpmn_period, gru_seq_fn)
        else:
            memory = hpmn_mod.encode_oracle(model.encoder, x, mask,
                                            m.hpmn_period)
        state = attention_readout(model.readout, memory, q)
    return _logits(model, cfg, batch, q, state, lookup), {"memory": memory}


def total_loss(model: nn.Module, cfg: Config, logits: torch.Tensor,
               aux: Dict[str, torch.Tensor], labels: torch.Tensor,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BCE + cov_weight * covariance regularizer (on aux["memory"]) +
    aux_weight * aux["aux_loss"] (DIEN) + l2_weight * sum of squares of
    every >= 2-D parameter."""
    bce = bce_with_logits(logits, labels)
    loss = bce
    metrics = {"bce": bce}
    if "memory" in aux and cfg.loss.cov_weight > 0:
        cov = covariance_regularizer(aux["memory"])
        loss = loss + cfg.loss.cov_weight * cov
        metrics["cov_reg"] = cov
    if "aux_loss" in aux and cfg.model.aux_weight > 0:
        loss = loss + cfg.model.aux_weight * aux["aux_loss"]
        metrics["aux_loss"] = aux["aux_loss"]
    if cfg.loss.l2_weight > 0:
        l2 = l2_regularizer(model.parameters())
        loss = loss + cfg.loss.l2_weight * l2
        metrics["l2"] = l2
    metrics["loss"] = loss
    return loss, metrics


def loss_fn(model: nn.Module, cfg: Config, batch: Batch,
            plain: bool = False, lookup=None, gru_seq_fn=None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One differentiable call: -> (loss, metrics with bce, cov_reg (hpmn)
    or aux_loss (dien), l2, loss, a2a_overflow (a sharded lookup's) and
    the logits). ``plain``, ``lookup`` and ``gru_seq_fn`` as for
    :func:`apply_model`."""
    logits, aux = apply_model(model, cfg, batch, plain=plain, lookup=lookup,
                              gru_seq_fn=gru_seq_fn)
    loss, metrics = total_loss(model, cfg, logits, aux,
                               batch.label.to(logits.dtype))
    if "a2a_overflow" in aux:
        metrics["a2a_overflow"] = aux["a2a_overflow"]
    metrics["logits"] = logits
    return loss, metrics
