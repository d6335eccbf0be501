"""The paper's remaining comparison models and BST — counterpart of
``hpmn_tpu/models/extra_baselines.py``: DNN, LSTM, Caser, SHAN, SVD++ and
the Behavior Sequence Transformer.

Each encoder maps (x [B, T, d_in], mask [B, T], q [B, d_in], uid [B]) to a
state [B, d_state] that the shared tower reads beside q:

- DNN: the masked mean of the behaviour embeddings (no parameters);
- LSTM: the final hidden state of an LSTM over the sequence (gates i, f,
  o, u; +1 on the forget gate's pre-activation; a masked step keeps h and
  c), d_state mem_dim;
- Caser: horizontal filters of windows 2, 3 and 4 (a VALID
  cross-correlation over time, ReLU, max over time) and vertical filters
  (weighted sums over time), d_state 3*caser_hfilters + caser_vfilters*d_in;
- SHAN: additive attention over the long-term sequence, then over [that
  read; the shan_recent newest events], both with the target as query;
- SVD++: [p_u[uid]; |N(u)|^-1/2 * sum of the behaviour embeddings],
  d_state 2*d_in;
- BST: the target appended to the sequence, learned positions added, then
  post-LN Transformer blocks (multi-head self-attention, LeakyReLU FFN);
  the state is the target position's output. The final block attends from
  the target position alone (exact: nothing after attention mixes
  positions); with ``bst_attn_chunk`` the inner blocks' attention is an
  online softmax over key chunks.

The JAX package computes all of them in jnp, in no Pallas kernel, so here
they are plain tensor ops that follow the JAX functions step by step (the
BST attention included: the same -1e9 key bias, the same chunking and
the same f32 statistics). Parameters keep the JAX layout and names, and
``reset_parameters`` draws the JAX init's distributions.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.synthetic import SPECS
from .embedding import gather_rows
from .readout import Readout, attention_readout

FAMILIES = ("dnn", "lstm", "caser", "shan", "svdpp", "bst")
_BST_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: torch.Generator) -> None:
    s = (6.0 / (fan_in + fan_out)) ** 0.5
    w.uniform_(-s, s, generator=generator)


# ----------------------------------------------------------------- DNN ----

class DNNEncoder(nn.Module):
    """No parameters (the JAX tree's encoder is ``{}``)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [B, T, d], mask [B, T] -> the mean of the valid steps [B, d] (0
    for an empty row)."""
    s = torch.einsum("btd,bt->bd", x, mask)
    return s / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)


# ---------------------------------------------------------------- LSTM ----

class LSTMEncoder(nn.Module):
    """wx [d_in, 4 d_m], wh [d_m, 4 d_m], b [4 d_m]; gates i, f, o, u."""

    def __init__(self, d_in: int, d_m: int):
        super().__init__()
        self.wx = nn.Parameter(torch.empty(d_in, 4 * d_m))
        self.wh = nn.Parameter(torch.empty(d_m, 4 * d_m))
        self.b = nn.Parameter(torch.empty(4 * d_m))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """wx uniform in +-sqrt(6 / (d_in + 4 d_m)), wh in
        +-sqrt(6 / (5 d_m)), b zero (as ``_lstm_init``)."""
        (d_in, d4), d_m = self.wx.shape, self.wh.shape[0]
        _glorot_(self.wx, d_in, d4, generator)
        _glorot_(self.wh, d_m, d4, generator)
        self.b.zero_()


def lstm_seq(enc: LSTMEncoder, x: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """x [B, T, d_in], mask [B, T] -> h_T [B, d_m]. The input projection
    of every step at once, then the masked recurrence."""
    B, T, _ = x.shape
    d_m = enc.wh.shape[0]
    xp = x @ enc.wx + enc.b
    h = x.new_zeros(B, d_m)
    c = x.new_zeros(B, d_m)
    for t in range(T):
        g = xp[:, t] + h @ enc.wh
        i = torch.sigmoid(g[:, :d_m])
        f = torch.sigmoid(g[:, d_m:2 * d_m] + 1.0)  # forget bias 1
        o = torch.sigmoid(g[:, 2 * d_m:3 * d_m])
        u = torch.tanh(g[:, 3 * d_m:])
        c_new = f * c + i * u
        h_new = o * torch.tanh(c_new)
        m = mask[:, t, None]
        h, c = m * h_new + (1 - m) * h, m * c_new + (1 - m) * c
    return h


# --------------------------------------------------------------- Caser ----

CASER_WINDOWS = (2, 3, 4)  # the horizontal filters' windows


class CaserEncoder(nn.Module):
    """hor: one [w, d_in, n_h] filter per window (JAX's TIO layout); vert
    [T_max, n_v], T_max the dataset's sequence length (sliced to the
    batch's T)."""

    def __init__(self, d_in: int, n_h: int, n_v: int, t_max: int):
        super().__init__()
        self.hor = nn.ParameterList(
            nn.Parameter(torch.empty(w, d_in, n_h)) for w in CASER_WINDOWS)
        self.vert = nn.Parameter(torch.empty(t_max, n_v))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each window's filter uniform in +-sqrt(6 / (w d_in + n_h)); vert
        normal with std T_max**-0.5 (as ``_caser_init``)."""
        for f in self.hor:
            w, d_in, n_h = f.shape
            _glorot_(f, w * d_in, n_h, generator)
        self.vert.normal_(0.0, self.vert.shape[0] ** -0.5,
                          generator=generator)


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN's f32 convolutions in f32, not TF32 (PyTorch lets cuDNN take
    TF32 by default), the flag restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv1dF32(torch.autograd.Function):
    """``F.conv1d`` on the card, forward and backward, with cuDNN's TF32
    off whatever the process's flag says (the backward runs after the
    forward's context has closed, so it sets the flag again)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _cudnn_without_tf32():
            return F.conv1d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _cudnn_without_tf32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv1d_input(x.shape, w, g)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv1d_weight(x, w.shape, g)
        return gx, gw


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Conv1dF32.apply(x, w) if x.is_cuda else F.conv1d(x, w)


def caser_encode(enc: CaserEncoder, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """-> [max over time of relu(conv_w) for w in 2, 3, 4; the vertical
    sums n-major, d minor]. ``F.conv1d`` is a cross-correlation, as
    ``lax.conv_general_dilated``; the TIO filter becomes [n_h, d_in, w].
    On the card it runs with cuDNN's TF32 off (``_Conv1dF32``): the
    model's f32 is f32 there too."""
    B, T, _ = x.shape
    xm = x * mask[:, :, None]
    xc = xm.transpose(1, 2)  # [B, d_in, T]
    outs = [torch.relu(_conv1d(xc, f.permute(2, 1, 0))).amax(dim=-1)
            for f in enc.hor]
    vert = torch.einsum("btd,tn->bnd", xm, enc.vert[:T]).reshape(B, -1)
    return torch.cat(outs + [vert], dim=-1)


# ---------------------------------------------------------------- SHAN ----

class SHANEncoder(nn.Module):
    """Two additive-attention readouts over the behaviours (d_in) with the
    target (d_in) as query: ``attn_long`` and ``attn_hybrid``."""

    def __init__(self, d_in: int, attn_dim: int):
        super().__init__()
        self.attn_long = Readout(d_in, d_in, attn_dim)
        self.attn_hybrid = Readout(d_in, d_in, attn_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn_long.reset_parameters(generator)
        self.attn_hybrid.reset_parameters(generator)


def shan_encode(enc: SHANEncoder, x: torch.Tensor, mask: torch.Tensor,
                q: torch.Tensor, recent: int = 10) -> torch.Tensor:
    """The long-term read over every valid step, then a read over [that
    read; the ``recent`` newest steps] (the long read always valid). Both
    through the plain readout with a slot mask, as in JAX (the CUDA
    readout kernel takes no mask)."""
    long_read = attention_readout(enc.attn_long, x, q, slot_mask=mask)
    recent_x = x[:, -recent:, :]
    recent_m = mask[:, -recent:]
    hybrid = torch.cat([long_read[:, None, :], recent_x], dim=1)
    hmask = torch.cat([torch.ones_like(recent_m[:, :1]), recent_m], dim=1)
    return attention_readout(enc.attn_hybrid, hybrid, q, slot_mask=hmask)


# --------------------------------------------------------------- SVD++ ----

class SVDppEncoder(nn.Module):
    """p_u [n_users, d_in]: the per-user latent factors (the implicit
    item factors are the behaviour embeddings)."""

    def __init__(self, n_users: int, d_in: int):
        super().__init__()
        self.p_u = nn.Parameter(torch.empty(n_users, d_in))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Normal with std d_in**-0.5 (as ``_svdpp_init``)."""
        self.p_u.normal_(0.0, self.p_u.shape[1] ** -0.5, generator=generator)


def svdpp_encode(enc: SVDppEncoder, x: torch.Tensor, mask: torch.Tensor,
                 uid: torch.Tensor) -> torch.Tensor:
    """-> [p_u[uid]; sum_t mask x_t / sqrt(max(sum mask, 1))] [B, 2 d_in].
    The row gather is ``embedding.gather_rows``, whose backward sums a
    repeated row's gradients in a fixed order."""
    implicit = torch.einsum("btd,bt->bd", x, mask)
    implicit = implicit * torch.rsqrt(
        torch.clamp(mask.sum(-1, keepdim=True), min=1.0))
    return torch.cat([gather_rows(enc.p_u, uid), implicit], dim=-1)


# ----------------------------------------------------------------- BST ----

class LayerNorm(nn.Module):
    """g [d] (ones), b [d] (zeros)."""

    def __init__(self, d: int):
        super().__init__()
        self.g = nn.Parameter(torch.empty(d))
        self.b = nn.Parameter(torch.empty(d))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.g.fill_(1.0)
        self.b.zero_()


def layer_norm(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Statistics, g and b in f32 whatever x's dtype; the result in x's
    dtype. (``F.layer_norm`` computes in the input's dtype.)"""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6) * ln.g + ln.b).to(x.dtype)


class BSTBlock(nn.Module):
    """wq, wk, wv, wo [d, d]; ln1, ln2; w1 [d, ffn], b1 [ffn], w2 [ffn, d],
    b2 [d]."""

    def __init__(self, d: int, ffn: int):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.empty(d, d)))
        self.ln1 = LayerNorm(d)
        self.ln2 = LayerNorm(d)
        self.w1 = nn.Parameter(torch.empty(d, ffn))
        self.b1 = nn.Parameter(torch.empty(ffn))
        self.w2 = nn.Parameter(torch.empty(ffn, d))
        self.b2 = nn.Parameter(torch.empty(d))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform wq, wk, wv, wo, w1, w2 (in that order), layer
        norms at identity, zero biases."""
        for w in (self.wq, self.wk, self.wv, self.wo, self.w1, self.w2):
            _glorot_(w, *w.shape, generator)
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()
        self.b1.zero_()
        self.b2.zero_()


class BSTEncoder(nn.Module):
    """pos [T_max + 1, d] (the target's position last) and ``blocks``."""

    def __init__(self, d: int, ffn: int, n_blocks: int, t_max: int):
        super().__init__()
        self.pos = nn.Parameter(torch.empty(t_max + 1, d))
        self.blocks = nn.ModuleList(BSTBlock(d, ffn) for _ in range(n_blocks))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """pos normal with std d**-0.5, then each block (as ``_bst_init``)."""
        self.pos.normal_(0.0, self.pos.shape[1] ** -0.5, generator=generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum with f32 sums whatever the operands' dtype (JAX's
    ``preferred_element_type=f32``): a bf16 product is exact in f32."""
    return torch.einsum(spec, a.float(), b.float())


def chunked_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                      kbias: torch.Tensor, chunk: int) -> torch.Tensor:
    """Online-softmax attention over key chunks of ``chunk``: qh [B, H, Sq,
    dh], kh and vh [B, H, S, dh], kbias [B, S] f32 -> [B, H, Sq, dh] f32.
    The keys are padded to whole chunks with bias -1e9; the running max
    starts at -1e30; the statistics and the accumulator are f32, and the
    probabilities are cast to the operands' dtype before P.V."""
    S, dh = kh.shape[2], kh.shape[3]
    nk = -(-S // chunk)
    pad = nk * chunk - S
    kh = F.pad(kh, (0, 0, 0, pad))
    vh = F.pad(vh, (0, 0, 0, pad))
    kbias = F.pad(kbias, (0, pad), value=-1e9)
    m = qh.new_full(qh.shape[:3], -1e30, dtype=torch.float32)
    l = qh.new_zeros(qh.shape[:3], dtype=torch.float32)
    acc = qh.new_zeros(qh.shape, dtype=torch.float32)
    for c in range(nk):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = (_f32_einsum("bhsd,bhtd->bhst", qh, kh[:, :, sl]) * dh ** -0.5
             + kbias[:, None, None, sl])
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _f32_einsum(
            "bhst,bhtd->bhsd", p.to(qh.dtype), vh[:, :, sl])
        m = m_new
    return acc / l[..., None]


def dense_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                    kbias: torch.Tensor) -> torch.Tensor:
    """The whole [B, H, Sq, S] f32 scores, one softmax, the probabilities
    cast to the operands' dtype, then P.V summed in f32 -> f32."""
    dh = qh.shape[-1]
    scores = (_f32_einsum("bhsd,bhtd->bhst", qh, kh) * dh ** -0.5
              + kbias[:, None, None, :])
    return _f32_einsum("bhst,bhtd->bhsd",
                       torch.softmax(scores, dim=-1).to(qh.dtype), vh)


def bst_attention(blk: BSTBlock, h: torch.Tensor, kbias: torch.Tensor,
                  heads: int, attn_chunk: int,
                  last_query_only: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """A block's multi-head attention -> (the queries' rows hq, their
    attention output after wo), both [B, Sq, d] in h's dtype. Sq is 1
    with ``last_query_only`` (dense scores [B, H, 1, S]), else S (chunked
    with ``attn_chunk``, else dense). The weights are cast to h's dtype at
    use (the parameters stay f32)."""
    B, S, d = h.shape
    dh = d // heads
    dt = h.dtype

    def split(x):  # [B, Sq, d] -> [B, heads, Sq, dh]
        return x.reshape(B, x.shape[1], heads, dh).transpose(1, 2)

    hq = h[:, -1:, :] if last_query_only else h
    qh = split(hq @ blk.wq.to(dt))
    kh = split(h @ blk.wk.to(dt))
    vh = split(h @ blk.wv.to(dt))
    if attn_chunk and not last_query_only:
        ctx = chunked_attention(qh, kh, vh, kbias, attn_chunk)
    else:
        ctx = dense_attention(qh, kh, vh, kbias)
    Sq = ctx.shape[2]
    a = ctx.to(dt).transpose(1, 2).reshape(B, Sq, d) @ blk.wo.to(dt)
    return hq, a


def bst_ffn(blk: BSTBlock, h: torch.Tensor, hq: torch.Tensor,
            a: torch.Tensor) -> torch.Tensor:
    """The rest of the post-LN block: LN1(hq + a), then LN2(. + FFN(.)),
    the FFN leaky_relu (slope 0.01) between w1 and w2."""
    dt = h.dtype
    h = layer_norm(blk.ln1, hq + a)
    f = h @ blk.w1.to(dt) + blk.b1.to(dt)
    f = torch.where(f >= 0, f, 0.01 * f) @ blk.w2.to(dt) + blk.b2.to(dt)
    return layer_norm(blk.ln2, h + f)


def bst_block(blk: BSTBlock, h: torch.Tensor, kbias: torch.Tensor,
              heads: int, attn_chunk: int,
              last_query_only: bool = False) -> torch.Tensor:
    """One post-LN Transformer block -> [B, Sq, d]; with
    ``last_query_only`` only the final position queries (Sq = 1)."""
    hq, a = bst_attention(blk, h, kbias, heads, attn_chunk, last_query_only)
    return bst_ffn(blk, h, hq, a)


def bst_encode(enc: BSTEncoder, x: torch.Tensor, mask: torch.Tensor,
               q: torch.Tensor, heads: int, attn_chunk: int = 0,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [B, T, d], mask [B, T], q [B, d] -> the target position's output
    [B, d] in x's dtype. Padded steps are masked as keys (bias -1e9 in
    f32); the appended target is always a valid key, so an empty history
    still attends. The last block runs ``last_query_only``."""
    T = x.shape[1]
    h = (torch.cat([x, q[:, None, :]], dim=1)
         + enc.pos[None, :T + 1]).to(compute_dtype)
    kmask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
    kbias = (1.0 - kmask.float()) * -1e9
    n = len(enc.blocks)
    for i, blk in enumerate(enc.blocks):
        h = bst_block(blk, h, kbias, heads, attn_chunk,
                      last_query_only=i == n - 1)
    return h[:, -1, :].to(x.dtype)


# ------------------------------------------------------------ dispatch ----

def build_encoder(name: str, cfg, d_in: int,
                  n_users: int = 0) -> Tuple[nn.Module, int]:
    """-> (the encoder of family ``name``, unset, and its d_state), as
    ``init_encoder``. SVD++ needs ``n_users`` > 0 and BST's heads must
    divide d_in, or ValueError."""
    m = cfg.model
    if name == "dnn":
        return DNNEncoder(), d_in
    if name == "svdpp":
        if n_users <= 0:
            raise ValueError("svdpp needs n_users > 0 passed to init_model "
                             "(the dataset spec's user-vocab size)")
        return SVDppEncoder(n_users, d_in), 2 * d_in
    if name == "lstm":
        return LSTMEncoder(d_in, m.mem_dim), m.mem_dim
    t_max = SPECS[cfg.dataset].seq_len
    if name == "caser":
        return (CaserEncoder(d_in, m.caser_hfilters, m.caser_vfilters, t_max),
                m.caser_hfilters * len(CASER_WINDOWS)
                + m.caser_vfilters * d_in)
    if name == "shan":
        return SHANEncoder(d_in, m.readout_dim), d_in
    if name == "bst":
        if d_in % m.bst_heads:
            raise ValueError(f"bst_heads={m.bst_heads} must divide the "
                             f"behavior embedding width {d_in}")
        return BSTEncoder(d_in, m.bst_ffn_mult * d_in, m.bst_blocks,
                          t_max), d_in
    raise ValueError(f"unknown encoder {name!r}")


def encode(enc: nn.Module, name: str, cfg, x: torch.Tensor,
           mask: torch.Tensor, q: torch.Tensor,
           uid: torch.Tensor = None) -> torch.Tensor:
    """The state [B, d_state] of family ``name``."""
    m = cfg.model
    if name == "dnn":
        return masked_mean(x, mask)
    if name == "svdpp":
        return svdpp_encode(enc, x, mask, uid)
    if name == "lstm":
        return lstm_seq(enc, x, mask)
    if name == "caser":
        return caser_encode(enc, x, mask)
    if name == "shan":
        return shan_encode(enc, x, mask, q, recent=m.shan_recent)
    if name == "bst":
        return bst_encode(enc, x, mask, q, heads=m.bst_heads,
                          attn_chunk=m.bst_attn_chunk,
                          compute_dtype=_BST_DTYPES[m.bst_dtype])
    raise ValueError(f"unknown encoder {name!r}")
