"""GRU cell and scan in plain PyTorch — counterpart of ``hpmn_tpu/ops/gru.py``.

The same cell as the JAX package ("linear before reset": one ``h @ wh`` per
step, the reset gate applied to its candidate block afterwards):

    xp = x @ wx + b
    g  = h @ wh
    r = sigmoid(xp_r + g_r);  z = sigmoid(xp_z + g_z)
    c = tanh(xp_c + r * g_c);  h' = (1 - z) * h + z * c

A masked step carries h unchanged (left-padded sequences). The AUGRU of
DIEN is the same cell with the update gate scaled by a per-step attention
weight a_t (``gate_scale``): z' = a_t * z. This is the plain version that
the CUDA scan kernels (ops/cuda_gru.py) are held against: ``gru_scan_tm``
for the forward, ``gru_scan_tm_bwd`` for the backward, and
``gru_scan_tm_bf16``/``gru_scan_tm_bwd_bf16`` for the bf16 chain of the
TPU kernel's ``dtype=bfloat16`` form (see there), each with and without
the scale; and, for the forward's two kernels, ``gru_input_proj``
(``_bf16``) then ``gru_scan_tm_xp`` (``_bf16``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..models.dtypes import matmul


class GRUWeights(NamedTuple):
    """Bare weight tensors with GRUParams' field names, for the functions
    below where no module is at hand (inside an autograd.Function)."""

    wx: torch.Tensor
    wh: torch.Tensor
    b: torch.Tensor


class GRUParams(nn.Module):
    """One GRU's weights in the JAX layout: wx [d_in, 3*d_m], wh
    [d_m, 3*d_m] (r, z, c blocks) and an input-side bias b [3*d_m]."""

    def __init__(self, d_in: int, d_m: int):
        super().__init__()
        self.wx = nn.Parameter(torch.empty(d_in, 3 * d_m))
        self.wh = nn.Parameter(torch.empty(d_m, 3 * d_m))
        self.b = nn.Parameter(torch.empty(3 * d_m))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform weights, zero bias (as ``gru_init``)."""
        d_in, d_m = self.wx.shape[0], self.wh.shape[0]
        s_x = (6.0 / (d_in + 3 * d_m)) ** 0.5
        s_h = (6.0 / (d_m + 3 * d_m)) ** 0.5
        self.wx.uniform_(-s_x, s_x, generator=generator)
        self.wh.uniform_(-s_h, s_h, generator=generator)
        self.b.zero_()


def gru_input_proj(params: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] -> xp [..., 3*d_m] (JAX's promotion where x's dtype
    is not the weights')."""
    return matmul(x, params.wx) + params.b


def _gates(params: GRUParams, xp: torch.Tensor, h: torch.Tensor):
    """One step's r, z, c and g_c = (h @ wh)_c from the input projection
    xp [..., 3*d_m] and h [..., d_m]."""
    d_m = h.shape[-1]
    g = matmul(h, params.wh)
    r = torch.sigmoid(xp[..., :d_m] + g[..., :d_m])
    z = torch.sigmoid(xp[..., d_m:2 * d_m] + g[..., d_m:2 * d_m])
    g_c = g[..., 2 * d_m:]
    c = torch.tanh(xp[..., 2 * d_m:] + r * g_c)
    return r, z, c, g_c


def gru_cell(params: GRUParams, xp: torch.Tensor, h: torch.Tensor,
             gate_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step from the input projection: xp [B, 3*d_m], h [B, d_m];
    gate_scale [B] or None, the AUGRU's attention weight on z."""
    _, z, c, _ = _gates(params, xp, h)
    if gate_scale is not None:
        z = z * gate_scale.reshape(z.shape[0], 1)
    return (1.0 - z) * h + z * c


def gru_step(params: GRUParams, xp_t: torch.Tensor, h: torch.Tensor,
             mask_t: Optional[torch.Tensor] = None,
             gate_scale_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gru_cell, with h carried unchanged where mask_t [B] is 0."""
    h_new = gru_cell(params, xp_t, h, gate_scale_t)
    if mask_t is None:
        return h_new
    m = mask_t.reshape(h.shape[0], 1)
    return m * h_new + (1.0 - m) * h


def gru_scan_tm(params: GRUParams, x_tm: torch.Tensor,
                mask_tm: Optional[torch.Tensor] = None,
                h0: Optional[torch.Tensor] = None,
                scale_tm: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major scan: x_tm [T, B, d_in], mask_tm [T, B] or None, h0
    [B, d_m] or None, scale_tm [T, B] or None (the AUGRU gate scale) ->
    (h_seq [T, B, d_m], h_T [B, d_m])."""
    return gru_scan_tm_xp(params, gru_input_proj(params, x_tm), mask_tm, h0,
                          scale_tm)


def gru_scan_tm_xp(params: GRUParams, xp: torch.Tensor,
                   mask_tm: Optional[torch.Tensor] = None,
                   h0: Optional[torch.Tensor] = None,
                   scale_tm: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_scan_tm` from its input projection xp [T, B, 3*d_m] = x
    @ wx + b (:func:`gru_input_proj`, one matmul): the plain version of the
    recurrence of K1 and K1-scale (csrc/gru_scan_fwd.cu, after
    csrc/gru_input_proj.cu) -> (h_seq [T, B, d_m], h_T [B, d_m])."""
    T, B, _ = xp.shape
    d_m = params.wh.shape[0]
    h = (torch.zeros(B, d_m, dtype=xp.dtype, device=xp.device)
         if h0 is None else h0)
    hs = []
    for t in range(T):
        h = gru_step(params, xp[t], h, None if mask_tm is None else mask_tm[t],
                     None if scale_tm is None else scale_tm[t])
        hs.append(h)
    if not hs:
        return xp.new_zeros(0, B, d_m), h
    return torch.stack(hs), h


def gru_scan_tm_bwd(params: GRUParams, x_tm: torch.Tensor,
                    mask_tm: Optional[torch.Tensor], h_seq: torch.Tensor,
                    dh_seq: torch.Tensor, h0: Optional[torch.Tensor] = None,
                    scale_tm: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`gru_scan_tm` by hand, independent of autograd:
    x_tm [T, B, d_in], mask_tm [T, B] or None, h_seq [T, B, d_m] (the
    forward's output), dh_seq [T, B, d_m] (its cotangent), h0 [B, d_m] or
    None, scale_tm [T, B] or None -> (dx [T, B, d_in], dwx, dwh, db, dh0
    [B, d_m]), and dscale [T, B] after them when scale_tm is given.

    The reverse sweep of the scan backward kernel: the gates are recomputed
    from h_{t-1} = h_seq[t-1] (h0 at t = 0) with the forward's formulas,
    and dh is carried in reverse. Per step, with m = mask_t and a =
    scale_t (1 with none), zs = z a:

        gtot = dh_seq[t] + dh;  gcell = gtot * m
        dz_s = gcell (c - h_prev);  dc = gcell zs (1 - c^2)
        dz = dz_s a z (1 - z);      dr = dc g_c r (1 - r)
        dh = gcell (1 - zs) + (gtot - gcell) + [dr|dz|dc r] @ wh^T
        dscale_t = sum_j dz_s z

    and dx_t = [dr|dz|dc] @ wx^T, dwx += x_t^T [dr|dz|dc], dwh += h_prev^T
    [dr|dz|dc r], db += sum [dr|dz|dc]: those after the sweep
    (:func:`gru_scan_tm_sweep`), from all its steps' gate gradients
    (:func:`gru_bwd_pass`)."""
    return _with_pass(params, x_tm, *gru_scan_tm_sweep(
        params, x_tm, mask_tm, h_seq, dh_seq, h0, scale_tm))


def gru_scan_tm_sweep(params: GRUParams, x_tm: torch.Tensor,
                      mask_tm: Optional[torch.Tensor], h_seq: torch.Tensor,
                      dh_seq: torch.Tensor, h0: Optional[torch.Tensor] = None,
                      scale_tm: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, ...]:
    """The reverse sweep of :func:`gru_scan_tm_bwd` (the plain version of
    the recurrence of K2 and K2-scale, csrc/gru_scan_bwd.cu), its arguments
    -> (dpre_x = [dr|dz|dc], dpre_h = [dr|dz|dc r] [T, B, 3*d_m], h_prev
    [T, B, d_m], dh0, dscale [T, B] or None)."""
    h0 = x_tm.new_zeros(x_tm.shape[1], params.wh.shape[0]) if h0 is None \
        else h0
    h_prev = torch.cat([h0[None], h_seq[:-1]])  # [T, B, d_m]
    dpre_x, dpre_h, dh0, dscale = _gate_sweep(
        params, x_tm, mask_tm, h_prev, lambda t, dh: dh_seq[t] + dh,
        scale_tm)
    return dpre_x, dpre_h, h_prev, dh0, dscale


def _with_pass(params, x_tm, dpre_x, dpre_h, h_prev, dh0, dscale=None):
    """A gate sweep's results, then :func:`gru_bwd_pass` on them -> (dx,
    dwx, dwh, db, dh0), and dscale after them when given."""
    out = gru_bwd_pass(x_tm, h_prev, dpre_x, dpre_h, params.wx) + (dh0,)
    return out if dscale is None else out + (dscale,)


def _gate_sweep(params, x_tm, mask_tm, h_prev, cotangent, scale_tm=None):
    """The reverse sweep of the f32 scan backward kernels (K2, K2-scale,
    K4): the gates from h_prev [T, B, d_m] (the state before each step),
    the cotangent gtot = cotangent(t, dh) that reaches h_t, the formulas of
    :func:`gru_scan_tm_bwd` -> (dpre_x = [dr|dz|dc], dpre_h = [dr|dz|dc r]
    [T, B, 3*d_m], dh0, dscale or None)."""
    T, B, _ = x_tm.shape
    d_m = params.wh.shape[0]
    xp = gru_input_proj(params, x_tm)  # the forward's projection
    dpre_x = x_tm.new_empty(T, B, 3 * d_m)  # [dr | dz | dc]
    dpre_h = x_tm.new_empty(T, B, 3 * d_m)  # [dr | dz | dc * r]
    dscale = None if scale_tm is None else x_tm.new_empty(T, B)
    dh = x_tm.new_zeros(B, d_m)
    for t in reversed(range(T)):
        hp = h_prev[t]
        r, z, c, g_c = _gates(params, xp[t], hp)
        gtot = cotangent(t, dh)
        gcell = gtot if mask_tm is None else gtot * mask_tm[t][:, None]
        a = None if scale_tm is None else scale_tm[t][:, None]
        zs = z if a is None else z * a
        dzs = gcell * (c - hp)
        dc = gcell * zs * (1.0 - c * c)
        dz = (dzs if a is None else dzs * a) * z * (1.0 - z)
        dr = dc * g_c * r * (1.0 - r)
        if dscale is not None:
            dscale[t] = (dzs * z).sum(dim=-1)
        dpre_x[t] = torch.cat([dr, dz, dc], dim=-1)
        dpre_h[t] = torch.cat([dr, dz, dc * r], dim=-1)
        dh = gcell * (1.0 - zs) + (gtot - gcell) + dpre_h[t] @ params.wh.T
    return dpre_x, dpre_h, dh, dscale


def gru_bwd_pass(x_tm: torch.Tensor, h_prev: torch.Tensor,
                 dpre_x: torch.Tensor, dpre_h: torch.Tensor,
                 wx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The scan backward's products that read only the gate gradients, after
    its reverse sweep (the plain version of csrc/gru_bwd_pass.cu): x_tm
    [T, B, d_in], h_prev [T, B, d_m], dpre_x = [dr|dz|dc] and dpre_h =
    [dr|dz|dc r] [T, B, 3*d_m], wx [d_in, 3*d_m] -> (dx = dpre_x @ wx^T,
    dwx = sum x_t^T dpre_x, dwh = sum h_prev^T dpre_h, db = sum dpre_x).
    bf16 tensors are summed in f32 (products of bf16 values) and dx is
    rounded to bf16 once; the weight gradients stay f32."""
    ct = torch.float32 if x_tm.dtype == torch.bfloat16 else x_tm.dtype
    dpx = dpre_x.to(ct)
    dx = (dpx @ wx.to(ct).T).to(x_tm.dtype)
    dwx = torch.einsum("tbi,tbj->ij", x_tm.to(ct), dpx)
    dwh = torch.einsum("tbi,tbj->ij", h_prev.to(ct), dpre_h.to(ct))
    return dx, dwx, dwh, dpx.sum(dim=(0, 1))


# The bf16 chain: where ``hpmn_tpu/ops/pallas_gru.py`` with dtype=bfloat16
# rounds. Every operand (x, h, the weights, the mask) is bf16; the products
# are f32 sums of bf16 values (upcast, then ``@``), summed as the TPU kernel
# sums its packed blocks, (x @ wx + h @ wh) + b, and rounded to bf16 once per
# block: r, z, the candidate's x part pre_c and its h part g_c (the packed
# zero blocks keep those two apart). From there every op runs on bf16
# tensors, so each rounds, and sigmoid is 0.5 * tanh(0.5 v) + 0.5.


def _sigmoid_tanh(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.tanh(0.5 * v) + 0.5


def gru_input_proj_bf16(params: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """The bf16 chain's input projection (the plain version of K1-bf16's
    first kernel, csrc/gru_input_proj.cu): x [..., d_in] bf16 -> f32 [...,
    3*d_m] holding x @ wx for the r and z blocks, without the bias (the
    chain adds it after the h part), and the candidate's pre_c = bf16(x @
    wx_c + b_c), rounded, as f32. Sums in f32 of bf16 values."""
    d_m = params.wh.shape[0]
    xw = x.float() @ params.wx.float()
    pre_c = (xw[..., 2 * d_m:] + params.b[2 * d_m:].float()).bfloat16()
    return torch.cat([xw[..., :2 * d_m], pre_c.float()], dim=-1)


def _bf16_gates(xp_t, h, whf, bf):
    """One step's r, z, c, g_c (bf16) from xp_t [B, 3*d_m], one step of
    :func:`gru_input_proj_bf16`, h [B, d_m] (bf16) and the f32 copies of wh
    and b."""
    d_m = h.shape[-1]
    g = h.float() @ whf
    pre = ((xp_t[:, :2 * d_m] + g[:, :2 * d_m]) + bf[:2 * d_m]).bfloat16()
    pre_c = xp_t[:, 2 * d_m:].bfloat16()
    g_c = g[:, 2 * d_m:].bfloat16()
    r = _sigmoid_tanh(pre[:, :d_m])
    z = _sigmoid_tanh(pre[:, d_m:])
    c = torch.tanh(pre_c + r * g_c)
    return r, z, c, g_c


def gru_scan_tm_bf16(params: GRUParams, x_tm: torch.Tensor,
                     mask_tm: Optional[torch.Tensor] = None,
                     h0: Optional[torch.Tensor] = None,
                     scale_tm: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_scan_tm` in the bf16 chain: every tensor bf16 (the weights
    and the scale too) -> (h_seq [T, B, d_m], h_T [B, d_m]), bf16. The cell
    is h_cell = h + zs * (c - h) with zs = z * a_t (one bf16 mul) or z; with
    a mask the step is h + m * (h_cell - h), rounded op by op; without one
    it is h_cell."""
    return gru_scan_tm_xp_bf16(params, gru_input_proj_bf16(params, x_tm),
                               mask_tm, h0, scale_tm)


def gru_scan_tm_xp_bf16(params: GRUParams, xp: torch.Tensor,
                        mask_tm: Optional[torch.Tensor] = None,
                        h0: Optional[torch.Tensor] = None,
                        scale_tm: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_scan_tm_bf16` from its input projection xp [T, B, 3*d_m]
    (:func:`gru_input_proj_bf16`, f32): the plain version of the
    recurrence of K1-bf16 and K1-scale-bf16 -> (h_seq, h_T), bf16."""
    T, B, _ = xp.shape
    d_m = params.wh.shape[0]
    whf, bf = params.wh.float(), params.b.float()
    h = xp.new_zeros(B, d_m, dtype=params.wh.dtype) if h0 is None else h0
    hs = []
    for t in range(T):
        r, z, c, _ = _bf16_gates(xp[t], h, whf, bf)
        zs = z if scale_tm is None else z * scale_tm[t][:, None]
        h_cell = h + zs * (c - h)
        h = (h_cell if mask_tm is None
             else h + mask_tm[t][:, None] * (h_cell - h))
        hs.append(h)
    if not hs:
        return h.new_zeros(0, B, d_m), h
    return torch.stack(hs), h


def gru_scan_tm_bwd_bf16(params: GRUParams, x_tm: torch.Tensor,
                         mask_tm: Optional[torch.Tensor], h_seq: torch.Tensor,
                         dh_seq: torch.Tensor,
                         h0: Optional[torch.Tensor] = None,
                         scale_tm: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, ...]:
    """:func:`gru_scan_tm_bwd` in the bf16 chain, as the TPU backward
    kernel: bf16 inputs -> (dx bf16, dwx, dwh, db f32, dh0 f32), and
    dscale [T, B] bf16 after them when scale_tm is given.

    The dh carry is f32: gtot = bf16(dh_seq[t] + dh). zs = z * a, dz_s, dc
    = (gcell zs)(1 - c^2), dz = ((dz_s a) z)(1 - z), dr and dc * r are
    bf16, op by op, and so is the carry's own term gcell - gcell zs (+ gtot
    - gcell with a mask); dh = f32(that) + dpre @ wh^T, an f32 sum. dx =
    bf16(dpre @ wx^T). dscale_t is the f32 sum over j of dz_s z, each
    product exact in f32 (two bf16 values), rounded to bf16 once: what XLA
    computes for the TPU kernel's ``jnp.sum(dzs * z)`` in interpret mode,
    where the sum runs in f32 and the product's bf16 rounding is elided.
    The weight gradients are f32 sums of bf16 products; rounding them to
    the weights' dtype is the caller's (``cuda_gru.GRUScan``)."""
    return _with_pass(params, x_tm, *gru_scan_tm_sweep_bf16(
        params, x_tm, mask_tm, h_seq, dh_seq, h0, scale_tm))


def gru_scan_tm_sweep_bf16(params: GRUParams, x_tm: torch.Tensor,
                           mask_tm: Optional[torch.Tensor],
                           h_seq: torch.Tensor, dh_seq: torch.Tensor,
                           h0: Optional[torch.Tensor] = None,
                           scale_tm: Optional[torch.Tensor] = None,
                           ) -> Tuple[torch.Tensor, ...]:
    """:func:`gru_scan_tm_sweep` in the bf16 chain (the plain version of the
    recurrence of K2-bf16 and K2-scale-bf16): bf16 inputs -> (dpre_x,
    dpre_h, h_prev bf16, dh0 f32, dscale bf16 or None)."""
    h0 = x_tm.new_zeros(x_tm.shape[1], params.wh.shape[0]) if h0 is None \
        else h0
    h_prev = torch.cat([h0[None], h_seq[:-1]])  # [T, B, d_m]
    dpre_x, dpre_h, dh0, dscale = _gate_sweep_bf16(
        params, x_tm, mask_tm, h_prev,
        lambda t, dh: (dh_seq[t].float() + dh).bfloat16(), scale_tm)
    return dpre_x, dpre_h, h_prev, dh0, dscale


def _gate_sweep_bf16(params, x_tm, mask_tm, h_prev, cotangent,
                     scale_tm=None):
    """The reverse sweep of the bf16 scan backward kernels (K2-bf16,
    K2-scale-bf16, K4-bf16), as :func:`_gate_sweep` with the bf16 chain's
    roundings (the gate gradients bf16, dh0 f32); cotangent(t, dh) returns
    gtot, already rounded to bf16 from its f32 sum."""
    T, B, _ = x_tm.shape
    d_m = params.wh.shape[0]
    whf, bf = params.wh.float(), params.b.float()
    xp = gru_input_proj_bf16(params, x_tm)
    dpre_x = x_tm.new_empty(T, B, 3 * d_m)  # [dr | dz | dc]
    dpre_h = x_tm.new_empty(T, B, 3 * d_m)  # [dr | dz | dc * r]
    dscale = None if scale_tm is None else x_tm.new_empty(T, B)
    dh = x_tm.new_zeros(B, d_m, dtype=torch.float32)
    for t in reversed(range(T)):
        hp = h_prev[t]
        r, z, c, g_c = _bf16_gates(xp[t], hp, whf, bf)
        gtot = cotangent(t, dh)
        gcell = gtot if mask_tm is None else gtot * mask_tm[t][:, None]
        a = None if scale_tm is None else scale_tm[t][:, None]
        zs = z if a is None else z * a
        dzs = gcell * (c - hp)
        dc = gcell * zs * (1.0 - c * c)
        dz = (dzs if a is None else dzs * a) * z * (1.0 - z)
        dr = dc * g_c * r * (1.0 - r)
        if dscale is not None:
            dscale[t] = (dzs.float() * z.float()).sum(dim=-1).bfloat16()
        carry = gcell - gcell * zs
        if mask_tm is not None:
            carry = carry + (gtot - gcell)
        dpre_x[t] = torch.cat([dr, dz, dc], dim=-1)
        dpre_h[t] = torch.cat([dr, dz, dc * r], dim=-1)
        dh = carry.float() + dpre_h[t].float() @ whf.T
    return dpre_x, dpre_h, dh, dscale


# The strided-output scan (pallas_gru.py's pallas_gru_stride_tm, the
# full-sequence path of model.pallas_stride_outputs): no mask; the layer
# emits only h_seq[period-1::period] (T // period rows) and h_T. The plain
# versions of K3/K4 (and of their bf16 forms; K3's recurrence alone, from
# its input projection, is gru_scan_stride_tm_xp): the backward recomputes
# the states from x (no boundaries) and takes the strided rows' and h_T's
# cotangents where they enter, at the firing steps (t+1) % period == 0 and
# at t = T-1, in the TPU kernel's order: (dh + dhs[s]) + dhT.


#: The kernels' boundary chunk: K3 keeps the state at the start of every
#: chunk of this many steps (csrc/gru_chain.cuh's kStrideChunk).
STRIDE_CHUNK = 16


def _stride_states_xp(params: GRUParams, xp: torch.Tensor,
                      h0: Optional[torch.Tensor],
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The strided scan's states, f32, from the input projection xp [T, B,
    3*d_m] (:func:`gru_input_proj`), with the TPU stride kernel's update
    h + z * (c - h): -> (h_seq [T, B, d_m], h_T)."""
    T, B, _ = xp.shape
    d_m = params.wh.shape[0]
    h = xp.new_zeros(B, d_m) if h0 is None else h0
    hs = []
    for t in range(T):
        _, z, c, _ = _gates(params, xp[t], h)
        h = h + z * (c - h)
        hs.append(h)
    return (torch.stack(hs) if hs else xp.new_zeros(0, B, d_m)), h


def _stride_states(params: GRUParams, x_tm: torch.Tensor,
                   h0: Optional[torch.Tensor],
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_stride_states_xp` from x_tm [T, B, d_in]."""
    return _stride_states_xp(params, gru_input_proj(params, x_tm), h0)


def _stride_outputs(h_seq, h0, h_T, period, t_first):
    """A chunk's strided outputs from its states h_seq [T, B, d_m] (steps
    t_first ... t_first + T - 1) and the state before them h0: (the rows
    h_seq[t] where (t_first + t + 1) % period == 0, h_T, the states before
    the steps where (t_first + t) % STRIDE_CHUNK == 0)."""
    t = torch.arange(t_first, t_first + h_seq.shape[0])
    h_prev = torch.cat([h0[None], h_seq[:-1]])
    return h_seq[(t + 1) % period == 0], h_T, h_prev[t % STRIDE_CHUNK == 0]


def gru_scan_stride_tm_xp(params: GRUParams, xp: torch.Tensor, period: int,
                          h0: Optional[torch.Tensor] = None,
                          t_first: int = 0) -> Tuple[torch.Tensor, ...]:
    """The strided scan's recurrence from its input projection (the plain
    version of K3's second kernel, csrc/gru_scan_fwd.cu's StrideOut
    policy), f32: xp [T, B, 3*d_m] = x @ wx + b (:func:`gru_input_proj`)
    of the steps t_first ... t_first + T - 1, h0 [B, d_m] or None (zeros)
    the state before them -> (h_stride, h_T, boundaries): the strided rows
    h_seq[t] of the steps with (t+1) % period == 0, in order (those of
    h_seq[period-1::period] that fall in the chunk), the last state, and
    the states before the steps with t % STRIDE_CHUNK == 0 (those of K3's
    boundaries that fall in the chunk). Steps are counted from 0 over the
    whole scan, so chunks run one after another, each from the last one's
    h_T, give the whole scan's outputs when their rows are concatenated."""
    d_m = params.wh.shape[0]
    if h0 is None:
        h0 = xp.new_zeros(xp.shape[1], d_m)
    h_seq, h_T = _stride_states_xp(params, xp, h0)
    return _stride_outputs(h_seq, h0, h_T, period, t_first)


def gru_scan_stride_tm_xp_bf16(params: GRUParams, xp: torch.Tensor,
                               period: int,
                               h0: Optional[torch.Tensor] = None,
                               t_first: int = 0) -> Tuple[torch.Tensor, ...]:
    """:func:`gru_scan_stride_tm_xp` in the bf16 chain (the plain version of
    K3-bf16's second kernel): xp from :func:`gru_input_proj_bf16` (f32),
    the weights and h0 bf16 -> (h_stride, h_T, boundaries), bf16. The
    stride kernel's h + z * (c - h), rounded op by op, is the no-mask step
    of :func:`gru_scan_tm_bf16`."""
    d_m = params.wh.shape[0]
    if h0 is None:
        h0 = xp.new_zeros(xp.shape[1], d_m, dtype=torch.bfloat16)
    h_seq, h_T = gru_scan_tm_xp_bf16(params, xp, None, h0)
    return _stride_outputs(h_seq, h0, h_T, period, t_first)


def gru_scan_stride_tm(params: GRUParams, x_tm: torch.Tensor, period: int,
                       h0: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strided-output scan, f32: x_tm [T, B, d_in], h0 [B, d_m] or None ->
    (h_stride [T // period, B, d_m] = h_seq[period-1::period], h_T)."""
    h_seq, h_T = _stride_states(params, x_tm, h0)
    return h_seq[period - 1::period], h_T


def _stride_cotangent(period, T, dhs, dhT, to_f=lambda v: v):
    def cot(t, dh):
        g = dh
        if dhs is not None and (t + 1) % period == 0:
            g = g + to_f(dhs[(t + 1) // period - 1])
        if dhT is not None and t == T - 1:
            g = g + to_f(dhT)
        return g
    return cot


def gru_scan_stride_tm_sweep(params: GRUParams, x_tm: torch.Tensor,
                             period: int, dhs: Optional[torch.Tensor],
                             dhT: Optional[torch.Tensor],
                             h0: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, ...]:
    """The gate sweep of :func:`gru_scan_stride_tm_bwd` (the plain version
    of K4's recurrence, csrc/gru_scan_stride_bwd.cu): dhs [T // period, B,
    d_m] and dhT [B, d_m] the outputs' cotangents (None: zero) -> (dpre_x
    = [dr|dz|dc], dpre_h = [dr|dz|dc r] [T, B, 3*d_m], h_prev [T, B, d_m],
    dh0). The states are recomputed from x."""
    T, B, _ = x_tm.shape
    h0 = x_tm.new_zeros(B, params.wh.shape[0]) if h0 is None else h0
    h_seq, _ = _stride_states(params, x_tm, h0)
    h_prev = torch.cat([h0[None], h_seq[:-1]])
    dpre_x, dpre_h, dh, _ = _gate_sweep(
        params, x_tm, None, h_prev, _stride_cotangent(period, T, dhs, dhT))
    return dpre_x, dpre_h, h_prev, dh


def gru_scan_stride_tm_bwd(params: GRUParams, x_tm: torch.Tensor,
                           period: int, dhs: Optional[torch.Tensor],
                           dhT: Optional[torch.Tensor],
                           h0: Optional[torch.Tensor] = None,
                           ) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`gru_scan_stride_tm` by hand (the plain K4): dhs
    [T // period, B, d_m] and dhT [B, d_m] the outputs' cotangents (None:
    zero) -> (dx, dwx, dwh, db, dh0): :func:`gru_scan_stride_tm_sweep`,
    then :func:`gru_bwd_pass`."""
    return _with_pass(params, x_tm, *gru_scan_stride_tm_sweep(
        params, x_tm, period, dhs, dhT, h0))


def gru_scan_stride_tm_bf16(params: GRUParams, x_tm: torch.Tensor,
                            period: int, h0: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gru_scan_stride_tm` in the bf16 chain (every tensor bf16):
    the stride kernel's h + z * (c - h), rounded op by op, is the no-mask
    h_cell of :func:`gru_scan_tm_bf16`."""
    h_seq, h_T = gru_scan_tm_bf16(params, x_tm, None, h0)
    return h_seq[period - 1::period], h_T


def gru_scan_stride_tm_sweep_bf16(params: GRUParams, x_tm: torch.Tensor,
                                  period: int, dhs: Optional[torch.Tensor],
                                  dhT: Optional[torch.Tensor],
                                  h0: Optional[torch.Tensor] = None,
                                  ) -> Tuple[torch.Tensor, ...]:
    """:func:`gru_scan_stride_tm_sweep` in the bf16 chain (the plain
    version of K4-bf16's recurrence): bf16 inputs -> (dpre_x, dpre_h,
    h_prev bf16, dh0 f32). The cotangents meet the f32 dh carry in f32,
    (dh + dhs[s]) + dhT, and the sum is rounded to bf16 once (where the
    dense path would sum dhs[s] and dhT in bf16 first)."""
    T, B, _ = x_tm.shape
    h0 = x_tm.new_zeros(B, params.wh.shape[0]) if h0 is None else h0
    h_seq, _ = gru_scan_tm_bf16(params, x_tm, None, h0)
    h_prev = torch.cat([h0[None], h_seq[:-1]])
    cot = _stride_cotangent(period, T, dhs, dhT, lambda v: v.float())
    dpre_x, dpre_h, dh, _ = _gate_sweep_bf16(
        params, x_tm, None, h_prev, lambda t, dh: cot(t, dh).bfloat16())
    return dpre_x, dpre_h, h_prev, dh


def gru_scan_stride_tm_bwd_bf16(params: GRUParams, x_tm: torch.Tensor,
                                period: int, dhs: Optional[torch.Tensor],
                                dhT: Optional[torch.Tensor],
                                h0: Optional[torch.Tensor] = None,
                                ) -> Tuple[torch.Tensor, ...]:
    """:func:`gru_scan_stride_tm_bwd` in the bf16 chain: bf16 inputs -> (dx
    bf16, dwx, dwh, db, dh0 f32): :func:`gru_scan_stride_tm_sweep_bf16`,
    then :func:`gru_bwd_pass`."""
    return _with_pass(params, x_tm, *gru_scan_stride_tm_sweep_bf16(
        params, x_tm, period, dhs, dhT, h0))


def gru_sequence(params: GRUParams, x: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 gate_scale: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major scan: x [B, T, d_in], mask [B, T], gate_scale [B, T]
    (the AUGRU attention) -> (h_seq [B, T, d_m], h_T [B, d_m])."""
    h_seq, h_T = gru_scan_tm(
        params, x.transpose(0, 1),
        None if mask is None else mask.transpose(0, 1), h0,
        None if gate_scale is None else gate_scale.transpose(0, 1))
    return h_seq.transpose(0, 1), h_T
