"""GRU cell and scan in plain PyTorch — counterpart of ``hpmn_tpu/ops/gru.py``.

The same cell as the JAX package ("linear before reset": one ``h @ wh`` per
step, the reset gate applied to its candidate block afterwards):

    xp = x @ wx + b
    g  = h @ wh
    r = sigmoid(xp_r + g_r);  z = sigmoid(xp_z + g_z)
    c = tanh(xp_c + r * g_c);  h' = (1 - z) * h + z * c

A masked step carries h unchanged (left-padded sequences). This is the plain
version that the CUDA scan kernels (ops/cuda_gru.py) are held against:
``gru_scan_tm`` for the forward, ``gru_scan_tm_bwd`` for the backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn


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
    """x [..., d_in] -> xp [..., 3*d_m]."""
    return x @ params.wx + params.b


def gru_cell(params: GRUParams, xp: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One step from the input projection: xp [B, 3*d_m], h [B, d_m]."""
    d_m = h.shape[-1]
    g = h @ params.wh
    r = torch.sigmoid(xp[..., :d_m] + g[..., :d_m])
    z = torch.sigmoid(xp[..., d_m:2 * d_m] + g[..., d_m:2 * d_m])
    c = torch.tanh(xp[..., 2 * d_m:] + r * g[..., 2 * d_m:])
    return (1.0 - z) * h + z * c


def gru_step(params: GRUParams, xp_t: torch.Tensor, h: torch.Tensor,
             mask_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gru_cell, with h carried unchanged where mask_t [B] is 0."""
    h_new = gru_cell(params, xp_t, h)
    if mask_t is None:
        return h_new
    m = mask_t.reshape(h.shape[0], 1)
    return m * h_new + (1.0 - m) * h


def gru_scan_tm(params: GRUParams, x_tm: torch.Tensor,
                mask_tm: Optional[torch.Tensor] = None,
                h0: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major scan: x_tm [T, B, d_in], mask_tm [T, B] or None, h0
    [B, d_m] or None -> (h_seq [T, B, d_m], h_T [B, d_m])."""
    T, B, _ = x_tm.shape
    d_m = params.wh.shape[0]
    h = (torch.zeros(B, d_m, dtype=x_tm.dtype, device=x_tm.device)
         if h0 is None else h0)
    xp = gru_input_proj(params, x_tm)  # [T, B, 3*d_m], one matmul
    hs = []
    for t in range(T):
        h = gru_step(params, xp[t], h, None if mask_tm is None else mask_tm[t])
        hs.append(h)
    if not hs:
        return x_tm.new_zeros(0, B, d_m), h
    return torch.stack(hs), h


def gru_scan_tm_bwd(params: GRUParams, x_tm: torch.Tensor,
                    mask_tm: Optional[torch.Tensor], h_seq: torch.Tensor,
                    dh_seq: torch.Tensor, h0: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, ...]:
    """Backward of :func:`gru_scan_tm` by hand, independent of autograd:
    x_tm [T, B, d_in], mask_tm [T, B] or None, h_seq [T, B, d_m] (the
    forward's output), dh_seq [T, B, d_m] (its cotangent), h0 [B, d_m] or
    None -> (dx [T, B, d_in], dwx, dwh, db, dh0 [B, d_m]).

    The reverse sweep of the scan backward kernel: the gates are recomputed
    from h_{t-1} = h_seq[t-1] (h0 at t = 0) with the forward's formulas,
    and dh is carried in reverse. Per step, with m = mask_t (1 with none):

        gtot = dh_seq[t] + dh;  gcell = gtot * m
        dz_s = gcell (c - h_prev);  dc = gcell z (1 - c^2)
        dz = dz_s z (1 - z);        dr = dc g_c r (1 - r)
        dh = gcell (1 - z) + (gtot - gcell) + [dr|dz|dc r] @ wh^T

    and dx_t = [dr|dz|dc] @ wx^T, dwx += x_t^T [dr|dz|dc], dwh += h_prev^T
    [dr|dz|dc r], db += sum [dr|dz|dc]."""
    T, B, _ = x_tm.shape
    d_m = params.wh.shape[0]
    h0 = x_tm.new_zeros(B, d_m) if h0 is None else h0
    h_prev = torch.cat([h0[None], h_seq[:-1]])  # [T, B, d_m]
    xp = gru_input_proj(params, x_tm)  # the forward's projection
    dpre_x = x_tm.new_empty(T, B, 3 * d_m)  # [dr | dz | dc]
    dpre_h = x_tm.new_empty(T, B, 3 * d_m)  # [dr | dz | dc * r]
    dh = x_tm.new_zeros(B, d_m)
    for t in reversed(range(T)):
        hp = h_prev[t]
        g = hp @ params.wh
        r = torch.sigmoid(xp[t, :, :d_m] + g[:, :d_m])
        z = torch.sigmoid(xp[t, :, d_m:2 * d_m] + g[:, d_m:2 * d_m])
        g_c = g[:, 2 * d_m:]
        c = torch.tanh(xp[t, :, 2 * d_m:] + r * g_c)
        gtot = dh_seq[t] + dh
        gcell = gtot if mask_tm is None else gtot * mask_tm[t][:, None]
        dzs = gcell * (c - hp)
        dc = gcell * z * (1.0 - c * c)
        dz = dzs * z * (1.0 - z)
        dr = dc * g_c * r * (1.0 - r)
        dpre_x[t] = torch.cat([dr, dz, dc], dim=-1)
        dpre_h[t] = torch.cat([dr, dz, dc * r], dim=-1)
        dh = gcell * (1.0 - z) + (gtot - gcell) + dpre_h[t] @ params.wh.T
    dx = dpre_x @ params.wx.T
    dwx = torch.einsum("tbi,tbj->ij", x_tm, dpre_x)
    dwh = torch.einsum("tbi,tbj->ij", h_prev, dpre_h)
    return dx, dwx, dwh, dpre_x.sum(dim=(0, 1)), dh


def gru_sequence(params: GRUParams, x: torch.Tensor,
                 h0: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major scan: x [B, T, d_in], mask [B, T] -> (h_seq [B, T, d_m],
    h_T [B, d_m])."""
    h_seq, h_T = gru_scan_tm(params, x.transpose(0, 1),
                             None if mask is None else mask.transpose(0, 1),
                             h0)
    return h_seq.transpose(0, 1), h_T
