"""RUM, the external user-memory baseline — counterpart of
``hpmn_tpu/models/rum.py``: a K-slot memory per user, written by every
behaviour (erase, then add) and read by the target's attention.

    write weights  w_t = softmax_k(beta * <x̂_t, key_k>)   (cosine)
    erase          e_t = sigmoid(We x̂_t);  add  a_t = tanh(Wa x̂_t)
    M <- M * (1 - w_t ⊗ e_t) + w_t ⊗ a_t      (a masked step keeps M)

    read weights   r = softmax_k(beta * <q̂, key_k>);  read = sum_k r_k M_k

The JAX package scans the writes with ``lax.scan``, not a Pallas kernel,
so here they are plain tensor ops: the projections of every step at once,
then the masked recurrence over T.
"""

from __future__ import annotations

import torch
from torch import nn

from .dtypes import einsum


class RUMEncoder(nn.Module):
    """keys [K, mem_dim], proj [in_dim, mem_dim], erase and add [mem_dim,
    mem_dim], qproj [in_dim, mem_dim] and the 0-d sharpness beta, as in
    the JAX layout."""

    def __init__(self, in_dim: int, mem_dim: int, n_slots: int):
        super().__init__()
        self.keys = nn.Parameter(torch.empty(n_slots, mem_dim))
        self.proj = nn.Parameter(torch.empty(in_dim, mem_dim))
        self.erase = nn.Parameter(torch.empty(mem_dim, mem_dim))
        self.add = nn.Parameter(torch.empty(mem_dim, mem_dim))
        self.qproj = nn.Parameter(torch.empty(in_dim, mem_dim))
        self.beta = nn.Parameter(torch.empty(()))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init_rum`` distributions: keys normal with std
        mem_dim**-0.5, the projections uniform in +-sqrt(6 / (in_dim +
        mem_dim)), beta 1."""
        in_dim, mem_dim = self.proj.shape
        self.keys.normal_(0.0, mem_dim ** -0.5, generator=generator)
        s = (6.0 / (in_dim + mem_dim)) ** 0.5
        for w in (self.proj, self.erase, self.add, self.qproj):
            w.uniform_(-s, s, generator=generator)
        self.beta.fill_(1.0)


def address(keys: torch.Tensor, q: torch.Tensor,
            beta: torch.Tensor) -> torch.Tensor:
    """Cosine addressing: q [B, d] against keys [K, d] -> weights [B, K]."""
    qn = q / (q.norm(dim=-1, keepdim=True) + 1e-6)
    kn = keys / (keys.norm(dim=-1, keepdim=True) + 1e-6)
    return torch.softmax(beta * qn @ kn.T, dim=-1)


def write_memory(enc: RUMEncoder, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The target-independent half of RUM: the erase/add writes of the
    behaviours x [B, T, in_dim] (mask [B, T]) into an empty memory ->
    memory [B, K, mem_dim]. Serving keeps this memory per user and writes
    each new event into it (serving/protocol.py)."""
    B, T, _ = x.shape
    K, d = enc.keys.shape
    xh = x @ enc.proj  # [B, T, d]
    e_all = torch.sigmoid(xh @ enc.erase)
    a_all = torch.tanh(xh @ enc.add)
    w_all = address(enc.keys, xh.reshape(B * T, d), enc.beta).reshape(B, T, K)
    M = x.new_zeros(B, K, d)
    for t in range(T):
        w = w_all[:, t, :, None]
        M_new = M * (1.0 - w * e_all[:, t, None, :]) + w * a_all[:, t, None, :]
        M = torch.where(mask[:, t, None, None] > 0, M_new, M)
    return M


def read_memory(enc: RUMEncoder, M: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """memory [B, K, mem_dim], target [B, in_dim] -> the read [B, mem_dim]
    (a store's float32 memory read by a bf16 model's weights in float32,
    JAX's promotion)."""
    r = address(enc.keys, target @ enc.qproj, enc.beta)
    return einsum("bk,bkd->bd", r, M)


def encode(enc: RUMEncoder, x: torch.Tensor, mask: torch.Tensor,
           target: torch.Tensor) -> torch.Tensor:
    """x [B, T, in_dim], mask [B, T], target [B, in_dim] -> the read vector
    [B, mem_dim]."""
    return read_memory(enc, write_memory(enc, x, mask), target)
