"""The optimizer of the JAX ``make_optimizer`` (``hpmn_tpu/train/train.py``)
on ``torch.optim.Adam`` / ``AdamW``.

optax composes it as ``MultiSteps(with_ema(chain(clip, adam|adamw)), k)``;
:class:`Optimizer` runs the same pieces in the same order on each
``step()``, after ``loss.backward()`` has filled the gradients:

1. accumulation (``grad_accum = k > 1``, ``optax.MultiSteps``): the
   running mean ``acc = acc + (g - acc) / (n + 1)`` of the micro-batch
   gradients; the parameters, the schedule's count and the EMA move only on
   every k-th call, from the mean;
2. global-norm clipping (``grad_clip_norm``, ``optax.clip_by_global_norm``):
   ``g`` if ``norm < max`` else ``g / norm * max``. Not
   ``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``;
3. the lr of the schedule at the count of updates made so far, set on the
   param group (optax evaluates the schedule before it counts the update,
   so with warmup the first update has lr 0);
4. Adam (b1 0.9, b2 0.999, eps 1e-8), or AdamW with optax's decoupled
   decay on every parameter (``weight_decay``);
5. the EMA (``ema_decay = d > 0``, ``with_ema``): a shadow that starts at
   the initial parameters and, after each update, becomes
   ``d * ema + (1 - d) * p``.

The defaults are plain Adam, and ``step()`` is then ``torch.optim.Adam``'s
step and nothing else. :meth:`Optimizer.state_dict` carries the inner
optimizer's state, the accumulator and its counter, the schedule's count
and the EMA shadow, so that a run resumed from a checkpoint continues bit
for bit.

The accumulation, clipping and EMA run in the parameters' dtype in
optax's order of operations, each result rounded to that dtype and each
Python constant rounded to it first, as JAX rounds a weakly typed scalar
(PyTorch would keep it in float32 against a bf16 tensor; against a
float32 tensor it rounds it the same way). Parameters in another dtype
than float32 (``model.dtype="bfloat16"``) take :class:`LowPrecisionAdam`,
optax's ``adam`` op for op (``mu_dtype=None``: the moments in the
parameters' dtype), instead of ``torch.optim.Adam``, which rounds a bf16
step in other places (``lerp_``, ``addcdiv_``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..configs import Config


def make_schedule(cfg: Config) -> Optional[Callable[[int], float]]:
    """count -> lr, the JAX make_optimizer's schedule, or None for a
    constant lr without warmup. Linear warmup from 0 over
    ``warmup_steps``, then cosine, exponential or constant over ``horizon
    - warmup`` updates (``horizon = decay_steps or max_steps``), down to
    ``lr * lr_min_ratio``; the body is fed ``count - warmup``
    (``optax.join_schedules``)."""
    t = cfg.train
    lr, warmup, sched = t.lr, t.warmup_steps, t.lr_schedule
    if sched not in ("constant", "cosine", "exponential"):
        raise ValueError(f"unknown lr_schedule {sched!r}")
    if sched == "constant" and warmup <= 0:
        return None
    horizon = t.decay_steps or t.max_steps
    end = lr * t.lr_min_ratio
    steps = max(1, horizon - warmup)
    if sched == "cosine":
        alpha = end / lr if lr else 0.0

        def body(count):  # optax.cosine_decay_schedule
            c = min(float(count), float(steps))
            cosine = 0.5 * (1 + math.cos(math.pi * c / steps))
            return lr * ((1 - alpha) * cosine + alpha)
    elif sched == "exponential":
        rate = max(end / lr, 1e-8) if lr else 1.0

        def body(count):  # optax.exponential_decay, no staircase or end
            if count <= 0:
                return lr
            return lr * rate ** (count / steps)
    else:
        def body(count):
            return lr
    if warmup <= 0:
        return body

    def schedule(count):  # optax.linear_schedule(0, lr, warmup), then body
        if count < warmup:
            c = min(max(count, 0), warmup)
            return (0.0 - lr) * (1 - c / warmup) + lr
        return body(count - warmup)

    return schedule


B1, B2, EPS = 0.9, 0.999, 1e-8


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d tensor of ``like``'s dtype: JAX rounds a
    weakly typed scalar to the array's dtype before the op."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


class LowPrecisionAdam:
    """optax's ``adam`` (or ``adamw``: ``add_decayed_weights`` after the
    moments) on parameters of a low-precision dtype, op for op in it:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        u = (mu / c1) / (sqrt(nu / c2) + eps)   c_i = 1 - b_i^count (f32,
                                                then rounded to the dtype)
        u += wd p (adamw);  p += -lr u

    The moments are in the parameters' dtype (optax's ``mu_dtype=None``),
    the count an int. ``param_groups[0]["lr"]`` is the lr, as
    ``torch.optim``'s, so :class:`Optimizer` sets a schedule's value on it
    the same way."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 weight_decay: float = 0.0):
        self.params = params
        self.param_groups = [{"lr": lr}]
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        lr = self.param_groups[0]["lr"]
        f32 = torch.float32
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            if p.grad is None:
                continue
            g = p.grad
            c = functools.partial(_const, like=p)
            mu.copy_(c(1 - B1) * g + c(B1) * mu)
            nu.copy_(c(1 - B2) * (g * g) + c(B2) * nu)
            c1, c2 = (1 - torch.tensor(b, dtype=f32) ** self.count
                      for b in (B1, B2))
            u = (mu / c1.to(p.dtype)) / (
                torch.sqrt(nu / c2.to(p.dtype) + c(0.0)) + c(EPS))
            if self.weight_decay > 0:
                u = u + c(self.weight_decay) * p
            p.copy_(p + c(-lr) * u)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu), "lr": self.param_groups[0]["lr"]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.param_groups[0]["lr"] = state["lr"]
        for mine, saved in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for a, b in zip(mine, saved):
                a.copy_(b)


class Optimizer:
    """See the module docstring. ``params`` are the model's parameters in
    a fixed order (that of ``model.parameters()``)."""

    def __init__(self, cfg: Config, params: Iterable[torch.Tensor]):
        t = cfg.train
        self.params: List[torch.Tensor] = list(params)
        self.schedule = make_schedule(cfg)
        # Every parameter float32: torch.optim's Adam; else optax's order.
        kw = dict(lr=t.lr, betas=(B1, B2), eps=EPS, fused=False,
                  capturable=False)
        if any(p.dtype != torch.float32 for p in self.params):
            self.inner = LowPrecisionAdam(self.params, t.lr, t.weight_decay)
        elif t.weight_decay > 0:
            self.inner = torch.optim.AdamW(self.params,
                                           weight_decay=t.weight_decay, **kw)
        else:
            self.inner = torch.optim.Adam(self.params, **kw)
        self.clip = t.grad_clip_norm
        # () -> the squared global norm of the gradients, where they are
        # sharded (``parallel.train_step`` sets it); None: the sum of the
        # squares of this process's gradients.
        self.grad_sq_norm: Optional[Callable[[], torch.Tensor]] = None
        self.accum = max(1, t.grad_accum)
        self.ema_decay = t.ema_decay
        self.count = 0  # updates made: the schedule's count
        self.mini_step = 0  # micro-batches in the accumulator
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accum > 1 else None)
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.ema_decay > 0 else None)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step; -> whether the parameters moved."""
        if self.acc is not None:
            n = self.mini_step
            for a, p in zip(self.acc, self.params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                a.copy_(a + (g - a) / _const(n + 1, a))
            if n < self.accum - 1:
                self.mini_step += 1
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
                a.zero_()
            self.mini_step = 0
        if self.clip > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            if self.grad_sq_norm is not None:
                norm = torch.sqrt(self.grad_sq_norm())
            else:  # optax's global_norm: each sum in the gradient's dtype
                norm = torch.sqrt(sum(g.square().sum() for g in grads))
            keep = norm < self.clip  # on the device: no host sync
            for g in grads:
                clipped = g / norm.to(g.dtype) * _const(self.clip, g)
                g.copy_(torch.where(keep, g, clipped))
        if self.schedule is not None:
            lr = float(self.schedule(self.count))
            for group in self.inner.param_groups:
                group["lr"] = lr
        self.inner.step()
        self.count += 1
        if self.ema is not None:
            d = self.ema_decay
            for e, p in zip(self.ema, self.params):
                e.copy_(_const(d, e) * e + _const(1.0 - d, p) * p)
        return True

    def ema_params(self) -> Optional[List[torch.Tensor]]:
        """The EMA shadow, in the order of ``params``, or None without
        EMA (``get_ema_params``)."""
        return self.ema

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step,
                "acc": None if self.acc is None else list(self.acc),
                "ema": None if self.ema is None else list(self.ema)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for mine, saved in ((self.acc, state["acc"]),
                            (self.ema, state["ema"])):
            if (mine is None) != (saved is None):
                raise ValueError("the checkpoint's optimizer options differ "
                                 "from this run's (grad_accum or ema_decay)")
            for a, b in zip(mine or [], saved or []):
                a.copy_(b)
