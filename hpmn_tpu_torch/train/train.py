"""The training step — counterpart of ``hpmn_tpu/train/train.py``'s
``make_optimizer``, ``_raw_train_step``, ``fuse_steps`` and
``make_multistep_train``.

    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(cfg, model, opt)
    metrics = step(batch)                 # one forward, backward, Adam step
    multi = make_multistep_train(cfg, model, opt)
    metrics = multi(batches)              # k steps, the last step's metrics

The step runs where the model and the batch are (the card, by the defaults
of ``init_model`` and ``batch_from_numpy``). With ``use_pallas`` its scans go
through the CUDA scan kernels forward and backward and its readout through
the CUDA readout kernel. The ``train()`` driver, its CLI, eval and
checkpoints wait (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence

import torch

from ..configs import Config
from ..data.schema import Batch
from ..models.model import HPMNModel, loss_fn

_PLAIN_ADAM = dict(lr_schedule="constant", warmup_steps=0,
                   grad_clip_norm=0.0, weight_decay=0.0, grad_accum=1,
                   ema_decay=0.0)


def make_optimizer(cfg: Config,
                   params: Iterable[torch.Tensor]) -> torch.optim.Adam:
    """Plain Adam at ``cfg.train.lr`` (b1 0.9, b2 0.999, eps 1e-8): the
    update of ``optax.adam``, which the JAX config's defaults give. A
    schedule, clipping, weight decay, accumulation or EMA raises."""
    for field, plain in _PLAIN_ADAM.items():
        value = getattr(cfg.train, field)
        if value != plain:
            raise NotImplementedError(
                f"train.{field}={value!r} is not ported yet; only plain "
                "Adam is (ROADMAP.md)")
    return torch.optim.Adam(params, lr=cfg.train.lr, betas=(0.9, 0.999),
                            eps=1e-8, fused=False, capturable=False)


def make_train_step(cfg: Config, model: HPMNModel,
                    opt: torch.optim.Optimizer,
                    ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """-> step(batch) -> metrics (bce, cov_reg, l2, loss; detached tensors
    on the model's device). One forward, backward and optimizer step, as
    the JAX ``_raw_train_step``; the parameters are updated in place."""

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, cfg, batch)
        loss.backward()
        opt.step()
        del metrics["logits"]
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_multistep_train(cfg: Config, model: HPMNModel,
                         opt: torch.optim.Optimizer,
                         ) -> Callable[[Sequence[Batch]],
                                       Dict[str, torch.Tensor]]:
    """-> multistep(batches) -> the last step's metrics: k = len(batches)
    steps, one per batch, in order (the JAX ``fuse_steps``, there one
    dispatch of a ``lax.scan``; here a Python loop)."""
    step = make_train_step(cfg, model, opt)

    def multistep(batches: Sequence[Batch]) -> Dict[str, torch.Tensor]:
        if not batches:
            raise ValueError("make_multistep_train needs at least one batch")
        for batch in batches:
            metrics = step(batch)
        return metrics

    return multistep
