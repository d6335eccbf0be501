"""The model dtypes the port takes, and JAX's type promotion at a product.

``model.dtype`` is the parameters' dtype: float32 or bfloat16, as in
``hpmn_tpu/models/model.py``, which also takes float16 (the port does not:
``model.check_supported`` raises). JAX promotes the operands of ``a @ b``
and ``jnp.einsum`` to their common dtype (f32 @ bf16 -> f32, bf16 @ bf16 ->
bf16); ``torch.matmul`` and ``torch.einsum`` raise on two dtypes. A bf16
model meets float32 operands where a kernel path returns float32 (the
use_pallas scans' memory and states, the readout's read) and where a
serving store holds its memory in float32; the products there go through
:func:`matmul` and :func:`einsum`. Elementwise ops and ``torch.cat``
already promote as JAX does.
"""

from __future__ import annotations

import functools

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, both operands in their promoted dtype."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """torch.einsum, every operand in their promoted dtype."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(spec, *(o.to(dt) for o in operands))
