"""LyCORIS LoKr (``ai_toolkit_tpu/adapters/lycoris.py`` in PyTorch), as far
as the frozen accuracy-recovery adapter needs it: :func:`factorize`, the
LyCORIS split of a width into two factors, and :func:`lokr_delta`, the
weight ``kron(w1, w2) * scale`` that ``ops.layers.LoKr`` adds to a kernel.
A trainable LoKr or LoHa network, and DoRA, come with the adapters slice
(ROADMAP Queue 1 item 6e)."""

from __future__ import annotations

import math

import torch


def factorize(n: int, factor: int = -1) -> tuple[int, int]:
    """``n = a * c`` with ``a <= c`` and ``a`` the largest divisor up to
    sqrt(n) (or ``a = factor`` when it divides ``n``), as JAX's."""
    if factor > 0 and n % factor == 0:
        return factor, n // factor
    a = math.isqrt(n)
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


def lokr_delta(w1: torch.Tensor, w2: torch.Tensor, scale: torch.Tensor | float, dtype: torch.dtype) -> torch.Tensor:
    """``kron(w1, w2) * scale`` in ``dtype`` over the torch layout (``w1``
    ``[o1, i1]``, ``w2`` ``[o2, i2]`` -> ``[o1 o2, i1 i2]``): each factor is
    cast first and every element is one product, as JAX's
    ``einsum("ab,cd->acbd")`` over its transposed factors computes it."""
    return torch.kron(w1.to(dtype), w2.to(dtype)) * torch.as_tensor(scale).to(dtype)
