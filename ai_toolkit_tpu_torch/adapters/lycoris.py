"""LyCORIS networks and DoRA on the port's ``Linear`` layers
(``ai_toolkit_tpu/adapters/lycoris.py`` in PyTorch).

The JAX package keeps each as a variable collection that its ``Linear``
reads; here each adapted ``ops.layers.Linear`` carries the overlay module in
its slot (``.lokr``, ``.loha``, ``.dora``), and a network is addressed as
``{module name: overlay}``, as ``adapters/lora.build_lora`` does for LoRA.
The targets are those of LoRA (``adapters/lora._matches`` over the port's
module names); draws come from an explicit ``torch.Generator``; the inits are
JAX's:

- LoKr: ``w1`` ~ N(0, ``init_std``), ``w2`` = 0, ``scale`` = 1, the factors
  from :func:`factorize` of each width (``lokr_factor``);
- LoHa: ``w1a``, ``w1b``, ``w2a`` ~ N(0, ``init_std``), ``w2b`` = 0,
  ``scale`` = alpha / rank;
- DoRA: ``a`` ~ N(0, ``init_std``), ``b`` = 0, ``scale`` = alpha / rank and
  ``magnitude`` the column norms of the (dequantized) base kernel.

JAX's ``build_lokr`` / ``build_loha`` / ``build_dora`` take 2-D kernels only,
so on a DiT whose blocks JAX scans (every full size) they adapt no block
(ROADMAP Queue 3). The port adapts every targeted block ``Linear``, as JAX
does with ``scan_blocks=False``. The frozen LoKr of an accuracy-recovery
adapter is the same :class:`~ai_toolkit_tpu_torch.ops.layers.LoKr` with its
parameters frozen."""

from __future__ import annotations

import math

import torch
from torch import nn

from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, _matches
from ai_toolkit_tpu_torch.ops.layers import DoRA, Linear, LoHa, LoKr


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


def _targets(model: nn.Module, spec: LoRASpec) -> list[tuple[str, Linear]]:
    return [(name, mod) for name, mod in model.named_modules() if isinstance(mod, Linear) and _matches(name, spec)]


def build_lokr(model: nn.Module, spec: LoRASpec, generator: torch.Generator, factor: int = -1) -> dict[str, LoKr]:
    """A trainable LoKr on every matching ``Linear``, in module order: the
    input width splits into ``i1 * i2`` and the output's into ``o1 * o2``
    (:func:`factorize`); ``w1`` ``[o1, i1]`` ~ N(0, ``init_std``), ``w2``
    ``[o2, i2]`` = 0 (a zero delta at init), ``scale`` = 1 (JAX's full-rank
    LoKr; its ``w1`` is this one transposed)."""
    out: dict[str, LoKr] = {}
    for name, mod in _targets(model, spec):
        i1, i2 = factorize(mod.in_features, factor)
        o1, o2 = factorize(mod.out_features, factor)
        dev = mod.stored_weight.device
        w1 = torch.empty(o1, i1, device=dev).normal_(0.0, spec.init_std, generator=generator)
        mod.lokr = out[name] = LoKr(w1, torch.zeros(o2, i2, device=dev))
    return out


def build_loha(model: nn.Module, spec: LoRASpec, generator: torch.Generator) -> dict[str, LoHa]:
    """A LoHa of ``spec.rank`` on every matching ``Linear``: ``w1a``, ``w1b``,
    ``w2a`` ~ N(0, ``init_std``), ``w2b`` = 0 (a zero delta at init), ``scale``
    = alpha / rank."""
    out: dict[str, LoHa] = {}
    for name, mod in _targets(model, spec):
        m = LoHa(mod.in_features, spec.rank, mod.out_features, spec.alpha / spec.rank,
                 device=mod.stored_weight.device)
        with torch.no_grad():
            for p in (m.w1a, m.w1b, m.w2a):
                p.normal_(0.0, spec.init_std, generator=generator)
        mod.loha = out[name] = m
    return out


def build_dora(model: nn.Module, spec: LoRASpec, generator: torch.Generator) -> dict[str, DoRA]:
    """A DoRA of ``spec.rank`` on every matching ``Linear``: ``a`` ~ N(0,
    ``init_std``), ``b`` = 0, ``scale`` = alpha / rank, ``magnitude`` the
    norm of each output's column of the base kernel (dequantized on a
    quantized base), in f32."""
    out: dict[str, DoRA] = {}
    for name, mod in _targets(model, spec):
        m = DoRA(mod.in_features, spec.rank, mod.out_features, spec.alpha / spec.rank,
                 device=mod.stored_weight.device)
        with torch.no_grad():
            m.a.normal_(0.0, spec.init_std, generator=generator)
            m.magnitude.copy_(torch.linalg.vector_norm(mod.dequantized().float(), dim=1))
        mod.dora = out[name] = m
    return out


BUILD_FNS = {"lokr": build_lokr, "loha": build_loha, "dora": build_dora}
