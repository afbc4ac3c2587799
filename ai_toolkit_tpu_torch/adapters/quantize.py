"""Weight-only quantization of a frozen base (``ai_toolkit_tpu/adapters/quantize.py``
in PyTorch): fp8 (e4m3) or int8 storage with one f32 scale per output channel.

:func:`quantize_params` selects what the JAX function selects: every 2-D
kernel (a ``Linear``) and 3-D kernel (an MoE expert ``Bank``) of at least
``2**16`` elements whose module name matches none of the exclude patterns
(``DEFAULT_EXCLUDE``, the JAX list over the port's module names). The chosen
modules keep ``qvalue`` / ``qscale`` in place of their weight and dequantize
it to the compute dtype next to the product (``ops/layers.QuantizedWeight``);
a LoRA composes on top. The 4-bit qtypes (``qint4``, ``uint4``, ``nvfp4``, ...)
and ``quantize_te`` raise.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import QuantizedWeight


def quantize_kernel_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[.., in, out]`` -> (int8, per-output-channel f32 scale ``[.., 1, out]``)."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-2, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def quantize_kernel_fp8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float8 e4m3 storage, per-output-channel scale to the e4m3 maximum (448)."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-2, keepdim=True) / 448.0).clamp_min(1e-12)
    return (wf / scale).to(torch.float8_e4m3fn), scale


_QTYPES = {
    "qint8": quantize_kernel_int8, "int8": quantize_kernel_int8, "uint8": quantize_kernel_int8,
    "qfloat8": quantize_kernel_fp8, "float8": quantize_kernel_fp8, "fp8": quantize_kernel_fp8,
    "float8_e4m3fn": quantize_kernel_fp8,
}
_UNPORTED_QTYPES = ("qint4", "int4", "uint4", "uint4wo", "nvfp4", "uint3", "uint2")

# JAX DEFAULT_EXCLUDE (norm, embedding, bias, mod/, _mod/, time_in, guidance_in,
# vector_in, final_) over the port's module names: norms, embeddings and biases
# are never Linear weights here; the modulations are ``*_mod.lin`` (double
# blocks) and ``modulation.lin`` (single blocks); the final layer is ``final_layer``
DEFAULT_EXCLUDE = [r"norm", r"embed", r"_mod\.", r"modulation\.", r"time_in", r"guidance_in",
                   r"vector_in", r"final_"]


def get_quantize_kernel(qtype: str):
    q = str(qtype).lower()
    if q in _UNPORTED_QTYPES:
        raise NotImplementedError(f"qtype '{qtype}': 4-bit and narrower storage comes with slice G "
                                  f"(ported: {sorted(_QTYPES)})")
    fn = _QTYPES.get(q)
    if fn is None:
        raise ValueError(f"unknown qtype {qtype!r} (ported: {sorted(_QTYPES)})")
    return fn


@torch.no_grad()
def quantize_params(module: nn.Module, exclude_patterns: list[str] | None = None,
                    min_size: int = 2**16, qtype: str = "qint8") -> list[str]:
    """Quantize the selected weights of ``module`` in place; returns their
    module names in module order."""
    exclude = DEFAULT_EXCLUDE if exclude_patterns is None else exclude_patterns
    fn = get_quantize_kernel(qtype)
    done = []
    for name, mod in module.named_modules():
        if not isinstance(mod, QuantizedWeight) or mod.qvalue is not None:
            continue
        if mod.weight.dim() in (2, 3) and mod.weight.numel() >= min_size \
                and not any(re.search(p, name) for p in exclude):
            mod.quantize_(fn)
            done.append(name)
    return done


def quantized_count(module: nn.Module) -> int:
    """The weights of ``module`` held quantized."""
    return sum(isinstance(m, QuantizedWeight) and m.qvalue is not None for m in module.modules())


def quantized_bytes(module: nn.Module) -> int:
    """Bytes of the quantized values and scales held by ``module``."""
    return sum(t.numel() * t.element_size() for m in module.modules()
               if isinstance(m, QuantizedWeight) and m.qvalue is not None for t in (m.qvalue, m.qscale))
