"""Core layers of the port (``ai_toolkit_tpu/ops/layers.py`` in PyTorch).

Weights use the torch layouts that checkpoints ship in: ``Linear.weight`` is
``[out, in]`` (the JAX kernel is ``[in, out]``) and ``Conv.weight`` is
``[out, in/groups, kh, kw]`` (JAX: HWIO). Norm scales and biases are f32, as in
the JAX package. Modules are built empty on an explicit ``device``/``dtype``
and filled by :func:`init_parameters` from an explicit ``torch.Generator``,
with the JAX package's initializers (flax ``lecun_normal`` kernels, zero
biases, unit norm scales). ``Linear`` carries the LoRA overlay of the JAX
``Linear`` (``_lora_delta``) and its weight-only quantized base
(:class:`QuantizedWeight`); its ctrl / LyCORIS overlays are not ported yet.

The LoRA multiplier (JAX ``adapters/lora.scale_lora``, which the slider
losses apply to the ``lora`` tree) is set for a block of code by
:func:`lora_multiplier`: a scalar or a per-sample ``[B]`` vector that every
overlay's ``scale`` is multiplied by, or :data:`ADAPTER_OFF`, the base
forward (JAX drops the ``lora`` collection). A block that is recomputed in
the backward goes through :func:`lora_checkpoint`, which hands the
recomputation the multiplier its forward ran under.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Fill ``w`` in place; drawn in f32, then cast to ``w``'s dtype."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    w.copy_(tmp)


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init of every submodule that defines ``init_weights(generator)``."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)
    return module


ADAPTER_OFF = "off"  # the lora_multiplier that gives the base forward


class _Multiplier:
    value: float | torch.Tensor | str | None = None  # None: every overlay as it is


@contextlib.contextmanager
def lora_multiplier(mult: float | torch.Tensor | str | None):
    """Every :class:`LoRA` overlay runs at ``scale * mult`` inside the block
    (JAX ``scale_lora``): ``mult`` a Python float, a ``[B]`` f32 tensor (one
    multiplier per sample), :data:`ADAPTER_OFF` or None (no multiplier)."""
    prev = _Multiplier.value
    _Multiplier.value = mult
    try:
        yield
    finally:
        _Multiplier.value = prev


def lora_checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
    **kwargs)`` whose recomputation in the backward runs under the LoRA
    multiplier that the forward ran under: the backward comes after the
    forward's :func:`lora_multiplier` block has exited, and a different
    multiplier there would give silently wrong gradients."""
    mult = _Multiplier.value

    def run(*a):
        with lora_multiplier(mult):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


class LoRA(nn.Module):
    """Low-rank overlay ``y += ((x @ a) @ b) * scale`` (JAX ``ops/layers.py``
    ``_lora_delta``): ``a`` ``[in, r]``, ``b`` ``[r, out]`` and the scalar
    ``scale`` are f32 master parameters, cast to the layer's dtype in the
    forward. ``scale`` is a parameter because the JAX package trains the whole
    ``{a, b, scale}`` leaf. Under :func:`lora_multiplier` the scale is
    ``scale * mult`` in f32 before the cast, and a ``[B]`` one is broadcast
    over the trailing dims of the delta, as JAX applies a ``scale_lora``
    tree; under :data:`ADAPTER_OFF` the overlay adds nothing."""

    def __init__(self, in_features: int, rank: int, out_features: int, scale: float, *,
                 device=None):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(in_features, rank, device=device, dtype=torch.float32))
        self.b = nn.Parameter(torch.zeros(rank, out_features, device=device, dtype=torch.float32))
        self.scale = nn.Parameter(torch.tensor(float(scale), device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mult = _Multiplier.value
        if mult is ADAPTER_OFF:
            return y
        dt = x.dtype
        delta = (x @ self.a.to(dt)) @ self.b.to(dt)
        scale = (self.scale if mult is None else self.scale * mult).to(dt)
        if scale.dim() > 0:  # per-sample [B]
            scale = scale.reshape(scale.shape + (1,) * (delta.dim() - scale.dim()))
        return y + delta * scale


class QuantizedWeight(nn.Module):
    """A weight that ``adapters/quantize.py`` may move to weight-only storage:
    ``qvalue`` (fp8 e4m3 or int8) and ``qscale`` (f32, one per output
    channel) replace the ``weight`` parameter, and :meth:`dequantized` gives
    ``qvalue * qscale`` in the compute dtype next to the product (JAX:
    the ``quant`` collection, ``qv.astype(dtype) * qs.astype(dtype)``)."""

    def _init_quant(self) -> None:
        self.register_buffer("qvalue", None)
        self.register_buffer("qscale", None)
        self._qdtype: torch.dtype | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.weight.dtype if self.qvalue is None else self._qdtype

    @property
    def stored_weight(self) -> torch.Tensor:
        """The tensor that holds the weight (parameter or quantized values)."""
        return self.weight if self.qvalue is None else self.qvalue

    def dequantized(self) -> torch.Tensor:
        if self.qvalue is None:
            return self.weight
        dt = self._qdtype
        return self.qvalue.to(dt) * self.qscale.to(dt)

    def _set_quantized(self, qvalue: torch.Tensor, qscale: torch.Tensor) -> None:
        self._qdtype = self.weight.dtype
        self.weight = None
        self.qvalue, self.qscale = qvalue, qscale


class Linear(QuantizedWeight):
    """``y = x W^T + b``; ``x`` is cast to the weight dtype first (JAX:
    ``x.astype(self.dtype)``). With a :class:`LoRA` in ``self.lora``
    (``adapters/lora.py``) its delta is added, also on a quantized weight."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device, dtype=dtype))
                     if bias else None)
        self.lora: LoRA | None = None
        self._init_quant()

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            self.bias.zero_()

    def quantize_(self, fn) -> None:
        """``fn(kernel [in, out]) -> (qvalue [in, out], qscale [1, out])`` in the
        JAX layout; stored transposed, ``[out, in]`` and ``[out, 1]``."""
        q, s = fn(self.weight.detach().t())
        self._set_quantized(q.t().contiguous(), s.t().contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.dequantized()
        x = x.to(w.dtype)
        y = F.linear(x, w, self.bias)
        return y if self.lora is None else self.lora(x, y)


class Conv(nn.Module):
    """2-D convolution with NHWC tensors at its boundary, as in the JAX
    package. The NCHW view it hands to ``conv2d`` is channels-last in memory,
    so no copy is made for an NHWC-contiguous input."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, *,
                 stride: int = 1, padding: int | None = None, bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding  # default: "SAME" at stride 1
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size,
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.weight.dtype).permute(0, 3, 1, 2), self.weight, self.bias,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class RMSNorm(nn.Module):
    """RMS norm in f32, cast back to the input dtype. ``weight_name`` is the
    checkpoint's name for the scale: ``scale`` (BFL flux QK norm) or
    ``weight`` (transformers T5)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, weight_name: str = "weight", device=None):
        super().__init__()
        self.eps = eps
        self.weight_name = weight_name
        self.register_parameter(weight_name, nn.Parameter(
            torch.empty(dim, device=device, dtype=torch.float32)))

    def init_weights(self, generator: torch.Generator) -> None:
        getattr(self, self.weight_name).fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * getattr(self, self.weight_name)).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm over the last dim in f32, cast back to the input dtype;
    ``affine=False`` is flux's parameter-free norm."""

    def __init__(self, dim: int, eps: float = 1e-6, affine: bool = True, *, device=None):
        super().__init__()
        self.dim, self.eps = dim, eps
        if affine:
            self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=torch.float32))
            self.bias = nn.Parameter(torch.empty(dim, device=device, dtype=torch.float32))
        else:
            self.weight = self.bias = None

    def init_weights(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, self.eps).to(x.dtype)


class GroupNorm(nn.Module):
    """Group norm over NHWC ``[..., C]`` in f32 with ``min(32, C)`` groups
    (JAX ``layers.py:263``)."""

    def __init__(self, channels: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.groups = min(32, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(channels, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xg = x.float().reshape(x.shape[0], -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)


class Embedding(nn.Module):
    """Lookup table kept in f32 (JAX keeps embeddings f32), normal(std) init."""

    def __init__(self, num: int, dim: int, std: float, *, device=None):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(num, dim, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class AdaLayerNormZero(nn.Module):
    """DiT adaLN-Zero: conditioning -> ``n_mods`` (shift, scale, gate) chunks.
    The projection is ``lin`` (BFL ``Modulation.lin``)."""

    def __init__(self, dim: int, n_mods: int = 6, *, device=None, dtype=None):
        super().__init__()
        self.n_mods = n_mods
        self.lin = Linear(dim, dim * n_mods, device=device, dtype=dtype)

    def forward(self, cond: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.lin(F.silu(cond.to(self.lin.compute_dtype))).chunk(self.n_mods, dim=-1)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x * (1 + scale) + shift`` broadcast over the sequence axis."""
    while shift.dim() < x.dim():
        shift, scale = shift.unsqueeze(1), scale.unsqueeze(1)
    return x * (1.0 + scale) + shift
