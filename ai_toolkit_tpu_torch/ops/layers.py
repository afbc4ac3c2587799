"""Core layers of the port (``ai_toolkit_tpu/ops/layers.py`` in PyTorch).

Weights use the torch layouts that checkpoints ship in: ``Linear.weight`` is
``[out, in]`` (the JAX kernel is ``[in, out]``) and ``Conv.weight`` is
``[out, in/groups, kh, kw]`` (JAX: HWIO). Norm scales and biases are f32, as in
the JAX package. Modules are built empty on an explicit ``device``/``dtype``
and filled by :func:`init_parameters` from an explicit ``torch.Generator``,
with the JAX package's initializers (flax ``lecun_normal`` kernels, zero
biases, unit norm scales). ``Linear`` carries the overlays that the JAX
``Linear`` reads from its variable collections (JAX ``ops/layers.py``
:84-145), in JAX's order: a :class:`LoKr` (``lokr``) and then a
:class:`LoHa` (``loha``) add their deltas to the (dequantized) kernel; then
a :class:`DoRA` (``dora``) rescales the columns of kernel plus its low-rank
delta, or a :class:`LoRA` (``lora``, JAX ``_lora_delta``) adds its delta to
the product. A :class:`LoRM` (``lorm``) replaces the kernel, whose weight
is freed. ``Linear`` also carries its weight-only quantized base
(:class:`QuantizedWeight`) and a frozen accuracy-recovery adapter
(``Linear.ara``, the ARA of a quantized base): a :class:`LoRA`, whose
factors stack with a trainable LoRA's by the exact rank-concat of JAX
``concat_loras`` (each scale folded into its ``b``), or a frozen
:class:`LoKr`. ``Conv`` carries a :class:`ConvLoRA` (JAX ``Conv``'s
``lora``, :186-208). A :class:`Ctrl` (``ctrl``, JAX :95-101, 145-148) is a
trainable input-channel expansion: the trailing ``extra_in`` input features
bypass the (dequantized) weight and go through its own ``w`` (and ``b``),
added after the product and its LoRA, which sees the base features alone.
:meth:`Linear.keep_f32_master` makes a layer's weight an f32 master copy
that the forward casts to its compute dtype, as JAX casts an f32 overlay.

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


def fold_scale(lora: "LoRA") -> tuple[torch.Tensor, torch.Tensor]:
    """``(a, b * scale)`` in f32: the factors of JAX ``concat_loras``'s fold."""
    return lora.a, lora.b * lora.scale


class LoKr(nn.Module):
    """A LyCORIS LoKr overlay (JAX ``lokr`` collection): ``delta = kron(w1,
    w2) * scale`` in the torch layout ``[out, in]`` (``w1`` ``[o1, i1]``,
    ``w2`` ``[o2, i2]``), each factor and the scale cast to the layer's dtype
    before the product, added to its kernel. The three are f32 parameters: a
    trainable network (``adapters/lycoris.build_lokr``) trains all of them,
    as JAX trains the whole leaf; an accuracy-recovery adapter's are frozen."""

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor, scale: float = 1.0):
        super().__init__()
        self.w1 = nn.Parameter(w1.float())
        self.w2 = nn.Parameter(w2.float())
        self.scale = nn.Parameter(torch.tensor(float(scale), device=w1.device))

    def delta(self, dtype: torch.dtype) -> torch.Tensor:
        from ai_toolkit_tpu_torch.adapters.lycoris import lokr_delta

        return lokr_delta(self.w1, self.w2, self.scale, dtype)


class LoHa(nn.Module):
    """A LyCORIS LoHa overlay (JAX ``loha`` collection): ``delta = (w1a @ w1b)
    * (w2a @ w2b) * scale`` in the JAX layout ``[in, out]`` (``w1a`` / ``w2a``
    ``[in, r]``, ``w1b`` / ``w2b`` ``[r, out]``), each factor and the scale
    cast to the layer's dtype first, added transposed to the kernel. f32
    parameters, all trained."""

    def __init__(self, in_features: int, rank: int, out_features: int, scale: float, *, device=None):
        super().__init__()
        for name, shape in (("w1a", (in_features, rank)), ("w1b", (rank, out_features)),
                            ("w2a", (in_features, rank)), ("w2b", (rank, out_features))):
            setattr(self, name, nn.Parameter(torch.zeros(shape, device=device, dtype=torch.float32)))
        self.scale = nn.Parameter(torch.tensor(float(scale), device=device, dtype=torch.float32))

    def delta(self, dtype: torch.dtype) -> torch.Tensor:
        h1 = self.w1a.to(dtype) @ self.w1b.to(dtype)
        h2 = self.w2a.to(dtype) @ self.w2b.to(dtype)
        return (h1 * h2 * self.scale.to(dtype)).t()


class DoRA(nn.Module):
    """DoRA (JAX ``dora`` collection): LoRA factors ``a`` ``[in, r]``, ``b``
    ``[r, out]``, ``scale`` and a per-output ``magnitude``, f32 parameters.
    The kernel becomes ``W' = W + (a @ b) * scale`` in f32 (the factors and
    the scale rounded to the layer's dtype first), each output's column of
    ``W'`` scaled to ``magnitude / max(|W'_col|, 1e-6)`` (the norm over the
    input axis), cast back to the layer's dtype; no LoRA delta follows."""

    def __init__(self, in_features: int, rank: int, out_features: int, scale: float, *, device=None):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(in_features, rank, device=device, dtype=torch.float32))
        self.b = nn.Parameter(torch.zeros(rank, out_features, device=device, dtype=torch.float32))
        self.scale = nn.Parameter(torch.tensor(float(scale), device=device, dtype=torch.float32))
        self.magnitude = nn.Parameter(torch.zeros(out_features, device=device, dtype=torch.float32))

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        dt = w.dtype
        delta = (self.a.to(dt).float() @ self.b.to(dt).float()) * self.scale.to(dt).float()
        v = w.float() + delta.t()
        norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        return (v * (self.magnitude[:, None] / torch.clamp(norm, min=1e-6))).to(dt)


class LoRM(nn.Module):
    """LoRM factors (JAX ``lorm`` collection, ``adapters/lorm.py``): ``a``
    ``[in, r]`` and ``b`` ``[r, out]``, f32 parameters that replace the
    kernel: ``y = (x @ a) @ b + bias`` in the layer's dtype."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a.float())
        self.b = nn.Parameter(b.float())


class Ctrl(nn.Module):
    """The input-channel expansion (JAX ``ctrl`` collection): ``w`` ``[extra_in,
    out]`` in the JAX layout and an optional ``b`` ``[out]``, f32 parameters
    cast to the layer's dtype; ``y += x[..., -extra_in:] @ w (+ b)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w.detach().float().clone())
        self.b = None if b is None else nn.Parameter(b.detach().float().clone())

    @property
    def extra_in(self) -> int:
        return self.w.shape[0]


class QuantizedWeight(nn.Module):
    """A weight that ``adapters/quantize.py`` may move to weight-only storage:
    ``qvalue`` (fp8 e4m3 or int8) and ``qscale`` (f32, one per output
    channel) replace the ``weight`` parameter, and :meth:`dequantized` gives
    ``qvalue * qscale`` in the compute dtype next to the product (JAX:
    the ``quant`` collection, ``qv.astype(dtype) * qs.astype(dtype)``), or
    the weight itself, an f32 master cast to the compute dtype where
    :meth:`Linear.keep_f32_master` made one."""

    def _init_quant(self) -> None:
        self.register_buffer("qvalue", None)
        self.register_buffer("qscale", None)
        self._qdtype: torch.dtype | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        if self._qdtype is not None:
            return self._qdtype
        return self.weight.dtype

    @property
    def stored_weight(self) -> torch.Tensor:
        """The tensor that holds the weight (parameter or quantized values)."""
        return self.weight if self.qvalue is None else self.qvalue

    def dequantized(self) -> torch.Tensor:
        if self.qvalue is None:  # an f32 master (Linear.keep_f32_master) in its compute dtype
            w = self.weight
            return w if w is None or self._qdtype is None else w.to(self._qdtype)
        dt = self._qdtype
        return self.qvalue.to(dt) * self.qscale.to(dt)

    def _set_quantized(self, qvalue: torch.Tensor, qscale: torch.Tensor) -> None:
        self._qdtype = self.weight.dtype
        self.weight = None
        self.qvalue, self.qscale = qvalue, qscale


class Linear(QuantizedWeight):
    """``y = x W^T + b``; ``x`` is cast to the weight dtype first (JAX:
    ``x.astype(self.dtype)``). The overlays (module docstring) act in JAX's
    order, on a quantized weight too. ``self.ara`` is a frozen
    accuracy-recovery adapter: a :class:`LoKr` changes the kernel; a
    :class:`LoRA` adds its delta, rank-concatenated with ``self.lora``'s when
    both are there (one product, scale 1)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device, dtype=dtype))
                     if bias else None)
        self.lora: LoRA | None = None
        self.ara: LoRA | LoKr | None = None
        self.lokr: LoKr | None = None
        self.loha: LoHa | None = None
        self.dora: DoRA | None = None
        self.lorm: LoRM | None = None
        self.ctrl: Ctrl | None = None
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

    def keep_f32_master(self) -> None:
        """Weight and bias become f32 parameters that the forward casts to the
        layer's compute dtype (JAX trains such a grafted leaf in f32 and its
        ``Linear`` casts it to ``self.dtype``)."""
        self._qdtype = self.compute_dtype
        self.weight = nn.Parameter(self.weight.detach().float(), requires_grad=self.weight.requires_grad)
        if self.bias is not None:
            self.bias = nn.Parameter(self.bias.detach().float(), requires_grad=self.bias.requires_grad)

    def replace_by_lorm(self, lorm: LoRM) -> None:
        """The factors take the kernel's place and the weight (or its
        quantized values) is freed, as JAX deletes the kernel leaf."""
        self._qdtype = self.compute_dtype
        self.weight = None
        self.qvalue = self.qscale = None
        self.lorm = lorm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ctrl is not None:
            return self._forward_ctrl(x)
        if self.lorm is not None:
            dt = self._qdtype
            y = (x.to(dt) @ self.lorm.a.to(dt)) @ self.lorm.b.to(dt)
            return y if self.bias is None else y + self.bias.to(dt)
        w = self.dequantized()
        ara = self.ara
        lokr = self.lokr
        if isinstance(ara, LoKr):
            lokr, ara = ara, None
        if lokr is not None:
            w = w + lokr.delta(w.dtype)
        if self.loha is not None:
            w = w + self.loha.delta(w.dtype)
        if self.dora is not None:
            w = self.dora.weight(w)
        x = x.to(w.dtype)
        y = F.linear(x, w, None if self.bias is None else self.bias.to(w.dtype))
        if self.dora is not None:
            return y
        if ara is None:
            return y if self.lora is None else self.lora(x, y)
        if _Multiplier.value is not None:
            raise NotImplementedError("a LoRA multiplier beside an accuracy-recovery adapter is not ported")
        if self.lora is None:
            return ara(x, y)
        # the frozen and the trained factors as one rank-concatenated LoRA (JAX merge_variables)
        a0, b0 = fold_scale(ara)
        a1, b1 = fold_scale(self.lora)
        dt = x.dtype
        return y + (x @ torch.cat([a0, a1], dim=-1).to(dt)) @ torch.cat([b0, b1], dim=0).to(dt)

    def _forward_ctrl(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's order: the base features through the (dequantized) weight and
        the LoRA, then the trailing features through the expansion, then its
        bias, then the layer's."""
        others = [n for n in ("ara", "lokr", "loha", "dora", "lorm") if getattr(self, n) is not None]
        if others:
            raise NotImplementedError(f"an input expansion (ctrl) beside {others} on one Linear is not ported "
                                      f"(the control_lora and i2v jobs keep every network off the expanded layer)")
        w = self.dequantized()
        dt = w.dtype
        x = x.to(dt)
        extra = self.ctrl.extra_in
        x, x_ctrl = x[..., :-extra], x[..., -extra:]
        y = F.linear(x, w)
        if self.lora is not None:
            y = self.lora(x, y)
        y = y + x_ctrl @ self.ctrl.w.to(dt)
        if self.ctrl.b is not None:
            y = y + self.ctrl.b.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class ConvLoRA(nn.Module):
    """Conv LoRA (LoCon; JAX ``Conv``'s ``lora`` collection): ``a`` ``[r, in,
    kh, kw]``, a conv at the layer's stride and padding, then ``b`` ``[out, r,
    1, 1]``, a 1x1 conv, times ``scale``; the factors in the torch (and kohya
    file) layout, f32 parameters cast to the layer's dtype. The multiplier
    acts as on :class:`LoRA`."""

    def __init__(self, in_channels: int, rank: int, out_channels: int, kernel_size: int, scale: float, *,
                 device=None):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(rank, in_channels, kernel_size, kernel_size, device=device,
                                          dtype=torch.float32))
        self.b = nn.Parameter(torch.zeros(out_channels, rank, 1, 1, device=device, dtype=torch.float32))
        self.scale = nn.Parameter(torch.tensor(float(scale), device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor, y: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
        """``x``, ``y``: NCHW views of the layer's input and its product."""
        mult = _Multiplier.value
        if mult is ADAPTER_OFF:
            return y
        dt = x.dtype
        delta = F.conv2d(F.conv2d(x, self.a.to(dt), stride=stride, padding=padding), self.b.to(dt))
        scale = (self.scale if mult is None else self.scale * mult).to(dt)
        if scale.dim() > 0:  # per-sample [B]
            scale = scale.reshape(scale.shape + (1,) * (delta.dim() - scale.dim()))
        return y + delta * scale


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
        self.lora: ConvLoRA | None = None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        if self.lora is None:
            y = F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)
        else:  # JAX: the product, its LoRA delta, then the bias
            y = self.lora(x, F.conv2d(x, self.weight, stride=self.stride, padding=self.padding),
                          self.stride, self.padding)
            if self.bias is not None:
                y = y + self.bias[:, None, None]
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
    """Group norm over NHWC ``[..., C]`` in f32 with ``min(groups, C)`` groups
    (JAX ``layers.py:263``; 32 by default)."""

    def __init__(self, channels: int, eps: float = 1e-6, *, groups: int = 32, device=None):
        super().__init__()
        self.groups = min(groups, channels)
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
