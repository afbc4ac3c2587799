"""Optimizers of the flux LoRA job (``ai_toolkit_tpu/train/optimizers.py`` in
PyTorch): AdamW with blockwise-int8 moments (``adamw8bit``) and plain AdamW,
behind optax's global-norm clipping, with optax's chain order and formulas:

    g <- g if |g| < max_norm else (g / |g|) * max_norm      (clip_by_global_norm)
    u <- m_hat / (sqrt(v_hat) + eps)                        (scale_by_adam[_8bit])
    u <- u + wd * p                                         (add_decayed_weights)
    p <- p - lr * u                                         (scale_by_learning_rate)

``torch.nn.utils.clip_grad_norm_`` is not used: it adds 1e-6 to the norm. The
JAX package leaves these elementwise updates to XLA fusion and has no Pallas
kernel for them; here they are plain torch on the parameters' device, updating
the parameters in place.

Low-precision parameters (the bf16 weights of a full fine-tune) follow JAX's
rules of arithmetic, which the tests pin bit for bit: every operation rounds
to its operands' dtype, and a Python scalar that meets an array of a narrower
float dtype is first rounded to that dtype (weak typing: ``0.999`` is ``1.0``
in bf16). So plain ``adamw`` keeps its moments in the parameter dtype and
computes in it, as ``optax.adamw`` does, while ``adamw8bit`` computes in f32
and rounds the parameter once (optax ``apply_updates`` adds in the promoted
dtype); the global norm of bf16 gradients is bf16 (per-tensor f32 sums,
rounded, then added in bf16), as ``optax.global_norm`` gives it. Where XLA
fuses a product into a sum in f32 (the 8-bit moments, the 8-bit update), so
does :func:`_fma`.

The learning rate is a float or a schedule (:func:`lr_schedule`, JAX
``SDTrainProcess._lr_schedule`` over optax's schedules): a function of the
number of updates taken before this one that returns optax's f32 value.
This is the bf16 trap the tests pin: optax's schedule hands the update an
f32 array, which is not weak-typed, where a constant lr is a Python float,
which is; so under a schedule the lr is rounded to f32 first and only then
to the update's dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256


def weak(x: float, dtype: torch.dtype) -> float:
    """The Python scalar ``x`` as JAX applies it to an array of ``dtype``:
    rounded to that dtype first."""
    return torch.tensor(x, dtype=dtype).item()


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as XLA contracts it on the CPU
    (the JAX reference): exact in f64, then rounded to f32."""
    return (a.double() * weak(b, torch.float32) + c.double()).float()


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax ``global_norm``):
    each tensor's squares summed in f32 and rounded to its dtype, the sums
    added in the promoted dtype."""
    return torch.sqrt(sum(torch.sum(torch.square(t).float()).to(t.dtype) for t in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    norm = global_norm(grads)
    keep = norm < weak(max_norm, norm.dtype)
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * weak(max_norm, g.dtype)) for g in grads]


def quantize_blockwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 flat ``[padded]``, f32 block scales ``[padded / BLOCK]``);
    scale = max|block| / 127, values rounded half to even (JAX ``_quantize_blockwise``).
    XLA computes the division by the constant as a product with its f32
    reciprocal, and so does this: the scales, and so the int8 values, agree
    bit for bit."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, -flat.numel() % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) * (1.0 / 127.0)
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q.view(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.view(-1, BLOCK).float() * scale[:, None]).view(-1)
    return flat[: torch.Size(shape).numel()].view(shape)


_F32_TINY = float(np.finfo(np.float32).tiny)


def _f32(x: float) -> float:
    """``x`` rounded to f32, with XLA's flush of f32 subnormals to zero."""
    x = float(np.float32(x))
    return 0.0 if abs(x) < _F32_TINY else x


def _fma32(a: float, b: float, c: float) -> float:
    """``a * b + c`` of f32 operands with one f32 rounding, as XLA contracts it."""
    return _f32(_f32(a) * _f32(b) + _f32(c))


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule`` as the jitted step computes it: the count
    divided as a product with the f32 reciprocal, both products contracted."""
    if steps <= 0:
        return lambda count: _f32(init)
    recip = _f32(_f32(1.0) / _f32(steps))
    return lambda count: _fma32(init - end, _fma32(-min(max(count, 0), steps), recip, 1.0), end)


def _cosine(init: float, steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` in f32, the division by ``steps`` a
    product with its f32 reciprocal as in the jitted step; the cosine is
    rounded from f64, where XLA's is not correctly rounded (within two f32
    ULPs of ``init`` of optax's value)."""
    recip = _f32(_f32(1.0) / _f32(steps))

    def schedule(count: int) -> float:
        x = _f32(_f32(_f32(math.pi) * _f32(min(count, steps))) * recip)
        decay = _f32(0.5 * _f32(1.0 + _f32(math.cos(x))))
        return _f32(_f32(init) * _f32(_f32(_f32(1.0 - alpha) * decay) + _f32(alpha)))
    return schedule


def lr_schedule(name: str | None, base: float, total: int, params: dict | None = None):
    """The lr of JAX ``SDTrainProcess._lr_schedule``: ``base`` itself for
    ``constant``, else a function of the update count giving optax's f32
    value: ``linear`` (to ``end_lr``), ``cosine`` (``alpha``),
    ``cosine_with_restarts`` (``num_cycles`` cosines of ``total //
    num_cycles`` steps), ``constant_with_warmup`` (``num_warmup_steps`` of a
    linear ramp from 0) and ``step`` (times ``gamma`` every ``step_size``)."""
    p = dict(params or {})
    name = (name or "constant").lower()
    if name == "constant":
        return base
    if name == "linear":
        return _linear(base, p.get("end_lr", 0.0), total)
    if name == "cosine":
        return _cosine(base, total, p.get("alpha", 0.0))
    if name == "cosine_with_restarts":
        n = p.get("num_cycles", 3)
        per = max(1, total // n)
        cos = _cosine(base, per)
        return lambda count: cos(count - min(count // per, n - 1) * per)
    if name == "constant_with_warmup":
        warm = p.get("num_warmup_steps", 100)
        ramp = _linear(0.0, base, warm)
        return lambda count: ramp(count) if count < warm else _f32(base)
    if name == "step":
        every, gamma = p.get("step_size", max(1, total // 3)), p.get("gamma", 0.1)
        return lambda count: _f32(_f32(base) * _f32(_f32(gamma) ** (count // every)))
    raise NotImplementedError(f"lr_scheduler '{name}' is not ported (ported: constant, linear, cosine, "
                              f"cosine_with_restarts, constant_with_warmup, step)")


class AdamW:
    """AdamW over a fixed list of parameters; ``eight_bit`` keeps both
    moments as blockwise int8 with f32 block scales, else they are kept in
    the parameters' dtype. ``lr``: a float or a schedule (:func:`lr_schedule`)."""

    def __init__(self, params: list[torch.Tensor], lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float | None = 1.0,
                 eight_bit: bool = False):
        self.params = list(params)
        self.lr = lr if callable(lr) else float(lr)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.max_grad_norm = max_grad_norm
        self.eight_bit = eight_bit
        self.count = 0
        if eight_bit:
            zeros = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.mu = [quantize_blockwise(z) for z in zeros]
            self.nu = [quantize_blockwise(z) for z in zeros]
        else:
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """Clip, update the moments, and update the parameters in place."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.lr(self.count) if callable(self.lr) else self.lr  # optax's schedule count: updates so far
        self.count += 1
        dev = self.params[0].device
        count = torch.tensor(self.count, dtype=torch.float32, device=dev)
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** count
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            decay = p * weak(self.weight_decay, p.dtype)  # optax add_decayed_weights, in p's dtype
            if self.eight_bit:  # scale_by_adam_8bit: f32 throughout
                g = g.float()
                mu = _fma(dequantize_blockwise(*self.mu[i], g.shape), self.b1, g * (1 - self.b1))
                nu = _fma(dequantize_blockwise(*self.nu[i], g.shape), self.b2, g * g * (1 - self.b2))
                self.mu[i], self.nu[i] = quantize_blockwise(mu), quantize_blockwise(nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                # apply_updates adds in f32 and rounds to p's dtype once
                p.copy_(_fma(u + decay, -lr, p.float()).to(p.dtype))
            else:  # optax scale_by_adam in the moments' (the parameter's) dtype
                dt = self.mu[i].dtype
                g = g.to(dt)
                mu = self.mu[i] = g * weak(1 - self.b1, dt) + self.mu[i] * weak(self.b1, dt)
                nu = self.nu[i] = g * g * weak(1 - self.b2, dt) + self.nu[i] * weak(self.b2, dt)
                u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt)) + weak(self.eps, dt))
                p.copy_(p + (u + decay) * weak(-lr, dt))


    def state_dict(self, names: list[str]) -> dict[str, torch.Tensor]:
        """The moments by parameter name (an 8-bit moment as its int8 values
        ``.q`` and block scales ``.scale``) and the update count."""
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for tag, moments in (("mu", self.mu), ("nu", self.nu)):
            for name, m in zip(names, moments):
                if self.eight_bit:
                    out[f"{tag}.{name}.q"], out[f"{tag}.{name}.scale"] = m
                else:
                    out[f"{tag}.{name}"] = m
        return out

    def load_state_dict(self, names: list[str], state: dict[str, torch.Tensor]) -> None:
        """Restore :meth:`state_dict`'s moments and count in place."""
        for tag, moments in (("mu", self.mu), ("nu", self.nu)):
            for i, name in enumerate(names):
                if self.eight_bit:
                    moments[i] = tuple(x.copy_(state[f"{tag}.{name}.{leaf}"])
                                       for x, leaf in zip(moments[i], ("q", "scale")))
                else:
                    moments[i].copy_(state[f"{tag}.{name}"])
        self.count = int(state["count"])


def get_optimizer(name: str, params: list[torch.Tensor], lr,
                  optimizer_params: dict | None = None,
                  max_grad_norm: float | None = 1.0) -> AdamW:
    """The optimizers of the JAX ``get_optimizer`` that this slice takes."""
    name = (name or "adamw").lower()
    p = dict(optimizer_params or {})
    kw = dict(betas=tuple(p.pop("betas", (0.9, 0.999))), eps=p.pop("eps", 1e-8),
              weight_decay=p.pop("weight_decay", 1e-2), max_grad_norm=max_grad_norm)
    if p:
        raise NotImplementedError(f"optimizer_params {sorted(p)} are not ported")
    if name in ("adamw", "adamw_fused"):
        return AdamW(params, lr, **kw)
    if name in ("adamw8bit", "adam8bit", "adamw8", "adam8"):  # all adamw8bit in JAX too
        return AdamW(params, lr, eight_bit=True, **kw)
    raise NotImplementedError(f"optimizer '{name}' comes with a later slice (ported: adamw, adamw8bit)")
