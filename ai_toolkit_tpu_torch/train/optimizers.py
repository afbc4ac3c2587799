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
"""

from __future__ import annotations

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


class AdamW:
    """AdamW over a fixed list of parameters; ``eight_bit`` keeps both
    moments as blockwise int8 with f32 block scales, else they are kept in
    the parameters' dtype."""

    def __init__(self, params: list[torch.Tensor], lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float | None = 1.0,
                 eight_bit: bool = False):
        self.params = list(params)
        self.lr, self.eps, self.weight_decay = float(lr), float(eps), float(weight_decay)
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
                p.copy_(_fma(u + decay, -self.lr, p.float()).to(p.dtype))
            else:  # optax scale_by_adam in the moments' (the parameter's) dtype
                dt = self.mu[i].dtype
                g = g.to(dt)
                mu = self.mu[i] = g * weak(1 - self.b1, dt) + self.mu[i] * weak(self.b1, dt)
                nu = self.nu[i] = g * g * weak(1 - self.b2, dt) + self.nu[i] * weak(self.b2, dt)
                u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt)) + weak(self.eps, dt))
                p.copy_(p + (u + decay) * weak(-self.lr, dt))


def get_optimizer(name: str, params: list[torch.Tensor], lr: float,
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
