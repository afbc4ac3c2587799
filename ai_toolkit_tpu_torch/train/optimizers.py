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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


def quantize_blockwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 flat ``[padded]``, f32 block scales ``[padded / BLOCK]``);
    scale = max|block| / 127, values rounded half to even (JAX ``_quantize_blockwise``)."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, -flat.numel() % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q.view(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.view(-1, BLOCK).float() * scale[:, None]).view(-1)
    return flat[: torch.Size(shape).numel()].view(shape)


class AdamW:
    """AdamW over a fixed list of parameters; ``eight_bit`` keeps both
    moments as blockwise int8 with f32 block scales."""

    def __init__(self, params: list[torch.Tensor], lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float | None = 1.0,
                 eight_bit: bool = False):
        self.params = list(params)
        self.lr, self.eps, self.weight_decay = float(lr), float(eps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.max_grad_norm = max_grad_norm
        self.eight_bit = eight_bit
        self.count = 0
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        if eight_bit:
            self.mu = [quantize_blockwise(z) for z in zeros]
            self.nu = [quantize_blockwise(z) for z in zeros]
        else:
            self.mu, self.nu = zeros, [z.clone() for z in zeros]

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
            g = g.float()
            if self.eight_bit:
                mu = dequantize_blockwise(*self.mu[i], g.shape) * self.b1 + g * (1 - self.b1)
                nu = dequantize_blockwise(*self.nu[i], g.shape) * self.b2 + g * g * (1 - self.b2)
                self.mu[i], self.nu[i] = quantize_blockwise(mu), quantize_blockwise(nu)
            else:
                mu = self.mu[i] = self.b1 * self.mu[i] + (1 - self.b1) * g
                nu = self.nu[i] = self.b2 * self.nu[i] + (1 - self.b2) * g * g
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.add_((u * -self.lr).to(p.dtype))


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
