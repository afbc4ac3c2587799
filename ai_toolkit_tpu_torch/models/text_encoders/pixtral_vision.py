"""The pixtral vision encoder (``ai_toolkit_tpu/models/text_encoders/pixtral_vision.py``
in PyTorch), the image tower of the ``vision_direct`` adapter with
``image_encoder_arch: pixtral``.

A 16 x 16 patch conv without bias -> RMSNorm ``ln_pre`` (eps 1e-5) -> llama
blocks (RMSNorm, attention with the 2-D rope on interleaved pairs, RMSNorm,
SwiGLU), no final norm, in f32 as in the JAX package. Images of one batch
share their size, so a batch is one sequence per image (the reference's
block-diagonal mask over packed images computes the same). Attention at
head dim 64 goes to the flash kernels on the card.

The rope (JAX ``pixtral_rope_angles``): base frequencies ``1 / theta^(2i /
dim)``; the height angles take the even rows, the width angles the odd
rows, concatenated to ``dim / 2`` angles per (h, w) cell, each rotating the
pair ``(x[2j], x[2j+1])``.

Module names are the reference checkpoint's (``patch_conv``, ``ln_pre``,
``transformer.layers.{i}.attention.wq``, ``.feed_forward.w1``), so
:func:`load_pixtral_encoder` reads ``config.json`` and ``model.safetensors``
directly.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.layers import Conv, Linear, RMSNorm, init_parameters

# the reference's normalisation (CLIP statistics)
PIXTRAL_MEAN = (0.48145466, 0.4578275, 0.40821073)
PIXTRAL_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class PixtralVisionConfig:
    hidden_size: int = 1024
    image_size: int = 1024
    patch_size: int = 16
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    rope_theta: float = 1e4

    @classmethod
    def tiny(cls) -> "PixtralVisionConfig":
        return cls(hidden_size=64, image_size=64, patch_size=16, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def pixtral_rope_angles(cfg: PixtralVisionConfig, gh: int, gw: int) -> np.ndarray:
    """``[gh * gw, head_dim / 2]`` rope angles in f32 (float64 on the host, as JAX's)."""
    dim = cfg.head_dim
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    fh = np.outer(np.arange(gh, dtype=np.float64), freqs[::2])
    fw = np.outer(np.arange(gw, dtype=np.float64), freqs[1::2])
    two_d = np.concatenate([np.repeat(fh[:, None, :], gw, axis=1), np.repeat(fw[None, :, :], gh, axis=0)], axis=-1)
    return two_d.reshape(gh * gw, -1).astype(np.float32)


def rope_interleaved(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs ``(x[2j], x[2j+1])`` of ``x`` ``[B, S, H, D]`` by
    ``angles`` ``[S, D/2]``, in f32."""
    x2 = x.float().unflatten(-1, (-1, 2))
    cos, sin = angles.cos()[None, :, None, :], angles.sin()[None, :, None, :]
    re = x2[..., 0] * cos - x2[..., 1] * sin
    im = x2[..., 0] * sin + x2[..., 1] * cos
    return torch.stack([re, im], dim=-1).flatten(-2).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: PixtralVisionConfig, *, device=None):
        super().__init__()
        d, self.heads = cfg.hidden_size, cfg.num_attention_heads
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, Linear(d, d, bias=False, device=device, dtype=torch.float32))

    def forward(self, x, angles):
        b, s, d = x.shape
        q, k, v = (getattr(self, n)(x).unflatten(-1, (self.heads, -1)) for n in ("wq", "wk", "wv"))
        out = dot_product_attention(rope_interleaved(q, angles), rope_interleaved(k, angles), v)
        return self.wo(out.reshape(b, s, d))


class FeedForward(nn.Module):
    def __init__(self, cfg: PixtralVisionConfig, *, device=None):
        super().__init__()
        d, h = cfg.hidden_size, cfg.intermediate_size
        self.w1 = Linear(d, h, bias=False, device=device, dtype=torch.float32)
        self.w2 = Linear(h, d, bias=False, device=device, dtype=torch.float32)
        self.w3 = Linear(d, h, bias=False, device=device, dtype=torch.float32)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Layer(nn.Module):
    def __init__(self, cfg: PixtralVisionConfig, *, device=None):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.hidden_size, 1e-5, device=device)
        self.attention = Attention(cfg, device=device)
        self.ffn_norm = RMSNorm(cfg.hidden_size, 1e-5, device=device)
        self.feed_forward = FeedForward(cfg, device=device)

    def forward(self, x, angles):
        x = x + self.attention(self.attention_norm(x), angles)
        return x + self.feed_forward(self.ffn_norm(x))


class PixtralVisionEncoder(nn.Module):
    """images ``[B, H, W, 3]`` (normalised) -> tokens ``[B, gh * gw, hidden]``."""

    def __init__(self, cfg: PixtralVisionConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_conv = Conv(3, cfg.hidden_size, p, stride=p, padding=0, bias=False, device=device,
                               dtype=torch.float32)
        self.ln_pre = RMSNorm(cfg.hidden_size, 1e-5, device=device)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(Layer(cfg, device=device) for _ in range(cfg.num_hidden_layers))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_conv(images.float())
        b, gh, gw, d = x.shape
        x = self.ln_pre(x.reshape(b, gh * gw, d))
        angles = torch.from_numpy(pixtral_rope_angles(self.cfg, gh, gw)).to(x.device)
        for layer in self.transformer.layers:
            x = layer(x, angles)
        return x


def init_pixtral_encoder(cfg: PixtralVisionConfig, generator: torch.Generator, device) -> PixtralVisionEncoder:
    """A seeded random tower, frozen (the JAX job's init when
    ``image_encoder_path`` is no directory)."""
    return init_parameters(PixtralVisionEncoder(cfg, device=device), generator).eval().requires_grad_(False)


def load_pixtral_encoder(path: str, device) -> PixtralVisionEncoder:
    """A local pixtral directory (``config.json`` + ``model.safetensors``) ->
    the frozen tower, loaded strictly (JAX ``load_pixtral_encoder``)."""
    from safetensors.torch import load_file

    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    cfg = PixtralVisionConfig(
        hidden_size=int(raw.get("hidden_size", 1024)), image_size=int(raw.get("image_size", 1024)),
        patch_size=int(raw.get("patch_size", 16)), intermediate_size=int(raw.get("intermediate_size", 4096)),
        num_hidden_layers=int(raw.get("num_hidden_layers", 24)),
        num_attention_heads=int(raw.get("num_attention_heads", 16)), rope_theta=float(raw.get("rope_theta", 1e4)))
    model = PixtralVisionEncoder(cfg, device=device)
    state = load_file(os.path.join(path, "model.safetensors"))
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.eval().requires_grad_(False)
