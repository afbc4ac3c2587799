"""Timestep embeddings (``ai_toolkit_tpu/ops/embeddings.py`` in PyTorch)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import Linear


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding ``[cos | sin]`` of ``t * time_factor`` (f32)."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """``out_layer(silu(in_layer(timestep_embedding(t, 256))))`` (BFL ``time_in``)."""

    freq_dim = 256

    def __init__(self, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.in_layer = Linear(self.freq_dim, hidden, device=device, dtype=dtype)
        self.out_layer = Linear(hidden, hidden, device=device, dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_dim).to(self.in_layer.weight.dtype)
        return self.out_layer(F.silu(self.in_layer(emb)))
