"""Rotary position embeddings (``ai_toolkit_tpu/ops/rope.py`` in PyTorch).

Tables keep the JAX layout ``[..., N, D/2, 2, 2]`` (rotation matrices
``[[cos, -sin], [sin, cos]]``). ``image_position_ids`` is the JAX package's
numpy function, repeated here because its module imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(pos: torch.Tensor, dim: int, theta: float = 10_000.0) -> torch.Tensor:
    """pos ``[..., N]`` -> ``[..., N, dim/2, 2, 2]`` rotation matrices (f32)."""
    assert dim % 2 == 0
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.float()[..., None] * omega
    cos, sin = out.cos(), out.sin()
    return torch.stack([cos, -sin, sin, cos], dim=-1).reshape(*out.shape, 2, 2)


def multi_axis_rope(ids: torch.Tensor, axes_dim, theta: float = 10_000.0) -> torch.Tensor:
    """ids ``[..., N, n_axes]`` -> ``[..., N, sum(axes_dim)/2, 2, 2]``."""
    return torch.cat(
        [rope_frequencies(ids[..., i], d, theta) for i, d in enumerate(axes_dim)], dim=-3)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``[B, S, H, D]`` by a ``[B|1, S, D/2, 2, 2]`` table, in f32."""
    xf = x.float().reshape(*x.shape[:-1], -1, 1, 2)
    if freqs.dim() == 5:
        freqs = freqs[:, :, None]  # broadcast over heads
    out = freqs[..., 0] * xf[..., 0] + freqs[..., 1] * xf[..., 1]
    return out.reshape(x.shape).to(x.dtype)


def image_position_ids(h: int, w: int, t: int = 1, text_len: int = 0) -> np.ndarray:
    """FLUX-style (t, y, x) integer ids for a text+image token sequence (host-side)."""
    img = np.zeros((t * h * w, 3), dtype=np.int32)
    tt, yy, xx = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    img[:, 0] = tt.reshape(-1)
    img[:, 1] = yy.reshape(-1)
    img[:, 2] = xx.reshape(-1)
    if text_len:
        return np.concatenate([np.zeros((text_len, 3), dtype=np.int32), img], axis=0)
    return img
