"""Attention dispatch (``ai_toolkit_tpu/ops/attention.py`` in PyTorch).

Unmasked, non-causal attention at head_dim 64 or 128 goes to the flash
forward (``ops/kernels/flash_attention.py``): on a CUDA tensor that is the
hand-written kernel, on a CPU tensor its plain version. Masked or causal calls
(CLIP, ``attn_masking``) and other head dims go to :func:`reference_attention`,
as the JAX package sends them to XLA (``ai_toolkit_tpu/ops/attention.py:37``).
"""

from __future__ import annotations

import torch

from ai_toolkit_tpu_torch.ops.kernels.flash_attention import HEAD_DIMS, flash_attention_fwd


def dot_product_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, H, D]
    v: torch.Tensor,  # [B, T, H, D]
    mask: torch.Tensor | None = None,  # [B, 1|H, S, T] bool, True = attend
    is_causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-head attention over ``[batch, seq, heads, head_dim]`` tensors."""
    if mask is None and not is_causal and q.shape[-1] in HEAD_DIMS:
        return flash_attention_fwd(q, k, v, scale)[0]
    return reference_attention(q, k, v, mask=mask, is_causal=is_causal, scale=scale)


def reference_attention(q, k, v, mask=None, is_causal=False, scale=None):
    """Plain einsum attention in f32 (JAX ``_reference_attention``). The
    logits are scaled and masked in place (the product's backward reads q and
    k, not its output), so one f32 ``[B, H, S, T]`` tensor lives beside the
    weights: 6.85 GB each for Qwen-Image-Edit's 8,448 tokens at 1024^2."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()).mul_(scale)
    if is_causal:
        s, t = logits.shape[-2:]
        causal = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        logits.masked_fill_(~causal, float("-inf"))
    if mask is not None:
        logits.masked_fill_(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", weights, v.float()).to(q.dtype)
