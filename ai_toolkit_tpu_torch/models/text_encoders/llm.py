"""Decoder-LLM text encoder (``ai_toolkit_tpu/models/text_encoders/llm.py`` in
PyTorch), the Llama family that hidream conditions on and Qwen2.5-VL's text
tower that Qwen-Image conditions on (``qkv_bias``: Qwen2's q/k/v biases).

Module names follow transformers' ``LlamaModel`` (``embed_tokens``,
``layers.{i}.self_attn.q_proj``, ``layers.{i}.mlp.gate_proj``, ``norm``), so
its state dict loads as it is. Token embedding (f32) -> pre-norm decoder
layers (GQA attention with the half-split RoPE, KV heads repeated; SwiGLU
MLP) -> final RMSNorm; the hidden states are returned, no LM head. The
causal (and padding) mask sends attention to the plain path, as the JAX
package sends masked calls to XLA. The other families' flags of the JAX
``LLMConfig`` (Gemma2 norms and softcap, interleaved or partial RoPE,
per-head QK norms, biases on every Linear, collected layers) raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import reference_attention
from ai_toolkit_tpu_torch.ops.layers import Embedding, Linear, RMSNorm


@dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14336
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    # flags of the other families (Qwen2 / Gemma2 / Qwen3 / Ernie4.5 / GLM-4)
    qkv_bias: bool = False
    post_norms: bool = False
    gemma_gelu: bool = False
    scale_embeddings: bool = False
    collect_layers: tuple[int, ...] = ()
    attn_softcap: float = 0.0
    query_scale: float | None = None
    qk_head_norm: bool = False
    all_bias: bool = False
    rope_interleaved: bool = False
    partial_rotary: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def llama31_8b(cls) -> "LLMConfig":
        return cls()

    @classmethod
    def qwen25_7b(cls) -> "LLMConfig":
        """Qwen2.5-VL-7B's text tower: GQA 28 / 4, q/k/v biases, theta 1e6."""
        return cls(vocab_size=152_064, d_model=3584, n_layers=28, n_heads=28, n_kv_heads=4, head_dim=128,
                   d_ff=18944, rope_theta=1_000_000.0, qkv_bias=True, rms_eps=1e-6)

    @classmethod
    def tiny(cls, **kw) -> "LLMConfig":
        base = dict(vocab_size=1000, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, dtype=torch.float32)
        base.update(kw)
        return cls(**base)


_OTHER_FAMILIES = ("post_norms", "gemma_gelu", "scale_embeddings", "collect_layers",
                   "attn_softcap", "query_scale", "qk_head_norm", "all_bias", "rope_interleaved",
                   "partial_rotary")


def llm_rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (llama) RoPE over ``[B, S, H, D]`` at positions 0..S-1, in f32."""
    _, s, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.cfg = cfg
        bias = cfg.qkv_bias
        self.q_proj = Linear(d, cfg.n_heads * cfg.head_dim, bias=bias, device=device, dtype=dt)
        self.k_proj = Linear(d, cfg.n_kv_heads * cfg.head_dim, bias=bias, device=device, dtype=dt)
        self.v_proj = Linear(d, cfg.n_kv_heads * cfg.head_dim, bias=bias, device=device, dtype=dt)
        self.o_proj = Linear(cfg.n_heads * cfg.head_dim, d, bias=False, device=device, dtype=dt)

    def forward(self, x, mask):
        cfg = self.cfg
        q = llm_rope(self.q_proj(x).unflatten(-1, (cfg.n_heads, cfg.head_dim)), cfg.rope_theta)
        k = llm_rope(self.k_proj(x).unflatten(-1, (cfg.n_kv_heads, cfg.head_dim)), cfg.rope_theta)
        v = self.v_proj(x).unflatten(-1, (cfg.n_kv_heads, cfg.head_dim))
        if cfg.n_kv_heads != cfg.n_heads:  # GQA: repeat the kv heads
            rep = cfg.n_heads // cfg.n_kv_heads
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        return self.o_proj(reference_attention(q, k, v, mask=mask).flatten(2))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.gate_proj = Linear(d, cfg.d_ff, bias=False, device=device, dtype=dt)
        self.up_proj = Linear(d, cfg.d_ff, bias=False, device=device, dtype=dt)
        self.down_proj = Linear(cfg.d_ff, d, bias=False, device=device, dtype=dt)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LLMLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.d_model, eps=cfg.rms_eps, device=device)
        self.self_attn = LlamaAttention(cfg, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.d_model, eps=cfg.rms_eps, device=device)
        self.mlp = LlamaMLP(cfg, device=device)

    def forward(self, x, mask):
        x = x + self.self_attn(self.input_layernorm(x), mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LLMEncoder(nn.Module):
    """Causal LM as a text encoder: ``input_ids [B, S]`` (and an optional
    ``attn_mask [B, S]``, 1 = token) -> final hidden states ``[B, S, d]``."""

    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        changed = [n for n in _OTHER_FAMILIES if getattr(cfg, n) != getattr(LLMConfig, n)]
        if changed:
            raise NotImplementedError(f"LLMConfig {changed}: the other LLM families (Gemma2, Qwen3, "
                                      f"Ernie4.5, GLM-4) come with slice G")
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.d_model, 0.02, device=device)
        self.layers = nn.ModuleList(LLMLayer(cfg, device=device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.d_model, eps=cfg.rms_eps, device=device)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, s = input_ids.shape
        x = self.embed_tokens(input_ids).to(self.cfg.dtype)
        mask = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()[None, None]
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()
        mask = mask.expand(b, 1, s, s)
        for layer in self.layers:
            x = layer(x, mask)
        return self.norm(x)
