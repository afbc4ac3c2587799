"""Decoder-LLM text encoder (``ai_toolkit_tpu/models/text_encoders/llm.py`` in
PyTorch), the Llama family that hidream conditions on, Qwen2.5-VL's text
tower that Qwen-Image (7B) and OmniGen2 (3B) condition on (``qkv_bias``:
Qwen2's q/k/v biases) and Gemma2-2B, Lumina-Image-2.0's.

Module names follow transformers' ``LlamaModel`` (``embed_tokens``,
``layers.{i}.self_attn.q_proj``, ``layers.{i}.mlp.gate_proj``, ``norm``), so
its state dict loads as it is. Token embedding (f32) -> pre-norm decoder
layers (GQA attention with the half-split RoPE, KV heads repeated; SwiGLU
MLP) -> final RMSNorm; the hidden states are returned, no LM head. The
causal (and padding) mask sends attention to the plain path, as the JAX
package sends masked calls to XLA.

Gemma2 (``post_norms``, the family's flag) takes transformers'
``Gemma2Model`` names: ``input_layernorm`` before attention,
``post_attention_layernorm`` on the attention's output (in Llama and Qwen2
that name is the norm before the MLP), ``pre_feedforward_layernorm`` and
``post_feedforward_layernorm`` around the MLP. Every Gemma RMSNorm stores
``w`` and scales by ``1 + w`` in f32 (:class:`GemmaRMSNorm`; the JAX
importer adds the 1 at load, ``plus_one``, into an f32 scale, which is the
same number). ``gemma_gelu``: the tanh GELU gates the MLP;
``scale_embeddings``: the embeddings times sqrt(d_model) in the compute
dtype; ``attn_softcap``: the attention is the JAX package's own einsum
(f32 logits times ``query_scale``, ``cap * tanh(logits / cap)``, masked
entries set to -1e30, not -inf, then the softmax). Gemma2's 4096-token
sliding window is not implemented, in JAX either: it never bites at
Lumina-Image-2.0's 256 tokens. The other families' flags (interleaved or
partial RoPE, per-head QK norms, biases on every Linear, collected layers)
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
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
    def gemma2_2b(cls) -> "LLMConfig":
        """Gemma2-2B: GQA 8 / 4 heads of 256, the Gemma2 norms, tanh GELU,
        embeddings times 48, logits softcapped at 50 and scaled by 256^-1/2."""
        return cls(vocab_size=256_000, d_model=2304, n_layers=26, n_heads=8, n_kv_heads=4, head_dim=256,
                   d_ff=9216, rope_theta=10_000.0, post_norms=True, gemma_gelu=True, scale_embeddings=True,
                   rms_eps=1e-6, attn_softcap=50.0, query_scale=256.0 ** -0.5)

    @classmethod
    def qwen25_7b(cls) -> "LLMConfig":
        """Qwen2.5-VL-7B's text tower: GQA 28 / 4, q/k/v biases, theta 1e6."""
        return cls(vocab_size=152_064, d_model=3584, n_layers=28, n_heads=28, n_kv_heads=4, head_dim=128,
                   d_ff=18944, rope_theta=1_000_000.0, qkv_bias=True, rms_eps=1e-6)

    @classmethod
    def qwen25_3b(cls) -> "LLMConfig":
        """Qwen2.5-VL-3B's text tower (OmniGen2's): GQA 16 / 2, q/k/v biases,
        theta 1e6 (JAX ``omnigen2_model.py:70-74``)."""
        return cls(vocab_size=151_936, d_model=2048, n_layers=36, n_heads=16, n_kv_heads=2, head_dim=128,
                   d_ff=11008, rope_theta=1_000_000.0, qkv_bias=True, rms_eps=1e-6)

    @classmethod
    def tiny(cls, **kw) -> "LLMConfig":
        base = dict(vocab_size=1000, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, dtype=torch.float32)
        base.update(kw)
        return cls(**base)


_OTHER_FAMILIES = ("collect_layers", "qk_head_norm", "all_bias", "rope_interleaved", "partial_rotary")


def llm_rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split (llama) RoPE over ``[B, S, H, D]`` at positions 0..S-1, in f32."""
    _, s, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class GemmaRMSNorm(RMSNorm):
    """Gemma's RMSNorm: the stored ``weight`` is ``w`` and the norm scales by
    ``1 + w``, in f32 (transformers ``Gemma2RMSNorm``); a seeded init is
    ``w = 0``, a scale of 1."""

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.zero_()

    @property
    def scale(self) -> torch.Tensor:
        return 1.0 + self.weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.scale).to(x.dtype)


def softcapped_attention(q, k, v, mask, scale: float, cap: float) -> torch.Tensor:
    """Gemma2's attention as the JAX package computes it: f32 logits times
    ``scale``, ``cap * tanh(logits / cap)``, masked entries -1e30, softmax,
    the product with v in f32, cast back to q's dtype."""
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = cap * torch.tanh(logits / cap)
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


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
        if cfg.attn_softcap:
            scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim ** -0.5
            o = softcapped_attention(q, k, v, mask, scale, cfg.attn_softcap)
        else:
            o = reference_attention(q, k, v, mask=mask, scale=cfg.query_scale)
        return self.o_proj(o.flatten(2))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.gate_proj = Linear(d, cfg.d_ff, bias=False, device=device, dtype=dt)
        self.up_proj = Linear(d, cfg.d_ff, bias=False, device=device, dtype=dt)
        self.down_proj = Linear(cfg.d_ff, d, bias=False, device=device, dtype=dt)
        self.gelu = cfg.gemma_gelu

    def forward(self, x):
        gate = self.gate_proj(x)
        act = F.gelu(gate, approximate="tanh") if self.gelu else F.silu(gate)
        return self.down_proj(act * self.up_proj(x))


def _norm(cfg: LLMConfig, device) -> RMSNorm:
    return (GemmaRMSNorm if cfg.post_norms else RMSNorm)(cfg.d_model, eps=cfg.rms_eps, device=device)


class LLMLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        self.gemma = cfg.post_norms
        self.input_layernorm = _norm(cfg, device)
        self.self_attn = LlamaAttention(cfg, device=device)
        # Llama / Qwen2: the norm before the MLP; Gemma2: the norm after attention
        self.post_attention_layernorm = _norm(cfg, device)
        if self.gemma:
            self.pre_feedforward_layernorm = _norm(cfg, device)
            self.post_feedforward_layernorm = _norm(cfg, device)
        self.mlp = LlamaMLP(cfg, device=device)

    def forward(self, x, mask):
        if self.gemma:
            x = x + self.post_attention_layernorm(self.self_attn(self.input_layernorm(x), mask))
            return x + self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))
        x = x + self.self_attn(self.input_layernorm(x), mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LLMEncoder(nn.Module):
    """Causal LM as a text encoder: ``input_ids [B, S]`` (and an optional
    ``attn_mask [B, S]``, 1 = token) -> final hidden states ``[B, S, d]``."""

    def __init__(self, cfg: LLMConfig, *, device=None):
        super().__init__()
        changed = [n for n in _OTHER_FAMILIES if getattr(cfg, n) != getattr(LLMConfig, n)]
        if changed:
            raise NotImplementedError(f"LLMConfig {changed}: the other LLM families (Qwen3, Ernie4.5, "
                                      f"GLM-4) come with slice G")
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.d_model, 0.02, device=device)
        self.layers = nn.ModuleList(LLMLayer(cfg, device=device) for _ in range(cfg.n_layers))
        self.norm = _norm(cfg, device)

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, s = input_ids.shape
        x = self.embed_tokens(input_ids).to(self.cfg.dtype)
        if self.cfg.scale_embeddings:  # Gemma2: sqrt(d_model) in the compute dtype
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=torch.float32).to(x.dtype)
        mask = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()[None, None]
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()
        mask = mask.expand(b, 1, s, s)
        for layer in self.layers:
            x = layer(x, mask)
        return self.norm(x)
