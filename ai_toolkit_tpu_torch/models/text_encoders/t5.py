"""T5 v1.1 encoder (``ai_toolkit_tpu/models/text_encoders/t5.py`` in PyTorch).

Module names follow transformers' ``T5EncoderModel``
(``encoder.block.{i}.layer.0.SelfAttention.q``, ``shared`` tied to
``encoder.embed_tokens``), so its state dict loads as it is. The relative
position bias of block 0 is shared by every layer; with ``per_layer_bias``
(UMT5, wan's text encoder: transformers ``UMT5EncoderModel``) every block
owns its table.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import Embedding, Linear, RMSNorm


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    # UMT5: every layer has its own relative-bias table instead of sharing layer 0's
    per_layer_bias: bool = False
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def xxl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=1000, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
                   dtype=torch.float32)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucketing, with the JAX package's f32 arithmetic
    (the log-ratio constant is an f32 log, not a float64 ``math.log``)."""
    num_buckets //= 2
    ret = (rel_pos > 0).to(torch.int32) * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_ratio.to(n.device) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, *, device=None):
        super().__init__()
        inner, dt = cfg.num_heads * cfg.d_kv, cfg.dtype
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = Linear(cfg.d_model, inner, bias=False, device=device, dtype=dt)
        self.k = Linear(cfg.d_model, inner, bias=False, device=device, dtype=dt)
        self.v = Linear(cfg.d_model, inner, bias=False, device=device, dtype=dt)
        self.o = Linear(inner, cfg.d_model, bias=False, device=device, dtype=dt)
        if has_bias:
            self.relative_attention_bias = Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, 0.4, device=device)

    def forward(self, x, pos_bias):
        heads = (self.num_heads, self.d_kv)
        q = self.q(x).unflatten(-1, heads).float()
        k = self.k(x).unflatten(-1, heads).float()
        v = self.v(x).unflatten(-1, heads).float()
        # T5 does not scale q by 1/sqrt(d); the bias enters as additive logits
        logits = torch.einsum("bshd,bthd->bhst", q, k) + pos_bias
        out = torch.einsum("bhst,bthd->bshd", torch.softmax(logits, dim=-1), v).to(x.dtype)
        return self.o(out.flatten(2))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, *, device=None):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias, device=device)
        self.layer_norm = RMSNorm(cfg.d_model, device=device)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        dt = cfg.dtype
        self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False, device=device, dtype=dt)
        self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False, device=device, dtype=dt)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False, device=device, dtype=dt)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg, device=device)
        self.layer_norm = RMSNorm(cfg.d_model, device=device)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, *, device=None):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias, device=device),
                                    T5LayerFF(cfg, device=device)])

    def forward(self, x, pos_bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), pos_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared = Embedding(cfg.vocab_size, cfg.d_model, 1.0, device=device)
        self.encoder = nn.Module()
        self.encoder.embed_tokens = self.shared  # tied, as in transformers
        self.encoder.block = nn.ModuleList(T5Block(cfg, i == 0 or cfg.per_layer_bias, device=device)
                                           for i in range(cfg.num_layers))
        self.encoder.final_layer_norm = RMSNorm(cfg.d_model, device=device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.shared(input_ids).to(cfg.dtype)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        pos_bias = None
        for blk in self.encoder.block:
            if pos_bias is None or cfg.per_layer_bias:
                table = blk.layer[0].SelfAttention.relative_attention_bias.weight
                pos_bias = table[buckets].permute(2, 0, 1)[None]  # [1, H, S, S]
            x = blk(x, pos_bias)
        return self.encoder.final_layer_norm(x)
