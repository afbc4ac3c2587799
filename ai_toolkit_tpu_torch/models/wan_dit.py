"""Wan-class video DiT (``ai_toolkit_tpu/models/wan_dit.py`` in PyTorch):
Wan 2.1 text-to-video and image-to-video, and the Wan 2.2 TI2V-5B widths.

Patchified 3-D latent tokens (patch t=1, h=2, w=2), blocks of [self-attention
with 3-D rope -> cross-attention to the text -> FFN], each modulated by six
adaLN chunks: the shared time projection plus the block's learned table,
added in f32 and rounded to the compute dtype chunk by chunk. The QK RMSNorm
runs across heads (over the full inner dim), and every GELU is the tanh form
(the FFN, the text MLP and the image MLP). Modules carry diffusers
``WanTransformer3DModel`` names (``blocks.{i}.attn1.to_q``,
``blocks.{i}.ffn.net.0.proj``, ``condition_embedder.time_proj``,
``scale_shift_table``), the names ``io/dit_importers.wan_dit_rules`` of the
JAX package maps; the patch embedding is the JAX ``Linear`` over
``(t, y, x, c)`` features, not the checkpoint's Conv3d. One module per block
(no scan stacking); with ``gradient_checkpointing`` every block is
recomputed in the backward, as the JAX ``nn.remat`` of ``WanConfig.remat``
recomputes it (no policy, so the flash forward runs again). Every attention
goes to the port's flash dispatch (``ops/attention.py``).

An i2v DiT (``WanConfig.i2v``) takes CLIP-vision tokens ``img_cond``: the
image MLP (``condition_embedder.image_embedder``: LayerNorm -> Linear ->
tanh GELU -> Linear -> LayerNorm) maps them to ``dim``, and each block's
cross-attention adds a second softmax over them, with its own K/V
(``attn2.add_k_proj`` with its full-dim RMSNorm ``attn2.norm_added_k``, and
``attn2.add_v_proj``), to the text attention's output (decoupled K/V, not one
softmax over both). Sequence parallelism comes with the rest of slice E and
has no field here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.embeddings import timestep_embedding
from ai_toolkit_tpu_torch.ops.layers import LayerNorm, Linear, RMSNorm, lora_checkpoint
from ai_toolkit_tpu_torch.ops.rope import apply_rope


@dataclass(frozen=True)
class WanConfig:
    in_channels: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    num_layers: int = 30
    text_dim: int = 4096  # umt5-xxl
    freq_dim: int = 256
    patch_size: tuple[int, int, int] = (1, 2, 2)  # (t, h, w)
    axes_dim: tuple[int, ...] = (44, 42, 42)  # rope split of head_dim (t, h, w)
    i2v: bool = False
    img_cond_dim: int = 1280  # the CLIP vision tower's width (ViT-H)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @classmethod
    def wan21_1_3b(cls) -> "WanConfig":
        return cls()

    @classmethod
    def wan21_14b(cls) -> "WanConfig":
        return cls(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)

    @classmethod
    def wan22_5b(cls) -> "WanConfig":
        """Wan 2.2 TI2V-5B (48-channel latents of the 16x Wan 2.2 VAE)."""
        return cls(in_channels=48, dim=3072, ffn_dim=14336, num_heads=24, num_layers=30)

    @classmethod
    def tiny(cls) -> "WanConfig":
        return cls(in_channels=4, dim=64, ffn_dim=128, num_heads=4, num_layers=2, text_dim=64,
                   freq_dim=32, axes_dim=(8, 4, 4), dtype=torch.float32, remat=False)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        pt, ph, pw = self.patch_size
        return self.in_channels * pt * ph * pw


def _ln(dim: int, affine: bool = False, device=None) -> LayerNorm:
    """Wan's LayerNorm (eps 1e-6) in f32; parameter-free except ``norm2``."""
    return LayerNorm(dim, eps=1e-6, affine=affine, device=device)


class WanAttention(nn.Module):
    """diffusers ``attn1`` / ``attn2``: q, k, v and out projections, QK
    RMSNorm over the full inner dim; with ``image_kv`` (the i2v
    cross-attention) the image tokens' own K/V and a second softmax over
    them, added to the text attention's output."""

    def __init__(self, cfg: WanConfig, *, image_kv: bool = False, device=None):
        super().__init__()
        d, dt = cfg.dim, cfg.dtype
        self.heads = (cfg.num_heads, cfg.head_dim)
        self.to_q = Linear(d, d, device=device, dtype=dt)
        self.to_k = Linear(d, d, device=device, dtype=dt)
        self.to_v = Linear(d, d, device=device, dtype=dt)
        self.to_out = nn.ModuleList([Linear(d, d, device=device, dtype=dt)])
        self.norm_q = RMSNorm(d, device=device)
        self.norm_k = RMSNorm(d, device=device)
        if image_kv:
            self.add_k_proj = Linear(d, d, device=device, dtype=dt)
            self.add_v_proj = Linear(d, d, device=device, dtype=dt)
            self.norm_added_k = RMSNorm(d, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor, pe: torch.Tensor | None = None,
                context_img: torch.Tensor | None = None):
        q = self.norm_q(self.to_q(x)).unflatten(-1, self.heads)
        k = self.norm_k(self.to_k(context)).unflatten(-1, self.heads)
        v = self.to_v(context).unflatten(-1, self.heads)
        if pe is not None:
            q, k = apply_rope(q, pe), apply_rope(k, pe)
        out = dot_product_attention(q, k, v)
        if context_img is not None:
            ki = self.norm_added_k(self.add_k_proj(context_img)).unflatten(-1, self.heads)
            vi = self.add_v_proj(context_img).unflatten(-1, self.heads)
            out = out + dot_product_attention(q, ki, vi)
        return self.to_out[0](out.flatten(2))


class _GELUProj(nn.Module):
    """diffusers ``GELU(approximate='tanh')``: ``proj`` then the tanh GELU."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.proj = Linear(d_in, d_out, device=device, dtype=dtype)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class WanFeedForward(nn.Module):
    """diffusers ``ffn``: ``net.0.proj`` -> tanh GELU -> ``net.2``."""

    def __init__(self, cfg: WanConfig, *, device=None):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(cfg.dim, cfg.ffn_dim, cfg.dtype, device=device), nn.Identity(),
                                  Linear(cfg.ffn_dim, cfg.dim, device=device, dtype=cfg.dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.norm1, self.norm2, self.norm3 = _ln(d), _ln(d, affine=True, device=device), _ln(d)
        self.attn1 = WanAttention(cfg, device=device)
        self.attn2 = WanAttention(cfg, image_kv=cfg.i2v, device=device)
        self.ffn = WanFeedForward(cfg, device=device)
        # the block's learned modulation offset (f32, normal(0.02) as in JAX)
        self.scale_shift_table = nn.Parameter(torch.empty(1, 6, d, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, context, e, pe, context_img=None):
        """x ``[B, N, dim]``; context ``[B, S, dim]``; e ``[B, 6, dim]`` the time
        projection; pe the rope table; context_img ``[B, S_img, dim]`` the
        embedded image tokens (i2v) or None."""
        dt = self.cfg.dtype
        # the table added in f32, each chunk rounded to the compute dtype
        mods = (e.float() + self.scale_shift_table).unbind(1)
        shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = (m[:, None].to(dt) for m in mods)
        h = self.norm1(x) * (1 + scale_sa) + shift_sa
        x = x + gate_sa * self.attn1(h, h, pe)
        x = x + self.attn2(self.norm2(x), context, context_img=context_img)  # cross: no rope, no modulation
        h = self.norm3(x) * (1 + scale_ff) + shift_ff
        return x + gate_ff * self.ffn(h)


class _MLP(nn.Module):
    """``linear_2(act(linear_1(x)))`` (diffusers ``PixArtAlphaTextProjection``
    with tanh GELU, ``TimestepEmbedding`` with SiLU)."""

    def __init__(self, d_in: int, d: int, act, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.act = act
        self.linear_1 = Linear(d_in, d, device=device, dtype=dtype)
        self.linear_2 = Linear(d, d, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(self.act(self.linear_1(x)))


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class WanImageEmbedding(nn.Module):
    """diffusers ``WanImageEmbedding`` (the i2v MLPProj): ``norm1`` -> ``ff``
    (``net.0.proj``, tanh GELU, ``net.2``) -> ``norm2``; both LayerNorms
    affine, eps 1e-6."""

    def __init__(self, cfg: WanConfig, *, device=None):
        super().__init__()
        c, dt = cfg.img_cond_dim, cfg.dtype
        self.norm1 = LayerNorm(c, eps=1e-6, device=device)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([_GELUProj(c, c, dt, device=device), nn.Identity(),
                                     Linear(c, cfg.dim, device=device, dtype=dt)])
        self.norm2 = LayerNorm(cfg.dim, eps=1e-6, device=device)

    def forward(self, x):
        net = self.ff.net
        return self.norm2(net[2](net[0](self.norm1(x))))


class WanConditionEmbedder(nn.Module):
    def __init__(self, cfg: WanConfig, *, device=None):
        super().__init__()
        d, dt = cfg.dim, cfg.dtype
        self.text_embedder = _MLP(cfg.text_dim, d, _gelu_tanh, dt, device=device)
        self.time_embedder = _MLP(cfg.freq_dim, d, F.silu, dt, device=device)
        self.time_proj = Linear(d, 6 * d, device=device, dtype=dt)
        self.image_embedder = WanImageEmbedding(cfg, device=device) if cfg.i2v else None


class WanDiT(nn.Module):
    def __init__(self, cfg: WanConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.gradient_checkpointing = cfg.remat
        d, dt = cfg.dim, cfg.dtype
        self.patch_embedding = Linear(cfg.patch_dim, d, device=device, dtype=dt)
        self.condition_embedder = WanConditionEmbedder(cfg, device=device)
        self.blocks = nn.ModuleList(WanBlock(cfg, device=device) for _ in range(cfg.num_layers))
        self.norm_out = _ln(d)
        self.proj_out = Linear(d, cfg.patch_dim, device=device, dtype=dt)
        # head modulation (shift, scale): the learned table plus the raw time embedding
        self.scale_shift_table = nn.Parameter(torch.empty(1, 2, d, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        self.scale_shift_table.normal_(0.0, 0.02, generator=generator)

    def forward(
        self,
        x: torch.Tensor,  # [B, N, patch_dim] patchified latent tokens
        context: torch.Tensor,  # [B, S, text_dim] umt5 states
        t: torch.Tensor,  # [B] in [0, 1]
        pe: torch.Tensor,  # rope table [1|B, N, head_dim/2, 2, 2]
        img_cond: torch.Tensor | None = None,  # [B, S_img, img_cond_dim] CLIP-vision tokens (i2v)
    ) -> torch.Tensor:
        cfg, ce = self.cfg, self.condition_embedder
        dt = cfg.dtype
        x = self.patch_embedding(x)
        ctx = ce.text_embedder(context.to(dt))
        ic = ce.image_embedder(img_cond.to(dt)) if cfg.i2v and img_cond is not None else None
        temb = ce.time_embedder(timestep_embedding(t, cfg.freq_dim).to(dt))
        e = ce.time_proj(F.silu(temb)).unflatten(-1, (6, cfg.dim))
        for blk in self.blocks:
            if self.gradient_checkpointing and torch.is_grad_enabled():
                x = lora_checkpoint(blk, x, ctx, e, pe, ic)
            else:
                x = blk(x, ctx, e, pe, ic)
        shift, scale = (self.scale_shift_table + temb.float()[:, None]).to(dt).unbind(1)
        h = self.norm_out(x) * (1 + scale[:, None]) + shift[:, None]
        return self.proj_out(h)


def wan_patchify(latents: torch.Tensor, patch: tuple[int, int, int]) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, N, pt*ph*pw*C] tokens (T-major order, features ``(t, y, x, c)``)."""
    b, tt, hh, ww, c = latents.shape
    pt, ph, pw = patch
    x = latents.reshape(b, tt // pt, pt, hh // ph, ph, ww // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (tt // pt) * (hh // ph) * (ww // pw), pt * ph * pw * c)


def wan_unpatchify(tokens: torch.Tensor, t: int, h: int, w: int, patch, channels: int) -> torch.Tensor:
    b = tokens.shape[0]
    pt, ph, pw = patch
    x = tokens.reshape(b, t // pt, h // ph, w // pw, pt, ph, pw, channels)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t, h, w, channels)


def wan_position_ids(t: int, h: int, w: int) -> np.ndarray:
    """(t, y, x) integer ids ``[1, t*h*w, 3]`` of the token grid (host-side)."""
    tt, yy, xx = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    return np.stack([tt.reshape(-1), yy.reshape(-1), xx.reshape(-1)], axis=-1).astype(np.int32)[None]


def wan_lora_targets() -> list[str]:
    """Every Linear of the transformer blocks (JAX ``wan_lora_targets``)."""
    return [r"^blocks\."]


# the port's block module names -> the JAX Linear names in a block
_JAX_LINEAR = {
    "attn1.to_q": "self_q", "attn1.to_k": "self_k", "attn1.to_v": "self_v", "attn1.to_out.0": "self_o",
    "attn2.to_q": "cross_q", "attn2.to_k": "cross_k", "attn2.to_v": "cross_v", "attn2.to_out.0": "cross_o",
    "ffn.net.0.proj": "ffn_in", "ffn.net.2": "ffn_out",
    "attn2.add_k_proj": "cross_k_img", "attn2.add_v_proj": "cross_v_img",  # i2v
}
_PORT_LINEAR = {v: k for k, v in _JAX_LINEAR.items()}


def wan_lora_key(name: str, scanned: bool) -> str:
    """The module name a LoRA file of the JAX job carries for the port's
    ``name`` (``blocks.3.attn1.to_q``). The JAX package has no wan key map, so
    its files hold its own module paths, dot-joined: ``block_3.self_q`` for an
    unrolled DiT (``tiny``), ``blocks.block.self_q.3`` for a scanned one
    (one entry per layer of the stack)."""
    _, i, rest = name.split(".", 2)
    leaf = _JAX_LINEAR[rest]
    return f"blocks.block.{leaf}.{i}" if scanned else f"block_{i}.{leaf}"


def wan_module_name(key: str) -> str:
    """Inverse of :func:`wan_lora_key`, for both layouts."""
    parts = key.split(".")
    if parts[:2] == ["blocks", "block"] and len(parts) == 4:
        return f"blocks.{parts[3]}.{_PORT_LINEAR[parts[2]]}"
    if len(parts) == 2 and parts[0].startswith("block_"):
        return f"blocks.{parts[0][len('block_'):]}.{_PORT_LINEAR[parts[1]]}"
    raise KeyError(f"LoRA key module '{key}' names no wan block Linear")
