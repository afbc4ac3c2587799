"""Conditional UNet of SD / SDXL (``ai_toolkit_tpu/models/unet.py`` ``UNet2DCondition``
in PyTorch), NHWC at its boundary like the JAX package.

Module names follow diffusers' ``UNet2DConditionModel`` (``conv_in``,
``time_embedding.linear_1``, ``add_embedding.linear_1``,
``down_blocks.{i}.resnets.{j}``, ``down_blocks.{i}.attentions.{j}.transformer_blocks.{k}.attn1.to_q``,
``down_blocks.{i}.downsamplers.0.conv``, ``mid_block.resnets.{0,1}``,
``mid_block.attentions.0``, ``up_blocks.{n-1-i}.upsamplers.0.conv``,
``conv_norm_out``, ``conv_out``), so a diffusers state dict loads as it is.
The details the JAX package pins are kept:

- the timestep embedding is ``[cos | sin]`` of the raw timestep (time factor 1);
- SDXL's added condition is the pooled text embedding, then the six
  ``time_ids`` each embedded at ``addition_time_embed_dim``;
- resnet GroupNorms use eps 1e-5, the spatial transformer's 1e-6;
- heads per level are ``dim // head_dim`` when ``head_dim`` is set (SDXL:
  10 x 64 at 640 channels, 20 x 64 at 1280), else ``num_heads``;
- the feed-forward is GEGLU with the exact erf gelu;
- downsampling pads (1, 1) on both sides; upsampling is nearest x 2 then a conv;
- skips are concatenated after the backbone's channels, in the JAX order.

Attention goes through ``ops.attention.dot_product_attention``: at head_dim
64 (SD 2.x, SDXL) that is the flash kernel on a CUDA tensor; SD 1.x's global
8 heads are 40, 80 and 160 wide, which take the plain attention, as the JAX
package sends them to XLA. SD 1.x files hold ``proj_in`` / ``proj_out`` as
1x1 convs, read into the Linears by ``io/safetensors_dir.squeeze_to``. With ``UNetConfig.remat`` each
``ResnetBlock`` and ``SpatialTransformer`` is checkpointed while gradients are
recorded (JAX ``nn.remat`` per block). FreeU (``train.free_u``) is refused
by the train job.

The two adapter inputs (JAX ``UNet2DCondition``'s ``ip_context`` and
``adapter_residuals``): with ``ip_context`` ``[B, N, cross_dim]`` every
transformer block that carries an ``ip`` (``adapters/ip_adapter.UNetIP``)
runs its ``attn2`` query over ``ip_context @ ip_k^T`` / ``@ ip_v^T`` too
and adds ``scale`` times that output, in the UNet's dtype, before
``attn2``'s out-projection (the decoupled cross-attention, a second
attention at each site: the flash kernel over an ``N``-token K/V at head_dim
64). ``adapter_residuals`` (a T2I adapter's per-level features) are added to
the hidden states after each down level's last resnet / attention and
before its downsample, and replace that level's last skip.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.embeddings import timestep_embedding
from ai_toolkit_tpu_torch.ops.layers import Conv, GroupNorm, LayerNorm, Linear, lora_checkpoint


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers: tuple[int, ...] = (1, 1, 1, 0)  # per level; 0 = a plain resnet level
    num_heads: int = 8
    head_dim: int | None = None
    cross_attention_dim: int = 768
    addition_time_embed_dim: int | None = None  # SDXL: 256
    projection_class_embeddings_dim: int | None = None  # SDXL: 2816
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @classmethod
    def sd15(cls) -> "UNetConfig":
        """SD 1.x: global 8 heads, so 40, 80 and 160 wide by level."""
        return cls()

    @classmethod
    def sd21(cls) -> "UNetConfig":
        return cls(cross_attention_dim=1024, head_dim=64)

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        return cls(block_out_channels=(320, 640, 1280), transformer_layers=(0, 2, 10),
                   cross_attention_dim=2048, head_dim=64, addition_time_embed_dim=256,
                   projection_class_embeddings_dim=2816)

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(block_out_channels=(32, 64), layers_per_block=1, transformer_layers=(1, 1),
                   num_heads=2, cross_attention_dim=64, dtype=torch.float32, remat=False)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads(self, dim: int) -> int:
        return dim // self.head_dim if self.head_dim else self.num_heads


class ResnetBlock(nn.Module):
    """GroupNorm, SiLU, conv; plus the projected time embedding; GroupNorm,
    SiLU, conv; a 1x1 shortcut where the channels change."""

    def __init__(self, in_ch: int, out_ch: int, cfg: UNetConfig, *, device=None):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = GroupNorm(in_ch, eps=1e-5, device=device)
        self.conv1 = Conv(in_ch, out_ch, 3, device=device, dtype=dt)
        self.time_emb_proj = Linear(cfg.time_embed_dim, out_ch, device=device, dtype=dt)
        self.norm2 = GroupNorm(out_ch, eps=1e-5, device=device)
        self.conv2 = Conv(out_ch, out_ch, 3, device=device, dtype=dt)
        self.conv_shortcut = Conv(in_ch, out_ch, 1, device=device, dtype=dt) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention of ``x`` over ``context`` (itself for ``attn1``):
    bias-free q, k, v projections, ``to_out.0`` with a bias."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype, *, device=None):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False, device=device, dtype=dtype)
        self.to_k = Linear(context_dim, dim, bias=False, device=device, dtype=dtype)
        self.to_v = Linear(context_dim, dim, bias=False, device=device, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(dim, dim, device=device, dtype=dtype)])

    def forward(self, x: torch.Tensor, context: torch.Tensor, ip=None, ip_context=None) -> torch.Tensor:
        """With ``ip`` (a :class:`~ai_toolkit_tpu_torch.adapters.ip_adapter.UNetIP`)
        and ``ip_context``, the decoupled cross-attention: the same query over
        the image tokens' K/V, ``scale`` times it added before ``to_out``."""
        split = (self.heads, -1)
        q = self.to_q(x).unflatten(-1, split)
        k = self.to_k(context).unflatten(-1, split)
        v = self.to_v(context).unflatten(-1, split)
        o = dot_product_attention(q, k, v)
        if ip is not None and ip_context is not None:
            dt = q.dtype
            c = ip_context.to(dt)
            k_ip = (c @ ip.ip_k.to(dt).t()).unflatten(-1, split)
            v_ip = (c @ ip.ip_v.to(dt).t()).unflatten(-1, split)
            o = o + ip.scale.to(dt) * dot_product_attention(q, k_ip, v_ip)
        return self.to_out[0](o.flatten(2))


class GEGLU(nn.Module):
    """``a * gelu(g)`` of the two halves of one projection, the exact erf gelu
    (JAX ``jax.nn.gelu(approximate=False)``)."""

    def __init__(self, dim: int, inner: int, dtype, *, device=None):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g, approximate="none")


class FeedForward(nn.Module):
    """diffusers ``FeedForward``: ``net.0`` GEGLU, ``net.1`` dropout (none
    here), ``net.2`` the output projection."""

    def __init__(self, dim: int, dtype, *, device=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, dtype, device=device), nn.Identity(),
                                  Linear(4 * dim, dim, device=device, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    """Self-attention, cross-attention over the text states, GEGLU feed-forward,
    each after a LayerNorm (eps 1e-5) and added to the residual."""

    def __init__(self, dim: int, cfg: UNetConfig, *, device=None):
        super().__init__()
        dt, heads = cfg.dtype, cfg.heads(dim)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn1 = Attention(dim, dim, heads, dt, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn2 = Attention(dim, cfg.cross_attention_dim, heads, dt, device=device)
        self.norm3 = LayerNorm(dim, eps=1e-5, device=device)
        self.ff = FeedForward(dim, dt, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor, ip_context=None) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attn1(h, h)
        x = x + self.attn2(self.norm2(x), context, getattr(self, "ip", None), ip_context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """diffusers ``Transformer2DModel`` with linear projections: GroupNorm
    (eps 1e-6), ``proj_in``, ``depth`` transformer blocks over the h*w tokens,
    ``proj_out``, added to the input."""

    def __init__(self, ch: int, depth: int, cfg: UNetConfig, *, device=None):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6, device=device)
        self.proj_in = Linear(ch, ch, device=device, dtype=cfg.dtype)
        self.transformer_blocks = nn.ModuleList(TransformerBlock(ch, cfg, device=device)
                                                for _ in range(depth))
        self.proj_out = Linear(ch, ch, device=device, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor, ip_context=None) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(b, hh * ww, c))
        for blk in self.transformer_blocks:
            h = blk(h, context, ip_context)
        return x + self.proj_out(h).reshape(b, hh, ww, c)


class Downsample(nn.Module):
    def __init__(self, ch: int, dtype, *, device=None):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, padding=1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int, dtype, *, device=None):
        super().__init__()
        self.conv = Conv(ch, ch, 3, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class UNetBlock(nn.Module):
    """One level of the down or up path: ``resnets``, ``attentions`` (a
    transformer level) and ``downsamplers`` / ``upsamplers``."""

    def __init__(self, resnets: list[ResnetBlock], attentions: list[SpatialTransformer] | None,
                 resample: nn.Module | None, kind: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resample is not None:
            setattr(self, f"{kind}samplers", nn.ModuleList([resample]))


class UNetMidBlock(nn.Module):
    def __init__(self, ch: int, depth: int, cfg: UNetConfig, *, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, cfg, device=device),
                                      ResnetBlock(ch, ch, cfg, device=device)])
        self.attentions = nn.ModuleList([SpatialTransformer(ch, depth, cfg, device=device)])


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype, *, device=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, device=device, dtype=dtype)
        self.linear_2 = Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt, chans, n = cfg.dtype, cfg.block_out_channels, len(cfg.block_out_channels)
        ted = cfg.time_embed_dim
        self.conv_in = Conv(cfg.in_channels, chans[0], 3, device=device, dtype=dt)
        self.time_embedding = TimestepEmbedding(chans[0], ted, dt, device=device)
        self.add_embedding = (TimestepEmbedding(cfg.projection_class_embeddings_dim, ted, dt, device=device)
                              if cfg.addition_time_embed_dim else None)

        def attn(ch, i):
            depth = cfg.transformer_layers[i]
            return SpatialTransformer(ch, depth, cfg, device=device) if depth > 0 else None

        down, skip_chans, ch = [], [chans[0]], chans[0]
        for i, out_ch in enumerate(chans):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(ch, out_ch, cfg, device=device))
                attns.append(attn(out_ch, i))
                ch = out_ch
                skip_chans.append(ch)
            resample = Downsample(ch, dt, device=device) if i < n - 1 else None
            if resample is not None:
                skip_chans.append(ch)
            down.append(UNetBlock(resnets, attns if attns[0] is not None else None, resample, "down"))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = UNetMidBlock(ch, max(cfg.transformer_layers[-1], 1), cfg, device=device)

        up = []
        for i in reversed(range(n)):  # diffusers up_blocks.0 is the deepest level
            out_ch = chans[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(ch + skip_chans.pop(), out_ch, cfg, device=device))
                attns.append(attn(out_ch, i))
                ch = out_ch
            resample = Upsample(ch, dt, device=device) if i > 0 else None
            up.append(UNetBlock(resnets, attns if attns[0] is not None else None, resample, "up"))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch, eps=1e-5, device=device)
        self.conv_out = Conv(ch, cfg.out_channels, 3, device=device, dtype=dt)

    def _run(self, module: nn.Module, *args) -> torch.Tensor:
        """A resnet or spatial transformer, checkpointed when ``remat`` is on
        and gradients are recorded."""
        if self.cfg.remat and torch.is_grad_enabled():
            return lora_checkpoint(module, *args)
        return module(*args)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                added_cond: dict | None = None, ip_context=None, adapter_residuals=None) -> torch.Tensor:
        """x ``[B, h, w, C]`` noisy latents; t ``[B]`` timesteps (integer
        indices or floats); context ``[B, T, cross_dim]``; ``added_cond``
        (SDXL) ``{time_ids [B, 6], text_embeds [B, pooled]}``; ``ip_context``
        ``[B, N, cross_dim]`` (the IP-adapter's image tokens) and
        ``adapter_residuals`` (one map per down level; module docstring)."""
        cfg = self.cfg
        dt = cfg.dtype
        temb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0], time_factor=1.0).to(dt))
        if self.add_embedding is not None and added_cond is not None:
            tid = timestep_embedding(added_cond["time_ids"].reshape(-1), cfg.addition_time_embed_dim,
                                     time_factor=1.0).reshape(x.shape[0], -1)
            temb = temb + self.add_embedding(torch.cat([added_cond["text_embeds"].to(dt), tid.to(dt)], dim=-1))
        context = context.to(dt)
        attn_args = (context,) if ip_context is None else (context, ip_context)

        h = self.conv_in(x)
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                h = self._run(res, h, temb)
                if hasattr(blk, "attentions"):
                    h = self._run(blk.attentions[j], h, *attn_args)
                skips.append(h)
            if adapter_residuals is not None and i < len(adapter_residuals):
                h = h + adapter_residuals[i].to(h.dtype)
                skips[-1] = h
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = self._run(mid.resnets[0], h, temb)
        h = self._run(mid.attentions[0], h, *attn_args)
        h = self._run(mid.resnets[1], h, temb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = self._run(res, torch.cat([h, skips.pop()], dim=-1), temb)
                if hasattr(blk, "attentions"):
                    h = self._run(blk.attentions[j], h, *attn_args)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))


def unet_lora_targets() -> list[str]:
    """Attention projections, the feed-forward and the spatial transformers'
    proj_in / proj_out (JAX ``unet_lora_targets``, on the diffusers names)."""
    return [r"\.attn\d\.(to_q|to_k|to_v|to_out\.0)$", r"\.ff\.net\.(0\.proj|2)$", r"\.proj_(in|out)$"]
