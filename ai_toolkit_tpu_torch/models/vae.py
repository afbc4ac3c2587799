"""KL autoencoder (``ai_toolkit_tpu/models/vae.py`` in PyTorch), NHWC.

Module names follow diffusers' ``AutoencoderKL`` (``encoder.down_blocks.{i}``,
``decoder.up_blocks.{i}`` with ``i = 0`` the deepest level,
``mid_block.attentions.0.to_q``, ``conv_norm_out``), so its state dict loads
as it is. Tensors are NHWC at every public function, as in the JAX package;
the convs hand cuDNN channels-last NCHW views. The SD and SDXL VAEs
(``use_quant_conv``) have diffusers' 1x1 ``quant_conv`` after the encoder and
``post_quant_conv`` before the decoder; the flux and SD3 VAEs have neither.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import reference_attention
from ai_toolkit_tpu_torch.ops.layers import Conv, GroupNorm, Linear


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_multipliers: tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def sd(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        return cls(scaling_factor=0.13025)

    @classmethod
    def flux(cls) -> "VAEConfig":
        return cls(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False)

    @classmethod
    def sd3(cls) -> "VAEConfig":
        """SD3 / SD3.5's 16-channel VAE (diffusers ``vae/config.json``)."""
        return cls(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609, use_quant_conv=False)

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        base = dict(base_channels=16, channel_multipliers=(1, 2), layers_per_block=1,
                    use_quant_conv=False, dtype=torch.float32)
        return cls(**{**base, **kw})

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_multipliers) - 1)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype, *, device=None):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, device=device)
        self.conv1 = Conv(in_ch, out_ch, 3, device=device, dtype=dtype)
        self.norm2 = GroupNorm(out_ch, device=device)
        self.conv2 = Conv(out_ch, out_ch, 3, device=device, dtype=dtype)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, device=device, dtype=dtype)
                              if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Single-head mid-block self-attention over the h*w tokens (head_dim =
    channels, 512 in the flux VAE). Plain attention: the JAX package leaves it
    to XLA too."""

    def __init__(self, ch: int, dtype, *, device=None):
        super().__init__()
        self.group_norm = GroupNorm(ch, device=device)
        self.to_q = Linear(ch, ch, device=device, dtype=dtype)
        self.to_k = Linear(ch, ch, device=device, dtype=dtype)
        self.to_v = Linear(ch, ch, device=device, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(ch, ch, device=device, dtype=dtype)])

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, 1, c)
        out = reference_attention(self.to_q(y), self.to_k(y), self.to_v(y))
        return x + self.to_out[0](out.reshape(b, h, w, c))


class Upsample2D(nn.Module):
    def __init__(self, ch: int, dtype, *, device=None):
        super().__init__()
        self.conv = Conv(ch, ch, 3, device=device, dtype=dtype)

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_res: int, upsample: bool, dtype, *, device=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, dtype, device=device)
            for j in range(n_res))
        self.upsamplers = (nn.ModuleList([Upsample2D(out_ch, dtype, device=device)])
                           if upsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2D(nn.Module):
    def __init__(self, ch: int, dtype, *, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, dtype, device=device),
                                      ResnetBlock2D(ch, ch, dtype, device=device)])
        self.attentions = nn.ModuleList([Attention(ch, dtype, device=device)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv after a (0, 1) pad of height and width (the SD
    convention, JAX ``down_{i}_downsample``)."""

    def __init__(self, ch: int, dtype, *, device=None):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, padding=0, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_res: int, downsample: bool, dtype, *,
                 device=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, dtype, device=device)
            for j in range(n_res))
        self.downsamplers = (nn.ModuleList([Downsample2D(out_ch, dtype, device=device)])
                             if downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None):
        super().__init__()
        dt = cfg.dtype
        mults = cfg.channel_multipliers
        self.conv_in = Conv(cfg.in_channels, cfg.base_channels, 3, device=device, dtype=dt)
        blocks, ch = [], cfg.base_channels
        for i, mult in enumerate(mults):
            out_ch = cfg.base_channels * mult
            blocks.append(DownEncoderBlock2D(ch, out_ch, cfg.layers_per_block, i < len(mults) - 1,
                                             dt, device=device))
            ch = out_ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = UNetMidBlock2D(ch, dt, device=device)
        self.conv_norm_out = GroupNorm(ch, device=device)
        self.conv_out = Conv(ch, 2 * cfg.latent_channels, 3, device=device, dtype=dt)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None):
        super().__init__()
        dt = cfg.dtype
        mults = cfg.channel_multipliers
        n = len(mults)
        mid_ch = cfg.base_channels * mults[-1]
        self.conv_in = Conv(cfg.latent_channels, mid_ch, 3, device=device, dtype=dt)
        self.mid_block = UNetMidBlock2D(mid_ch, dt, device=device)
        blocks, ch = [], mid_ch
        for i in range(n):  # diffusers order: deepest level first
            out_ch = cfg.base_channels * mults[n - 1 - i]
            blocks.append(UpDecoderBlock2D(ch, out_ch, cfg.layers_per_block + 1, i < n - 1, dt,
                                           device=device))
            ch = out_ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(ch, device=device)
        self.conv_out = Conv(ch, cfg.in_channels, 3, device=device, dtype=dt)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device=device)
        self.decoder = Decoder(cfg, device=device)
        if cfg.use_quant_conv:
            c = cfg.latent_channels
            self.quant_conv = Conv(2 * c, 2 * c, 1, device=device, dtype=cfg.dtype)
            self.post_quant_conv = Conv(c, c, 1, device=device, dtype=cfg.dtype)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Image ``[B, H, W, 3]`` in [-1, 1] -> scaled latent ``[B, h, w, C]``:
        the posterior mode, or a sample when ``generator`` is given."""
        moments = self.encoder(x)
        if self.cfg.use_quant_conv:
            moments = self.quant_conv(moments)
        mean, logvar = moments.chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            mean = mean + std * torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                            device=mean.device)
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent ``[B, h, w, C]`` -> image ``[B, H, W, 3]`` in [-1, 1]."""
        z = z / self.cfg.scaling_factor + self.cfg.shift_factor
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)
