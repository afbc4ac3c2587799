"""The Wan causal video VAE (``ai_toolkit_tpu/models/wan_vae.py`` in
PyTorch, diffusers ``AutoencoderKLWan``): Wan 2.1's, and Wan 2.2's residual
TI2V-5B form; NDHWC at every public function.

Module names follow diffusers (``encoder.down_blocks.{i}`` as one flat list
of residual, attention and resample blocks, ``decoder.up_blocks.{i}.resnets.{j}``
and ``.upsamplers.0``, ``resample.1``, ``time_conv``, ``norm1.gamma``; Wan
2.2's ``encoder.down_blocks.{i}.resnets.{j}`` / ``.downsampler`` and
``decoder.up_blocks.{i}.upsampler``), the names
``io/video_vae_import.wan_vae_rules`` of the JAX package maps. Two layouts
differ from the checkpoint's: an RMS norm's ``gamma`` is ``[C]`` (diffusers
``[C, 1, 1, 1]``), and the attention block's ``to_qkv`` and ``proj`` are
Linears ``[out, in]`` (diffusers 1x1 Conv2d).

The JAX package's full-sequence form of diffusers' chunked causal flow is
kept as it is: every ``WanCausalConv3d`` sees ``2 * pad_t`` zero frames in
front (here given to the conv as a symmetric pad, the outputs that saw the
back pad dropped, so no padded copy of the input is made); the encoder's
``downsample3d`` passes frame 0 through and takes frames 1.. from a
stride-2 temporal conv over the whole stream; the decoder's ``upsample3d``
passes frame 0 through and runs its causal ``time_conv`` over the stream
with frame 0 replaced by zeros, each output frame splitting its 2C channels
into two frames. Encode maps T = 4k+1 frames to k+1 latent frames; decode
inverts it. The decoder runs all frames at once.

Wan 2.2 (``WanVAEConfig.wan22_5b``, diffusers ``patch_size=2``,
``is_residual=True``, ``decoder_base_dim``): the video is patchified 2x2
before ``conv_in`` (channel order ``(c r q)``, q the H sub-index) and
unpatchified after the decoder; every down block adds a parameter-free
``AvgDown3D`` shortcut (zero front pad in time, a grouped channel mean in
f32) and every upsampling up block a ``DupUp3D`` shortcut (channels repeated
into space-time, the first ``ft - 1`` frames dropped); up-block resample
convs keep full width and the decoder runs at ``decoder_base_dim``.

The convs hand cuDNN channels-last NCDHW / NCHW views of NDHWC / NHWC
memory. The RMS norm runs in f32 over row chunks, so that its f32
temporaries stay small at the decoder's top level, and the residual blocks
add their shortcut last, in place. The attention block is one head over the
channels of each frame's h*w tokens, in explicit f32 as in JAX (no Pallas
kernel there, plain products here).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import Conv, Linear, lecun_normal_

# Wan 2.1 per-channel latent statistics (diffusers AutoencoderKLWan config)
_WAN21_LATENTS_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
_WAN21_LATENTS_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclass(frozen=True)
class WanVAEConfig:
    base_dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: tuple[float, ...] = ()
    temperal_downsample: tuple[bool, ...] = (False, True, True)
    latents_mean: tuple[float, ...] = _WAN21_LATENTS_MEAN
    latents_std: tuple[float, ...] = _WAN21_LATENTS_STD
    in_channels: int = 3
    dtype: torch.dtype = torch.bfloat16
    # Wan 2.2 (TI2V-5B)
    patch_size: int = 1
    is_residual: bool = False
    decoder_base_dim: int | None = None
    clip_output: bool = False

    @classmethod
    def wan21(cls) -> "WanVAEConfig":
        return cls(clip_output=True)  # diffusers' clip_output default

    @classmethod
    def wan22_5b(cls) -> "WanVAEConfig":
        """The Wan 2.2 TI2V-5B VAE (a checkpoint's config.json brings its
        48-channel latent statistics)."""
        return cls(base_dim=160, z_dim=48, latents_mean=(0.0,) * 48, latents_std=(1.0,) * 48, patch_size=2,
                   is_residual=True, decoder_base_dim=256)

    @classmethod
    def tiny(cls) -> "WanVAEConfig":
        return cls(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1, temperal_downsample=(True,),
                   latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4, dtype=torch.float32)

    @classmethod
    def tiny22(cls) -> "WanVAEConfig":
        # the last block keeps in == out (AvgDown3D needs in * factor % out == 0)
        return cls(base_dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temperal_downsample=(True, True),
                   latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4, dtype=torch.float32, patch_size=2,
                   is_residual=True, decoder_base_dim=12)

    @property
    def latent_channels(self) -> int:
        return self.z_dim

    @property
    def spatial_downscale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1) * self.patch_size

    @property
    def temporal_downscale(self) -> int:
        return 2 ** sum(self.temperal_downsample)

    @property
    def temperal_upsample(self) -> tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


class WanCausalConv3d(nn.Module):
    """Conv3d whose temporal padding is all in front (``2 * pad_t`` zero
    frames), spatial padding symmetric; NDHWC in and out. ``weight`` is torch's
    ``[out, in, kt, kh, kw]``."""

    def __init__(self, in_dim: int, out_dim: int, kernel=(3, 3, 3), stride=(1, 1, 1), pad=(1, 1, 1), *,
                 dtype=None, device=None):
        super().__init__()
        if pad[0] and stride[0] != 1:
            raise ValueError("a temporally padded causal conv has temporal stride 1")
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, *kernel, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, device=device, dtype=dtype))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pt, ph, pw = self.pad
        y = F.conv3d(_ncdhw(x.to(self.weight.dtype)), self.weight, self.bias, stride=self.stride,
                     padding=(2 * pt, ph, pw))
        if pt:  # the front pad given as a symmetric one: the last 2 * pt outputs saw the back pad
            y = y[:, :, :y.shape[2] - 2 * pt]
        return y.permute(0, 2, 3, 4, 1)


class WanRMSNorm(nn.Module):
    """diffusers ``WanRMS_norm``: ``F.normalize`` over channels * sqrt(C) * gamma, in f32."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.empty(dim, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # over chunks of rows: at the decoder's top level one f32 copy of x is ~20 GB
        rows = x.reshape(-1, x.shape[-1])
        out = torch.empty_like(rows)
        n = max(1, (1 << 26) // rows.shape[1])
        for src, dst in zip(rows.split(n), out.split(n)):
            xf = src.float()
            y = xf / xf.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12)
            dst.copy_(y.mul_(self.scale).mul_(self.gamma))
        return out.view(x.shape)


class WanResidualBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype, *, device=None):
        super().__init__()
        self.norm1 = WanRMSNorm(in_dim, device=device)
        self.conv1 = WanCausalConv3d(in_dim, out_dim, dtype=dtype, device=device)
        self.norm2 = WanRMSNorm(out_dim, device=device)
        self.conv2 = WanCausalConv3d(out_dim, out_dim, dtype=dtype, device=device)
        self.conv_shortcut = (WanCausalConv3d(in_dim, out_dim, (1, 1, 1), pad=(0, 0, 0), dtype=dtype, device=device)
                              if in_dim != out_dim else None)

    def forward(self, x):
        y = self.conv1(F.silu(self.norm1(x), inplace=True))
        y = self.conv2(F.silu(self.norm2(y), inplace=True))
        return y.add_(x if self.conv_shortcut is None else self.conv_shortcut(x))


class WanAttentionBlock(nn.Module):
    """One head of per-frame spatial self-attention over the channels, the
    logits, softmax and the product with v in f32."""

    def __init__(self, dim: int, dtype, *, device=None):
        super().__init__()
        self.norm = WanRMSNorm(dim, device=device)
        self.to_qkv = Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        b, t, h, w, c = x.shape
        qkv = self.to_qkv(self.norm(x).reshape(b * t, h * w, c))
        q, k, v = qkv.float().chunk(3, dim=-1)
        attn = torch.softmax(q @ k.transpose(1, 2) / c ** 0.5, dim=-1)
        out = self.proj((attn @ v).to(qkv.dtype))
        return x + out.reshape(b, t, h, w, c)


class WanMidBlock(nn.Module):
    def __init__(self, dim: int, dtype, *, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([WanResidualBlock(dim, dim, dtype, device=device) for _ in range(2)])
        self.attentions = nn.ModuleList([WanAttentionBlock(dim, dtype, device=device)])

    def forward(self, x):
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


def _conv2d_per_frame(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """A 2-D conv on every frame, T folded into the batch (torch does the same)."""
    b, t = x.shape[:2]
    y = conv(x.reshape(b * t, *x.shape[2:]))
    return y.reshape(b, t, *y.shape[1:])


class WanResample(nn.Module):
    """Modes ``upsample2d``, ``upsample3d``, ``downsample2d``, ``downsample3d``;
    the 2-D conv is ``resample.1`` (diffusers' ``nn.Sequential`` index), its
    upsampling width ``dim // 2`` unless ``up_out`` is given."""

    def __init__(self, dim: int, mode: str, dtype, *, up_out: int | None = None, device=None):
        super().__init__()
        self.mode = mode
        if mode in ("upsample2d", "upsample3d"):  # Wan 2.1 halves the width, Wan 2.2 keeps it (up_out)
            conv = Conv(dim, dim // 2 if up_out is None else up_out, 3, device=device, dtype=dtype)
        elif mode in ("downsample2d", "downsample3d"):
            conv = Conv(dim, dim, 3, stride=2, padding=0, device=device, dtype=dtype)
        else:
            raise ValueError(f"resample mode '{mode}'")
        self.resample = nn.ModuleList([nn.Identity(), conv])
        self.time_conv = None
        if mode == "upsample3d":
            self.time_conv = WanCausalConv3d(dim, 2 * dim, (3, 1, 1), pad=(1, 0, 0), dtype=dtype, device=device)
        elif mode == "downsample3d":
            self.time_conv = WanCausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), pad=(0, 0, 0), dtype=dtype,
                                             device=device)

    def forward(self, x):
        b, t, h, w, c = x.shape
        conv = self.resample[1]
        if self.mode == "upsample3d":
            # frame 0 is never temporally convolved; the causal stream of frames
            # >= 1 sees zeros in its place
            stream = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:]], dim=1)
            y = self.time_conv(stream)[:, 1:]
            y = y.reshape(b, t - 1, h, w, 2, c).permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * (t - 1), h, w, c)
            x = torch.cat([x[:, :1].to(y.dtype), y], dim=1)
        if self.mode in ("upsample2d", "upsample3d"):
            t = x.shape[1]
            up = F.interpolate(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
            x = up.permute(0, 2, 3, 1).reshape(b, t, 2 * h, 2 * w, c)
            return _conv2d_per_frame(conv, x)
        x = _conv2d_per_frame(conv, F.pad(x, (0, 0, 0, 1, 0, 1)))  # ZeroPad2d (0, 1, 0, 1)
        if self.mode == "downsample3d":
            # frame 0 passes through; a stride-2 temporal conv over the whole
            # stream gives frames 1.. (none for fewer frames than its kernel:
            # one image, as Qwen-Image encodes, is frame 0 alone)
            kt = self.time_conv.weight.shape[2]
            x = torch.cat([x[:, :1], self.time_conv(x)], dim=1) if x.shape[1] >= kt else x[:, :1]
        return x


def vae_patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """``[B, T, H, W, C]`` -> ``[B, T, H/p, W/p, C*p*p]``, packed channel
    ``(c * p + r) * p + q`` with q the H sub-index (torch ``(c r q)``)."""
    if p == 1:
        return x
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 6, 5, 3)
    return x.reshape(b, t, h // p, w // p, c * p * p)


def vae_unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return x
    b, t, h, w, cpp = x.shape
    x = x.reshape(b, t, h, w, cpp // (p * p), p, p).permute(0, 1, 2, 6, 3, 5, 4)
    return x.reshape(b, t, h * p, w * p, cpp // (p * p))


def _avg_down3d(x: torch.Tensor, out_c: int, ft: int, fs: int) -> torch.Tensor:
    """Parameter-free ``AvgDown3D``: zero front pad of T to a multiple of
    ``ft``, the (ft, fs, fs) factor block packed into channels (channel
    ``((c * ft + it) * fs + ih) * fs + iw``), then a grouped mean in f32 down
    to ``out_c`` channels."""
    b, t, h, w, c = x.shape
    pad_t = (-t) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, pad_t, 0))
        t += pad_t
    x = x.reshape(b, t // ft, ft, h // fs, fs, w // fs, fs, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    x = x.reshape(b, t // ft, h // fs, w // fs, out_c, c * ft * fs * fs // out_c)
    return x.float().mean(-1).to(x.dtype)


def _dup_up3d(x: torch.Tensor, out_c: int, ft: int, fs: int) -> torch.Tensor:
    """Parameter-free ``DupUp3D``: channels repeated (interleaved) to
    ``out_c * ft * fs * fs``, the (ft, fs, fs) factor block spread into
    space-time, the leading ``ft - 1`` frames dropped (the chunked flow's
    first-chunk trim). Written one factor offset at a time into the output,
    so no repeated copy of the input is made."""
    b, t, h, w, c = x.shape
    repeats = out_c * ft * fs * fs // c
    # output channel o at offset (it, ih, iw) is the repeated tensor's channel
    # ((o * ft + it) * fs + ih) * fs + iw, which is x's channel that // repeats
    src = (torch.arange(out_c * ft * fs * fs, device=x.device) // repeats).view(out_c, ft, fs, fs)
    out = x.new_empty(b, t, ft, h, fs, w, fs, out_c)
    for it in range(ft):
        for ih in range(fs):
            for iw in range(fs):
                out[:, :, it, :, ih, :, iw] = x.index_select(-1, src[:, it, ih, iw])
    out = out.view(b, t * ft, h * fs, w * fs, out_c)
    return out[:, ft - 1:] if ft > 1 else out


class WanResidualDownBlock(nn.Module):
    """Wan 2.2's down block: residual blocks and an optional resample, with an
    ``AvgDown3D`` shortcut over the whole block."""

    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int, temporal_down: bool, down_flag: bool,
                 dtype, *, device=None):
        super().__init__()
        self.out_dim, self.ft, self.fs = out_dim, 2 if temporal_down else 1, 2 if down_flag else 1
        self.resnets = nn.ModuleList(WanResidualBlock(in_dim if j == 0 else out_dim, out_dim, dtype, device=device)
                                     for j in range(num_res_blocks))
        self.downsampler = (WanResample(out_dim, "downsample3d" if temporal_down else "downsample2d", dtype,
                                        device=device) if down_flag else None)

    def forward(self, x):
        shortcut = _avg_down3d(x, self.out_dim, self.ft, self.fs)
        for blk in self.resnets:
            x = blk(x)
        if self.downsampler is not None:
            x = self.downsampler(x)
        return x + shortcut


class WanResidualUpBlock(nn.Module):
    """Wan 2.2's up block: residual blocks and an optional resample at full
    width, with a ``DupUp3D`` shortcut (added last, in place)."""

    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int, temporal_up: bool, up_flag: bool,
                 dtype, *, device=None):
        super().__init__()
        self.out_dim, self.ft = out_dim, 2 if temporal_up else 1
        self.resnets = nn.ModuleList(WanResidualBlock(in_dim if j == 0 else out_dim, out_dim, dtype, device=device)
                                     for j in range(num_res_blocks + 1))
        self.upsampler = (WanResample(out_dim, "upsample3d" if temporal_up else "upsample2d", dtype,
                                      up_out=out_dim, device=device) if up_flag else None)

    def forward(self, x):
        x_in = x
        for blk in self.resnets:
            x = blk(x)
        if self.upsampler is None:
            return x
        return self.upsampler(x).add_(_dup_up3d(x_in, self.out_dim, self.ft, 2))


class WanEncoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, device=None):
        super().__init__()
        dt = cfg.dtype
        dims = [cfg.base_dim * u for u in (1,) + tuple(cfg.dim_mult)]
        self.conv_in = WanCausalConv3d(cfg.in_channels * cfg.patch_size ** 2, dims[0], dtype=dt, device=device)
        blocks, scale = [], 1.0
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            last = i == len(cfg.dim_mult) - 1
            if cfg.is_residual:
                blocks.append(WanResidualDownBlock(in_dim, out_dim, cfg.num_res_blocks,
                                                   (not last) and cfg.temperal_downsample[i], not last, dt,
                                                   device=device))
                continue
            for _ in range(cfg.num_res_blocks):
                blocks.append(WanResidualBlock(in_dim, out_dim, dt, device=device))
                if scale in cfg.attn_scales:
                    blocks.append(WanAttentionBlock(out_dim, dt, device=device))
                in_dim = out_dim
            if not last:
                mode = "downsample3d" if cfg.temperal_downsample[i] else "downsample2d"
                blocks.append(WanResample(out_dim, mode, dt, device=device))
                scale /= 2.0
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = WanMidBlock(dims[-1], dt, device=device)
        self.norm_out = WanRMSNorm(dims[-1], device=device)
        self.conv_out = WanCausalConv3d(dims[-1], 2 * cfg.z_dim, dtype=dt, device=device)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanUpBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, num_res_blocks: int, upsample_mode: str | None, dtype, *,
                 device=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            WanResidualBlock(in_dim if j == 0 else out_dim, out_dim, dtype, device=device)
            for j in range(num_res_blocks + 1))
        self.upsamplers = (nn.ModuleList([WanResample(out_dim, upsample_mode, dtype, device=device)])
                           if upsample_mode is not None else None)

    def forward(self, x):
        for blk in self.resnets:
            x = blk(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class WanDecoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig, *, device=None):
        super().__init__()
        dt = cfg.dtype
        base = cfg.decoder_base_dim or cfg.base_dim
        dims = [base * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
        ups = cfg.temperal_upsample
        self.conv_in = WanCausalConv3d(cfg.z_dim, dims[0], dtype=dt, device=device)
        self.mid_block = WanMidBlock(dims[0], dt, device=device)
        blocks = []
        for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
            last = i == len(cfg.dim_mult) - 1
            if cfg.is_residual:
                blocks.append(WanResidualUpBlock(in_dim, out_dim, cfg.num_res_blocks, (not last) and ups[i],
                                                 not last, dt, device=device))
                continue
            if i > 0:
                in_dim //= 2  # the previous upsampler halved the channels
            mode = None if last else ("upsample3d" if ups[i] else "upsample2d")
            blocks.append(WanUpBlock(in_dim, out_dim, cfg.num_res_blocks, mode, dt, device=device))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = WanRMSNorm(dims[-1], device=device)
        self.conv_out = WanCausalConv3d(dims[-1], cfg.in_channels * cfg.patch_size ** 2, dtype=dt, device=device)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class WanVAE(nn.Module):
    """The autoencoder; :meth:`encode` returns latents normalized by the
    config's per-channel mean and std (what the DiT trains on)."""

    def __init__(self, cfg: WanVAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = WanEncoder3d(cfg, device=device)
        self.quant_conv = WanCausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1), pad=(0, 0, 0),
                                          dtype=cfg.dtype, device=device)
        self.post_quant_conv = WanCausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1), pad=(0, 0, 0),
                                               dtype=cfg.dtype, device=device)
        self.decoder = WanDecoder3d(cfg, device=device)

    def _stats(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(self.cfg.latents_mean, dtype=torch.float32, device=device),
                torch.tensor(self.cfg.latents_std, dtype=torch.float32, device=device))

    def raw_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Unnormalized encoder moments ``[B, t, h, w, 2z]``."""
        return self.quant_conv(self.encoder(vae_patchify(x, self.cfg.patch_size)))

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x ``[B, T, H, W, 3]`` in [-1, 1], T = 4k+1 -> ``[B, k+1, H/sd, W/sd, z]``
        (posterior mode unless ``generator`` is given)."""
        mean, logvar = self.raw_moments(x).chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
            eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=torch.float32)
            mean = mean + (std * eps).to(mean.dtype)
        lm, ls = self._stats(mean.device)
        return ((mean.float() - lm) / ls).to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        lm, ls = self._stats(z.device)
        z = (z.float() * ls + lm).to(z.dtype)
        y = vae_unpatchify(self.decoder(self.post_quant_conv(z)), self.cfg.patch_size)
        return y.clamp(-1.0, 1.0) if self.cfg.clip_output else y
