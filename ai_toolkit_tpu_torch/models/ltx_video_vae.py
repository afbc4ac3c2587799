"""LTX-2 video VAE (``ai_toolkit_tpu/models/ltx_video_vae.py``
``LTXVideoVAE`` in PyTorch; diffusers ``AutoencoderKLLTX2Video``), NDHWC at
its boundary.

Videos ``[B, 8k+1, H, W, 3]`` -> pixel patchify (patch 4, channel-major
``(c, pt, ph, pw)``) -> causal 3-D convolutions whose temporal padding
replicates the edge frame (all on the left in the encoder, split in the
decoder; zero spatial padding, reflect in the decoder) -> four downsamplers
(space-to-depth of a convolution at full resolution plus the input's
space-to-depth averaged over channel groups; a temporal one replicates the
first frame first) -> ``2 x 128`` moments. The decoder's depth-to-space
upsamplers trim the leading ``stride - 1`` frames and add the input's
depth-to-space repeated over channels. Norms are parameter-free RMS norms.
Latents are normalized by the checkpoint's ``latents_mean`` /
``latents_std`` (zero / one when it has none). 32x spatial, 8x temporal
at LTX-2's widths. The parameters are f32 and cast to the config's dtype
at use, as in JAX; module names are the diffusers checkpoint's
(``encoder.down_blocks.0.resnets.1.conv1.conv``), kernels in torch's
``[out, in, kt, kh, kw]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import lecun_normal_


@dataclass(frozen=True)
class LTXVideoVAEConfig:
    in_channels: int = 3
    latent_channels: int = 128
    block_out_channels: tuple[int, ...] = (256, 512, 1024, 2048)
    layers_per_block: tuple[int, ...] = (4, 6, 6, 2, 2)  # 4 down blocks + mid
    downsample_type: tuple[str, ...] = ("spatial", "temporal", "spatiotemporal", "spatiotemporal")
    decoder_channels: tuple[int, ...] = (1024, 512, 256)  # each upsampler's input channels, in decode order
    decoder_layers: tuple[int, ...] = (5, 5, 5, 5)  # mid + up blocks
    upsample_type: tuple[str, ...] = ("spatiotemporal", "spatiotemporal", "spatiotemporal")
    upsample_residual: tuple[bool, ...] = (True, True, True)
    upsample_factor: tuple[int, ...] = (2, 2, 2)  # channel divisor per upsampler
    patch_size: int = 4
    patch_size_t: int = 1
    eps: float = 1e-6
    encoder_causal: bool = True
    decoder_causal: bool = False
    decoder_reflect_pad: bool = True
    latents_mean: tuple[float, ...] | None = None
    latents_std: tuple[float, ...] | None = None
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def ltx2(cls) -> "LTXVideoVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LTXVideoVAEConfig":
        return cls(latent_channels=4, block_out_channels=(8, 16), layers_per_block=(1, 1, 1),
                   downsample_type=("spatiotemporal",), decoder_channels=(16,), decoder_layers=(1, 1),
                   upsample_type=("spatiotemporal",), upsample_residual=(True,), upsample_factor=(2,), patch_size=2,
                   dtype=torch.float32)

    @property
    def spatial_downscale(self) -> int:
        return self.patch_size * 2 ** sum(t in ("spatial", "spatiotemporal") for t in self.downsample_type)

    @property
    def temporal_downscale(self) -> int:
        return self.patch_size_t * 2 ** sum(t in ("temporal", "spatiotemporal") for t in self.downsample_type)


_STRIDE = {"spatial": (1, 2, 2), "temporal": (2, 1, 1), "spatiotemporal": (2, 2, 2)}


class _Conv3dParams(nn.Module):
    """The checkpoint's inner ``conv`` (an ``nn.Conv3d``'s weight and bias), f32."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int, int], device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()


class LTXCausalConv3d(nn.Module):
    """Conv3d over NDHWC with replicate temporal padding (causal: all on the
    left) and zero or reflect spatial padding."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=(1, 1, 1), causal: bool = True,
                 reflect: bool = False, *, dtype, device=None):
        super().__init__()
        self.kernel, self.stride, self.causal, self.reflect, self.dtype = kernel, stride, causal, reflect, dtype
        self.conv = _Conv3dParams(cin, cout, kernel, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel
        if kt > 1:
            lo = kt - 1 if self.causal else (kt - 1) // 2
            hi = 0 if self.causal else (kt - 1) // 2
            x = torch.cat([x[:, :1]] * lo + [x] + [x[:, -1:]] * hi, dim=1)
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last in memory
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        if ph or pw:
            x = F.pad(x, (pw, pw, ph, ph, 0, 0), mode="reflect" if self.reflect else "constant")
        y = F.conv3d(x, self.conv.weight.to(self.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 4, 1) + self.conv.bias.to(self.dtype)


def _rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


class LTXResnetBlock3d(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float, causal: bool, reflect: bool, *, dtype, device=None):
        super().__init__()
        self.eps = eps
        kw = dict(dtype=dtype, device=device)
        self.conv1 = LTXCausalConv3d(cin, cout, causal=causal, reflect=reflect, **kw)
        self.conv2 = LTXCausalConv3d(cout, cout, causal=causal, reflect=reflect, **kw)
        self.conv_shortcut = LTXCausalConv3d(cin, cout, (1, 1, 1), causal=causal, **kw) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(_rms_norm(x, self.eps)))
        h = self.conv2(F.silu(_rms_norm(h, self.eps)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


def _space_to_depth(x: torch.Tensor, s) -> torch.Tensor:
    """NDHWC, channel-major blocks ``(c, st, sh, sw)``."""
    b, t, h, w, c = x.shape
    st, sh, sw = s
    x = x.reshape(b, t // st, st, h // sh, sh, w // sw, sw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, t // st, h // sh, w // sw, c * st * sh * sw)


def _depth_to_space(x: torch.Tensor, s) -> torch.Tensor:
    b, t, h, w, c = x.shape
    st, sh, sw = s
    x = x.reshape(b, t, h, w, c // (st * sh * sw), st, sh, sw).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * st, h * sh, w * sw, c // (st * sh * sw))


class LTXDownsampler3d(nn.Module):
    def __init__(self, cin: int, cout: int, kind: str, causal: bool, *, dtype, device=None):
        super().__init__()
        self.s, self.cin, self.cout = _STRIDE[kind], cin, cout
        prod = self.s[0] * self.s[1] * self.s[2]
        self.conv = LTXCausalConv3d(cin, cout // prod, causal=causal, dtype=dtype, device=device)

    def forward(self, x):
        s = self.s
        prod = s[0] * s[1] * s[2]
        if s[0] > 1:  # the first frame replicated, so 8k+1 frames stay aligned
            x = torch.cat([x[:, :1]] * (s[0] - 1) + [x], dim=1)
        y = _space_to_depth(self.conv(x), s)
        res = _space_to_depth(x, s)
        res = res.reshape(*res.shape[:-1], self.cout, (self.cin * prod) // self.cout).mean(dim=-1)
        return y + res.to(y.dtype)


class LTXUpsampler3d(nn.Module):
    def __init__(self, cin: int, kind: str, factor: int, residual: bool, causal: bool, reflect: bool, *, dtype,
                 device=None):
        super().__init__()
        self.s, self.factor, self.residual = _STRIDE[kind], factor, residual
        prod = self.s[0] * self.s[1] * self.s[2]
        self.conv = LTXCausalConv3d(cin, cin * prod // factor, causal=causal, reflect=reflect, dtype=dtype,
                                    device=device)

    def forward(self, x):
        s = self.s
        prod = s[0] * s[1] * s[2]
        y = _depth_to_space(self.conv(x), s)[:, s[0] - 1:]
        if self.residual:
            res = _depth_to_space(x, s).repeat(1, 1, 1, 1, prod // self.factor)
            y = y + res[:, s[0] - 1:].to(y.dtype)
        return y


def _patchify(x: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    return _space_to_depth(x, (pt, p, p))


def _unpatchify(x: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    return _depth_to_space(x, (pt, p, p))


class _Blocks(nn.Module):
    """diffusers ``down_blocks.{i}`` / ``up_blocks.{i}`` / ``mid_block``: ``resnets`` and a resampler."""

    def __init__(self, resnets: list[nn.Module], sampler_name: str | None = None, sampler: nn.Module | None = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler_name is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class LTXVideoEncoder3d(nn.Module):
    def __init__(self, cfg: LTXVideoVAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        ch, causal = cfg.block_out_channels, cfg.encoder_causal
        pin = cfg.in_channels * cfg.patch_size_t * cfg.patch_size ** 2
        self.conv_in = LTXCausalConv3d(pin, ch[0], causal=causal, **kw)
        blocks = []
        for i, kind in enumerate(cfg.downsample_type):
            d, out = ch[i], ch[i + 1] if i + 1 < len(ch) else ch[-1]
            blocks.append(_Blocks([LTXResnetBlock3d(d, d, cfg.eps, causal, False, **kw)
                                   for _ in range(cfg.layers_per_block[i])],
                                  "downsamplers", LTXDownsampler3d(d, out, kind, causal, **kw)))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Blocks([LTXResnetBlock3d(ch[-1], ch[-1], cfg.eps, causal, False, **kw)
                                  for _ in range(cfg.layers_per_block[-1])])
        self.conv_out = LTXCausalConv3d(ch[-1], 2 * cfg.latent_channels, causal=causal, **kw)

    def forward(self, x):
        cfg = self.cfg
        x = self.conv_in(_patchify(x, cfg.patch_size_t, cfg.patch_size))
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x)
            x = blk.downsamplers[0](x)
        for r in self.mid_block.resnets:
            x = r(x)
        return self.conv_out(F.silu(_rms_norm(x, cfg.eps)))


class LTXVideoDecoder3d(nn.Module):
    def __init__(self, cfg: LTXVideoVAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        causal, refl = cfg.decoder_causal, cfg.decoder_reflect_pad
        d = cfg.decoder_channels[0]
        self.conv_in = LTXCausalConv3d(cfg.latent_channels, d, causal=causal, reflect=refl, **kw)
        self.mid_block = _Blocks([LTXResnetBlock3d(d, d, cfg.eps, causal, refl, **kw)
                                  for _ in range(cfg.decoder_layers[0])])
        blocks = []
        for i, kind in enumerate(cfg.upsample_type):
            din = cfg.decoder_channels[i]
            d = din // cfg.upsample_factor[i]
            up = LTXUpsampler3d(din, kind, cfg.upsample_factor[i], cfg.upsample_residual[i], causal, refl, **kw)
            blocks.append(_Blocks([LTXResnetBlock3d(d, d, cfg.eps, causal, refl, **kw)
                                   for _ in range(cfg.decoder_layers[i + 1])], "upsamplers", up))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_out = LTXCausalConv3d(d, cfg.in_channels * cfg.patch_size_t * cfg.patch_size ** 2, causal=causal,
                                        reflect=refl, **kw)

    def forward(self, z):
        cfg = self.cfg
        x = self.conv_in(z)
        for r in self.mid_block.resnets:
            x = r(x)
        for blk in self.up_blocks:
            x = blk.upsamplers[0](x)
            for r in blk.resnets:
                x = r(x)
        x = self.conv_out(F.silu(_rms_norm(x, cfg.eps)))
        return _unpatchify(x, cfg.patch_size_t, cfg.patch_size)


class LTXVideoVAE(nn.Module):
    """encode: ``[B, T, H, W, 3]`` (T = 8k+1) -> normalized latents ``[B, k+1,
    H/32, W/32, 128]`` (the posterior mean, or a sample with ``generator``);
    decode inverts."""

    def __init__(self, cfg: LTXVideoVAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = LTXVideoEncoder3d(cfg, device=device)
        self.decoder = LTXVideoDecoder3d(cfg, device=device)

    def _stats(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg.latent_channels
        mean = torch.tensor(self.cfg.latents_mean or (0.0,) * c, dtype=torch.float32, device=device)
        std = torch.tensor(self.cfg.latents_std or (1.0,) * c, dtype=torch.float32, device=device)
        return mean, std

    def raw_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        mean, logvar = self.encoder(x).chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
            noise = torch.randn(mean.shape, generator=generator, dtype=torch.float32, device=mean.device)
            mean = mean + (std * noise).to(mean.dtype)
        lm, ls = self._stats(mean.device)
        return ((mean.float() - lm) / ls).to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        lm, ls = self._stats(z.device)
        return self.decoder((z.float() * ls + lm).to(z.dtype))

    def forward(self, x):
        return self.decode(self.encode(x))
