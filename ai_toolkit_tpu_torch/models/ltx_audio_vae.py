"""LTX-2 mel audio VAE (``ai_toolkit_tpu/models/ltx_audio_vae.py`` in
PyTorch; diffusers ``AutoencoderKLLTX2Audio``), NHWC at its boundary, and
the log-mel front end that feeds it.

Stereo log-mels ``[B, T, mel, 2]`` (the mel time axis is the image height)
-> a taming-style encoder whose 3x3 convolutions pad causally along time
(two rows on top), parameter-free pixel norms, stride-2 downsamplers padded
at the front of time and the right of the mel axis -> ``2 x latent``
moments through ``quant_conv`` -> latents ``[B, T/4, mel/4, 8]``,
normalized by the checkpoint's statistics. The decoder mirrors it with
nearest 2x upsamples that drop their first row (the causal look-ahead).
:func:`pack_audio_latents` flattens ``(mel, channels)`` into the DiT's
128-wide audio tokens. Module names are the checkpoint's
(``encoder.down.0.block.1.conv1``, ``decoder.up.1.upsample.conv``), f32.

:func:`log_mel` is JAX's ``log_mel_jax``: frames of ``n_fft`` samples every
``hop`` with no centre padding, the symmetric Hann window of
``np.hanning`` (``torch.stft``'s defaults differ on both), the power of
``torch.fft.rfft``, JAX's own mel filterbank (:func:`mel_filterbank`, HTK
mel scale, triangles on the rfft bins) and ``log(max(mel, 1e-5))``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import lecun_normal_


@dataclass(frozen=True)
class LTXAudioVAEConfig:
    in_channels: int = 2
    base_channels: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    latent_channels: int = 8
    mel_bins: int = 64
    sample_rate: int = 16000
    hop_length: int = 160
    causal: bool = True  # causal along the time (height) axis
    latents_mean: tuple[float, ...] | None = None
    latents_std: tuple[float, ...] | None = None

    @classmethod
    def ltx2(cls) -> "LTXAudioVAEConfig":
        return cls()

    @property
    def time_downscale(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def downscale(self) -> int:
        """Waveform samples per audio token: the mel hop times the VAE's time stride."""
        return self.hop_length * self.time_downscale


class _Conv2d(nn.Module):
    """A 2-D convolution over NHWC with explicit ``(top, bottom, left, right)`` zero padding."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, pad=(0, 0, 0, 0), *, device=None):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom, left, right = self.pad
        x = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride).permute(0, 2, 3, 1)


def _causal_conv(cin: int, cout: int, causal: bool, device=None) -> _Conv2d:
    """3x3, two rows of zeros on top when causal (one each side when not), one column each side."""
    return _Conv2d(cin, cout, 3, 1, (2, 0, 1, 1) if causal else (1, 1, 1, 1), device=device)


def _pixel_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, causal: bool, *, device=None):
        super().__init__()
        self.conv1 = _causal_conv(cin, cout, causal, device)
        self.conv2 = _causal_conv(cout, cout, causal, device)
        self.nin_shortcut = _Conv2d(cin, cout, 1, device=device) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(_pixel_norm(self.conv1(F.silu(_pixel_norm(x))))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class _Level(nn.Module):
    """``down.{i}`` / ``up.{i}``: ``block`` and an optional ``downsample.conv`` / ``upsample.conv``."""

    def __init__(self, blocks: list[nn.Module], sampler_name: str | None = None, conv: nn.Module | None = None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if sampler_name is not None:
            sampler = nn.Module()
            sampler.conv = conv
            setattr(self, sampler_name, sampler)


class _Mid(nn.Module):
    def __init__(self, ch: int, causal: bool, device=None):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, causal, device=device)
        self.block_2 = ResnetBlock(ch, ch, causal, device=device)

    def forward(self, x):
        return self.block_2(self.block_1(x))


class AudioEncoder(nn.Module):
    def __init__(self, cfg: LTXAudioVAEConfig, *, device=None):
        super().__init__()
        ch, c = [cfg.base_channels * m for m in cfg.ch_mult], cfg.causal
        self.conv_in = _causal_conv(cfg.in_channels, ch[0], c, device)
        # taming's Downsample pads right / bottom; the causal axis pads in front instead
        down_pad = (1, 0, 0, 1) if c else (0, 1, 0, 1)
        self.down = nn.ModuleList(
            _Level([ResnetBlock(ch[i], ch[i], c, device=device) for _ in range(cfg.num_res_blocks)],
                   *(("downsample", _Conv2d(ch[i], ch[i + 1], 3, 2, down_pad, device=device))
                     if i < len(ch) - 1 else ()))
            for i in range(len(ch)))
        self.mid = _Mid(ch[-1], c, device)
        self.conv_out = _causal_conv(ch[-1], 2 * cfg.latent_channels, c, device)

    def forward(self, x):
        x = self.conv_in(x)
        for level in self.down:
            for b in level.block:
                x = b(x)
            if hasattr(level, "downsample"):
                x = level.downsample.conv(x)
        return self.conv_out(F.silu(_pixel_norm(self.mid(x))))


class AudioDecoder(nn.Module):
    def __init__(self, cfg: LTXAudioVAEConfig, *, device=None):
        super().__init__()
        ch, c = [cfg.base_channels * m for m in cfg.ch_mult], cfg.causal
        self.causal = c
        self.conv_in = _causal_conv(cfg.latent_channels, ch[-1], c, device)
        self.mid = _Mid(ch[-1], c, device)
        self.up = nn.ModuleList(
            _Level([ResnetBlock(ch[i], ch[i], c, device=device) for _ in range(cfg.num_res_blocks + 1)],
                   *(("upsample", _causal_conv(ch[i], ch[i - 1], c, device)) if i > 0 else ()))
            for i in range(len(ch)))
        self.conv_out = _causal_conv(ch[0], cfg.in_channels, c, device)

    def forward(self, z):
        x = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for b in level.block:
                x = b(x)
            if hasattr(level, "upsample"):
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                if self.causal:
                    x = x[:, 1:]  # drop the look-ahead row the upsample introduced
                x = level.upsample.conv(x)
        return self.conv_out(F.silu(_pixel_norm(x)))


class LTXAudioVAE(nn.Module):
    """encode: mel ``[B, T, mel, 2]`` -> normalized latents ``[B, T/4, mel/4,
    8]`` (the posterior mean, or a sample with ``generator``); decode inverts
    to mel space."""

    def __init__(self, cfg: LTXAudioVAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg, device=device)
        self.quant_conv = _Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, device=device)
        self.post_quant_conv = _Conv2d(cfg.latent_channels, cfg.latent_channels, 1, device=device)
        self.decoder = AudioDecoder(cfg, device=device)

    def _stats(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg.latent_channels
        mean = torch.tensor(self.cfg.latents_mean or (0.0,) * c, dtype=torch.float32, device=device)
        std = torch.tensor(self.cfg.latents_std or (1.0,) * c, dtype=torch.float32, device=device)
        return mean, std

    def raw_moments(self, mel: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(mel))

    def encode(self, mel: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        mean, logvar = self.raw_moments(mel).chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
            mean = mean + std * torch.randn(mean.shape, generator=generator, dtype=torch.float32, device=mean.device)
        lm, ls = self._stats(mean.device)
        return (mean.float() - lm) / ls

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        lm, ls = self._stats(z.device)
        return self.decoder(self.post_quant_conv(z.float() * ls + lm))


def pack_audio_latents(z: torch.Tensor) -> torch.Tensor:
    """``[B, T, mel_lat, C]`` -> ``[B, T, mel_lat * C]`` DiT tokens."""
    b, t, w, c = z.shape
    return z.reshape(b, t, w * c)


def unpack_audio_latents(tokens: torch.Tensor, mel_lat: int) -> torch.Tensor:
    b, t, d = tokens.shape
    return tokens.reshape(b, t, mel_lat, d // mel_lat)


def log_mel(wav: torch.Tensor, sample_rate: int = 16000, n_fft: int = 1024, hop: int = 160,
            n_mels: int = 64) -> torch.Tensor:
    """``[B, S, C]`` waveform -> ``[B, T, n_mels, C]`` log-mel, T = ``1 + (S - n_fft) // hop``
    (JAX ``log_mel_jax``; frame indices past the end are clamped, as JAX's gather clamps them)."""
    s = wav.shape[1]
    n_frames = max(1, 1 + (s - n_fft) // hop)
    idx = np.minimum(np.arange(n_fft)[None] + hop * np.arange(n_frames)[:, None], s - 1)
    idx = torch.from_numpy(idx).to(wav.device)
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(wav.device)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(wav.device)
    frames = wav.float()[:, idx, :] * win[None, None, :, None]  # [B, T, n_fft, C]
    power = torch.fft.rfft(frames, dim=2).abs().square()
    mel = torch.einsum("btfc,mf->btmc", power, fb)
    return torch.log(mel.clamp(min=1e-5))


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """``[n_mels, n_fft // 2 + 1]`` triangles on the HTK mel scale (JAX ``_mel_filterbank``)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb
