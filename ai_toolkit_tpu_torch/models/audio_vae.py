"""1-D causal waveform VAE (``ai_toolkit_tpu/models/audio_vae.py``
``AudioAutoencoderKL`` in PyTorch), the ACE-Step stand-in's latent space
and the LTX-2 ``waveform`` audio backend.

``[B, S, C]`` waveforms (NLC at the boundary, as in JAX) -> strided causal
convolutions (left pad ``k - s``) with residual blocks -> ``[B, S / stride^(n-1),
latent]`` posterior means, and back: the decoder's nearest x``stride``
upsample is ``repeat_interleave`` along time. The parameters are stored in
the config's dtype (bf16 at full size), as the JAX module creates them
(``self.param(..., self.dtype)``), not f32 cast at use. Module names are the
JAX ones (``enc_blocks_1_0.conv1``), kernels in torch's ``[out, in, k]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import lecun_normal_


@dataclass(frozen=True)
class AudioVAEConfig:
    in_channels: int = 2  # stereo
    latent_channels: int = 64
    base_channels: int = 64
    channel_multipliers: tuple[int, ...] = (1, 2, 4, 8, 8)
    stride: int = 4  # per downsample stage: 4^4 = 256x compression
    scaling_factor: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def default(cls) -> "AudioVAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "AudioVAEConfig":
        return cls(latent_channels=4, base_channels=8, channel_multipliers=(1, 2), stride=4, dtype=torch.float32)

    @property
    def downscale(self) -> int:
        return self.stride ** (len(self.channel_multipliers) - 1)


class CausalConv1d(nn.Module):
    """Conv1d over ``[B, T, C]`` with ``k - s`` zeros on the left."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 7, stride: int = 1, *, dtype, device=None):
        super().__init__()
        self.k, self.stride = kernel_size, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=dtype))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (max(self.k - self.stride, 0), 0)).to(self.weight.dtype)
        return (F.conv1d(x, self.weight, stride=self.stride) + self.bias[:, None]).transpose(1, 2)


class ResBlock1d(nn.Module):
    def __init__(self, cin: int, ch: int, *, dtype, device=None):
        super().__init__()
        self.conv1 = CausalConv1d(cin, ch, 7, dtype=dtype, device=device)
        self.conv2 = CausalConv1d(ch, ch, 1, dtype=dtype, device=device)
        self.shortcut = CausalConv1d(cin, ch, 1, dtype=dtype, device=device) if cin != ch else None

    def forward(self, x):
        h = self.conv2(F.silu(self.conv1(F.silu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class AudioAutoencoderKL(nn.Module):
    def __init__(self, cfg: AudioVAEConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt, base, mults, n = cfg.dtype, cfg.base_channels, cfg.channel_multipliers, len(cfg.channel_multipliers)
        kw = dict(dtype=dt, device=device)
        self.enc_in = CausalConv1d(cfg.in_channels, base, 7, **kw)
        self.enc_levels, self.dec_levels = [], []
        cin = base
        for i, m in enumerate(mults):
            setattr(self, f"enc_blocks_{i}_0", ResBlock1d(cin, base * m, **kw))
            cin = base * m
            if i < n - 1:
                setattr(self, f"enc_blocks_{i}_1", CausalConv1d(cin, cin, cfg.stride * 2, cfg.stride, **kw))
            self.enc_levels.append(i)
        self.enc_out = CausalConv1d(cin, 2 * cfg.latent_channels, 3, **kw)
        self.dec_in = CausalConv1d(cfg.latent_channels, base * mults[-1], 3, **kw)
        cin = base * mults[-1]
        # JAX lists the decoder levels deepest first: dec_blocks_0 is the last level (no upsample)
        for j, (i, m) in enumerate(reversed(list(enumerate(mults)))):
            setattr(self, f"dec_blocks_{j}_0", ResBlock1d(cin, base * m, **kw))
            cin = base * m
            if i < n - 1:
                setattr(self, f"dec_blocks_{j}_1", CausalConv1d(cin, cin, cfg.stride * 2, 1, **kw))
            self.dec_levels.append(j)
        self.dec_out = CausalConv1d(cin, cfg.in_channels, 7, **kw)

    def _pair(self, prefix: str, i: int):
        return getattr(self, f"{prefix}_{i}_0"), getattr(self, f"{prefix}_{i}_1", None)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``[B, S, C]`` -> posterior means ``[B, S', latent]`` (a sample with ``generator``)."""
        h = self.enc_in(x)
        for i in self.enc_levels:
            res, down = self._pair("enc_blocks", i)
            h = res(h)
            if down is not None:
                h = down(h)
        mean, logvar = self.enc_out(h).chunk(2, dim=-1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            mean = mean + std * torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
        return mean * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dec_in(z / self.cfg.scaling_factor)
        for j in self.dec_levels:
            res, up = self._pair("dec_blocks", j)
            h = res(h)
            if up is not None:
                h = up(h.repeat_interleave(self.cfg.stride, dim=1))
        return self.dec_out(h)

    def forward(self, x):
        return self.decode(self.encode(x))
