"""LTX-2 vocoder (``ai_toolkit_tpu/models/ltx_vocoder.py`` ``LTX2Vocoder`` in
PyTorch; diffusers ``LTX2Vocoder``): HiFi-GAN-family mel -> waveform.

``[B, T, 128]`` stereo mels (:func:`stack_stereo_mel`: the left channel's 64
bins, then the right's) -> ``conv_in`` (k 7) -> five levels of leaky ReLU
(0.1), a transposed convolution (kernels 16, 15, 8, 4, 4; strides 6, 5, 2,
2, 2; the HiFi-GAN padding ``(k - s) // 2``, which is
``conv_transpose1d``'s own ``padding``) halving the width, and the mean of
three residual stacks (kernels 3, 7, 11; dilations 1, 3, 5) -> leaky ReLU,
``conv_out`` (k 7) to 2 channels, tanh: ``[B, 240 T, 2]``. Module names are
the checkpoint's (``upsamplers.0``, ``resnets.4.convs1.2``), f32; a
transposed kernel is torch's ``[in, out, k]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import lecun_normal_


@dataclass(frozen=True)
class VocoderConfig:
    in_channels: int = 128
    hidden_channels: int = 1024
    out_channels: int = 2
    upsample_kernel_sizes: tuple[int, ...] = (16, 15, 8, 4, 4)
    upsample_factors: tuple[int, ...] = (6, 5, 2, 2, 2)
    resnet_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resnet_dilations: tuple[int, ...] = (1, 3, 5)
    leaky_slope: float = 0.1

    @classmethod
    def ltx2(cls) -> "VocoderConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VocoderConfig":
        return cls(in_channels=8, hidden_channels=16, upsample_kernel_sizes=(4, 4), upsample_factors=(2, 2),
                   resnet_kernel_sizes=(3,), resnet_dilations=(1, 3))

    @property
    def total_upsample(self) -> int:
        out = 1
        for f in self.upsample_factors:
            out *= f
        return out


class Conv1d(nn.Module):
    """A torch Conv1d over ``[B, T, C]`` with symmetric ``(k - 1) d / 2`` padding."""

    def __init__(self, cin: int, cout: int, kernel: int, dilation: int = 1, *, device=None):
        super().__init__()
        self.dilation, self.pad = dilation, (kernel - 1) * dilation // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        self.bias.zero_()

    def forward(self, x):
        return F.conv1d(x.transpose(1, 2), self.weight, self.bias, padding=self.pad,
                        dilation=self.dilation).transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """A torch ConvTranspose1d over ``[B, T, C]``: length ``(T - 1) s - 2p + k``, ``p = (k - s) // 2``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, *, device=None):
        super().__init__()
        self.stride, self.pad = stride, (kernel - stride) // 2
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=torch.float32))

    def init_weights(self, generator: torch.Generator) -> None:
        # flax lecun_normal over the JAX kernel (k, in, out): fan in k * in
        lecun_normal_(self.weight, self.weight.shape[0] * self.weight.shape[2], generator)
        self.bias.zero_()

    def forward(self, x):
        return F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias, stride=self.stride,
                                  padding=self.pad).transpose(1, 2)


class VocoderResBlock(nn.Module):
    def __init__(self, ch: int, kernel: int, dilations: tuple[int, ...], slope: float, *, device=None):
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList(Conv1d(ch, ch, kernel, d, device=device) for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(ch, ch, kernel, 1, device=device) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
        return x


class LTX2Vocoder(nn.Module):
    def __init__(self, cfg: VocoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv1d(cfg.in_channels, cfg.hidden_channels, 7, device=device)
        ups, res, ch = [], [], cfg.hidden_channels
        for k, u in zip(cfg.upsample_kernel_sizes, cfg.upsample_factors):
            ups.append(ConvTranspose1d(ch, ch // 2, k, u, device=device))
            ch //= 2
            res += [VocoderResBlock(ch, rk, cfg.resnet_dilations, cfg.leaky_slope, device=device)
                    for rk in cfg.resnet_kernel_sizes]
        self.upsamplers = nn.ModuleList(ups)
        self.resnets = nn.ModuleList(res)
        self.conv_out = Conv1d(ch, cfg.out_channels, 7, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """``[B, T, in_channels]`` -> ``[B, T * total_upsample, out_channels]`` in [-1, 1]."""
        cfg = self.cfg
        nk = len(cfg.resnet_kernel_sizes)
        x = self.conv_in(mel.float())
        for i, up in enumerate(self.upsamplers):
            x = up(F.leaky_relu(x, cfg.leaky_slope))
            acc = None
            for j in range(nk):
                y = self.resnets[nk * i + j](x)
                acc = y if acc is None else acc + y
            x = acc / nk
        return torch.tanh(self.conv_out(F.leaky_relu(x, cfg.leaky_slope)))


def stack_stereo_mel(mel: torch.Tensor) -> torch.Tensor:
    """``[B, T, n_mels, 2]`` -> ``[B, T, 2 n_mels]``: the left block, then the right."""
    b, t, m, c = mel.shape
    return mel.transpose(2, 3).reshape(b, t, c * m)
