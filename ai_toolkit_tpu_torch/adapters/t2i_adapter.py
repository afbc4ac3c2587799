"""The T2I adapter (``ai_toolkit_tpu/adapters/t2i_adapter.py`` in PyTorch):
a small conv net that turns a control image into one feature map per UNet
down level, added to the UNet's hidden states after each level's last
attention (``models/unet.py``). It trains as the ``t2i`` custom adapter,
or sits frozen as the assistant adapter (``adapter_assist_name_or_path``)
that steers another network's training.

:class:`T2IAdapterNet`: pixel-unshuffle by the VAE's downscale to the latent
grid, ``conv_in``, then per level ``proj_0`` (level 0) or a stride-2
``down_{i}``, and ``num_res_blocks`` residual blocks (conv, SiLU, conv,
added). Every conv is 3 x 3, f32, padded as XLA's ``SAME`` pads it (at
stride 2 over an even size: none before, one after). The module names are
the JAX ones, so :func:`t2i_flat` gives the JAX file's keys; its conv
weights are HWIO there, as JAX ``save_custom_adapter`` writes a 4-D kernel
as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import Conv, init_parameters


def _same_pad(x: torch.Tensor, stride: int, k: int = 3) -> torch.Tensor:
    """NHWC ``x`` padded as XLA's ``SAME`` at ``stride`` (the extra row and
    column after)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads))


class _ResBlock(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3, device=device, dtype=torch.float32)
        self.conv2 = Conv(ch, ch, 3, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.silu(self.conv1(x)))


class T2IAdapterNet(nn.Module):
    """Control image ``[B, H, W, 3]`` -> one ``[B, H/d/2^i, W/d/2^i, ch_i]``
    feature map per level ``i`` of ``channels`` (the UNet's
    ``block_out_channels``)."""

    def __init__(self, channels: tuple[int, ...], downscale: int = 8, num_res_blocks: int = 2, *, device=None):
        super().__init__()
        self.channels, self.downscale, self.num_res_blocks = tuple(channels), downscale, num_res_blocks
        f32 = torch.float32
        self.conv_in = Conv(3 * downscale * downscale, channels[0], 3, device=device, dtype=f32)
        prev = channels[0]
        for i, ch in enumerate(channels):
            if i == 0:
                self.proj_0 = Conv(prev, ch, 3, device=device, dtype=f32)
            else:
                setattr(self, f"down_{i}", Conv(prev, ch, 3, stride=2, padding=0, device=device, dtype=f32))
            for j in range(num_res_blocks):
                setattr(self, f"level_{i}_res_{j}", _ResBlock(ch, device=device))
            prev = ch

    def forward(self, control: torch.Tensor) -> tuple[torch.Tensor, ...]:
        d = self.downscale
        b, h, w, c = control.shape
        x = control.float().reshape(b, h // d, d, w // d, d, c).permute(0, 1, 3, 2, 4, 5)
        x = self.conv_in(x.reshape(b, h // d, w // d, d * d * c))
        feats = []
        for i in range(len(self.channels)):
            x = self.proj_0(x) if i == 0 else getattr(self, f"down_{i}")(_same_pad(x, 2))
            for j in range(self.num_res_blocks):
                x = getattr(self, f"level_{i}_res_{j}")(x)
            feats.append(x)
        return tuple(feats)


def init_t2i_adapter(unet_config, generator: torch.Generator, device, downscale: int = 8) -> T2IAdapterNet:
    """The seeded net for ``unet_config``'s levels (JAX ``init_t2i_adapter``)."""
    return init_parameters(T2IAdapterNet(tuple(unet_config.block_out_channels), downscale, device=device), generator)


def t2i_flat(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The net's tensors (a state dict, or the trained copies under the same
    names) in the JAX file's layout: conv weights HWIO, biases as they are."""
    return {k: (v.detach().float().permute(2, 3, 1, 0) if v.dim() == 4 else v.detach().float()).cpu().numpy()
            for k, v in state.items()}


def t2i_state_from_flat(flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of :func:`t2i_flat` (a file read by
    ``custom_adapter.load_custom_adapter``): a state dict for :class:`T2IAdapterNet`."""
    return {k: (v.permute(3, 2, 0, 1) if v.dim() == 4 else v).float().contiguous() for k, v in flat.items()}
