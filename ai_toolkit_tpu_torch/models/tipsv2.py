"""TIPSv2 DPT dense-prediction model (``ai_toolkit_tpu/models/tipsv2.py`` in
PyTorch): the backbone of the DFE v7 / v8 perceptual loss.

A DINOv2-style ViT-B/14 (a cls token and register tokens, LayerScale, a
position table interpolated to the patch grid) whose four collected layers
feed three DPT trunks (readout-project reassemble, a pre-activation fusion
stack) with their heads: bin-weighted depth, l2-normalised normals and
150-class segmentation. Tensors are NHWC, in f32 as in the JAX package.

The module names are the reference checkpoint's (``vision_encoder.blocks.*``,
``depth_head.reassemble.*``, the map JAX ``tipsv2_tree`` reads), so
:func:`load_tipsv2_dpt` loads ``model.safetensors`` / ``dpt.safetensors`` /
``backbone.safetensors`` directly. Linear weights are ``[out, in]``, convs
OIHW, the two transposed convs ``[in, out, k, k]``.

Numerics that follow the JAX package:

- the patch conv pads as flax ``nn.Conv``'s SAME does: ``ceil(H / 14)``
  patches, the padding split low = total // 2 (512 px: 37 patches, 3 + 3);
- linear resizes (the position table, the fusion residuals, the heads'
  outputs) are ``jax.image.resize``'s: half-pixel centres, antialiased only
  when they shrink;
- the fusion upsampling is align_corners=True, done as JAX does it (a gather
  of the two neighbours and a lerp at ``linspace`` positions);
- the k == stride transposed convs are one einsum over non-overlapping tiles.

Attention at head dim 64 goes to ``ops/attention.dot_product_attention``,
the flash kernels on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.layers import Conv, LayerNorm, Linear, init_parameters


@dataclass(frozen=True)
class TIPSConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 14
    img_size: int = 448  # the position table's native resolution
    num_register_tokens: int = 1
    init_values: float = 1.0  # LayerScale init
    channels: int = 256
    post_process_channels: tuple = (96, 192, 384, 768)
    block_indices: tuple = (2, 5, 8, 11)
    num_depth_bins: int = 256
    min_depth: float = 1e-3
    max_depth: float = 10.0
    num_seg_classes: int = 150

    @classmethod
    def b14_dpt(cls) -> "TIPSConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "TIPSConfig":
        return cls(embed_dim=32, depth=4, num_heads=2, img_size=56, channels=16,
                   post_process_channels=(8, 12, 16, 24), block_indices=(0, 1, 2, 3),
                   num_depth_bins=16, num_seg_classes=5)


def resize_linear(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, oh, ow, C), "linear")`` over NHWC: bilinear
    with half-pixel centres, antialiased along an axis that shrinks."""
    b, h, w, c = x.shape
    if (h, w) == (oh, ow):
        return x
    y = x.permute(0, 3, 1, 2)
    if oh < h or ow < w:
        y = F.interpolate(y, size=(oh, ow), mode="bilinear", align_corners=False, antialias=True)
    else:
        y = F.interpolate(y, size=(oh, ow), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True over NHWC, as JAX
    ``_resize_ac_true`` computes it."""
    b, h, w, c = x.shape
    ys = torch.linspace(0.0, h - 1.0, oh, device=x.device)
    xs = torch.linspace(0.0, w - 1.0, ow, device=x.device)
    y0 = ys.floor().long().clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0.to(ys.dtype))[None, :, None, None].to(x.dtype)
    wx = (xs - x0.to(xs.dtype))[None, None, :, None].to(x.dtype)
    rows0, rows1 = x[:, y0], x[:, y1]
    top = rows0[:, :, x0] * (1 - wx) + rows0[:, :, x1] * wx
    bot = rows1[:, :, x0] * (1 - wx) + rows1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax SAME padding of NHWC ``x`` for a ``k`` x ``k`` conv at stride ``s``."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad orders the last dims first: W, then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, *, device=None):
        super().__init__()
        self.init = init
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        self.gamma.fill_(self.init)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, *, device=None):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, device=device, dtype=torch.float32)
        self.proj = Linear(dim, dim, device=device, dtype=torch.float32)

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.qkv(x).unflatten(-1, (3, self.heads, d // self.heads)).unbind(2)
        return self.proj(dot_product_attention(q, k, v).reshape(b, s, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device=device, dtype=torch.float32)
        self.fc2 = Linear(hidden, dim, device=device, dtype=torch.float32)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: TIPSConfig, *, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, 1e-6, device=device)
        self.attn = Attention(d, cfg.num_heads, device=device)
        self.ls1 = LayerScale(d, cfg.init_values, device=device)
        self.norm2 = LayerNorm(d, 1e-6, device=device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), device=device)
        self.ls2 = LayerScale(d, cfg.init_values, device=device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1.gamma
        return x + self.mlp(self.norm2(x)) * self.ls2.gamma


class PatchEmbed(nn.Module):
    def __init__(self, cfg: TIPSConfig, *, device=None):
        super().__init__()
        self.p = cfg.patch_size
        self.proj = Conv(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, padding=0, device=device,
                         dtype=torch.float32)

    def forward(self, images):
        return self.proj(_same_pad(images.float(), self.p, self.p))


class VisionEncoder(nn.Module):
    """images ``[B, H, W, 3]`` in [0, 1] -> ``[(cls [B, D], patches [B, gh, gw, D])]``
    at ``block_indices``, final-normed (JAX ``TIPSVisionTransformer``)."""

    def __init__(self, cfg: TIPSConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, side = cfg.embed_dim, cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, side * side + 1, d, device=device))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_register_tokens, d, device=device))
        self.blocks = nn.ModuleList(Block(cfg, device=device) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, 1e-6, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        if self.cfg.num_register_tokens:
            self.register_tokens.zero_()

    def interp_pos(self, gh: int, gw: int) -> torch.Tensor:
        """The position table at a ``gh`` x ``gw`` grid; the cls row passes through."""
        side = self.cfg.img_size // self.cfg.patch_size
        if (gh, gw) == (side, side):
            return self.pos_embed
        grid = resize_linear(self.pos_embed[:, 1:].reshape(1, side, side, -1), gh, gw)
        return torch.cat([self.pos_embed[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)

    def forward(self, images):
        cfg = self.cfg
        x = self.patch_embed(images)
        b, gh, gw, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d), x.reshape(b, gh * gw, d)], dim=1)
        x = x + self.interp_pos(gh, gw)
        nr = cfg.num_register_tokens
        if nr:
            x = torch.cat([x[:, :1], self.register_tokens.expand(b, nr, d), x[:, 1:]], dim=1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.block_indices:
                on = self.norm(x)
                outs.append((on[:, 0], on[:, 1 + nr:].reshape(b, gh, gw, d)))
        return outs


class ConvT(nn.Module):
    """ConvTranspose2d with kernel == stride: ``weight`` ``[in, out, s, s]``
    (torch layout), one einsum over the non-overlapping tiles."""

    def __init__(self, ch: int, s: int, *, device=None):
        super().__init__()
        self.s = s
        self.weight = nn.Parameter(torch.empty(ch, ch, s, s, device=device))
        self.bias = nn.Parameter(torch.empty(ch, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        from ai_toolkit_tpu_torch.ops.layers import lecun_normal_

        lecun_normal_(self.weight, self.s * self.s * self.weight.shape[0], generator)
        self.bias.zero_()

    def forward(self, x):
        b, h, w, _ = x.shape
        out = torch.einsum("bhwi,ioyx->bhywxo", x, self.weight)
        return out.reshape(b, h * self.s, w * self.s, -1) + self.bias


class PreActUnit(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3, padding=1, bias=False, device=device, dtype=torch.float32)
        self.conv2 = Conv(ch, ch, 3, padding=1, bias=False, device=device, dtype=torch.float32)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, ch: int, has_residual: bool, *, device=None):
        super().__init__()
        if has_residual:
            self.residual_unit = PreActUnit(ch, device=device)
        self.main_unit = PreActUnit(ch, device=device)
        self.out_conv = Conv(ch, ch, 1, padding=0, device=device, dtype=torch.float32)

    def forward(self, x, residual=None):
        if residual is not None and hasattr(self, "residual_unit"):
            residual = resize_linear(residual, x.shape[1], x.shape[2])
            x = x + self.residual_unit(residual)
        x = self.main_unit(x)
        return self.out_conv(resize_align_corners(x, x.shape[1] * 2, x.shape[2] * 2))


class Reassemble(nn.Module):
    def __init__(self, cfg: TIPSConfig, *, device=None):
        super().__init__()
        d, ppc = cfg.embed_dim, cfg.post_process_channels
        self.readout_projects = nn.ModuleList(Linear(2 * d, d, device=device, dtype=torch.float32)
                                              for _ in range(4))
        self.out_projections = nn.ModuleList(Conv(d, c, 1, padding=0, device=device, dtype=torch.float32)
                                             for c in ppc)
        self.resize_layers = nn.ModuleList([
            ConvT(ppc[0], 4, device=device), ConvT(ppc[1], 2, device=device), nn.Identity(),
            Conv(ppc[3], ppc[3], 3, stride=2, padding=1, device=device, dtype=torch.float32)])


class DPTTrunk(nn.Module):
    """reassemble (readout 'project') -> convs -> fusion stack -> project."""

    def __init__(self, cfg: TIPSConfig, *, device=None):
        super().__init__()
        ppc, ch = cfg.post_process_channels, cfg.channels
        self.reassemble = Reassemble(cfg, device=device)
        self.convs = nn.ModuleList(Conv(c, ch, 3, padding=1, bias=False, device=device, dtype=torch.float32)
                                   for c in ppc)
        self.fusion_blocks = nn.ModuleList(FusionBlock(ch, i > 0, device=device) for i in range(4))
        self.project = Conv(ch, ch, 3, padding=1, device=device, dtype=torch.float32)

    def forward(self, feats):
        ra = self.reassemble
        xs = []
        for i, (cls_tok, patch) in enumerate(feats):
            ro = cls_tok[:, None, None, :].expand(patch.shape)
            x = F.gelu(ra.readout_projects[i](torch.cat([patch, ro], dim=-1)))
            x = ra.resize_layers[i](ra.out_projections[i](x))
            xs.append(self.convs[i](x))
        out = self.fusion_blocks[0](xs[-1])
        for i in range(1, 4):
            out = self.fusion_blocks[i](out, xs[-(i + 1)])
        return self.project(out)


class Head(DPTTrunk):
    """A DPT trunk and its output linear, named as the reference's ``<task>_head``."""

    def __init__(self, cfg: TIPSConfig, linear: str, n_out: int, *, device=None):
        super().__init__(cfg, device=device)
        self.linear_name = linear
        setattr(self, linear, Linear(cfg.channels, n_out, device=device, dtype=torch.float32))

    def out(self, x):
        return getattr(self, self.linear_name)(x)


class TIPSv2DPT(nn.Module):
    """images ``[B, H, W, 3]`` in [0, 1] -> ``{head, depth, normals,
    segmentation}``, the DFE v7 feature stack (JAX ``TIPSv2DPT``)."""

    def __init__(self, cfg: TIPSConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_encoder = VisionEncoder(cfg, device=device)
        self.depth_head = Head(cfg, "depth_head", cfg.num_depth_bins, device=device)
        self.normals_head = Head(cfg, "normals_head", 3, device=device)
        self.segmentation_head = Head(cfg, "segmentation_head", cfg.num_seg_classes, device=device)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        feats = self.vision_encoder(images)
        head = torch.cat([p for _, p in feats], dim=-1)
        h, w = images.shape[1:3]
        out = self.depth_head.out(F.relu(self.depth_head(feats)))
        bins = torch.linspace(cfg.min_depth, cfg.max_depth, cfg.num_depth_bins, device=out.device)
        out = F.relu(out) + cfg.min_depth
        out = out / out.sum(dim=-1, keepdim=True)
        depth = resize_linear(torch.einsum("bhwn,n->bhw", out, bins)[..., None], h, w)
        nrm = self.normals_head.out(self.normals_head(feats))
        nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        nrm = resize_linear(nrm, h, w)
        seg = resize_linear(self.segmentation_head.out(self.segmentation_head(feats)), h, w)
        return {"head": head, "depth": depth, "normals": nrm, "segmentation": seg}


def init_tipsv2_dpt(cfg: TIPSConfig, generator: torch.Generator, device) -> TIPSv2DPT:
    """A seeded random TIPSv2 DPT (the DFE's ``v7`` with no weight directory),
    frozen."""
    return init_parameters(TIPSv2DPT(cfg, device=device), generator).eval().requires_grad_(False)


TIPS_FILES = ("model.safetensors", "dpt.safetensors", "backbone.safetensors")


def load_tipsv2_dpt(path: str, device, cfg: TIPSConfig | None = None) -> TIPSv2DPT:
    """The reference's local directory (``model.safetensors``, or the DPT heads
    and ``vision_encoder.*`` backbone split over ``dpt.safetensors`` /
    ``backbone.safetensors``; the first file to hold a key wins) -> the
    frozen module, loaded strictly (JAX ``load_tipsv2_dpt``; b14-dpt unless
    ``cfg`` is given)."""
    from safetensors import safe_open

    flat: dict[str, np.ndarray] = {}
    for fn in TIPS_FILES:
        fp = os.path.join(path, fn)
        if os.path.exists(fp):
            with safe_open(fp, "np") as f:
                for k in f.keys():
                    flat.setdefault(k, f.get_tensor(k))
    if not flat:
        raise FileNotFoundError(f"no tipsv2 safetensors under {path} (looked for {', '.join(TIPS_FILES)})")
    model = TIPSv2DPT(cfg or TIPSConfig.b14_dpt(), device=device)
    state = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model.eval().requires_grad_(False)
