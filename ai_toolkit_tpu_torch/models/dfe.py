"""The Diffusion Feature Extractor perceptual losses
(``ai_toolkit_tpu/models/dfe.py`` in PyTorch): the train step's aux loss
``aux_loss_fn(pred, noisy, latents, noise, t) -> scalar``.

- v1 / v2 (``latent_feature_extractor_path``, or a
  ``diffusion_feature_extractor_path`` that is no ``v7`` / ``v8``): a conv
  net at latent resolution, from a torch-layout file or a seeded random init
  when there is none. v1 matches the features of the prediction stepped to
  x0 with those of the clean latents, weighted by ``1 - t``; v2 the feature
  list of ``[pred, noise]`` with that of ``[noise - latents, noise]``.
- v7 / v8 (``"v7"``, ``"v8"`` or ``"v7:<dir>"``): the TIPSv2 b14-DPT
  (``models/tipsv2.py``) in pixel space. The prediction is stepped to x0
  and decoded by the VAE inside the differentiated graph; the target side
  decodes the clean latents (as JAX does: the VAE round trip of both sides
  instead of the dataset's pixels); the head features are matched by MSE
  and the depth, normals and segmentation maps by L1, each weighted per
  sample by ``1 / max(t, 0.1)^2``, the four averaged. v8 is v7 with a
  partial step of JAX's fixed 0.035 (the reference draws U(0.02, 0.05)),
  against the target noised to the same step, times 10.

The target sides run under ``torch.no_grad`` (JAX ``stop_gradient``). A
``v7`` without a directory is a seeded random backbone, as the JAX package
takes when it is offline; ``v7:<dir>`` loads the reference's safetensors
and raises when the directory holds none.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.models.tipsv2 import TIPSConfig, init_tipsv2_dpt, load_tipsv2_dpt
from ai_toolkit_tpu_torch.ops.layers import Conv, GroupNorm, init_parameters


def _conv(cin: int, cout: int, k: int, device) -> Conv:
    return Conv(cin, cout, k, padding=k // 2, device=device, dtype=torch.float32)


class DFEBlock(nn.Module):
    def __init__(self, ch: int, *, device=None):
        super().__init__()
        self.conv1, self.conv2 = _conv(ch, ch, 3, device), _conv(ch, ch, 3, device)
        self.proj = _conv(ch, ch, 1, device)

    def forward(self, x):
        return self.proj(F.gelu(self.conv2(self.conv1(x)))) + x


class DFEv1(nn.Module):
    """conv_in 1x1 -> 6 blocks -> conv_out 1x1 at latent resolution."""

    def __init__(self, in_channels: int, out_channels: int = 512, width: int = 512, num_blocks: int = 6, *,
                 device=None):
        super().__init__()
        self.conv_in = _conv(in_channels, width, 1, device)
        self.blocks = nn.ModuleList(DFEBlock(width, device=device) for _ in range(num_blocks))
        self.conv_out = _conv(width, out_channels, 1, device)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.blocks:
            x = blk(x)
        return self.conv_out(x)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, *, device=None):
        super().__init__()
        self.conv1, self.conv2 = _conv(cin, cout, 3, device), _conv(cout, cout, 3, device)
        self.norm1 = GroupNorm(cout, groups=8, device=device)
        self.norm2 = GroupNorm(cout, groups=8, device=device)
        self.skip = _conv(cin, cout, 1, device) if cin != cout else None

    def forward(self, x):
        identity = x if self.skip is None else self.skip(x)
        x = F.silu(self.norm1(self.conv1(x)))
        return F.silu(self.norm2(self.conv2(x)) + identity)


def _upsample2(x):
    """``jax.image.resize(x, 2x, "bilinear")``: half-pixel centres."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def _avg_pool2(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


# the reference's module lists: (name, kind) per index; "up" is an nn.Upsample, "pool" an AvgPool
_V2_PATHS = {
    "up_path": (("in", 1), "up", ("res", 1), "up", ("res", 1), "up", ("res", 1), ("out", 1)),
    "path2": (("in", 2), "up", ("res", 2), "up", ("res", 2), ("out", 2)),
    "path3": (("in", 4), "up", ("res", 4), ("out", 4)),
    "path4": (("in", 8), ("res", 8), ("res", 8), ("out", 8)),
    "path5": (("in", 8), ("res", 8), "pool", ("res", 8), ("out", 8)),
}


class DFEv2(nn.Module):
    """Five multi-scale paths over ``[x, noise]``; returns the feature list in
    the reference's order. Module names are the reference's
    (``up_path.2.conv1``)."""

    def __init__(self, in_channels: int, width: int = 64, *, device=None):
        super().__init__()
        for name, layers in _V2_PATHS.items():
            mods = []
            for spec in layers:
                if isinstance(spec, str):
                    mods.append(nn.Identity())
                    continue
                kind, mult = spec
                ch = mult * width
                mods.append(ResBlock(ch, ch, device=device) if kind == "res"
                            else _conv(in_channels if kind == "in" else ch, ch, 3, device))
            setattr(self, name, nn.ModuleList(mods))

    def forward(self, x):
        outs = []
        for name, layers in _V2_PATHS.items():
            h = x
            for spec, mod in zip(layers, getattr(self, name)):
                h = _upsample2(h) if spec == "up" else _avg_pool2(h) if spec == "pool" else mod(h)
            outs.append(h)
        return outs


def load_dfe(path: str | None, in_channels: int, device, generator: torch.Generator | None = None):
    """-> (module, version): the reference's torch-layout file at ``path``
    (v2 when it holds ``up_path.*``), or a seeded random v1 when ``path`` is
    None (JAX ``load_dfe``). Strict: every weight of the module must be in
    the file."""
    state, version = None, 1
    if path:
        from safetensors.torch import load_file

        state = load_file(path)
        version = 2 if any(k.startswith("up_path") for k in state) else 1
    module = DFEv1(in_channels, device=device) if version == 1 else DFEv2(2 * in_channels, device=device)
    if state is None:
        init_parameters(module, generator or torch.Generator(device=device).manual_seed(0))
    else:
        module.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return module.eval().requires_grad_(False), version


def make_dfe_loss(module: nn.Module, version: int, schedule, weight: float) -> Callable:
    """The v1 / v2 aux loss (JAX ``make_dfe_loss``)."""

    def v1_loss(pred, noisy, latents, noise, t):
        x0 = schedule.pred_to_x0(pred.float(), noisy.float(), t)
        pred_f = module(x0)
        with torch.no_grad():
            tgt_f = module(latents.float())
        scaler = (1.0 - t.float()).reshape(-1, *([1] * (pred_f.dim() - 1)))
        return weight * ((pred_f - tgt_f).square() * scaler).mean()

    def v2_loss(pred, noisy, latents, noise, t):
        nf = noise.float()
        with torch.no_grad():
            tgt_f = module(torch.cat([nf - latents.float(), nf], dim=-1))
        pred_f = module(torch.cat([pred.float(), nf], dim=-1))
        loss = 0.0
        for pf, tf in zip(pred_f, tgt_f):
            loss = loss + (pf - tf).square().mean()
        return weight * loss

    return v1_loss if version == 1 else v2_loss


V7_VERSIONS = ("v7", "v8", "v7-tiny", "v8-tiny")


def load_dfe7(path: str, device, generator: torch.Generator | None = None):
    """-> (TIPSv2 module, partial_step) for ``"v7"`` / ``"v8"`` (a seeded
    random b14-dpt; ``-tiny``: the tiny config, a test hook) or
    ``"v7:<dir>"`` / ``"v8:<dir>"`` (the reference's local weights; JAX
    ``load_dfe7``)."""
    ver, _, wdir = path.partition(":")
    partial = ver.startswith("v8")
    if wdir:
        return load_tipsv2_dpt(wdir, device), partial
    cfg = TIPSConfig.tiny() if ver.endswith("-tiny") else TIPSConfig.b14_dpt()
    print("DFE v7: no local tipsv2 weights: random-init backbone (pass 'v7:<dir>' with model.safetensors "
          "for the real one)")
    return init_tipsv2_dpt(cfg, generator or torch.Generator(device=device).manual_seed(7), device), partial


def make_dfe7_loss(module: nn.Module, schedule, weight: float, decode_fn: Callable,
                   partial_step: bool = False) -> Callable:
    """The v7 / v8 aux loss (JAX ``make_dfe7_loss``); ``decode_fn(latents) ->
    pixels in [-1, 1]``, differentiable."""

    def loss(pred, noisy, latents, noise, t):
        tv = t.float().reshape(-1, 1, 1, 1)
        if not partial_step:
            x0 = schedule.pred_to_x0(pred.float(), noisy.float(), t)
            tgt_lat = latents.float()
            tv_eff = tv.clamp_min(0.001)
        else:
            nxt = (tv - 0.035).clamp_min(0.0)
            x0 = noisy.float() + (nxt - tv) * pred.float()
            tgt_lat = (1.0 - nxt) * latents.float() + nxt * noise.float()
            tv_eff = tv
        p = module((decode_fn(x0).float() + 1.0) / 2.0)
        with torch.no_grad():
            tg = module((decode_fn(tgt_lat).float() + 1.0) / 2.0)
        w = 1.0 / tv_eff.clamp_min(0.1) ** 2  # the velocity-equivalent weight

        def red(a, b, sq):
            d = a.float() - b.float()
            return ((d.square() if sq else d.abs()) * w).mean()

        total = (red(p["head"], tg["head"], True) + red(p["depth"], tg["depth"], False)
                 + red(p["normals"], tg["normals"], False)
                 + red(p["segmentation"], tg["segmentation"], False)) / 4.0
        if partial_step:
            total = total * 10.0
        return weight * total

    return loss


def make_aux_loss(path, weight: float, model, variables: dict, schedule, device,
                  generator: torch.Generator | None = None) -> tuple[Callable, str]:
    """The job's aux loss for a feature-extractor path (JAX ``run``,
    ``jobs/train_process.py:512-550``) and the line that names it."""
    if isinstance(path, str) and path.split(":")[0] in V7_VERSIONS:
        module, partial = load_dfe7(path, device, generator)

        def decode(lat):
            return model.decode_latents(variables, lat)

        return (make_dfe7_loss(module, schedule, weight, decode, partial_step=partial),
                f"DFE perceptual loss active (tipsv2 {'v8 partial-step' if partial else 'v7'}, weight {weight})")
    in_ch = getattr(getattr(model, "vae_config", None), "latent_channels", 4)
    real = path if isinstance(path, str) and os.path.isfile(path) else None
    if real is None:
        print(f"DFE: no weight file at {path!r}: random-init feature net")
    module, version = load_dfe(real, in_ch, device, generator=generator)
    return make_dfe_loss(module, version, schedule, weight), f"DFE perceptual loss active (v{version}, weight {weight})"
