"""The OmniGen2 transformer (``ai_toolkit_tpu/models/omnigen2_dit.py`` in
PyTorch), diffusers ``OmniGen2Transformer2DModel``: Lumina2's NextDiT blocks
(``models/lumina2_dit.py``) with a reference-image stream.

Beside the Lumina2 modules it holds ``ref_image_patch_embedder`` (the
packed reference latents to the model width), ``image_index_embedding``
``[5, dim]`` (row j added to every token of reference j) and
``ref_image_refiner``, modulated blocks that refine each reference as its
own batch row with the time embedding repeated. Rope ids: caption token i
at (i, i, i); reference j's token (r, c) at (cap_len + j * max(rh, rw), r,
c); the noise image's at (cap_len + R * max(rh, rw), r, c). The joint
sequence is ``[caption | references | image]`` under the caption's key mask
and the output is its last ``n_img`` tokens. References have one shape per
batch (the data pipeline buckets them), as in JAX. The time embedding takes
``timestep_scale`` as its time factor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ai_toolkit_tpu_torch.models.lumina2_dit import (
    Lumina2Block,
    Lumina2Config,
    Lumina2DiT,
    caption_angles,
    grid_angles,
)
from ai_toolkit_tpu_torch.ops.layers import Linear


@dataclass(frozen=True)
class OmniGen2Config(Lumina2Config):
    # the released OmniGen2 transformer; a checkpoint's transformer/config.json overrides these
    dim: int = 2520
    n_layers: int = 32
    n_heads: int = 21
    n_kv_heads: int = 7
    cap_feat_dim: int = 2048  # Qwen2.5-VL-3B's width
    ffn_hidden: int = 10240  # 256 * ceil(4 * 2520 / 256)
    axes_dims: tuple[int, ...] = (40, 40, 40)
    timestep_scale: float = 1.0
    max_ref_images: int = 5  # image_index_embedding rows

    @classmethod
    def tiny(cls, **kw) -> "OmniGen2Config":
        base = dict(in_channels=4, out_channels=4, dim=32, n_layers=2, n_refiner_layers=1, n_heads=2,
                    n_kv_heads=1, cap_feat_dim=24, ffn_hidden=64, axes_dims=(4, 6, 6), dtype=torch.float32)
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf(cls, hf: dict, **kw) -> "OmniGen2Config":
        """From a diffusers ``transformer/config.json`` dict (JAX
        ``OmniGen2Config.from_hf``): ``hidden_size`` is required, the ffn
        width rounds ``ffn_dim_multiplier * 4 * dim`` up to ``multiple_of``."""
        mult = hf.get("ffn_dim_multiplier") or 1.0
        m_of = hf.get("multiple_of", 256)
        dim = hf["hidden_size"]
        base = dict(in_channels=hf.get("in_channels", 16),
                    out_channels=hf.get("out_channels") or hf.get("in_channels", 16),
                    patch_size=hf.get("patch_size", 2), dim=dim, n_layers=hf.get("num_layers", 32),
                    n_refiner_layers=hf.get("num_refiner_layers", 2), n_heads=hf.get("num_attention_heads", 21),
                    n_kv_heads=hf.get("num_kv_heads", 7), cap_feat_dim=hf.get("text_feat_dim", 2048),
                    ffn_hidden=m_of * math.ceil(int(mult * 4 * dim) / m_of),
                    axes_dims=tuple(hf.get("axes_dim_rope", (40, 40, 40))), norm_eps=hf.get("norm_eps", 1e-5),
                    timestep_scale=float(hf.get("timestep_scale", 1.0)))
        base.update(kw)
        return cls(**base)


def omnigen2_pos_angles(cfg: OmniGen2Config, hp: int, wp: int, cap_lens: torch.Tensor, t_max: int,
                        ref_hw: tuple[int, int] | None = None, n_ref: int = 0):
    """``(caption [B, t_max, hd/2], image [B, hp*wp, hd/2], references
    [B, R, rh*rw, hd/2] | None)``."""
    cap = caption_angles(cfg, cap_lens.shape[0], t_max, cap_lens.device)
    ell = cap_lens.float()
    if ref_hw is None or n_ref == 0:
        return cap, grid_angles(cfg, hp, wp, ell), None
    rhp, rwp = ref_hw
    step = float(max(rhp, rwp))
    refs = torch.stack([grid_angles(cfg, rhp, rwp, ell + j * step) for j in range(n_ref)], dim=1)
    return cap, grid_angles(cfg, hp, wp, ell + n_ref * step), refs


class OmniGen2DiT(Lumina2DiT):
    """``forward(img, cap, t, cap_mask, img_ang, cap_ang, refs [B, R, N_ref,
    p*p*C] | None, ref_ang [B, R, N_ref, hd/2] | None)``."""

    def __init__(self, cfg: OmniGen2Config, *, device=None):
        super().__init__(cfg, device=device)
        p = cfg.patch_size
        self.time_factor = cfg.timestep_scale
        self.ref_image_patch_embedder = Linear(p * p * cfg.in_channels, cfg.dim, device=device, dtype=cfg.dtype)
        self.ref_image_refiner = nn.ModuleList(Lumina2Block(cfg, True, device=device)
                                               for _ in range(cfg.n_refiner_layers))
        self.image_index_embedding = nn.Parameter(torch.empty(cfg.max_ref_images, cfg.dim, device=device,
                                                              dtype=cfg.dtype))

    def init_weights(self, generator: torch.Generator) -> None:
        self.image_index_embedding.copy_(torch.empty_like(self.image_index_embedding, dtype=torch.float32)
                                         .normal_(0.0, 0.02, generator=generator))

    def forward(self, img, cap, t, cap_mask, img_ang, cap_ang, refs=None, ref_ang=None):
        b, n_img = img.shape[:2]
        temb, cap, x, cap_mask = self.embed(img, cap, t, cap_mask, cap_ang)
        r = None
        if refs is not None:
            n_r = refs.shape[1]
            r = self.ref_image_patch_embedder(refs) + self.image_index_embedding[None, :n_r, None, :].to(x.dtype)
        for blk in self.noise_refiner:
            x = blk(x, img_ang, None, temb)
        parts, angs = [cap], [cap_ang]
        if r is not None:  # each reference refines as its own batch row
            n_r, n_rtok = r.shape[1], r.shape[2]
            rf = r.reshape(b * n_r, n_rtok, -1)
            ra = ref_ang.reshape(b * n_r, n_rtok, ref_ang.shape[-1])
            rtemb = temb.repeat_interleave(n_r, dim=0)
            for blk in self.ref_image_refiner:
                rf = blk(rf, ra, None, rtemb)
            parts.append(rf.reshape(b, n_r * n_rtok, -1))
            angs.append(ref_ang.reshape(b, n_r * n_rtok, ref_ang.shape[-1]))
        parts.append(x)
        angs.append(img_ang)
        n_rest = sum(p.shape[1] for p in parts[1:])
        key_ok = torch.cat([cap_mask, torch.ones((b, n_rest), dtype=torch.bool, device=x.device)], dim=1)
        return self.joint(torch.cat(parts, dim=1), torch.cat(angs, dim=1), key_ok, temb, n_img)


def omnigen2_lora_targets(use_image_refiner: bool = False) -> list[str]:
    """The joint layers, the noise and caption refiners, and with
    ``use_image_refiner`` the reference refiner (JAX ``lora_targets``)."""
    targets = [r"^layers\.", r"^noise_refiner\.", r"^context_refiner\."]
    return targets + [r"^ref_image_refiner\."] if use_image_refiner else targets
