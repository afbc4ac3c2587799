"""Wan 2.1 text-to-video model wrapper (``ai_toolkit_tpu/models/wan_model.py``
``WanModel`` in PyTorch, arch ``wan21`` at sizes ``1.3b``, ``14b`` and
``tiny``): the flow-matching video DiT (``models/wan_dit.py``), UMT5 text
conditioning (T5-XXL with a relative-bias table per layer), the causal 3-D
VAE (``models/wan_vae.py``) and the frame-count grid of the VAE (4k+1
frames). Latents are 5-D, ``[B, T, h, w, C]``; a lone image is a one-frame
video.

The other archs of the JAX class (``wan21_i2v``, ``wan22_5b``, ``wan22_14b``,
``wan22_14b_i2v``), its two-expert ``multistage`` routing, control latents and
sequence parallelism raise ``NotImplementedError`` naming their slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from ai_toolkit_tpu_torch.models.wan_dit import (
    WanConfig,
    WanDiT,
    wan_lora_key,
    wan_lora_targets,
    wan_module_name,
    wan_patchify,
    wan_position_ids,
    wan_unpatchify,
)
from ai_toolkit_tpu_torch.models.wan_vae import WanVAE, WanVAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

# what the rest of slice E brings, in ROADMAP order
UNPORTED_ARCHS = {
    "wan21_i2v": "wan21_i2v (image-to-video, clip_vision.py) comes with slice E's first remaining item",
    "wan22_5b": "wan22_5b (the Wan 2.2 VAE's residual parts) comes with slice E's second remaining item",
    "wan22_14b": "wan22_14b (the multistage expert pair) comes with slice E's third remaining item",
    "wan22_14b_i2v": "wan22_14b_i2v (the multistage i2v pair) comes with slice E's third remaining item",
}
SEQUENCE_PARALLEL = "sequence parallelism (ring attention, multi-GPU) comes with slice E's last remaining item"


@register_model
class WanModel(BaseModel):
    arch = "wan21"
    archs = ["wan21", *UNPORTED_ARCHS]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 512

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        if config.arch in UNPORTED_ARCHS:
            raise NotImplementedError(UNPORTED_ARCHS[config.arch])
        kw = config.model_kwargs
        if kw.get("multistage"):
            raise NotImplementedError(UNPORTED_ARCHS["wan22_14b"])
        size = kw.get("size", "1.3b")
        umt5 = dataclasses.replace(T5Config.xxl(), per_layer_bias=True)
        if size == "tiny":
            self.dit_config = WanConfig.tiny()
            self.vae_config = WanVAEConfig.tiny()
            umt5 = dataclasses.replace(T5Config.tiny(), per_layer_bias=True)
            self.max_txt_len = 16
        elif size in ("14b", "14B"):
            self.dit_config = WanConfig.wan21_14b()
            self.vae_config = WanVAEConfig.wan21()
        elif size == "1.3b":
            self.dit_config = WanConfig.wan21_1_3b()
            self.vae_config = WanVAEConfig.wan21()
        else:
            raise NotImplementedError(f"wan21 size '{size}' (ported: 1.3b, 14b, tiny)")
        self.t5_config = umt5
        self.tokenizer = load_tokenizer(config.name_or_path, "tokenizer", vocab_size=umt5.vocab_size,
                                        eos_id=1, max_len=self.max_txt_len)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        dev = self.device
        variables = {"dit": WanDiT(self.dit_config, device=dev), "vae": WanVAE(self.vae_config, device=dev),
                     "t5": T5Encoder(self.t5_config, device=dev)}
        for m in variables.values():
            init_parameters(m, generator).eval().requires_grad_(False)
        return variables

    def load_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        return self.refuse_or_init(generator)

    def enable_sequence_parallel(self, *args, **kwargs) -> None:
        raise NotImplementedError(SEQUENCE_PARALLEL)

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        ids = np.stack([self.tokenizer.encode(p) for p in prompts])
        return {"txt": variables["t5"](torch.from_numpy(ids).long().to(self.device))}

    def rope_table(self, t: int, h: int, w: int) -> torch.Tensor:
        """The (t, y, x) rope table of a ``t x h x w`` latent grid, ``[1, N, head_dim/2, 2, 2]``."""
        pt, ph, pw = self.dit_config.patch_size
        ids = torch.from_numpy(wan_position_ids(t // pt, h // ph, w // pw)).to(self.device)
        return multi_axis_rope(ids, list(self.dit_config.axes_dim))

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, T, h, w, C]``; cond: txt, pe. Differentiable."""
        if cond.get("control_latents") is not None or cond.get("img_cond") is not None:
            raise NotImplementedError("control latents / i2v image conditioning: " + UNPORTED_ARCHS["wan21_i2v"])
        _, tt, hh, ww, c = noisy_latents.shape
        patch = self.dit_config.patch_size
        out = variables["dit"](wan_patchify(noisy_latents, patch), cond["txt"], t, cond["pe"])
        return wan_unpatchify(out, tt, hh, ww, patch, c)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """Video ``[B, T, H, W, 3]`` (or images ``[B, H, W, 3]``, one-frame
        videos) in [-1, 1] -> normalized latents ``[B, t, h, w, C]``."""
        if images.dim() == 4:
            images = images[:, None]
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return wan_lora_targets()

    def lora_key(self, name: str) -> str:
        """The module name the JAX job's LoRA file carries for ``name``
        (:func:`~ai_toolkit_tpu_torch.models.wan_dit.wan_lora_key`): the
        scanned layout at every size but ``tiny``."""
        return wan_lora_key(name, scanned=self.config.model_kwargs.get("size", "1.3b") != "tiny")

    @staticmethod
    def lora_module_name(key: str) -> str:
        return wan_module_name(key)

    # ---- geometry ----

    def latent_shape(self, height: int, width: int, num_frames: int = 1) -> tuple[int, int, int, int]:
        sd, td = self.vae_config.spatial_downscale, self.vae_config.temporal_downscale
        return (max(1, num_frames) - 1) // td + 1, height // sd, width // sd, self.vae_config.latent_channels

    def image_seq_len(self, height: int, width: int) -> int:
        _, h, w, _ = self.latent_shape(height, width)
        _, ph, pw = self.dit_config.patch_size
        return (h // ph) * (w // pw)

    def frame_count_snapper(self, frames: int) -> int:
        """Snap to the causal VAE's temporal grid: td*k+1 frames."""
        td = self.vae_config.temporal_downscale
        return max(1, ((frames - 1) // td) * td + 1)
