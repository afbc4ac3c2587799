"""FLUX model wrapper: DiT + VAE + CLIP/T5 conditioning
(``ai_toolkit_tpu/models/flux_model.py`` in PyTorch, the plain flux and
flux_schnell archs at sizes ``dev`` and ``tiny``).

A local checkpoint directory (JAX ``io/flux_import.load_flux_checkpoint``)
holds the DiT in the BFL layout, as ``transformer/`` or a
``flux1-dev.safetensors`` / ``flux1-schnell.safetensors`` file, or as the
directory's own top-level shards, and the HF companions ``vae/``,
``text_encoder/`` (CLIP-L) and ``text_encoder_2/`` (T5); the port's modules
carry those names. The first BFL source wins, so FLUX.1-dev's own layout (a
diffusers ``transformer/`` beside ``flux1-dev.safetensors``) loads the
single file, as in JAX. A diffusers-layout ``transformer/`` (no
``double_blocks.*`` keys) with no BFL source beside it raises, where the JAX
loader skips it and trains a random DiT.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io.safetensors_dir import SafetensorsIndex, safetensors_files
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.flux_dit import (
    FluxConfig,
    FluxDiT,
    flux_lora_targets,
    pack_latents_cmajor,
    unpack_latents_cmajor,
)
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextModel, drop_absent_projection
from ai_toolkit_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope


_LAYOUT = ("a directory with transformer/ or flux1-dev.safetensors (BFL keys) and the HF vae/, "
           "text_encoder/, text_encoder_2/")


@register_model
class FluxModel(BaseModel):
    arch = "flux"
    archs = ["flux", "flux_schnell"]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 512

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        size = config.model_kwargs.get("size", "dev")
        if size == "tiny":
            self.dit_config = FluxConfig.tiny()
            self.vae_config = VAEConfig.tiny()
            self.clip_config = CLIPTextConfig.tiny()
            self.t5_config = T5Config.tiny()
            self.max_txt_len = 16
        elif size == "dev":
            self.dit_config = FluxConfig.schnell() if config.arch == "flux_schnell" else FluxConfig.dev()
            self.vae_config = VAEConfig.flux()
            self.clip_config = CLIPTextConfig.clip_l()
            self.t5_config = T5Config.xxl()
        else:
            raise NotImplementedError(f"flux size '{size}' is not ported yet (ported: dev, tiny)")
        if config.arch == "flux_schnell":
            self.dit_config = dataclasses.replace(self.dit_config, guidance_embed=False)
        if config.model_kwargs.get("control"):
            raise NotImplementedError("flux control conditioning comes with a later slice")
        self.tokenizer_clip = load_tokenizer(
            config.name_or_path, "tokenizer", vocab_size=self.clip_config.vocab_size,
            eos_id=self.clip_config.eos_token_id, max_len=77,
        )
        self.tokenizer_t5 = load_tokenizer(
            config.name_or_path, "tokenizer_2", vocab_size=self.t5_config.vocab_size,
            eos_id=1, max_len=self.max_txt_len,
        )

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Build every component empty on the device in its dtype, then fill
        it from ``generator``."""
        dev = self.device
        variables = {
            "dit": FluxDiT(self.dit_config, device=dev),
            "vae": AutoencoderKL(self.vae_config, device=dev),
            "clip": CLIPTextModel(self.clip_config, device=dev),
            "t5": T5Encoder(self.t5_config, device=dev),
        }
        for m in variables.values():
            init_parameters(m, generator).eval().requires_grad_(False)
        return variables

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        if not os.path.isdir(path):
            self.refuse_bad_layout(_LAYOUT)
        variables = self.init_variables(generator)
        loaded, diffusers = 0, None
        # the first BFL source wins, as in JAX; FLUX.1-dev's own repo holds a
        # diffusers transformer/ beside the BFL flux1-dev.safetensors
        for sub in ("transformer", "flux1-dev.safetensors", "flux1-schnell.safetensors", "."):
            src = path if sub == "." else os.path.join(path, sub)
            if not os.path.exists(src) or not safetensors_files(src):
                continue
            with SafetensorsIndex(src) as index:
                bfl = any(k.startswith("double_blocks.") for k in index.keys())
            if bfl:
                loaded += self.load_component(variables, "dit", src, "flux dit")
                break
            if sub == "transformer":
                diffusers = src
        else:
            if diffusers is not None:
                raise NotImplementedError(
                    f"{diffusers}: a diffusers-layout flux transformer (no double_blocks.* keys) and no BFL "
                    f"source beside it; the port loads the BFL layout (transformer/ or flux1-dev.safetensors "
                    f"with double_blocks.* keys)")
            print(f"flux dit: no BFL transformer under {path}; 'dit' keeps its seeded init")
        for sub, name in (("vae", "vae"), ("text_encoder", "clip"), ("text_encoder_2", "t5")):
            loaded += self.load_component(variables, name, os.path.join(path, sub), f"flux {name}",
                                          prepare=drop_absent_projection if name == "clip" else None)
        if not loaded:
            self.refuse_bad_layout(_LAYOUT)
        return variables

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        clip_ids = np.stack([self.tokenizer_clip.encode(p) for p in prompts])
        t5_ids = np.stack([self.tokenizer_t5.encode(p) for p in prompts])
        clip_out = variables["clip"](torch.from_numpy(clip_ids).long().to(self.device))
        txt = variables["t5"](torch.from_numpy(t5_ids).long().to(self.device))
        out = {"txt": txt, "y": clip_out["pooled_output"]}
        if self.config.attn_masking:
            # non-padding = everything up to and including the first eos
            is_eos = t5_ids == 1
            out["txt_mask"] = torch.from_numpy(np.cumsum(is_eos, axis=1) - is_eos <= 0).to(self.device)
        return out

    def rope_table(self, latent_h: int, latent_w: int, txt_len: int) -> torch.Tensor:
        ids = image_position_ids(latent_h // 2, latent_w // 2, text_len=txt_len)
        return multi_axis_rope(torch.from_numpy(ids)[None].to(self.device),
                               list(self.dit_config.axes_dim), self.dit_config.theta)

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, C]``; cond: txt, y, pe, guidance[, txt_mask].
        Differentiable: the train step takes gradients through it into the
        DiT's LoRA factors."""
        if cond.get("control_latents") is not None or cond.get("ip_tokens") is not None:
            raise NotImplementedError("control / IP-adapter conditioning comes with a later slice")
        _, h, w, _ = noisy_latents.shape
        out = variables["dit"](pack_latents_cmajor(noisy_latents), cond["txt"], t, cond["y"],
                               cond["pe"], cond.get("guidance"), cond.get("txt_mask"))
        return unpack_latents_cmajor(out, h, w)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """Images ``[B, H, W, 3]`` in [-1, 1] -> scaled, shifted latents
        ``[B, h, w, C]`` (posterior mode unless ``generator`` is given)."""
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return flux_lora_targets()

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        d = self.vae_config.downscale
        return height // d, width // d, self.vae_config.latent_channels

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return (h // 2) * (w // 2)
