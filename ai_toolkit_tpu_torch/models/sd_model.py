"""SDXL model wrapper (``ai_toolkit_tpu/models/sd_model.py`` ``SDXLModel`` in
PyTorch): the SDXL UNet (``models/unet.py``), CLIP-L and OpenCLIP-G, both
called at ``clip_skip=1`` with their penultimate states concatenated into the
2048-wide context and the pooled output taken from OpenCLIP-G, the SDXL VAE
(4-channel latents, scale 0.13025, quant convs), and the added condition of
the pooled embedding and ``[h, w, 0, 0, h, w]``. Epsilon prediction on DDPM
schedules (``is_flow_matching`` false).

``model_kwargs``: ``size`` (``full`` | ``tiny``). ``model.remat_policy:
none`` turns the UNet's per-block checkpointing off, as in the JAX package.
The archs ``sd1`` / ``sd2`` and the refiner (``sdxl_refiner``,
``refiner_name_or_path``) raise ``NotImplementedError``.

A local checkpoint is an HF-layout directory (JAX
``io/sd_import.load_sd_checkpoint``): ``unet/``, ``vae/``, ``text_encoder/``
and ``text_encoder_2/``, each of which ``unet_path``, ``vae_path`` and
``text_encoder_path`` may point elsewhere; the port's modules carry the
diffusers and transformers names. The LDM single file raises
``NotImplementedError`` (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextModel, drop_absent_projection
from ai_toolkit_tpu_torch.models.unet import UNet2DCondition, UNetConfig, unet_lora_targets
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

_LATER = "comes with a later slice"


@register_model
class SDXLModel(BaseModel):
    arch = "sdxl"
    archs = ["sdxl", "sd1", "sd15", "sd2", "ssd", "vega", "sdxl_refiner", "ssd_refiner"]
    is_flow_matching = False
    bucket_divisibility = 8
    main_component = "unet"

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        if config.arch != "sdxl":
            raise NotImplementedError(f"arch '{config.arch}' {_LATER}; ported: sdxl")
        if config.refiner_name_or_path:
            raise NotImplementedError(f"the SDXL refiner (refiner_name_or_path) {_LATER}")
        size = config.model_kwargs.get("size", "full")
        if size == "tiny":
            self.unet_config = UNetConfig(
                block_out_channels=(32, 64), layers_per_block=1, transformer_layers=(0, 1), num_heads=2,
                cross_attention_dim=128, addition_time_embed_dim=32,
                projection_class_embeddings_dim=64 + 32 * 6, dtype=torch.float32, remat=False)
            self.vae_config = VAEConfig.tiny()
            self.clip_config = self.clip2_config = CLIPTextConfig.tiny()
        elif size == "full":
            self.unet_config = UNetConfig.sdxl()
            self.vae_config = VAEConfig.sdxl()
            self.clip_config = CLIPTextConfig.clip_l()
            self.clip2_config = CLIPTextConfig.open_clip_g()
        else:
            raise NotImplementedError(f"sdxl size '{size}' (ported: full, tiny)")
        if config.remat_policy == "none":
            self.unet_config = dataclasses.replace(self.unet_config, remat=False)
        self.tokenizer = load_tokenizer(
            config.name_or_path, "tokenizer", vocab_size=self.clip_config.vocab_size,
            eos_id=self.clip_config.eos_token_id, max_len=77,
        )

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Every component built empty on the device in its dtype, then filled
        from ``generator``, one after the other."""
        dev = self.device
        builders = {
            "unet": lambda: UNet2DCondition(self.unet_config, device=dev),
            "vae": lambda: AutoencoderKL(self.vae_config, device=dev),
            "clip": lambda: CLIPTextModel(self.clip_config, device=dev),
            "clip2": lambda: CLIPTextModel(self.clip2_config, device=dev),
        }
        return {name: init_parameters(build(), generator).eval().requires_grad_(False)
                for name, build in builders.items()}

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        if os.path.isfile(path):
            raise NotImplementedError(f"{path}: the LDM / SGM single file (sd_xl_base_1.0.safetensors) {_LATER}; "
                                      f"give the HF-layout directory (unet/, vae/, text_encoder/, text_encoder_2/)")
        if not os.path.isdir(path):
            self.refuse_bad_layout("an HF-layout directory: unet/, vae/, text_encoder/, text_encoder_2/")
        variables = self.init_variables(generator)
        overrides = {"unet": self.config.unet_path, "vae": self.config.vae_path, "clip": self.config.text_encoder_path}
        loaded = 0
        for subdir, name in (("unet", "unet"), ("vae", "vae"), ("text_encoder", "clip"), ("text_encoder_2", "clip2")):
            root, ov = path, overrides.get(name)
            if ov:  # a whole HF directory (its matching subdir), or the component's own directory or file
                if os.path.isdir(os.path.join(ov, subdir)):
                    root = ov
                else:
                    root, subdir = os.path.split(ov.rstrip("/"))
            loaded += self.load_component(variables, name, os.path.join(root, subdir), f"sdxl {name}",
                                          prepare=drop_absent_projection if name == "clip" else None)
        if not loaded:
            self.refuse_bad_layout("an HF-layout directory: unet/, vae/, text_encoder/, text_encoder_2/")
        return variables

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """context: both encoders' penultimate states concatenated
        ``[B, 77, 2048]``; pooled: OpenCLIP-G's projected pooled output."""
        ids = torch.from_numpy(np.stack([self.tokenizer.encode(p) for p in prompts])).long().to(self.device)
        o1 = variables["clip"](ids, clip_skip=1)
        o2 = variables["clip2"](ids, clip_skip=1)
        return {"context": torch.cat([o1["last_hidden_state"], o2["last_hidden_state"]], dim=-1),
                "pooled": o2["pooled_output"]}

    def added_cond(self, pooled: torch.Tensor, height: int, width: int) -> dict:
        """SDXL micro-conditioning: original size, crop (0, 0), target size."""
        time_ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                                device=pooled.device).repeat(pooled.shape[0], 1)
        return {"time_ids": time_ids, "text_embeds": pooled}

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, 4]``; t ``[B]`` (integer timesteps in
        training); cond: context, added_cond. Differentiable."""
        return variables["unet"](noisy_latents, t, cond["context"], cond.get("added_cond"),
                                 cond.get("ip_tokens"), cond.get("adapter_residuals"))

    def predict_train(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                      cond: dict) -> torch.Tensor:
        """The train-time forward (JAX ``predict_train``): without token ids
        (text-encoder training) or IP-adapter embeddings, which raise, it is
        :meth:`predict`."""
        if "input_ids" in cond or "ip_embeds" in cond:
            raise NotImplementedError("text-encoder and IP-adapter training come with later slices")
        return self.predict(variables, noisy_latents, t, cond)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return unet_lora_targets()

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        d = self.vae_config.downscale
        return height // d, width // d, self.vae_config.latent_channels
