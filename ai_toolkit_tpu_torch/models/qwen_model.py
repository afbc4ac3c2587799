"""Qwen-Image model wrapper (``ai_toolkit_tpu/models/qwen_model.py`` in
PyTorch): archs ``qwen_image`` and ``qwen_image_edit`` at sizes ``full``
(the default) and ``tiny``, as JAX ``QwenImageModel`` builds them.

``FluxDiT`` with ``depth_single`` 0: 60 joint blocks of 24x128 heads
(hidden 3072), modulation from the timestep alone (no guidance embed; the
pooled vector is zeros, so ``vector_in`` adds a learned constant),
conditioned on Qwen2.5-VL-7B's final hidden states (3584 wide, 256 tokens)
under a key-padding mask that keeps every token up to the first eos. The
mask sends the joint attention to the plain path, as the JAX package sends
masked attention to XLA: no flash kernel runs in this DiT. Latents: the Wan
2.1 causal VAE at T = 1 (the tiny size: the tiny KL VAE, as in JAX), packed
channel-major. The edit arch joins the packed control latents to the image
tokens along the sequence, on frame index 1 of the rope grid, and the output
is cut back to the image tokens. The DiT checkpoints its blocks with the
``full`` policy (only the block inputs are kept), JAX's ``remat_policy``
default: at 1024^2 the edit arch's plain attention over 8,448 tokens holds
f32 logits of 6.85 GB each, and the ``dots_flash`` products of 60 blocks
would not fit beside them on one card. ``model_kwargs`` keys other than
``size`` raise; ``qwen_image_edit_plus`` and the mageflow archs wait for a
later slice (``models/registry.py``).

A local checkpoint (JAX ``io/qwen_import.load_qwen_checkpoint``) is a
diffusers directory: ``transformer/`` through ``io/sd3_layout.qwen_layout``
and ``vae/`` through the Wan VAE loader (its ``config.json`` rebuilds the
VAE). Three of the JAX loader's choices are mirrored, each with a printed
line (ROADMAP Queue 3): ``text_encoder/`` is not read, so Qwen2.5-VL keeps
its seeded init; the checkpoint's ``txt_norm`` has no slot; ``vector_in``
has no source and keeps its seeded init. The LoRA file is in the JAX job's
``comfy`` layout (``diffusion_model.double_blocks.0.img_attn.qkv``, BFL
names), which is not the diffusers names that the reference's ComfyUI
convention writes (Queue 3).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io.sd3_layout import QWEN_KEEP, qwen_layout, sources
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.flux_dit import (
    FluxConfig,
    FluxDiT,
    flux_lora_targets,
    pack_latents_cmajor,
    unpack_latents_cmajor,
)
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig, LLMEncoder
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.models.wan_model import _adapt, wan_vae_config_from_json
from ai_toolkit_tpu_torch.models.wan_vae import WanVAE, WanVAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

QWEN_DIT = FluxConfig(in_channels=64, hidden_size=3072, num_heads=24, head_dim=128, depth_double=60,
                      depth_single=0, context_dim=3584, vec_dim=256, guidance_embed=False, axes_dim=(16, 56, 56),
                      checkpoint_policy="full")


@register_model
class QwenImageModel(BaseModel):
    arch = "qwen_image"
    archs = ["qwen_image", "qwen_image_edit"]
    is_flow_matching = True
    bucket_divisibility = 32  # 16 (VAE) * 2 (patch)
    max_txt_len = 256

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        kw = config.model_kwargs
        if set(kw) - {"size"}:
            raise NotImplementedError(f"arch '{config.arch}': model_kwargs {sorted(set(kw) - {'size'})} are not "
                                      f"read (read: ['size'])")
        self.is_edit = config.arch == "qwen_image_edit"
        self.size = kw.get("size", "full")
        if self.size == "tiny":
            self.dit_config = dataclasses.replace(FluxConfig.tiny(), depth_double=2, depth_single=0,
                                                  guidance_embed=False, checkpoint_policy="full")
            self.vae_config = VAEConfig.tiny()
            self.llm_config = LLMConfig.tiny()
            self.max_txt_len = 16
        elif self.size == "full":
            self.dit_config = QWEN_DIT
            self.vae_config = WanVAEConfig.wan21()
            self.llm_config = LLMConfig.qwen25_7b()
        else:
            raise NotImplementedError(f"qwen_image size '{self.size}' (ported: full, tiny)")
        self.tokenizer = load_tokenizer(config.name_or_path, "tokenizer", vocab_size=self.llm_config.vocab_size,
                                        eos_id=2, max_len=self.max_txt_len)

    @property
    def takes_control(self) -> bool:
        return self.is_edit

    @property
    def _vae_3d(self) -> bool:
        return isinstance(self.vae_config, WanVAEConfig)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        dev = self.device
        variables = {
            "dit": FluxDiT(self.dit_config, device=dev),
            "vae": (WanVAE if self._vae_3d else AutoencoderKL)(self.vae_config, device=dev),
            "te": LLMEncoder(self.llm_config, device=dev),
        }
        for m in variables.values():
            init_parameters(m, generator).eval().requires_grad_(False)
        return variables

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        tdir, vdir = os.path.join(path, "transformer"), os.path.join(path, "vae")
        if not os.path.isdir(tdir):
            self.refuse_bad_layout("a diffusers directory with transformer/ (and vae/)")
        if self._vae_3d and os.path.isdir(vdir):
            self.vae_config = wan_vae_config_from_json(vdir, self.vae_config.dtype)
        variables = self.init_variables(generator)
        arch = self.config.arch

        def name_what_is_dropped(dit, index, what):
            print(f"{what}: vector_in has no source in the checkpoint and keeps its seeded init (the JAX "
                  f"loader's choice, ROADMAP Queue 3)")
            norm = sorted(k for k in index.keys() if k.startswith("txt_norm."))
            if norm:
                print(f"{what}: {norm} (the RMSNorm before txt_in) has no slot in the DiT and is not read, as "
                      f"the JAX loader drops it (ROADMAP Queue 3)")

        self.load_component(variables, "dit", tdir, f"{arch} dit", prepare=name_what_is_dropped,
                            sources=sources(qwen_layout(self.dit_config), self.dit_config),
                            keep=lambda k: k.startswith(QWEN_KEEP))
        if self._vae_3d:
            self.load_component(variables, "vae", vdir, f"{arch} vae", strip=(), adapt=_adapt)
        else:
            print(f"{arch} vae: the tiny KL VAE keeps its seeded init (the JAX loader reads vae/ for the Wan VAE)")
        print(f"{arch} te: {os.path.join(path, 'text_encoder')} is not read, so Qwen2.5-VL keeps its seeded init "
              f"(the JAX loader reads a text encoder for mageflow alone, ROADMAP Queue 3)")
        return variables

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """txt: the text tower's final states over ``max_txt_len`` tokens;
        txt_mask: every token up to and including the first eos; y: zeros."""
        ids = np.stack([self.tokenizer.encode(p) for p in prompts])
        is_eos = ids == self.tokenizer.eos_id
        mask = torch.from_numpy(np.cumsum(is_eos, axis=1) - is_eos <= 0).to(self.device)
        txt = variables["te"](torch.from_numpy(ids).long().to(self.device), mask)
        return {"txt": txt, "y": torch.zeros((len(prompts), self.dit_config.vec_dim), device=self.device),
                "txt_mask": mask}

    def rope_table(self, latent_h: int, latent_w: int, txt_len: int) -> torch.Tensor:
        """The (t, y, x) rope table of ``[txt | image]``; the edit arch adds the
        control tokens' grid on frame index 1."""
        gh, gw = latent_h // 2, latent_w // 2
        axes, theta = list(self.dit_config.axes_dim), self.dit_config.theta
        ids = [image_position_ids(gh, gw, text_len=txt_len)]
        if self.is_edit:
            ctrl = image_position_ids(gh, gw).copy()
            ctrl[:, 0] = 1
            ids.append(ctrl)
        return multi_axis_rope(torch.from_numpy(np.concatenate(ids))[None].to(self.device), axes, theta)

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, C]``; cond: txt, y, pe, txt_mask, and for
        the edit arch ``control_latents`` ``[B, h, w, C]``, packed and joined
        along the sequence. Differentiable."""
        if cond.get("ip_tokens") is not None:
            raise NotImplementedError("IP-adapter conditioning comes with a later slice")
        _, h, w, _ = noisy_latents.shape
        img = pack_latents_cmajor(noisy_latents)
        n_img = img.shape[1]
        ctrl = cond.get("control_latents")
        if (ctrl is not None) != self.is_edit:
            raise ValueError(f"arch '{self.config.arch}' takes control latents: {self.is_edit}; the batch "
                             f"carries them: {ctrl is not None}")
        if ctrl is not None:
            img = torch.cat([img, pack_latents_cmajor(ctrl.to(img.device)).to(img.dtype)], dim=1)
        out = variables["dit"](img, cond["txt"], t, cond["y"], cond["pe"], None, cond.get("txt_mask"))
        return unpack_latents_cmajor(out[:, :n_img], h, w)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """Images ``[B, H, W, 3]`` in [-1, 1] -> latents ``[B, h, w, C]`` (the
        Wan VAE on one-frame videos)."""
        images = images.to(self.device)
        if self._vae_3d:
            return variables["vae"].encode(images[:, None], generator)[:, 0]
        return variables["vae"].encode(images, generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        if self._vae_3d:
            return variables["vae"].decode(latents[:, None])[:, 0]
        return variables["vae"].decode(latents)

    def sampling_control_latents(self, variables: dict, h: int, w: int, ctrl_img: str | None,
                                 gen_width: int, gen_height: int) -> torch.Tensor:
        """A sample's control latents (JAX ``generate_flux``'s ``is_edit``
        branch): the encoded ``ctrl_img`` resized to the sample's size, or
        zeros without one, as the rope table holds the control tokens."""
        from PIL import Image

        if not ctrl_img:
            return torch.zeros((1, h, w, self.latent_shape(gen_height, gen_width)[2]), dtype=torch.float32,
                               device=self.device)
        with Image.open(ctrl_img) as im:
            px = np.asarray(im.convert("RGB").resize((gen_width, gen_height)), np.float32) / 127.5 - 1.0
        return self.encode_images(variables, torch.from_numpy(px)[None])

    def lora_targets(self) -> list[str]:
        return flux_lora_targets()

    def lora_key_layout(self) -> str:
        return "comfy"

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        if self._vae_3d:
            d, c = self.vae_config.spatial_downscale, self.vae_config.z_dim
        else:
            d, c = self.vae_config.downscale, self.vae_config.latent_channels
        return height // d, width // d, c

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return (h // 2) * (w // 2)
