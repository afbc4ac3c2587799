"""Lumina-Image-2.0 model wrapper (``ai_toolkit_tpu/models/lumina2_model.py`` in
PyTorch): arch ``lumina2`` at sizes ``full`` (the default) and ``tiny``, as
JAX ``Lumina2Model`` builds them.

The NextDiT-2B (``models/lumina2_dit.py``: 26 joint layers of 24 x 96 heads,
2 noise and 2 caption refiners) conditioned on Gemma2-2B's final hidden
states (2304 wide, 256 tokens; 16 at ``tiny``, where the text tower is the
tiny Llama one, as in JAX) under the key mask that keeps every token up to
the first eos (id 1). Latents: the 16-channel FLUX VAE, packed patch-major.
The model's time axis is reversed: it gets ``1 - t``, and its output is
negated into the flow-matching velocity. Flow matching samples at a static
shift of 6 (``samplers/factory.py``); sampling has no CFG pass, as in JAX
``generate_flux``. ``model_kwargs`` other than ``size`` raise.

A local checkpoint (JAX ``io/dit_importers.load_lumina2_checkpoint``) is a
diffusers directory (``transformer/``, ``vae/``, ``text_encoder/``) or one
transformer ``.safetensors`` file, ``model.diffusion_model.`` stripped; each
component loads strictly in the diffusers and transformers names the
modules carry. A component that is absent keeps its seeded init, and one
line says so, as in JAX. The JAX job writes the LoRA under its own module
paths (ROADMAP Queue 3): :func:`~ai_toolkit_tpu_torch.models.lumina2_dit.nextdit_lora_key`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.flux_dit import pack_latents, unpack_latents
from ai_toolkit_tpu_torch.models.lumina2_dit import (
    Lumina2Config,
    Lumina2DiT,
    lumina2_lora_targets,
    lumina2_pos_angles,
    nextdit_lora_key,
    nextdit_module_name,
)
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig, LLMEncoder
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

# JAX DEFAULT_EXCLUDE over the NextDiT's JAX paths keeps the modulations (``norm1_lin``:
# "norm"), ``time_in`` and ``final_mod`` / ``final_proj`` ("final_") in their dtype and
# quantizes ``x_embedder``, ``cap_proj`` and ``ref_embedder``; over the diffusers names
NEXTDIT_QUANTIZE_EXCLUDE = [r"norm", r"timestep_embedder"]


@register_model
class Lumina2Model(BaseModel):
    arch = "lumina2"
    archs = ["lumina2"]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 256
    quantize_exclude = NEXTDIT_QUANTIZE_EXCLUDE
    _kwargs = ("size",)

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        kw = config.model_kwargs
        if set(kw) - set(self._kwargs):
            raise NotImplementedError(f"arch '{config.arch}': model_kwargs {sorted(set(kw) - set(self._kwargs))} "
                                      f"are not read (read: {list(self._kwargs)})")
        self.size = kw.get("size", "full")
        if self.size not in ("full", "tiny"):
            raise NotImplementedError(f"{config.arch} size '{self.size}' (ported: full, tiny)")
        if self.size == "tiny":
            self.dit_config = self._tiny_dit_config()
            self.vae_config = VAEConfig.tiny()
            self.llm_config = LLMConfig.tiny(d_model=self.dit_config.cap_feat_dim)
            self.max_txt_len = 16
        else:
            self.dit_config = self._full_dit_config()
            self.vae_config = VAEConfig.flux()
            self.llm_config = self._full_llm_config()
        self.tokenizer = load_tokenizer(config.name_or_path, "tokenizer", vocab_size=self.llm_config.vocab_size,
                                        eos_id=self._eos_id(), max_len=self.max_txt_len)

    def _tiny_dit_config(self):
        return Lumina2Config.tiny()

    def _full_dit_config(self):
        return Lumina2Config()

    def _full_llm_config(self) -> LLMConfig:
        return LLMConfig.gemma2_2b()

    def _eos_id(self) -> int:
        return 1

    def _dit(self, device):
        return Lumina2DiT(self.dit_config, device=device)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        dev = self.device
        variables = {"dit": self._dit(dev), "vae": AutoencoderKL(self.vae_config, device=dev),
                     "te": LLMEncoder(self.llm_config, device=dev)}
        for m in variables.values():
            init_parameters(m, generator).eval().requires_grad_(False)
        return variables

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        tdir = os.path.join(path, "transformer")
        if not (os.path.isdir(tdir) or os.path.isfile(path)):
            self.refuse_bad_layout("a diffusers directory with transformer/, or one transformer .safetensors file")
        variables = self.init_variables(generator)
        arch = self.config.arch
        self.load_component(variables, "dit", tdir if os.path.isdir(tdir) else path, f"{arch} dit")
        if os.path.isfile(path):
            print(f"{arch}: {path} is one transformer file; the VAE and the text encoder keep their seeded init, "
                  f"as in JAX")
            return variables
        self.load_component(variables, "vae", os.path.join(path, "vae"), f"{arch} vae")
        self.load_te(variables, path)
        return variables

    def load_te(self, variables: dict, path: str) -> None:
        """``text_encoder/`` (Gemma2) in transformers' names, ``model.``
        stripped."""
        self.load_component(variables, "te", os.path.join(path, "text_encoder"), f"{self.config.arch} te",
                            strip=("model.",))

    # ---- conditioning ----

    def prompt_text(self, prompt: str) -> str:
        return prompt

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """txt: the text tower's final states over ``max_txt_len`` tokens;
        txt_mask: every token up to and including the first eos."""
        ids = np.stack([self.tokenizer.encode(self.prompt_text(p)) for p in prompts])
        is_eos = ids == self.tokenizer.eos_id
        mask = torch.from_numpy(np.cumsum(is_eos, axis=1) - is_eos <= 0).to(self.device)
        txt = variables["te"](torch.from_numpy(ids).long().to(self.device), mask)
        return {"txt": txt, "txt_mask": mask}

    def rope_table(self, latent_h: int, latent_w: int, txt_len: int) -> torch.Tensor:
        """Unused: the angles follow each sample's caption length and are
        built in :meth:`predict` (JAX returns a ``[1, 1]`` placeholder too)."""
        return torch.zeros((1, 1), device=self.device)

    # ---- forward ----

    def _masked_lengths(self, txt: torch.Tensor, mask: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
        b, t = txt.shape[:2]
        if mask is None:
            mask = torch.ones((b, t), dtype=torch.bool, device=txt.device)
        mask = mask.bool().to(txt.device).expand(b, t)
        return mask, mask.sum(dim=1)

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, C]``; cond: txt, txt_mask. The model gets
        ``1 - t`` and its output is negated. Differentiable."""
        if cond.get("control_latents") is not None or cond.get("ip_tokens") is not None:
            raise NotImplementedError(f"arch '{self.config.arch}' takes no control latents or IP tokens")
        _, h, w, _ = noisy_latents.shape
        txt = cond["txt"]
        mask, cap_lens = self._masked_lengths(txt, cond.get("txt_mask"))
        ta, ia = lumina2_pos_angles(self.dit_config, h // 2, w // 2, cap_lens, txt.shape[1])
        out = variables["dit"](pack_latents(noisy_latents), txt, 1.0 - t.to(txt.device), mask, ia, ta)
        return -unpack_latents(out, h, w)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return lumina2_lora_targets()

    @property
    def jax_scans_blocks(self) -> bool:
        return self.size != "tiny"

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        return nextdit_lora_key(name, scanned)

    def lora_key(self, name: str) -> str:
        """The module name the JAX job's LoRA file carries for ``name``: the
        scanned layout at every size but ``tiny``."""
        return nextdit_lora_key(name, scanned=self.size != "tiny")

    @staticmethod
    def lora_module_name(key: str) -> str:
        return nextdit_module_name(key)

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        d = self.vae_config.downscale
        return height // d, width // d, self.vae_config.latent_channels

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return (h // 2) * (w // 2)
