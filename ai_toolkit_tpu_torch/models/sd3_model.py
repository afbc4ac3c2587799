"""SD3-class MMDiT model wrapper (``ai_toolkit_tpu/models/sd3_model.py`` in
PyTorch): archs ``sd3``, ``sd35`` and ``sd35_large`` on the port's
``FluxDiT`` with the SD3 flags, at sizes ``medium`` (the default), ``35`` /
``3.5``, ``large`` / ``8b`` and ``tiny``, each with the DiT config JAX
``SD3Model.__init__`` builds:

- sd3 (2B medium): 24 blocks of 24x64 heads, hidden 1536, no QK norm;
- sd3.5-medium (``sd35``, or ``size: 35``): QK RMSNorm, the first 13 blocks
  with the image-only ``img2_attn``, a 384x384 position table;
- sd3.5-large (``sd35_large``, or ``size: large``): 38 blocks of 38x64 heads,
  hidden 2432, QK RMSNorm, a 192x192 table;

every one with a context_pre_only last block, no guidance embed, the
identity rope table (MMDiT has no RoPE) and the learned ``pos_embed`` read at
the centre-cropped rows of the latent grid. Conditioning (JAX
``encode_prompt``): CLIP-L's and OpenCLIP-G's penultimate states (``clip_skip``
1) concatenated, zero-padded to T5's 4096 and followed by T5-XXL over 154
tokens (231 tokens in all); the two pooled outputs concatenated, padded to
2048. Latents: the 16-channel SD3 VAE, packed patch-major, flow matching.
``model_kwargs`` keys other than ``size`` raise.

A local checkpoint (JAX ``io/sd3_import.load_sd3_checkpoint``) is the
diffusers ``transformer/`` directory, or one transformer file, read through
``io/sd3_layout.py``, with the companions ``vae/``, ``text_encoder/``
(CLIP-L), ``text_encoder_2/`` (OpenCLIP-G) and ``text_encoder_3/`` (T5).

The LoRA file carries the module names the JAX job writes
(``flux_lora_key_map`` over the JAX tree): the BFL names of the double
blocks (``double_blocks.3.img_attn.qkv``), and the JAX paths, dot-joined, of
what the map does not name: ``dual_blocks.block.img2_qkv.5`` for a scanned
stack (every size but ``tiny``), ``dual_5.img2_qkv`` unrolled, and
``final_block.txt_qkv`` (:func:`sd3_lora_key`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io.sd3_layout import sd3_layout, sources
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.flux_dit import (
    FluxConfig,
    FluxDiT,
    flux_lora_targets,
    pack_latents,
    unpack_latents,
)
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextModel, drop_absent_projection
from ai_toolkit_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

SIZES = ("tiny", "medium", "35", "3.5", "large", "8b")
_LAYOUT = ("a diffusers directory with transformer/ (and vae/, text_encoder/, text_encoder_2/, "
           "text_encoder_3/), or one transformer .safetensors file")


def sd3_dit_config(arch: str, size: str) -> FluxConfig:
    """The DiT config JAX ``SD3Model`` builds for ``arch`` at ``size``."""
    if size == "tiny":
        return dataclasses.replace(FluxConfig.tiny(), depth_single=0, guidance_embed=False,
                                   final_context_pre_only=True, pos_embed_max_size=32, qk_norm=False)
    large = size in ("large", "8b") or arch == "sd35_large"
    is_35 = arch != "sd3" or size in ("35", "3.5")
    return FluxConfig(
        in_channels=64, hidden_size=2432 if large else 1536, num_heads=38 if large else 24, head_dim=64,
        depth_double=38 if large else 24, depth_single=0, context_dim=4096, vec_dim=2048, guidance_embed=False,
        axes_dim=(64,), qk_norm=is_35, final_context_pre_only=True,
        pos_embed_max_size=384 if (is_35 and not large) else 192,
        dual_attention_layers=13 if (is_35 and not large) else 0)


# the port's Linear names inside a block -> the JAX module path the LoRA file carries
_JAX_LINEAR = {"img_attn.qkv": "img_qkv", "txt_attn.qkv": "txt_qkv", "img_attn.proj": "img_proj",
               "txt_attn.proj": "txt_proj", "img2_attn.qkv": "img2_qkv", "img2_attn.proj": "img2_proj",
               "img_mlp.0": "img_mlp_in", "img_mlp.2": "img_mlp_out", "txt_mlp.0": "txt_mlp_in",
               "txt_mlp.2": "txt_mlp_out", "img_mod.lin": "img_mod.mod", "txt_mod.lin": "txt_mod.mod",
               "txt_mod": "txt_mod"}
_PORT_LINEAR = {v: k for k, v in _JAX_LINEAR.items() if k != "txt_mod"}


def sd3_lora_key(name: str, scanned: bool) -> str:
    """The module name a JAX job's LoRA file carries for the port's ``name``:
    a double block's BFL name as it is; a dual block's JAX path, per layer of
    the scanned stack (``dual_blocks.block.img2_qkv.5``) or unrolled
    (``dual_5.img2_qkv``); the final block's JAX path (``final_block.txt_mod``)."""
    if name.startswith("double_blocks."):
        return name
    if name.startswith("final_block."):
        return "final_block." + _JAX_LINEAR[name[len("final_block."):]]
    _, i, rest = name.split(".", 2)
    return f"dual_blocks.block.{_JAX_LINEAR[rest]}.{i}" if scanned else f"dual_{i}.{_JAX_LINEAR[rest]}"


def sd3_module_name(key: str) -> str:
    """Inverse of :func:`sd3_lora_key`, for both layouts."""
    if key.startswith("double_blocks."):
        return key
    if key.startswith("final_block."):
        rest = key[len("final_block."):]
        return "final_block." + ("txt_mod" if rest == "txt_mod" else _PORT_LINEAR[rest])
    if key.startswith("dual_blocks.block."):
        leaf, i = key[len("dual_blocks.block."):].rsplit(".", 1)
        return f"dual_blocks.{i}.{_PORT_LINEAR[leaf]}"
    head, leaf = key.split(".", 1)
    if head.startswith("dual_"):
        return f"dual_blocks.{head[len('dual_'):]}.{_PORT_LINEAR[leaf]}"
    raise KeyError(f"LoRA key module '{key}' names no sd3 block Linear")


@register_model
class SD3Model(BaseModel):
    arch = "sd3"
    archs = ["sd3", "sd35", "sd35_large"]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 154  # T5 tokens; 77 CLIP tokens go before them

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        kw = config.model_kwargs
        if set(kw) - {"size"}:
            raise NotImplementedError(f"arch '{config.arch}': model_kwargs {sorted(set(kw) - {'size'})} are not "
                                      f"read (read: ['size'])")
        self.size = str(kw.get("size", "medium"))
        if self.size not in SIZES:
            raise NotImplementedError(f"sd3 size '{self.size}' (ported: {list(SIZES)})")
        self.dit_config = sd3_dit_config(config.arch, self.size)
        if self.size == "tiny":
            self.vae_config = VAEConfig.tiny()
            self.clip_config = self.clip2_config = CLIPTextConfig.tiny()
            self.t5_config = T5Config.tiny()
            self.max_txt_len = 16
        else:
            self.vae_config = VAEConfig.sd3()
            self.clip_config = CLIPTextConfig.clip_l()
            self.clip2_config = CLIPTextConfig.open_clip_g()
            self.t5_config = T5Config.xxl()
        self.tokenizer = load_tokenizer(config.name_or_path, "tokenizer", vocab_size=self.clip_config.vocab_size,
                                        eos_id=self.clip_config.eos_token_id, max_len=77)
        self.tokenizer_t5 = load_tokenizer(config.name_or_path, "tokenizer_3", vocab_size=self.t5_config.vocab_size,
                                           eos_id=1, max_len=self.max_txt_len)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        dev = self.device
        variables = {
            "dit": FluxDiT(self.dit_config, device=dev),
            "vae": AutoencoderKL(self.vae_config, device=dev),
            "clip": CLIPTextModel(self.clip_config, device=dev),
            "clip2": CLIPTextModel(self.clip2_config, device=dev),
            "t5": T5Encoder(self.t5_config, device=dev),
        }
        for m in variables.values():
            init_parameters(m, generator).eval().requires_grad_(False)
        return variables

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        tdir = os.path.join(path, "transformer")
        if not (os.path.isdir(tdir) or os.path.isfile(path)):
            self.refuse_bad_layout(_LAYOUT)
        variables = self.init_variables(generator)
        self.load_component(variables, "dit", tdir if os.path.isdir(tdir) else path, f"{self.config.arch} dit",
                            sources=sources(sd3_layout(self.dit_config), self.dit_config))
        if os.path.isfile(path):
            print(f"{self.config.arch}: {path} is one transformer file; the VAE and the text encoders keep "
                  f"their seeded init")
            return variables
        for sub, name in (("vae", "vae"), ("text_encoder", "clip"), ("text_encoder_2", "clip2"),
                          ("text_encoder_3", "t5")):
            self.load_component(variables, name, os.path.join(path, sub), f"{self.config.arch} {name}",
                                prepare=drop_absent_projection if name.startswith("clip") else None)
        return variables

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """txt: ``[CLIP-L | OpenCLIP-G penultimate states, zero-padded to
        context_dim]`` (77 tokens) then T5's states; y: the two pooled
        outputs concatenated, padded (or cut) to ``vec_dim``."""
        cfg = self.dit_config
        ids = torch.from_numpy(np.stack([self.tokenizer.encode(p) for p in prompts])).long().to(self.device)
        t5_ids = torch.from_numpy(np.stack([self.tokenizer_t5.encode(p) for p in prompts])).long().to(self.device)
        o1 = variables["clip"](ids, clip_skip=1)
        o2 = variables["clip2"](ids, clip_skip=1)
        t5_out = variables["t5"](t5_ids)
        clip_cat = torch.cat([o1["last_hidden_state"], o2["last_hidden_state"]], dim=-1)
        clip_cat = F.pad(clip_cat, (0, max(cfg.context_dim - clip_cat.shape[-1], 0)))[..., :cfg.context_dim]
        pooled = torch.cat([o1["pooled_output"], o2["pooled_output"]], dim=-1)
        pooled = F.pad(pooled, (0, max(cfg.vec_dim - pooled.shape[-1], 0)))[..., :cfg.vec_dim]
        return {"txt": torch.cat([clip_cat, t5_out.to(clip_cat.dtype)], dim=1), "y": pooled}

    def rope_table(self, latent_h: int, latent_w: int, txt_len: int) -> torch.Tensor:
        """The identity rotation over every token (JAX ``_identity_pe``)."""
        n, d2 = txt_len + (latent_h // 2) * (latent_w // 2), self.dit_config.head_dim // 2
        table = torch.zeros((1, n, d2, 2, 2), dtype=torch.float32, device=self.device)
        table[..., 0, 0] = 1.0
        table[..., 1, 1] = 1.0
        return table

    def pos_ids(self, latent_h: int, latent_w: int) -> torch.Tensor:
        """The centre-cropped rows of the ``m x m`` position table under the
        ``(h/2) x (w/2)`` patch grid (diffusers ``cropped_pos_embed``)."""
        m = self.dit_config.pos_embed_max_size
        h2, w2 = latent_h // 2, latent_w // 2
        top, left = (m - h2) // 2, (m - w2) // 2
        rows = np.arange(top, top + h2)[:, None] * m + np.arange(left, left + w2)[None]
        return torch.from_numpy(rows.reshape(-1)).to(self.device)

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, 16]``; cond: txt, y, pe. Differentiable."""
        if cond.get("control_latents") is not None or cond.get("ip_tokens") is not None:
            raise NotImplementedError(f"arch '{self.config.arch}' takes no control latents or IP tokens")
        _, h, w, _ = noisy_latents.shape
        out = variables["dit"](pack_latents(noisy_latents), cond["txt"], t, cond["y"], cond["pe"],
                               pos_ids=self.pos_ids(h, w))
        return unpack_latents(out, h, w)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return flux_lora_targets()

    @property
    def jax_scans_blocks(self) -> bool:
        return self.size != "tiny"

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        return sd3_lora_key(name, scanned)

    def lora_key(self, name: str) -> str:
        return sd3_lora_key(name, scanned=self.size != "tiny")

    @staticmethod
    def lora_module_name(key: str) -> str:
        return sd3_module_name(key)

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        d = self.vae_config.downscale
        return height // d, width // d, self.vae_config.latent_channels

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return (h // 2) * (w // 2)
