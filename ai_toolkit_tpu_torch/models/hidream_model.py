"""HiDream-I1 model wrapper (``ai_toolkit_tpu/models/hidream_model.py`` in
PyTorch): an MMDiT with a routed MoE FFN (16 double + 32 single blocks,
hidden 2560 = 20 heads x 128, 4 SwiGLU experts of width 6912 top-2 with
unnormalised gates plus a shared expert of width 3584, QK norms over the full
inner dim), conditioned on CLIP-L + OpenCLIP-G pooled outputs (the 2048-wide
vector) and T5-XXL + Llama-3.1-8B states concatenated along the sequence,
flow matching on the 16-channel flux VAE latents packed patch-major.

As in the JAX package, one conditioning sequence runs through every block
(T5 states then final Llama states, 128 tokens each), where the reference
feeds a different Llama layer to each block. ``model_kwargs``: ``size``
(``full`` | ``tiny``) and ``moe_dispatch`` (``dense`` | ``grouped``, the CUDA
grouped SwiGLU kernels; the JAX tiny size is always dense, the port's takes
either). The edit archs ``hidream_e1`` / ``hidream_o1`` raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT, pack_latents, unpack_latents
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextModel
from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig, LLMEncoder
from ai_toolkit_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

ROUTED_HIDDEN = 6912  # 256 * ceil(2/3 * 4 * 2560 / 256), the reference's SwiGLU rounding
SHARED_HIDDEN = 3584  # 256 * ceil(2/3 * 2 * 2560 / 256)


def hidream_dit_config(moe_dispatch: str = "dense") -> FluxConfig:
    cfg = FluxConfig(
        in_channels=64, hidden_size=2560, num_heads=20, head_dim=128, depth_double=16,
        depth_single=32, context_dim=4096, vec_dim=2048, guidance_embed=False,
        axes_dim=(16, 56, 56), moe_experts=4, moe_top_k=2, mlp_ratio=ROUTED_HIDDEN / 2560,
        moe_shared_hidden=SHARED_HIDDEN, qk_norm_across_heads=True, moe_dispatch=moe_dispatch,
    )
    routed = int(cfg.hidden_size * cfg.mlp_ratio)
    if routed != ROUTED_HIDDEN:  # mlp_ratio is a float: the width must still come out exact
        raise ValueError(f"routed expert width {routed} != {ROUTED_HIDDEN}")
    return cfg


def hidream_lora_targets() -> list[str]:
    """Attention projections only (JAX ``HiDreamModel.lora_targets``): the
    expert banks carry an [E, ...] axis the LoRA builder does not adapt."""
    return [r"^double_blocks\.\d+\.(img|txt)_attn\.(qkv|proj)$", r"^single_blocks\.\d+\.(qkv|proj)$"]


@register_model
class HiDreamModel(BaseModel):
    arch = "hidream"
    archs = ["hidream", "hidream_e1", "hidream_o1"]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 128

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        if config.arch != "hidream":
            raise NotImplementedError(f"arch '{config.arch}' (hidream edit / omni conditioning) "
                                      f"comes with slice G; ported: hidream")
        kw = config.model_kwargs
        size, dispatch = kw.get("size", "full"), kw.get("moe_dispatch", "dense")
        if size == "tiny":
            self.dit_config = dataclasses.replace(
                FluxConfig.tiny(), depth_double=1, depth_single=1, guidance_embed=False,
                moe_experts=4, moe_top_k=2, qk_norm_across_heads=True, moe_dispatch=dispatch)
            self.vae_config = VAEConfig.tiny()
            self.clip_config = self.clip2_config = CLIPTextConfig.tiny()
            self.t5_config = T5Config.tiny()
            self.llm_config = LLMConfig.tiny(d_model=64)
            self.max_txt_len = 16
        elif size == "full":
            self.dit_config = hidream_dit_config(dispatch)
            self.vae_config = VAEConfig.flux()
            self.clip_config = CLIPTextConfig.clip_l()
            self.clip2_config = CLIPTextConfig.open_clip_g()
            self.t5_config = T5Config.xxl()
            self.llm_config = LLMConfig.llama31_8b()
        else:
            raise NotImplementedError(f"hidream size '{size}' (ported: full, tiny)")
        self.tokenizer_clip = load_tokenizer(
            config.name_or_path, "tokenizer", vocab_size=self.clip_config.vocab_size,
            eos_id=self.clip_config.eos_token_id, max_len=77,
        )
        self.tokenizer_t5 = load_tokenizer(
            config.name_or_path, "tokenizer_3", vocab_size=self.t5_config.vocab_size,
            eos_id=1, max_len=self.max_txt_len,
        )
        self.tokenizer_llm = load_tokenizer(
            config.name_or_path, "tokenizer_4", vocab_size=self.llm_config.vocab_size,
            eos_id=2, max_len=self.max_txt_len,
        )

    # ---- construction ----

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Every component built empty on the device in its dtype, then filled
        from ``generator``, one after the other."""
        dev = self.device
        builders = {
            "dit": lambda: FluxDiT(self.dit_config, device=dev),
            "vae": lambda: AutoencoderKL(self.vae_config, device=dev),
            "clip": lambda: CLIPTextModel(self.clip_config, device=dev),
            "clip2": lambda: CLIPTextModel(self.clip2_config, device=dev),
            "t5": lambda: T5Encoder(self.t5_config, device=dev),
            "llm": lambda: LLMEncoder(self.llm_config, device=dev),
        }
        return {name: init_parameters(build(), generator).eval().requires_grad_(False)
                for name, build in builders.items()}

    def load_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        return self.refuse_or_init(generator)

    # ---- conditioning ----

    def _ids(self, tokenizer, prompts: list[str]) -> torch.Tensor:
        return torch.from_numpy(np.stack([tokenizer.encode(p) for p in prompts])).long().to(self.device)

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """txt: T5 then Llama states, each fitted to ``context_dim``; y: CLIP-L
        and CLIP-G pooled outputs concatenated, fitted to ``vec_dim``."""
        cfg = self.dit_config
        ids = self._ids(self.tokenizer_clip, prompts)
        pooled = torch.cat([variables["clip"](ids)["pooled_output"],
                            variables["clip2"](ids)["pooled_output"]], dim=-1)
        txt = torch.cat([_fit(variables["t5"](self._ids(self.tokenizer_t5, prompts)), cfg.context_dim),
                         _fit(variables["llm"](self._ids(self.tokenizer_llm, prompts)), cfg.context_dim)],
                        dim=1)
        return {"txt": txt, "y": _fit(pooled, cfg.vec_dim)}

    def rope_table(self, latent_h: int, latent_w: int, txt_len: int) -> torch.Tensor:
        ids = image_position_ids(latent_h // 2, latent_w // 2, text_len=txt_len)
        return multi_axis_rope(torch.from_numpy(ids)[None].to(self.device),
                               list(self.dit_config.axes_dim), self.dit_config.theta)

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, C]``; cond: txt, y, pe. Differentiable."""
        if cond.get("control_latents") is not None or cond.get("ip_tokens") is not None:
            raise NotImplementedError("control / IP-adapter conditioning comes with a later slice")
        _, h, w, _ = noisy_latents.shape
        out = variables["dit"](pack_latents(noisy_latents), cond["txt"], t, cond["y"], cond["pe"])
        return unpack_latents(out, h, w)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return hidream_lora_targets()

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        d = self.vae_config.downscale
        return height // d, width // d, self.vae_config.latent_channels

    def image_seq_len(self, height: int, width: int) -> int:
        h, w, _ = self.latent_shape(height, width)
        return (h // 2) * (w // 2)


def _fit(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad or trim the last dim to ``width``."""
    if x.shape[-1] < width:
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    return x[..., :width]
