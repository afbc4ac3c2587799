"""ACE-Step-class audio model (``ai_toolkit_tpu/models/audio_model.py``
``AudioModel`` in PyTorch), the stand-in path: archs ``ace_step_15``,
``ace_step_15_xl`` and ``ace_step`` at sizes ``full`` and ``tiny``.

Waveforms ``[B, S, 2]`` go through the 1-D causal VAE
(``models/audio_vae.py``, 256x) to latents ``[B, T, 64]``; the DiT is the
Wan DiT in 1-D mode (patch ``(1, 1, 1)``, the rope only over time:
``axes_dim (128, 0, 0)``, of which :meth:`rope_table` keeps the non-zero
axes), conditioned on T5-XXL states of 256 tokens; flow matching. The
``_xl`` arch is 32 layers at 2560 wide. The exact mode of the JAX class (a
``.safetensors`` ``name_or_path``: the ACE-Step 1.5 DiT, its Oobleck VAE
and Qwen3-0.6B) raises :data:`EXACT_MODE`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.models.audio_vae import AudioAutoencoderKL, AudioVAEConfig
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.t5 import T5Config, T5Encoder
from ai_toolkit_tpu_torch.models.wan_dit import (WanConfig, WanDiT, wan_lora_key, wan_lora_targets,
                                                 wan_module_name, wan_position_ids)
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

EXACT_MODE = ("the exact ACE-Step 1.5 mode (a .safetensors name_or_path: the ACE-Step DiT, its Oobleck VAE and the "
              "Qwen3-0.6B text tower) is not ported (ROADMAP Queue 1 item 6a); name_or_path '' trains the WanDiT "
              "stand-in")


def ace_dit_config(arch: str, size: str, latent_channels: int) -> WanConfig:
    """The JAX class's 1-D WanDiT: 1536 x 24 (12 heads), ``_xl`` 2560 x 32 (20 heads); ``tiny``'s 16-wide rope."""
    if size == "tiny":
        return WanConfig(**{**WanConfig.tiny().__dict__, "in_channels": latent_channels, "patch_size": (1, 1, 1),
                            "axes_dim": (16, 0, 0)})
    xl = arch.endswith("xl")
    return WanConfig(in_channels=latent_channels, dim=2560 if xl else 1536, ffn_dim=10240 if xl else 6144,
                     num_heads=20 if xl else 12, num_layers=32 if xl else 24, patch_size=(1, 1, 1),
                     axes_dim=(128, 0, 0))


@register_model
class AudioModel(BaseModel):
    arch = "ace_step_15"
    archs = ["ace_step_15", "ace_step_15_xl", "ace_step"]
    is_flow_matching = True
    bucket_divisibility = 1
    max_txt_len = 256
    is_audio = True

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        path = config.name_or_path or ""
        if path.endswith(".safetensors"):
            raise NotImplementedError(EXACT_MODE)
        self.size = config.model_kwargs.get("size", "full")
        if self.size == "tiny":
            self.vae_config, self.t5_config, self.max_txt_len = AudioVAEConfig.tiny(), T5Config.tiny(), 16
        elif self.size == "full":
            self.vae_config, self.t5_config = AudioVAEConfig.default(), T5Config.xxl()
        else:
            raise NotImplementedError(f"ace_step size '{self.size}': the JAX class builds any size but 'tiny' at "
                                      f"full size; the port takes 'full' or 'tiny' (ROADMAP Queue 1 item 6a)")
        self.dit_config = ace_dit_config(config.arch, self.size, self.vae_config.latent_channels)
        self.tokenizer = load_tokenizer(path, "tokenizer", vocab_size=self.t5_config.vocab_size, eos_id=1,
                                        max_len=self.max_txt_len)

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Seeded init of ``dit``, ``vae`` and ``t5``, in that order."""
        dev = self.device
        return {name: init_parameters(m, generator).eval().requires_grad_(False)
                for name, m in (("dit", WanDiT(self.dit_config, device=dev)),
                                ("vae", AudioAutoencoderKL(self.vae_config, device=dev)),
                                ("t5", T5Encoder(self.t5_config, device=dev)))}

    # ---- conditioning and forward ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        ids = np.stack([self.tokenizer.encode(p) for p in prompts])
        return {"txt": variables["t5"](torch.from_numpy(ids).long().to(self.device))}

    def rope_table(self, n_tokens: int) -> torch.Tensor:
        """The 1-D rope over latent time, ``[1, n, head_dim/2, 2, 2]``."""
        ids = torch.from_numpy(wan_position_ids(n_tokens, 1, 1)).to(self.device)
        dims = [d for d in self.dit_config.axes_dim if d > 0]
        return multi_axis_rope(ids[..., :len(dims)], dims)

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, T, C]``: one token per latent frame. Differentiable."""
        return variables["dit"](noisy_latents, cond["txt"], t, cond["pe"])

    def encode_audio(self, variables: dict, waveform: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """``[B, S, C]`` in [-1, 1] -> ``[B, S / 256, 64]`` latents (the posterior mean without ``generator``)."""
        return variables["vae"].encode(waveform.to(self.device), generator)

    encode_images = encode_audio  # the latent cache encodes waveforms through the same call

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def latent_shape_audio(self, num_samples: int) -> tuple[int, int]:
        return num_samples // self.vae_config.downscale, self.vae_config.latent_channels

    def lora_targets(self) -> list[str]:
        return wan_lora_targets()

    @property
    def jax_scans_blocks(self) -> bool:
        return self.size != "tiny"

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        return wan_lora_key(name, scanned)

    def lora_key(self, name: str) -> str:
        """The JAX job's module name: scanned blocks at full size, unrolled at ``tiny``."""
        return wan_lora_key(name, scanned=self.size != "tiny")

    @staticmethod
    def lora_module_name(key: str) -> str:
        return wan_module_name(key)
