"""OmniGen2 model wrapper (``ai_toolkit_tpu/models/omnigen2_model.py`` in
PyTorch): arch ``omnigen2`` at sizes ``full`` (the default) and ``tiny``.

``models/omnigen2_dit.py`` (32 joint layers of 21 x 120 heads and the
reference-image stream) conditioned on Qwen2.5-VL-3B's final hidden states
(2048 wide, 256 tokens) of the chat-templated prompt, under the eos key mask
(eos 151,643; 2 at ``tiny``); the FLUX VAE, latents packed patch-major; the
model gets ``1 - t`` and its output is negated. ``cond["control_latents"]``
(the encoded ``datasets[].control_path`` images: ``[B, h, w, C]`` is one
reference, ``[B, R, h, w, C]`` R of them) feeds the reference stream; a
batch without control images trains without references, as the JAX job's
generic control branch does. Sampling takes no references: JAX
``generate_flux`` gives omnigen2 none, and a ``ctrl_img`` raises.

The full-size transformer config comes from ``transformer/config.json``
under ``name_or_path`` merged with ``model_kwargs.transformer_config`` (its
keys win), as in JAX; with neither the build raises, naming the file.
``model_kwargs.use_image_refiner`` adds ``ref_image_refiner`` to the LoRA
targets. A local checkpoint (JAX ``load_omnigen2_checkpoint``) is
``transformer/``, ``vae/`` and ``mllm/`` (Qwen2.5-VL; the text tower's
``model.language_model.`` or ``model.`` prefix stripped, the vision tower
and the LM head not read), or one transformer file. The LoRA file is in the
JAX job's ``comfy`` layout under its module paths (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import os

import torch

from ai_toolkit_tpu_torch.models.flux_dit import pack_latents, unpack_latents
from ai_toolkit_tpu_torch.models.lumina2_model import Lumina2Model
from ai_toolkit_tpu_torch.models.omnigen2_dit import (
    OmniGen2Config,
    OmniGen2DiT,
    omnigen2_lora_targets,
    omnigen2_pos_angles,
)
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig

# pipeline_omnigen2.py's Qwen2 chat template (JAX ``_CHAT_TEMPLATE``)
CHAT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant that generates "
    "high-quality images based on user instructions.<|im_end|>\n"
    "<|im_start|>user\n{}<|im_end|>\n"
)


@register_model
class OmniGen2Model(Lumina2Model):
    arch = "omnigen2"
    archs = ["omnigen2"]
    takes_control = True  # datasets[].control_path feeds the reference stream
    control_optional = True  # and a batch without control images has no references
    _kwargs = ("size", "transformer_config", "use_image_refiner")

    def _tiny_dit_config(self):
        return OmniGen2Config.tiny()

    def _full_dit_config(self):
        return OmniGen2Config.from_hf(self._dit_config_json())

    def _full_llm_config(self) -> LLMConfig:
        return LLMConfig.qwen25_3b()

    def _eos_id(self) -> int:
        return 2 if self.size == "tiny" else 151_643

    def _dit(self, device):
        return OmniGen2DiT(self.dit_config, device=device)

    def _dit_config_json(self) -> dict:
        over = dict(self.config.model_kwargs.get("transformer_config", {}))
        p = os.path.join(self.config.name_or_path or "", "transformer", "config.json")
        base = {}
        if os.path.isfile(p):
            with open(p) as f:
                base = json.load(f)
        merged = {**base, **over}
        if "hidden_size" not in merged:
            raise KeyError(f"omnigen2: no transformer config: {p} does not exist and model_kwargs.transformer_config "
                           f"holds no 'hidden_size' (the JAX model raises KeyError 'hidden_size' here, ROADMAP "
                           f"Queue 3); give the diffusers transformer config in either")
        return merged

    def load_te(self, variables: dict, path: str) -> None:
        """``mllm/`` (Qwen2.5-VL): its text tower, ``model.language_model.``
        or ``model.`` stripped (JAX renames the first to the second)."""
        self.load_component(variables, "te", os.path.join(path, "mllm"), f"{self.config.arch} te",
                            strip=("model.language_model.", "model."))

    def prompt_text(self, prompt: str) -> str:
        return CHAT_TEMPLATE.format(prompt)

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """cond: txt, txt_mask, and ``control_latents`` (``[B, h, w, C]`` or
        ``[B, R, h, w, C]``) for the reference stream. Differentiable."""
        if cond.get("ip_tokens") is not None:
            raise NotImplementedError("IP-adapter conditioning comes with a later slice")
        cfg = self.dit_config
        _, h, w, _ = noisy_latents.shape
        txt = cond["txt"]
        mask, cap_lens = self._masked_lengths(txt, cond.get("txt_mask"))
        refs = ref_ang = None
        ctrl = cond.get("control_latents")
        if ctrl is not None:
            ctrl = ctrl.to(txt.device)
            if ctrl.dim() == 4:  # one reference image
                ctrl = ctrl[:, None]
            b, n_ref, ch, cw, c = ctrl.shape
            refs = pack_latents(ctrl.reshape(b * n_ref, ch, cw, c)).unflatten(0, (b, n_ref))
            ca, ia, ref_ang = omnigen2_pos_angles(cfg, h // 2, w // 2, cap_lens, txt.shape[1],
                                                  ref_hw=(ch // 2, cw // 2), n_ref=n_ref)
        else:
            ca, ia, _ = omnigen2_pos_angles(cfg, h // 2, w // 2, cap_lens, txt.shape[1])
        out = variables["dit"](pack_latents(noisy_latents), txt, 1.0 - t.to(txt.device), mask, ia, ca, refs, ref_ang)
        return -unpack_latents(out, h, w)

    def sampling_control_latents(self, variables: dict, h: int, w: int, ctrl_img: str | None,
                                 gen_width: int, gen_height: int) -> None:
        """No references at sampling time, as JAX ``generate_flux`` gives
        omnigen2 none (it has no ``control_channels`` and no ``is_edit``)."""
        if ctrl_img:
            raise NotImplementedError("ctrl_img on arch 'omnigen2': the JAX generate_flux samples OmniGen2 without "
                                      "references, so the port takes none")
        return None

    def lora_targets(self) -> list[str]:
        return omnigen2_lora_targets(bool(self.config.model_kwargs.get("use_image_refiner", False)))

    def lora_key_layout(self) -> str:
        return "comfy"
