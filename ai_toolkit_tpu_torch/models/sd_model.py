"""SD 1.x / 2.x and SDXL model wrappers (``ai_toolkit_tpu/models/sd_model.py``
``SDModel`` and ``SDXLModel`` in PyTorch): epsilon (SD 2.x: v) prediction on
DDPM schedules (``is_flow_matching`` false), the SD VAE (4-channel latents,
quant convs).

``SDModel`` (archs ``sd1``, ``sd15``, ``sd2``, ``ssd``, ``vega``): the SD 1.5
UNet (global 8 heads: 40, 80 and 160 wide, on the plain attention), one
CLIP-L whose final states are the context, and no added condition. With a
textual-inversion bank in ``variables["emb"]`` (``adapters/embedding.py``)
the prompt's virtual ids take their vectors from it, and a batch that
carries ``input_ids`` runs CLIP inside the train step so that gradients
reach the bank. At ``size: full`` the archs the JAX package cannot build
raise, naming its fault: ``sd2`` (CLIP-L's 768-wide states before
``UNetConfig.sd21``'s 1024-wide context) and ``ssd`` / ``vega`` (SDXL
distillations built as SD 1.5); at ``size: tiny`` they are the JAX models
(``sd2`` tiny with v-prediction).

``SDXLModel`` (arch ``sdxl``): the SDXL UNet, CLIP-L and OpenCLIP-G, both
called at ``clip_skip=1`` with their penultimate states concatenated into the
2048-wide context and the pooled output taken from OpenCLIP-G, the SDXL VAE
(scale 0.13025), and the added condition of the pooled embedding and ``[h,
w, 0, 0, h, w]``. The refiner (``sdxl_refiner``, ``refiner_name_or_path``)
and text-encoder training raise ``NotImplementedError``.

``model_kwargs``: ``size`` (``full`` | ``tiny``). ``model.remat_policy:
none`` turns the UNet's per-block checkpointing off, as in the JAX package.
A local checkpoint is an LDM / SGM single file (``io/ldm_single_file.py``)
or an HF-layout directory (JAX ``io/sd_import.load_sd_checkpoint``):
``unet/``, ``vae/``, ``text_encoder/`` and (SDXL) ``text_encoder_2/``, each
of which ``unet_path``, ``vae_path`` and ``text_encoder_path`` may point
elsewhere; the port's modules carry the diffusers and transformers names.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io.from_jax import unet_jax_path
from ai_toolkit_tpu_torch.io.ldm_single_file import load_ldm_checkpoint
from ai_toolkit_tpu_torch.io.safetensors_dir import squeeze_adapt
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.clip import CLIPTextConfig, CLIPTextModel, drop_absent_projection
from ai_toolkit_tpu_torch.models.unet import UNet2DCondition, UNetConfig, unet_lora_targets
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

_LATER = "comes with a later slice"
_JAX_FAULTS = {
    "sd2": "the JAX package builds CLIP-L (768 wide, 12 layers; ai_toolkit_tpu/models/sd_model.py:41-43) before "
           "UNetConfig.sd21's 1024-wide context, while a real SD 2.x file carries OpenCLIP-H (1024 wide, 23 of its "
           "24 layers)",
    "ssd": "the JAX package builds the SD 1.5 UNet and CLIP-L for it (ai_toolkit_tpu/models/sd_model.py:41-43), "
           "but SSD-1B is an SDXL distillation: no real file of it fits",
    "vega": "the JAX package builds the SD 1.5 UNet and CLIP-L for it (ai_toolkit_tpu/models/sd_model.py:41-43), "
            "but Vega is an SDXL distillation: no real file of it fits",
}


@register_model
class SDModel(BaseModel):
    arch = "sd1"
    archs = ["sd1", "sd15", "sd2", "ssd", "vega"]
    is_flow_matching = False
    bucket_divisibility = 8
    main_component = "unet"
    # HF-layout subdirectory -> component
    hf_parts = (("unet", "unet"), ("vae", "vae"), ("text_encoder", "clip"))

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        if config.refiner_name_or_path:
            raise NotImplementedError(f"the SDXL refiner (refiner_name_or_path) {_LATER}")
        size = config.model_kwargs.get("size", "full")
        if size == "tiny":
            self.unet_config = UNetConfig.tiny()
            self.vae_config = VAEConfig.tiny()
            self.clip_config = CLIPTextConfig.tiny()
        elif size == "full":
            if config.arch in _JAX_FAULTS:
                raise NotImplementedError(f"arch '{config.arch}' at size full: {_JAX_FAULTS[config.arch]}. Not "
                                          f"ported until the reference builds it (size: tiny runs)")
            self.unet_config = UNetConfig.sd15()
            self.vae_config = VAEConfig.sd()
            self.clip_config = CLIPTextConfig.clip_l()
        else:
            raise NotImplementedError(f"{config.arch} size '{size}' (ported: full, tiny)")
        self._finish_init(config)

    def _finish_init(self, config: ModelConfig) -> None:
        if config.remat_policy == "none":
            self.unet_config = dataclasses.replace(self.unet_config, remat=False)
        self.tokenizer = load_tokenizer(
            config.name_or_path, "tokenizer", vocab_size=self.clip_config.vocab_size,
            eos_id=self.clip_config.eos_token_id, max_len=77,
        )

    # ---- construction ----

    def _constructors(self) -> dict:
        dev = self.device
        return {
            "unet": lambda: UNet2DCondition(self.unet_config, device=dev),
            "vae": lambda: AutoencoderKL(self.vae_config, device=dev),
            "clip": lambda: CLIPTextModel(self.clip_config, device=dev),
        }

    def init_variables(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """Every component built empty on the device in its dtype, then filled
        from ``generator``, one after the other."""
        return {name: init_parameters(build(), generator).eval().requires_grad_(False)
                for name, build in self._constructors().items()}

    def load_checkpoint(self, path: str, generator: torch.Generator) -> dict[str, nn.Module]:
        layout = "an LDM single file or an HF-layout directory: " + ", ".join(f"{d}/" for d, _ in self.hf_parts)
        variables = self.init_variables(generator)
        if os.path.isfile(path):
            load_ldm_checkpoint(path, variables, self.unet_config.layers_per_block, self.clip_config.num_layers,
                                prepare={"clip": drop_absent_projection})
            return variables
        if not os.path.isdir(path):
            self.refuse_bad_layout(layout)
        overrides = {"unet": self.config.unet_path, "vae": self.config.vae_path, "clip": self.config.text_encoder_path}
        loaded = 0
        for subdir, name in self.hf_parts:
            root, ov = path, overrides.get(name)
            if ov:  # a whole HF directory (its matching subdir), or the component's own directory or file
                if os.path.isdir(os.path.join(ov, subdir)):
                    root = ov
                else:
                    root, subdir = os.path.split(ov.rstrip("/"))
            loaded += self.load_component(variables, name, os.path.join(root, subdir), f"{self.config.arch} {name}",
                                          prepare=drop_absent_projection if name == "clip" else None,
                                          adapt=squeeze_adapt if name == "unet" else None)
        if not loaded:
            self.refuse_bad_layout(layout)
        return variables

    # ---- conditioning ----

    def _ids(self, prompts: list[str]) -> torch.Tensor:
        return torch.from_numpy(np.stack([self.tokenizer.encode(p) for p in prompts])).long().to(self.device)

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """context: CLIP's final states ``[B, 77, 768]``, the prompt's
        virtual ids from the textual-inversion bank when there is one."""
        return {"context": variables["clip"](self._ids(prompts), bank=variables.get("emb"))["last_hidden_state"]}

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, h, w, 4]``; t ``[B]`` (integer timesteps in
        training); cond: context (SDXL: added_cond). Differentiable."""
        return variables["unet"](noisy_latents, t, cond["context"], cond.get("added_cond"),
                                 cond.get("ip_tokens"), cond.get("adapter_residuals"))

    @staticmethod
    def _ip_tokens(variables: dict, cond: dict) -> dict:
        """An IP-adapter batch's CLIP embeddings through the trained
        projection (``variables["ip_proj"]``) into ``ip_tokens``, inside the
        differentiated step (JAX ``predict_train``)."""
        if "ip_embeds" in cond and "ip_proj" in variables:
            return {**cond, "ip_tokens": variables["ip_proj"](cond["ip_embeds"])}
        return cond

    def predict_train(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                      cond: dict) -> torch.Tensor:
        """The train-time forward (JAX ``predict_train``): IP-adapter
        embeddings become ``ip_tokens`` through the trained projection; a
        batch that carries token ids (textual inversion) runs CLIP with the
        bank inside the step, so that gradients reach the bank."""
        cond = self._ip_tokens(variables, cond)
        if "input_ids" in cond:
            out = variables["clip"](cond["input_ids"], bank=variables.get("emb"))
            cond = {**cond, "context": out["last_hidden_state"]}
        return self.predict(variables, noisy_latents, t, cond)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        return unet_lora_targets()

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        return unet_jax_path(name, len(self.unet_config.block_out_channels))

    # ---- geometry ----

    def latent_shape(self, height: int, width: int) -> tuple[int, int, int]:
        d = self.vae_config.downscale
        return height // d, width // d, self.vae_config.latent_channels


@register_model
class SDXLModel(SDModel):
    arch = "sdxl"
    archs = ["sdxl", "sdxl_refiner", "ssd_refiner"]
    hf_parts = SDModel.hf_parts + (("text_encoder_2", "clip2"),)

    def __init__(self, config: ModelConfig, device: torch.device | str):
        BaseModel.__init__(self, config, device)
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
        self._finish_init(config)

    def _constructors(self) -> dict:
        return {**super()._constructors(), "clip2": lambda: CLIPTextModel(self.clip2_config, device=self.device)}

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        """context: both encoders' penultimate states concatenated
        ``[B, 77, 2048]``; pooled: OpenCLIP-G's projected pooled output."""
        ids = self._ids(prompts)
        o1 = variables["clip"](ids, clip_skip=1)
        o2 = variables["clip2"](ids, clip_skip=1)
        return {"context": torch.cat([o1["last_hidden_state"], o2["last_hidden_state"]], dim=-1),
                "pooled": o2["pooled_output"]}

    def added_cond(self, pooled: torch.Tensor, height: int, width: int) -> dict:
        """SDXL micro-conditioning: original size, crop (0, 0), target size."""
        time_ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                                device=pooled.device).repeat(pooled.shape[0], 1)
        return {"time_ids": time_ids, "text_embeds": pooled}

    def predict_train(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor,
                      cond: dict) -> torch.Tensor:
        """The train-time forward (JAX ``predict_train``): IP-adapter
        embeddings become ``ip_tokens`` through the trained projection; token
        ids (text-encoder training, textual inversion on SDXL) raise."""
        if "input_ids" in cond:
            raise NotImplementedError(f"text-encoder training and textual inversion on SDXL {_LATER}")
        return self.predict(variables, noisy_latents, t, self._ip_tokens(variables, cond))
