"""Wan video model wrapper (``ai_toolkit_tpu/models/wan_model.py``
``WanModel`` in PyTorch): archs ``wan21`` and ``wan21_i2v`` (Wan 2.1 t2v and
i2v at sizes ``1.3b``, ``14b`` and ``tiny``), ``wan22_5b`` (the Wan 2.2
TI2V-5B with its residual, patchified VAE) and ``wan22_14b`` /
``wan22_14b_i2v`` (the Wan 2.2 two-expert pair). The flow-matching video DiT
(``models/wan_dit.py``), UMT5 text conditioning (T5-XXL with a relative-bias
table per layer), the causal 3-D VAE (``models/wan_vae.py``), the CLIP
vision tower of the i2v archs (``text_encoders/clip_vision.py``: the first
frame's penultimate hidden states) and the frame-count grid of the VAE
(4k+1 frames). Latents are 5-D, ``[B, T, h, w, C]``; a lone image is a
one-frame video.

Sizes are chosen as the JAX class chooses them: ``size`` defaults to
``1.3b`` for every arch (so a ``wan22_14b`` job without ``model_kwargs.size``
builds its pair at 1.3B widths, as in JAX), ``wan22_5b`` is forced to ``5b``
unless ``tiny``, and ``5b`` buckets by 32. A multistage model
(``wan22_14b*``, or ``model_kwargs.multistage``) holds two DiTs: ``dit``, the
high-noise expert, and ``dit_low``; :meth:`predict` routes the whole batch
by ``mean(t) >= stage_boundary`` (default 0.875). One LoRA network serves
both experts. A quantized base (``init_variables(qtype=...)``, the train
job's ``model.quantize``) quantizes each expert from its own weights as it
is built, so the bf16 pair never sits on the device at once. Control
latents (the i2v adapter's first-frame conditioning) are patchified on
their own and feature-concatenated to the noisy latents' tokens, which the
frame embedder on ``patch_embedding`` (an ``ops.layers.Ctrl``) takes.
Sequence parallelism raises ``NotImplementedError`` naming its slice.

A local checkpoint (JAX ``io/dit_importers.load_wan_checkpoint``) is an
HF-layout directory, ``transformer/`` (and ``transformer_2/``, a pair's
low-noise expert ``dit_low``), ``text_encoder/`` (UMT5) and ``vae/``, whose
``config.json`` rebuilds the VAE (:func:`wan_vae_config_from_json`: the
TI2V-5B's Wan 2.2 VAE), or a single DiT file. The port's modules carry the
diffusers ``WanTransformer3DModel`` and ``AutoencoderKLWan`` names; the
conv3d patch embedding is read into the DiT's patch Linear, and the
singleton axes of the VAE's RMS gammas and 1x1 attention convs are dropped.
Each expert is loaded as it is built, before it is quantized. As in the
JAX package, an i2v arch's vision tower is not loaded (``image_encoder/``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io.safetensors_dir import squeeze_to
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
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

SEQUENCE_PARALLEL = "sequence parallelism (ring attention, multi-GPU) comes with slice E's last remaining item"
# the JAX DEFAULT_EXCLUDE over the JAX DiT's paths leaves out only its
# ``*embedding*`` kernels: the patch embedding and the text MLP
QUANTIZE_EXCLUDE = [r"^patch_embedding$", r"^condition_embedder\.text_embedder\."]


@register_model
class WanModel(BaseModel):
    arch = "wan21"
    archs = ["wan21", "wan21_i2v", "wan22_5b", "wan22_14b", "wan22_14b_i2v"]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 512
    quantize_exclude = QUANTIZE_EXCLUDE

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        kw = config.model_kwargs
        size = kw.get("size", "1.3b")
        if config.arch == "wan22_5b" and size not in ("tiny", "5b"):
            size = "5b"
        self.size = size
        i2v = config.arch.endswith("i2v")
        # the Wan 2.2 14B pair: high- and low-noise experts switched at a timestep boundary
        self.multistage = config.arch.startswith("wan22_14b") or bool(kw.get("multistage"))
        self.stage_boundary = float(kw.get("stage_boundary", 0.875))
        self.last_expert: str | None = None  # the expert the last predict ran (multistage)
        umt5 = dataclasses.replace(T5Config.xxl(), per_layer_bias=True)
        vision = CLIPVisionConfig.vit_h() if i2v else None
        if size == "tiny":
            vision = CLIPVisionConfig.tiny() if i2v else None
            dit = dataclasses.replace(WanConfig.tiny(), i2v=i2v, img_cond_dim=64)
            # wan22_5b runs the residual, patchified Wan 2.2 VAE end to end
            vae = WanVAEConfig.tiny22() if config.arch == "wan22_5b" else WanVAEConfig.tiny()
            umt5 = dataclasses.replace(T5Config.tiny(), per_layer_bias=True)
            self.max_txt_len = 16
        elif size == "5b":
            vision = None
            dit, vae = WanConfig.wan22_5b(), WanVAEConfig.wan22_5b()
            self.bucket_divisibility = 32  # the 16x VAE times the DiT's 2x2 patch
        elif size in ("14b", "14B"):
            dit, vae = dataclasses.replace(WanConfig.wan21_14b(), i2v=i2v), WanVAEConfig.wan21()
        elif size == "1.3b":
            dit, vae = dataclasses.replace(WanConfig.wan21_1_3b(), i2v=i2v), WanVAEConfig.wan21()
        else:
            raise NotImplementedError(f"wan size '{size}' (ported: 1.3b, 14b, 5b, tiny)")
        self.dit_config, self.vae_config, self.vision_config, self.t5_config = dit, vae, vision, umt5
        self.tokenizer = load_tokenizer(config.name_or_path, "tokenizer", vocab_size=umt5.vocab_size,
                                        eos_id=1, max_len=self.max_txt_len)

    @property
    def experts(self) -> tuple[str, ...]:
        return ("dit", "dit_low") if self.multistage else ("dit",)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator, qtype: str | None = None,
                       fill=None) -> dict[str, nn.Module]:
        """Seeded init of ``dit`` (``dit_low``), ``vae``, ``t5`` (and
        ``clip_vision``) in that order; ``fill(name, module)``, when given,
        loads each right after its init; with ``qtype`` each expert is then
        quantized from its own weights."""
        dev = self.device

        def build(name: str, module: nn.Module) -> nn.Module:
            module = init_parameters(module, generator).eval().requires_grad_(False)
            if fill is not None:
                fill(name, module)
            return module

        variables = {}
        for name in self.experts:
            variables[name] = build(name, WanDiT(self.dit_config, device=dev))
            if qtype is not None:
                quantize_params(variables[name], exclude_patterns=QUANTIZE_EXCLUDE, qtype=qtype)
        variables["vae"] = build("vae", WanVAE(self.vae_config, device=dev))
        variables["t5"] = build("t5", T5Encoder(self.t5_config, device=dev))
        if self.vision_config is not None:
            variables["clip_vision"] = build("clip_vision", CLIPVisionModel(self.vision_config, device=dev))
        return variables

    def load_variables(self, generator: torch.Generator, qtype: str | None = None) -> dict[str, nn.Module]:
        path = self.config.name_or_path
        if not path:
            return self.init_variables(generator, qtype)
        if not (os.path.isdir(os.path.join(path, "transformer")) or os.path.isfile(path)):
            self.refuse_bad_layout("transformer/ [transformer_2/, text_encoder/, vae/] or a single .safetensors "
                                   "file of the diffusers WanTransformer3DModel")
        srcs = {"dit": path}
        if os.path.isdir(path):
            srcs = {"dit": os.path.join(path, "transformer"), "dit_low": os.path.join(path, "transformer_2"),
                    "t5": os.path.join(path, "text_encoder"), "vae": os.path.join(path, "vae")}
            if os.path.isdir(srcs["vae"]):
                self.vae_config = wan_vae_config_from_json(srcs["vae"], self.vae_config.dtype)

        def fill(name: str, module: nn.Module) -> None:
            if name == "clip_vision":
                print("wan clip_vision: keeps its seeded init; the loader does not read image_encoder/, as the "
                      "JAX package's does not")
            elif name not in srcs:
                print(f"wan {name}: {path} is a single DiT file; '{name}' keeps its seeded init")
            else:
                strip = ("model.diffusion_model.", "transformer.") if name.startswith("dit") else ()
                self.load_component({name: module}, name, srcs[name], f"wan {name}", strip=strip, adapt=_adapt)

        return self.init_variables(generator, qtype, fill=fill)

    def enable_sequence_parallel(self, *args, **kwargs) -> None:
        raise NotImplementedError(SEQUENCE_PARALLEL)

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        ids = np.stack([self.tokenizer.encode(p) for p in prompts])
        return {"txt": variables["t5"](torch.from_numpy(ids).long().to(self.device))}

    def encode_image_cond(self, variables: dict, first_frame: torch.Tensor) -> torch.Tensor:
        """i2v conditioning: the first frame ``[B, H, W, 3]`` in [-1, 1] ->
        CLIP-vision tokens ``[B, N, img_cond_dim]``, the penultimate hidden
        states. The frame is resized to the tower's size by antialiased
        bilinear interpolation, as ``jax.image.resize(..., "bilinear")``
        antialiases when it downsamples."""
        if self.vision_config is None:
            raise ValueError(f"arch '{self.config.arch}' has no vision tower: first-frame conditioning "
                             f"(datasets[].do_i2v, ctrl_img) needs an i2v arch")
        sz = self.vision_config.image_size
        px = F.interpolate(first_frame.to(self.device).float().permute(0, 3, 1, 2), size=(sz, sz),
                           mode="bilinear", antialias=True, align_corners=False)
        return variables["clip_vision"](px.permute(0, 2, 3, 1))["penultimate_hidden_state"]

    def rope_table(self, t: int, h: int, w: int) -> torch.Tensor:
        """The (t, y, x) rope table of a ``t x h x w`` latent grid, ``[1, N, head_dim/2, 2, 2]``."""
        pt, ph, pw = self.dit_config.patch_size
        ids = torch.from_numpy(wan_position_ids(t // pt, h // ph, w // pw)).to(self.device)
        return multi_axis_rope(ids, list(self.dit_config.axes_dim))

    # ---- forward ----

    def expert(self, t: torch.Tensor) -> str:
        """The variables entry that denoises at ``t``: the whole batch goes to
        the high-noise expert when ``mean(t) >= stage_boundary``."""
        if not self.multistage:
            return "dit"
        return "dit" if float(t.float().mean()) >= self.stage_boundary else "dit_low"

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """noisy_latents ``[B, T, h, w, C]``; cond: txt, pe, img_cond (i2v) and
        control_latents ``[B, T, h, w, C_ctrl]`` (the frame embedder's input,
        patchified on its own and concatenated to the tokens' features, JAX
        ``predict``). Differentiable."""
        _, tt, hh, ww, c = noisy_latents.shape
        patch = self.dit_config.patch_size
        tokens = wan_patchify(noisy_latents, patch)
        ctrl = cond.get("control_latents")
        if ctrl is not None:
            tokens = torch.cat([tokens, wan_patchify(ctrl.to(tokens.device), patch).to(tokens.dtype)], dim=-1)
        self.last_expert = self.expert(t) if "dit_low" in variables else "dit"
        out = variables[self.last_expert](tokens, cond["txt"], t, cond["pe"], cond.get("img_cond"))
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

    @property
    def jax_scans_blocks(self) -> bool:
        return self.size != "tiny"

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        return wan_lora_key(name, scanned)

    def lora_key(self, name: str) -> str:
        """The module name the JAX job's LoRA file carries for ``name``
        (:func:`~ai_toolkit_tpu_torch.models.wan_dit.wan_lora_key`): the
        scanned layout at every size but ``tiny``."""
        return wan_lora_key(name, scanned=self.size != "tiny")

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


def _adapt(name: str, t: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """A diffusers Wan tensor in the port's layout: the conv3d patch
    embedding ``[out, in, kt, kh, kw]`` as the patch Linear ``[out, kt*kh*kw*in]``
    (``wan_patchify``'s (t, y, x, c) order), and singleton axes dropped or
    added (RMS gammas, 1x1 convs, modulation tables)."""
    if name == "patch_embedding.weight" and t.dim() == 5:
        return t.permute(0, 2, 3, 4, 1).reshape(t.shape[0], -1)
    return squeeze_to(t, target.shape)


def wan_vae_config_from_json(vae_dir: str, dtype: torch.dtype = torch.bfloat16) -> WanVAEConfig:
    """The VAE of a checkpoint's ``vae/config.json`` (JAX
    ``io/video_vae_import.wan_vae_config_from_json``): dims and latent
    statistics from the file, Wan 2.1's where it is silent; no file is Wan
    2.1's VAE. Wan 2.2 configs give the patchified ``in_channels`` (12 = 3*2*2)."""
    base = WanVAEConfig.wan21()
    path = os.path.join(vae_dir, "config.json")
    if not os.path.isfile(path):
        return dataclasses.replace(base, dtype=dtype)
    with open(path) as f:
        c = json.load(f)
    patch = int(c.get("patch_size") or 1)
    return WanVAEConfig(
        base_dim=c.get("base_dim", base.base_dim), z_dim=c.get("z_dim", base.z_dim),
        dim_mult=tuple(c.get("dim_mult", base.dim_mult)), num_res_blocks=c.get("num_res_blocks", base.num_res_blocks),
        attn_scales=tuple(c.get("attn_scales", base.attn_scales)),
        temperal_downsample=tuple(c.get("temperal_downsample", base.temperal_downsample)),
        latents_mean=tuple(c.get("latents_mean", base.latents_mean)),
        latents_std=tuple(c.get("latents_std", base.latents_std)),
        in_channels=c.get("in_channels", 3 * patch * patch) // (patch * patch), dtype=dtype, patch_size=patch,
        is_residual=bool(c.get("is_residual", False)), decoder_base_dim=c.get("decoder_base_dim"),
        clip_output=bool(c.get("clip_output", True)))
