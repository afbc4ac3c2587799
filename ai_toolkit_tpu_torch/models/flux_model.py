"""FLUX model wrapper: DiT + VAE + CLIP/T5 conditioning
(``ai_toolkit_tpu/models/flux_model.py`` in PyTorch): the archs ``flux``,
``flux_schnell``, ``flex1``, ``flex2``, ``flux_kontext`` and ``chroma`` at
sizes ``dev`` (chroma: also ``full``) and ``tiny``, each with the DiT config
JAX ``FluxModel.__init__`` builds: chroma without the guidance embed and
with the Approximator (5120 x 5; 64 x 2 at ``tiny``); flex2 with the
196-input ``img_in`` of its ``[noisy, inpaint latents, keep mask, control
latents]`` tokens; ``flux_kontext`` (and ``model_kwargs.control``) with the
128-input ``img_in`` of ``[noisy, control latents]``. ``predict``
concatenates the packed control latents to the image tokens' channels;
flex2's control tensor is assembled on the host
(:meth:`FluxModel.assemble_flex2_control`, numpy and OpenCV, as in JAX) and
at sampling time :meth:`FluxModel.sampling_control_latents` encodes a
``ctrl_img``. ``model_kwargs`` keys other than ``size``, ``control`` and
flex2's seven control knobs raise.

Two archs are built as the JAX package builds them, which published
checkpoints do not match (ROADMAP Queue 3): ``flux_kontext`` as a channel
concat (FLUX.1-Kontext-dev's ``img_in`` takes 64 inputs: the control image
joins the token stream), and ``flex1`` / ``flex2`` at FLUX.1-dev's 19
double blocks (Flex.1-alpha and Flex.2-preview have 8). The port mirrors
the JAX model, and its strict loader refuses such a file, naming the fault;
the JAX loader skips the mismatched ``img_in`` or the absent blocks and
trains them from a random init.

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
# flex2's train-time control knobs (JAX assemble_flex2_control)
FLEX2_KNOBS = ("inpaint_random_chance", "inpaint_dropout", "do_random_inpainting", "random_blur_mask",
               "invert_inpaint_mask_chance", "random_dialate_mask", "control_dropout")
FLEX_DOUBLE_BLOCKS = 8  # Flex.1-alpha's and Flex.2-preview's pruned transformer


@register_model
class FluxModel(BaseModel):
    arch = "flux"
    archs = ["flux", "flex1", "flex2", "flux_schnell", "flux_kontext", "chroma"]
    is_flow_matching = True
    bucket_divisibility = 16
    max_txt_len = 512

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        arch, kw = config.arch, config.model_kwargs
        known = {"size", "control", *(FLEX2_KNOBS if arch == "flex2" else ())}
        if set(kw) - known:
            raise NotImplementedError(f"arch '{arch}': model_kwargs {sorted(set(kw) - known)} are not read "
                                      f"(read: {sorted(known)})")
        size = kw.get("size", "dev")
        if size == "tiny":
            self.dit_config = FluxConfig.tiny()
            self.vae_config = VAEConfig.tiny()
            self.clip_config = CLIPTextConfig.tiny()
            self.t5_config = T5Config.tiny()
            self.max_txt_len = 16
        elif size == "dev" or (size == "full" and arch == "chroma"):
            self.dit_config = FluxConfig.schnell() if arch == "flux_schnell" else FluxConfig.dev()
            self.vae_config = VAEConfig.flux()
            self.clip_config = CLIPTextConfig.clip_l()
            self.t5_config = T5Config.xxl()
        else:
            raise NotImplementedError(f"flux size '{size}' is not ported yet (ported: dev, tiny; chroma: full)")
        if arch == "flux_schnell":
            self.dit_config = dataclasses.replace(self.dit_config, guidance_embed=False)
        if arch == "chroma":  # every modulation vector from the Approximator
            tiny = size == "tiny"
            self.dit_config = dataclasses.replace(
                self.dit_config, guidance_embed=False, chroma_mod=True,
                approximator_hidden=64 if tiny else 5120, approximator_depth=2 if tiny else 5)
        base_in = self.dit_config.in_channels
        if arch == "flex2":  # [noisy(64), inpaint latents(64) + keep mask(4), control(64)], packed
            self.dit_config = dataclasses.replace(self.dit_config, in_channels=base_in * 3 + 4,
                                                  out_channels=base_in, control_channels=base_in * 2 + 4)
        elif kw.get("control") or arch == "flux_kontext":  # [noisy, control latents]
            self.dit_config = dataclasses.replace(self.dit_config, in_channels=base_in * 2,
                                                  out_channels=base_in, control_channels=base_in)
        self.tokenizer_clip = load_tokenizer(
            config.name_or_path, "tokenizer", vocab_size=self.clip_config.vocab_size,
            eos_id=self.clip_config.eos_token_id, max_len=77,
        )
        self.tokenizer_t5 = load_tokenizer(
            config.name_or_path, "tokenizer_2", vocab_size=self.t5_config.vocab_size,
            eos_id=1, max_len=self.max_txt_len,
        )

    @property
    def takes_control(self) -> bool:
        return bool(self.dit_config.control_channels)

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
                loaded += self.load_component(variables, "dit", src, f"{self.config.arch} dit",
                                              prepare=self._refuse_jax_faults)
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

    def _refuse_jax_faults(self, dit: nn.Module, index: SafetensorsIndex, what: str) -> None:
        """Before the strict load: a published Kontext or Flex file meets the
        DiT the JAX package builds for its arch; raise naming the fault
        (ROADMAP Queue 3) instead of the first shape or key that differs."""
        arch, cfg = self.config.arch, self.dit_config
        if arch == "flux_kontext" and "img_in.weight" in index:
            n_in = index.get("img_in.weight").shape[1]
            if n_in != cfg.in_channels:
                raise ValueError(
                    f"{what}: img_in in {index.path} takes {n_in} inputs, as FLUX.1-Kontext-dev's does (the "
                    f"control image joins the token stream). The JAX package builds flux_kontext as a channel "
                    f"concat with a {cfg.in_channels}-input img_in, and its non-strict merge skips this one and "
                    f"trains a random img_in (ROADMAP Queue 3); the port mirrors the JAX model and refuses the file")
        if arch in ("flex1", "flex2"):
            have = {int(k.split(".")[1]) for k in index.keys() if k.startswith("double_blocks.")}
            if have and len(have) < cfg.depth_double:
                raise KeyError(
                    f"{what}: {index.path} holds {len(have)} double blocks, as Flex.1-alpha and Flex.2-preview "
                    f"do ({FLEX_DOUBLE_BLOCKS}). The JAX package builds {arch} at FLUX.1-dev's "
                    f"{cfg.depth_double}, and its loader leaves double_blocks.{len(have)}-{cfg.depth_double - 1} "
                    f"on their seeded init (ROADMAP Queue 3); the port mirrors the JAX model and refuses the file")

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
        """noisy_latents ``[B, h, w, C]``; cond: txt, y, pe, guidance[, txt_mask],
        and for a control arch ``control_latents`` ``[B, h, w, C_ctrl]``,
        packed and concatenated to the image tokens' channels (JAX
        ``predict``); ``ip_tokens`` ``[B, N, mid]`` feed the blocks' decoupled
        K/V of a vision_direct adapter. Differentiable: the train step takes
        gradients through it into the DiT's LoRA factors and the adapter."""
        _, h, w, _ = noisy_latents.shape
        img = pack_latents_cmajor(noisy_latents)
        ctrl = cond.get("control_latents")
        if (ctrl is not None) != self.takes_control:
            raise ValueError(f"arch '{self.config.arch}' takes control latents: {self.takes_control}; "
                             f"the batch carries them: {ctrl is not None}")
        if ctrl is not None:
            img = torch.cat([img, pack_latents_cmajor(ctrl.to(img.device)).to(img.dtype)], dim=-1)
        out = variables["dit"](img, cond["txt"], t, cond["y"], cond["pe"], cond.get("guidance"),
                               cond.get("txt_mask"), ip_tokens=cond.get("ip_tokens"))
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

    # ---- control conditioning (flex2, kontext; JAX flux_model.py:270-430) ----

    def assemble_flex2_control(self, latents: np.ndarray, keep_mask_px: np.ndarray | None,
                               ctrl_latents: np.ndarray | None, host_rng: np.random.Generator) -> np.ndarray:
        """flex2's train-time control tensor ``[B, h, w, 2C + 1]``: [the clean
        latents where the keep mask keeps them, the inpaint mask (1 =
        inpaint), the control latents], with the per-batch dropouts of
        ``model_kwargs``, on the host in numpy and OpenCV; ``host_rng`` is
        drawn in the JAX function's order, so equal generators give equal
        tensors bit for bit. ``keep_mask_px``: the pixel keep mask ``[B, H,
        W, 1]`` (1 = keep) or None; ``ctrl_latents``: ``[B, h, w, C]`` or None."""
        import cv2

        mk = self.config.model_kwargs
        b, h, w, c = latents.shape
        lat = np.asarray(latents, np.float32)
        keep = None
        if keep_mask_px is not None:
            keep = np.stack([cv2.resize(m[..., 0], (w, h), interpolation=cv2.INTER_LINEAR)
                             for m in np.asarray(keep_mask_px, np.float32)])[..., None]
        if float(mk.get("inpaint_random_chance", 0.0)) > 0.0:
            if host_rng.random() < float(mk["inpaint_random_chance"]):
                keep = None
        do_dropout = host_rng.random() < float(mk.get("inpaint_dropout", 0.0))
        if keep is None and not do_dropout and mk.get("do_random_inpainting"):
            keep = 1.0 - _random_blob_mask(b, h, w, host_rng)
        if keep is not None and not do_dropout:
            if mk.get("random_blur_mask") and host_rng.random() < 0.5:
                k = int(host_rng.integers(3, 8))
                k += 1 - k % 2
                keep = np.stack([cv2.blur(m[..., 0], (k, k)) for m in keep])[..., None]
            if float(mk.get("invert_inpaint_mask_chance", 0.0)) > 0.0:
                if host_rng.random() < float(mk["invert_inpaint_mask_chance"]):
                    keep = 1.0 - keep
            inpaint_lat = lat * keep
            if mk.get("random_dialate_mask"):
                px = max(1, int(0.05 * host_rng.random() * min(h, w)))
                keep = np.stack([cv2.dilate(m[..., 0], np.ones((px, px), np.uint8)) for m in keep])[..., None]
            mask_chan = 1.0 - keep
        else:
            inpaint_lat = np.zeros_like(lat)
            mask_chan = np.ones((b, h, w, 1), np.float32)
        ctrl = np.zeros_like(lat)
        if ctrl_latents is not None:
            if not (host_rng.random() < float(mk.get("control_dropout", 0.0))):
                ctrl = np.asarray(ctrl_latents, np.float32)
        return np.concatenate([inpaint_lat, mask_chan, ctrl], axis=-1)

    def _encode_image_file(self, variables: dict, im, width: int, height: int) -> torch.Tensor:
        px = np.asarray(im.convert("RGB").resize((width, height)), np.float32) / 127.5 - 1.0
        return self.encode_images(variables, torch.from_numpy(px)[None]).float()

    def sampling_control_latents(self, variables: dict, h: int, w: int, ctrl_img: str | None,
                                 gen_width: int, gen_height: int) -> torch.Tensor:
        """The control latents of a sample (JAX ``sampling_control_latents``):
        kontext and ``control`` get the encoded ``ctrl_img`` (zeros without
        one); flex2 gets ``[inpaint, mask = 1, control]`` with the image in the
        control slot, or in the inpaint slot (its alpha the keep mask) when the
        file name holds ``.inpaint.`` and the image is RGBA."""
        from PIL import Image

        dev, c = self.device, self.vae_config.latent_channels
        with torch.no_grad():
            if self.config.arch != "flex2":
                ctrl_c = max(c, (self.dit_config.control_channels or 4 * c) // 4)
                out = torch.zeros((1, h, w, ctrl_c), dtype=torch.float32, device=dev)
                if ctrl_img:
                    with Image.open(ctrl_img) as im:
                        out[..., :c] = self._encode_image_file(variables, im, gen_width, gen_height)
                return out
            inpaint = torch.zeros((1, h, w, c), dtype=torch.float32, device=dev)
            mask = torch.ones((1, h, w, 1), dtype=torch.float32, device=dev)
            ctrl = torch.zeros((1, h, w, c), dtype=torch.float32, device=dev)
            if ctrl_img:
                with Image.open(ctrl_img) as im:
                    if ".inpaint." in ctrl_img and im.mode == "RGBA":
                        import cv2

                        im = im.resize((gen_width, gen_height))
                        keep = np.asarray(im.split()[-1], np.float32) / 255.0
                        keep_l = torch.from_numpy(cv2.resize(keep, (w, h))[None, ..., None]).to(dev)
                        inpaint = self._encode_image_file(variables, im, gen_width, gen_height) * keep_l
                        mask = 1.0 - keep_l
                    else:
                        ctrl = self._encode_image_file(variables, im, gen_width, gen_height)
            return torch.cat([inpaint, mask, ctrl], dim=-1)


def _random_blob_mask(b: int, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """``[B, h, w, 1]`` random elliptical blobs, 1 = inpaint (JAX ``_random_blob_mask``)."""
    out = np.zeros((b, h, w, 1), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.random() * h, rng.random() * w
            ry = max(2.0, rng.random() * h / 2)
            rx = max(2.0, rng.random() * w / 2)
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            out[i, ..., 0] = np.maximum(out[i, ..., 0], blob.astype(np.float32))
    return out
