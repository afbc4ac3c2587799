"""LTX-2 video model wrapper (``ai_toolkit_tpu/models/ltx2_model.py``
``LTX2Model`` in PyTorch): archs ``ltx2``, ``ltx2_3``, ``ltx2.3``, ``ltxv``
and ``minimax_h3`` (one class in JAX), at sizes ``full`` and ``tiny``.

The DiT is the Wan DiT at LTX-2's widths (48 layers, 4096 wide, 32 heads of
128, patch 1, rope axes (32, 48, 48) over (t, y, x), 3840-wide caption
states), or with ``model_kwargs.joint_audio`` the joint audio-video DiT
(``models/ltx2_av.py``). The video VAE is ``models/ltx_video_vae.py`` (128
latent channels, 32x spatial, 8x temporal: 8k+1 frames), the caption tower
the Gemma-family ``LLMEncoder`` (48 layers, 3840 wide, 16 heads and 8 KV
heads of 240, Gemma norms and GELU, scaled embeddings, no softcap; its
attention is causal, so it takes the plain path, as in JAX). The audio
backend (``model_kwargs.audio_vae``) is ``mel``, the reference chain:
:func:`~ai_toolkit_tpu_torch.models.ltx_audio_vae.log_mel` of the
waveform with the VAE's 16 kHz filterbank and hop of 160 (JAX feeds it the
48 kHz waveform the dataset loads, so one second gives 75 tokens, not 25:
``ROADMAP`` Queue 3), the mel VAE and 16 x 8 token packing, decoded by
``models/ltx_vocoder.py``; or ``waveform``, the 1-D causal VAE of
``models/audio_vae.py`` at 128 latent channels. Without the key the
backend is ``mel`` when ``name_or_path`` is a directory, else
``waveform``, as in JAX.

A joint model given a video-only batch runs the audio stream on one silent
token (JAX ``predict``). ``model.quantize`` quantizes the DiT as it is built
(the JAX ``DEFAULT_EXCLUDE`` over the JAX paths leaves out the patch and
text embeddings).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.models.audio_vae import AudioAutoencoderKL, AudioVAEConfig
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.ltx2_av import LTX2AVConfig, LTX2AVDiT, av_lora_key, av_module_name
from ai_toolkit_tpu_torch.models.ltx_audio_vae import (LTXAudioVAE, LTXAudioVAEConfig, log_mel, pack_audio_latents,
                                                       unpack_audio_latents)
from ai_toolkit_tpu_torch.models.ltx_video_vae import LTXVideoVAE, LTXVideoVAEConfig
from ai_toolkit_tpu_torch.models.ltx_vocoder import LTX2Vocoder, VocoderConfig, stack_stereo_mel
from ai_toolkit_tpu_torch.models.registry import register_model
from ai_toolkit_tpu_torch.models.text_encoders.llm import LLMConfig, LLMEncoder
from ai_toolkit_tpu_torch.models.wan_dit import (WanConfig, WanDiT, wan_lora_key, wan_lora_targets, wan_module_name,
                                                 wan_patchify, wan_position_ids, wan_unpatchify)
from ai_toolkit_tpu_torch.models.wan_model import QUANTIZE_EXCLUDE as WAN_QUANTIZE_EXCLUDE
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope
from ai_toolkit_tpu_torch.utils.tokenizer import load_tokenizer

AV_QUANTIZE_EXCLUDE = [r"^patch_embedding$", r"^text_embedding_"]


def ltx2_dit_config() -> WanConfig:
    return WanConfig(in_channels=128, dim=4096, ffn_dim=16384, num_heads=32, num_layers=48, text_dim=3840,
                     patch_size=(1, 1, 1), axes_dim=(32, 48, 48))


def ltx2_text_config() -> LLMConfig:
    """The Gemma-family caption tower (JAX ``ltx2_model.py:76-82``)."""
    return LLMConfig(vocab_size=256_000, d_model=3840, n_layers=48, n_heads=16, n_kv_heads=8, head_dim=240,
                     d_ff=15360, post_norms=True, gemma_gelu=True, scale_embeddings=True)


@register_model
class LTX2Model(BaseModel):
    arch = "ltx2"
    archs = ["ltx2", "ltx2_3", "ltx2.3", "ltxv", "minimax_h3"]
    is_flow_matching = True
    bucket_divisibility = 32  # the 32x spatial VAE
    max_txt_len = 256

    def __init__(self, config: ModelConfig, device: torch.device | str):
        super().__init__(config, device)
        kw = config.model_kwargs
        self.size = kw.get("size", "full")
        self.joint_audio = bool(kw.get("joint_audio", False))
        self.audio_backend = "waveform"
        if self.size == "tiny":
            self.dit_config, self.vae_config, self.llm_config = WanConfig.tiny(), LTXVideoVAEConfig.tiny(), \
                LLMConfig.tiny()
            self.max_txt_len = 16
        elif self.size == "full":
            self.dit_config, self.vae_config, self.llm_config = ltx2_dit_config(), LTXVideoVAEConfig.ltx2(), \
                ltx2_text_config()
        else:
            raise NotImplementedError(f"ltx2 size '{self.size}': the JAX class builds any size but 'tiny' at full "
                                      f"size; the port takes 'full' or 'tiny' (ROADMAP Queue 1 item 6a)")
        self.av_config = self.audio_vae_config = self.vocoder_config = None
        if self.joint_audio:
            path = str(config.name_or_path or "")
            has_ckpt_audio = os.path.isdir(os.path.join(path, "audio_vae"))
            backend = kw.get("audio_vae")
            if backend is None:
                backend = "mel" if has_ckpt_audio or os.path.isdir(path) else "waveform"
            if backend not in ("mel", "waveform"):
                raise NotImplementedError(f"ltx2 audio_vae '{backend}': the JAX class takes any backend but 'mel' "
                                          f"as 'waveform'; the port takes 'mel' or 'waveform' (ROADMAP Queue 1 "
                                          f"item 6a)")
            if backend != "mel" and has_ckpt_audio:
                print(f"WARNING: ltx2 joint-audio with audio_vae='{backend}' but '{path}/audio_vae' exists: the "
                      f"checkpoint's mel audio VAE will NOT be loaded and audio trains against a seeded waveform "
                      f"VAE. Drop the audio_vae override (or set audio_vae: mel) for reference numerics.")
            self.audio_backend = backend
            tiny = self.size == "tiny"
            self.av_config = LTX2AVConfig.tiny() if tiny else LTX2AVConfig(video=self.dit_config)
            if backend == "mel":
                # packed width (mel / 4) * latent channels == the DiT's audio_in_channels
                self.audio_vae_config = LTXAudioVAEConfig(base_channels=8, ch_mult=(1, 2), num_res_blocks=1,
                                                          latent_channels=2, mel_bins=4) if tiny \
                    else LTXAudioVAEConfig.ltx2()
                self.vocoder_config = VocoderConfig.tiny() if tiny else VocoderConfig.ltx2()
            else:
                self.audio_vae_config = AudioVAEConfig.tiny() if tiny else AudioVAEConfig(latent_channels=128)
        self.quantize_exclude = AV_QUANTIZE_EXCLUDE if self.joint_audio else WAN_QUANTIZE_EXCLUDE
        self.tokenizer = load_tokenizer(config.name_or_path, "tokenizer", vocab_size=self.llm_config.vocab_size,
                                        eos_id=1, max_len=self.max_txt_len)

    # ---- construction ----

    def init_variables(self, generator: torch.Generator, qtype: str | None = None,
                       fill=None) -> dict[str, nn.Module]:
        """Seeded init of ``dit``, ``vae``, ``te`` (and ``audio_vae``,
        ``vocoder`` for a joint model) in that order; ``fill(name, module)``
        loads each right after its init; with ``qtype`` the DiT is then
        quantized, before the rest is built."""
        dev = self.device

        def build(name: str, module: nn.Module) -> nn.Module:
            module = init_parameters(module, generator).eval().requires_grad_(False)
            if fill is not None:
                fill(name, module)
            return module

        dit = LTX2AVDiT(self.av_config, device=dev) if self.joint_audio else WanDiT(self.dit_config, device=dev)
        variables = {"dit": build("dit", dit)}
        if qtype is not None:
            quantize_params(variables["dit"], exclude_patterns=self.quantize_exclude, qtype=qtype)
        variables["vae"] = build("vae", LTXVideoVAE(self.vae_config, device=dev))
        variables["te"] = build("te", LLMEncoder(self.llm_config, device=dev))
        if self.joint_audio:
            if self.audio_backend == "mel":
                variables["audio_vae"] = build("audio_vae", LTXAudioVAE(self.audio_vae_config, device=dev))
                variables["vocoder"] = build("vocoder", LTX2Vocoder(self.vocoder_config, device=dev))
            else:
                variables["audio_vae"] = build("audio_vae", AudioAutoencoderKL(self.audio_vae_config, device=dev))
        return variables

    def load_variables(self, generator: torch.Generator, qtype: str | None = None) -> dict[str, nn.Module]:
        path = self.config.name_or_path
        if not path:
            return self.init_variables(generator, qtype)
        if not (os.path.isdir(os.path.join(path, "transformer")) or os.path.isfile(path)):
            self.refuse_bad_layout("transformer/ [text_encoder/, vae/, audio_vae/, vocoder/] or a single "
                                   ".safetensors file of the LTX-2 video transformer")
        from ai_toolkit_tpu_torch.io.ltx2_layout import ltx2_fill

        return self.init_variables(generator, qtype, fill=ltx2_fill(self, path))

    # ---- conditioning ----

    def encode_prompt(self, variables: dict, prompts: list[str]) -> dict:
        ids = np.stack([self.tokenizer.encode(p) for p in prompts])
        return {"txt": variables["te"](torch.from_numpy(ids).long().to(self.device))}

    def rope_table(self, t: int, h: int, w: int) -> torch.Tensor:
        pt, ph, pw = self.dit_config.patch_size
        ids = torch.from_numpy(wan_position_ids(max(1, t // pt), h // ph, w // pw)).to(self.device)
        return multi_axis_rope(ids, list(self.dit_config.axes_dim))

    def audio_rope_table(self, n_tokens: int) -> torch.Tensor:
        """The 1-D rope over audio latent time, ``[1, n, audio_head_dim/2, 2, 2]``."""
        ids = torch.arange(n_tokens, dtype=torch.int32, device=self.device)[None, :, None]
        return multi_axis_rope(ids, [self.av_config.audio_head_dim])

    # ---- forward ----

    def predict(self, variables: dict, noisy_latents: torch.Tensor, t: torch.Tensor, cond: dict):
        """noisy_latents ``[B, T, h, w, C]``. A joint model with
        ``cond["noisy_audio"]`` ``[B, Na, C_a]`` returns ``(video, audio)``
        predictions; without it the audio stream is one silent token and the
        video prediction alone is returned. Differentiable."""
        b, tt, hh, ww, c = noisy_latents.shape
        patch = self.dit_config.patch_size
        tokens = wan_patchify(noisy_latents, patch)
        dit = variables["dit"]
        if not self.joint_audio:
            return wan_unpatchify(dit(tokens, cond["txt"], t, cond["pe"]), tt, hh, ww, patch, c)
        if "noisy_audio" in cond:
            out_v, out_a = dit(tokens, cond["noisy_audio"], cond["txt"], t, cond["pe"], cond["pe_audio"])
            return wan_unpatchify(out_v, tt, hh, ww, patch, c), out_a
        xa = torch.zeros((b, 1, self.av_config.audio_in_channels), dtype=tokens.dtype, device=tokens.device)
        out_v, _ = dit(tokens, xa, cond["txt"], t, cond["pe"], self.audio_rope_table(1))
        return wan_unpatchify(out_v, tt, hh, ww, patch, c)

    def encode_audio(self, variables: dict, waveform: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """``[B, S, C]`` waveform -> ``[B, Na, audio_in_channels]`` audio tokens."""
        waveform = waveform.to(self.device)
        if self.audio_backend == "mel":
            mc = self.audio_vae_config
            mel = log_mel(waveform, mc.sample_rate, n_mels=mc.mel_bins)
            t = (mel.shape[1] // mc.time_downscale) * mc.time_downscale  # the VAE's time grid
            return pack_audio_latents(variables["audio_vae"].encode(mel[:, :t], generator))
        return variables["audio_vae"].encode(waveform, generator)

    def decode_audio(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        """``[B, Na, audio_in_channels]`` audio tokens -> ``[B, S, C]`` waveform."""
        if self.audio_backend == "mel":
            mc = self.audio_vae_config
            z = unpack_audio_latents(latents, mc.mel_bins // mc.time_downscale)
            return variables["vocoder"](stack_stereo_mel(variables["audio_vae"].decode(z)))
        return variables["audio_vae"].decode(latents)

    def encode_images(self, variables: dict, images: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """Video ``[B, T, H, W, 3]`` (an image is a one-frame video) in [-1, 1] -> latents ``[B, t, h, w, 128]``."""
        if images.dim() == 4:
            images = images[:, None]
        return variables["vae"].encode(images.to(self.device), generator)

    def decode_latents(self, variables: dict, latents: torch.Tensor) -> torch.Tensor:
        return variables["vae"].decode(latents)

    def lora_targets(self) -> list[str]:
        """Every Linear of the blocks, joint or not (JAX ``wan_lora_targets``)."""
        return wan_lora_targets()

    @property
    def jax_scans_blocks(self) -> bool:
        return self.size != "tiny"

    def jax_module_path(self, name: str, scanned: bool = False) -> str:
        return av_lora_key(name, scanned) if self.joint_audio else wan_lora_key(name, scanned)

    def lora_key(self, name: str) -> str:
        """The JAX job's module path: scanned at full size, unrolled at ``tiny``."""
        scanned = self.size != "tiny"
        return av_lora_key(name, scanned) if self.joint_audio else wan_lora_key(name, scanned)

    def lora_module_name(self, key: str) -> str:
        return av_module_name(key) if self.joint_audio else wan_module_name(key)

    # ---- geometry ----

    def latent_shape(self, height: int, width: int, num_frames: int = 1) -> tuple[int, int, int, int]:
        sd, td = self.vae_config.spatial_downscale, self.vae_config.temporal_downscale
        return (max(1, num_frames) - 1) // td + 1, height // sd, width // sd, self.vae_config.latent_channels

    def image_seq_len(self, height: int, width: int) -> int:
        _, h, w, _ = self.latent_shape(height, width)
        _, ph, pw = self.dit_config.patch_size
        return (h // ph) * (w // pw)

    def frame_count_snapper(self, frames: int) -> int:
        """Snap to the VAE's temporal grid: 8k+1 frames (``tiny``: 2k+1)."""
        td = self.vae_config.temporal_downscale
        return max(1, ((frames - 1) // td) * td + 1)
