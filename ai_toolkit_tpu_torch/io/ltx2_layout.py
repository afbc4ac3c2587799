"""The LTX-2 checkpoint directory (JAX ``io/dit_importers.load_ltx2_checkpoint``)
read into the port's modules.

``transformer/`` (or a single DiT file): the diffusers LTX-2 video
transformer's names (``transformer_blocks.{i}.attn1.to_q``, ``proj_in``,
``time_embed.linear``, ``caption_projection.linear_1``) mapped onto the
port's Wan DiT names; the parameter-free cross-attention norm of LTX-2 is
the Wan DiT's affine ``norm2`` at its identity init, which stays. The joint
audio-video DiT raises :data:`JOINT_DIT`: no rule of the JAX importer
covers its audio stream, which JAX leaves at its seeded init while it reads
the video keys (and reads the time projection into a name the joint tree
has not). ``text_encoder/``: the Gemma tower under transformers' names,
with the ``language_model.`` prefixes of a composite save dropped.
``vae/``: ``AutoencoderKLLTX2Video`` with its ``latents_mean`` /
``latents_std`` and the ``config.json`` widths; ``audio_vae/`` (the ``mel``
backend): the mel VAE with its statistics; ``vocoder/``. Every tensor of a
component that is loaded must be found (``io/safetensors_dir.load_module``);
a component whose directory is absent keeps its seeded init.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

from ai_toolkit_tpu_torch.io.safetensors_dir import SafetensorsIndex, squeeze_to
from ai_toolkit_tpu_torch.models.ltx_video_vae import LTXVideoVAEConfig

JOINT_DIT = ("the joint audio-video DiT from a checkpoint's transformer/: no rule maps its audio stream (the JAX "
             "loader reads the video keys and leaves the audio stream at its seeded init, ROADMAP Queue 3); the "
             "port loads strictly and refuses it")

_DIT = [
    (r"transformer_blocks\.(\d+)\.(attn1|attn2)\.(to_q|to_k|to_v|to_out\.0|norm_q|norm_k)\.(weight|bias)",
     "blocks.{0}.{1}.{2}.{3}"),
    (r"transformer_blocks\.(\d+)\.ff\.net\.(0\.proj|2)\.(weight|bias)", "blocks.{0}.ffn.net.{1}.{2}"),
    (r"transformer_blocks\.(\d+)\.scale_shift_table", "blocks.{0}.scale_shift_table"),
    (r"proj_in\.(weight|bias)", "patch_embedding.{0}"),
    (r"time_embed\.emb\.timestep_embedder\.(linear_1|linear_2)\.(weight|bias)",
     "condition_embedder.time_embedder.{0}.{1}"),
    (r"time_embed\.linear\.(weight|bias)", "condition_embedder.time_proj.{0}"),
    (r"caption_projection\.(linear_1|linear_2)\.(weight|bias)", "condition_embedder.text_embedder.{0}.{1}"),
    (r"proj_out\.(weight|bias)", "proj_out.{0}"),
    (r"scale_shift_table", "scale_shift_table"),
]


def ltx2_dit_name(key: str) -> str | None:
    """The port's Wan DiT name of a diffusers LTX-2 transformer key, or None."""
    for pat, tmpl in _DIT:
        m = re.fullmatch(pat, key)
        if m:
            return tmpl.format(*m.groups())
    return None


def _stats(path: str) -> dict:
    """``latents_mean`` / ``latents_std`` of a VAE directory as config tuples."""
    out = {}
    with SafetensorsIndex(path, ()) as index:
        for k in ("latents_mean", "latents_std"):
            if k in index:
                out[k] = tuple(float(v) for v in index.get(k).float().reshape(-1).numpy())
    return out


def ltx2_prepare(model, path: str) -> None:
    """Fit the model's VAE configs to the checkpoint before its modules are
    built: LTX-2's video VAE with the directory's statistics and
    ``config.json`` widths (``latent_channels``, ``block_out_channels``,
    ``patch_size``), the mel VAE's statistics (JAX ``load_ltx_video_vae`` /
    ``load_ltx_audio_vae``)."""
    vae_dir = os.path.join(path, "vae")
    if os.path.isdir(vae_dir):
        kw = _stats(vae_dir)
        cfg_path = os.path.join(vae_dir, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                c = json.load(f)
            kw.update({k: tuple(c[k]) if k == "block_out_channels" else c[k]
                       for k in ("latent_channels", "block_out_channels", "patch_size") if k in c})
        # JAX rebuilds the VAE on LTX-2's own config with these fields replaced
        model.vae_config = dataclasses.replace(LTXVideoVAEConfig.ltx2(), **kw)
    audio_dir = os.path.join(path, "audio_vae")
    if model.audio_backend == "mel" and os.path.isdir(audio_dir):
        model.audio_vae_config = dataclasses.replace(model.audio_vae_config, **_stats(audio_dir))


def ltx2_fill(model, path: str):
    """``fill(name, module)`` for ``LTX2Model.init_variables``: each
    component from its directory of ``path`` (``transformer/`` or ``path``
    itself, a single file, for the DiT)."""
    ltx2_prepare(model, path)
    single = os.path.isfile(path)
    srcs = {"dit": path if single else os.path.join(path, "transformer")}
    if not single:
        srcs.update(te=os.path.join(path, "text_encoder"), vae=os.path.join(path, "vae"),
                    audio_vae=os.path.join(path, "audio_vae"), vocoder=os.path.join(path, "vocoder"))

    def fill(name: str, module) -> None:
        if name not in srcs:
            print(f"ltx2 {name}: {path} is a single DiT file; '{name}' keeps its seeded init")
            return
        if name == "dit":
            if model.joint_audio:
                raise NotImplementedError(JOINT_DIT)
            strip = ("model.diffusion_model.", "transformer.")
            with SafetensorsIndex(srcs[name], strip) as index:
                sources = {n: (lambda t: t, [k]) for k in index.keys() if (n := ltx2_dit_name(k)) is not None}
            model.load_component({name: module}, name, srcs[name], "ltx2 dit", strip=strip, sources=sources,
                                 keep=lambda n: ".norm2." in n, adapt=lambda n, t, target: squeeze_to(t, target.shape))
        elif name == "te":
            model.load_component({name: module}, name, srcs[name], "ltx2 gemma te",
                                 strip=("language_model.model.", "language_model.", "model."))
        elif name != "audio_vae" or model.audio_backend == "mel":
            model.load_component({name: module}, name, srcs[name], f"ltx2 {name}", strip=())
        elif os.path.isdir(srcs[name]):
            print(f"WARNING: ltx2 import skipping the checkpoint's audio_vae/: audio_backend='waveform' "
                  f"substitutes a seeded waveform VAE")

    return fill
