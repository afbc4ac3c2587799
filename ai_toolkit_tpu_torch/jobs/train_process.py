"""The training job (``ai_toolkit_tpu/jobs/train_process.py``
``SDTrainProcess`` in PyTorch), on the paths of the LoRA job and of the full
fine-tune:

model (seeded random weights, or the local checkpoint of ``name_or_path``,
``models/base.py``) -> optional weight-only quantization of the DiT
(``model.quantize``, fp8 or int8: ``adapters/quantize.py``; each expert of a
multistage pair from its own weights, as it is built) -> LoRA on the
model's main component, the DiT or the UNet (the model's targets), one
network shared by a multistage pair's two experts (or LoKr, LoHa, DoRA,
LoRM: below) ->
AdamW(8bit) with the lr schedule (``train/optimizers.lr_schedule``) -> resume
from the newest save in the output folder -> the schedule
(``samplers/factory.get_schedule``: flow matching, or DDPM for the UNets,
under ``train.scheduler_params``) -> folder datasets (one item per file and
resolution) with the latent cache in memory or on disk
(``<save_root>/latent_cache``) and the text-embedding cache -> the
validation batch -> a first sample -> train loop (``train/step.py``) with
the validation, save and sample cadences -> final save of the LoRA (the EMA
copy when EMA is on) in
the PEFT layout for a flow-matching DiT (the ComfyUI one where the model's
``lora_key_layout`` asks for it: Qwen-Image), under the module names the
JAX job writes (the model's ``lora_key``: Wan's and sd3's JAX paths), the
kohya layout (``lora_unet_...``) for the UNet -> a final sample. A video model (Wan, LTX-2)
snaps each dataset's ``num_frames`` to its VAE's frame grid and trains on
5-D latents ``[B, T, h, w, C]``; an audio model (ACE-Step) on waveform
latents ``[B, T, C]`` with the 1-D rope over T; a joint audio-video model
(LTX-2 with ``joint_audio``) encodes each batch's ``audio_waveform`` into
``audio_latents`` with its 1-D rope ``pe_audio``, and each sample is an
animated webp with a ``.wav`` beside it; with a dataset's ``do_i2v`` the first
frame of each clip goes through an i2v arch's vision tower into
``img_cond``. A control arch (flux_kontext, ``model_kwargs.control``, and
qwen_image_edit, which joins them to the image tokens along the sequence)
encodes each batch's ``control_pixels`` through the VAE into
``control_latents`` (omnigen2's references, which a batch without
control images goes without); flex2 assembles its ``[inpaint, mask, control]``
tensor on the host from the clean latents, the batch's ``inpaint_keep``
and the encoded controls, with the job's ``np.random.default_rng(1234)``
drawn in the JAX job's order (JAX ``_prepare_batch``), and that
generator's state rides in ``training_state.safetensors``, so a resume
draws what the uninterrupted run would. A multistage pair with ``switch_boundary_every > 1``
alternates the trained expert every that many steps, high-noise first (the
sampled t squeezed into ``[boundary, 1]``, then ``[0, boundary]``), and each
step logs the expert that ran.

Textual inversion (``embedding:`` with no ``network``, SD 1.x / 2.x only;
JAX ``_build_trainable``'s embedding branch): a ``[vectors, hidden]`` f32
bank, initialised from ``init_words``' token embeddings, is the one
trainable tensor (``variables["emb"]``, at ``train.embedding_lr`` when it is
set); the trigger maps to its virtual ids (``adapters/embedding.py``), the
batches carry raw token ids, so CLIP runs inside the step, the samples use
the bank as it is, and each save is the a1111 file ``{"emb_params": [n,
hidden]}`` in f32 (the EMA copy when EMA is on), ``<name>_<step:09d>`` and
``<name>.safetensors``, without rotation.

Validation (JAX step 9 and the loop's check): with ``validate_every`` the
first batch of dataset 0, unshuffled, is prepared once, and every that many
steps ``train/step.eval_loss`` takes its loss at t and noise drawn from
``validation.seed``; ``val_loss`` is printed and returned.

A full fine-tune (``network`` absent or of type ``full`` / ``fine_tune``,
flow-matching DiTs only) trains the DiT's own parameters in place, those its ``only_if_contains`` /
``ignore_if_contains`` patterns select (:func:`filter_param_names`, JAX
``_filter_param_tree``), and saves them as they are: the trained tensors
(not the EMA) in their own dtype, keyed by the port's parameter names, in
``<name>_<step:09d>.safetensors`` at the save cadence and a final
``<name>.safetensors``, with no rotation (JAX ``_save``'s full fine-tune
branch). The JAX job's HF-layout export of the final save
(``_export_interop``) is not ported (ROADMAP: ``io/full_export.py``).

Resume (JAX ``run``'s step 6): a run whose output folder holds a save goes
on from it. The trainable tensors come from the newest save, and from
``training_state.safetensors`` (``io/checkpoint.py``) the optimizer state,
the EMA, the exact trained tensors and the random generator, so a resumed
run computes what the uninterrupted one would have; the data stream skips
the batches already trained on. A network whose shape changed starts fresh.
The JAX job resumes a LoRA only, from the save's EMA copy in the save
dtype, and restarts its data; the port resumes the full fine-tune too.

Sampling (JAX ``_sample``): the sample prompts through
``generation.generate`` with the EMA copy of the LoRA when EMA is on (a full
fine-tune's trained tensors), written to
``<save_root>/samples/<name>_<step:09d>_<i>.<ext>`` (an animated webp for a
clip): first unless ``skip_first_sample``, every ``sample_every`` steps and
at the end. A sample that fails raises, where the JAX job prints and goes on.

Paired-image guidance (``guidance_loss`` in the train section or the
process, JAX ``run``'s base step): ``polarity`` and the guided kinds
``targeted``, ``targeted_polarity``, ``direct``, ``tnt`` and
``targeted_flow`` (``train/slider.py``) take the place of the diffusion loss
inside the same train step, at the train section's ``network_weight``; each
batch's ``unconditional_pixels`` (the dataset's ``unconditional_path``) go
through the VAE into ``unconditional_latents`` every step, uncached, as in
JAX. ``concept_replacer`` and any other kind raise.

The feature-extractor losses (``diffusion_feature_extractor_path`` /
``_weight``, else ``latent_feature_extractor_path`` /
``latent_feature_loss_weight``; JAX ``run``, :512-550) add
``models/dfe.py``'s aux loss to the step: v7 / v8, the TIPSv2 DPT over the
VAE decode of the prediction, differentiated through the decoder; v1 / v2 at
latent resolution. Its value is logged as ``aux_loss``.

An accuracy-recovery adapter (``model.accuracy_recovery_adapter``, or
``qtype: "<q>|<path>"``; JAX :98-154) is read after the model is built and
before its base is quantized: a LoRA file, or a LyCORIS LoKr one (the file's
first key starts with ``lycoris``), sits frozen in the ``ara`` slot of the
named Linears, and the trainable LoRA stacks with it by rank-concat. The
saves hold the trainable LoRA alone, as JAX's do; the samples run with both.

A custom adapter (``adapter: {type: redux | vision_direct}`` on the flux
DiT; JAX ``_build_trainable``, :911-1064) trains the adapter instead of a
network: each image batch carries its pixels, which go through the
adapter's vision tower (Redux: a seeded CLIP ViT-H, its penultimate hidden
state; ``image_encoder_arch: pixtral``: the pixtral tower from
``image_encoder_path``, or seeded when that is no directory, at
``min(image_size, 512)`` px, normalised) into ``vision_tokens``, cached in
memory by content, and on disk under ``<save_root>/clip_vision_cache`` with
``cache_clip_vision_to_disk``. Redux appends its tokens to the text stream
(the rope table covers them); vision_direct attends to them through the
per-block decoupled K/V (``adapters/ip_adapter.py``). Each save is the
JAX job's adapter file (``adapters/custom_adapter.save_custom_adapter``:
the module, from the EMA copy when EMA is on, and the K/V under the
reference's ``adapter_modules.{i}`` names); a resume restores the exact
state from ``training_state.safetensors``. Samples run without the adapter,
except that a vision_direct sample with a ``ctrl_img`` attends to that
image's tokens (JAX ``_sample``). Three JAX faults are mirrored, each with
a printed line (ROADMAP Queue 3): a ``network`` beside the adapter is not
trained, Redux's ``image_encoder_path`` is not read, and vision_direct's
``train_scaler: false`` is not read (the K/V scales train). A fourth is
not: on a quantized base the JAX job cannot build the K/V (it reads the K
weights from the emptied ``params``); the port reads them dequantized.

The two input-expansion adapters (JAX ``_build_trainable``, :1087-1246)
train beside a LoRA, given as ``network`` or as ``adapter.lora_config``
(without either they raise, as JAX does). ``control_lora`` on ``flux`` /
``flux_schnell`` (``adapters/control_lora.py``): an expansion on ``img_in``
(``ops.layers.Ctrl``) over ``num_control_images`` packed controls, or over
``[masked latents, mask]`` with ``has_inpainting_input``, read back from
``name_or_path`` when that is a file; every batch carries its control
latents, assembled on the host with the job's ``default_rng(4321)`` (the
dropout, the inpaint masks, zeros for a batch without a control, the slots
past a batch's controls left zero), whose state rides in the training state.
``i2v`` on a ``wan21`` t2v base (``adapters/i2v.py``): the image K/V, its
norm and the image MLP grafted onto the loaded DiT and seeded, a seeded
CLIP ViT-H when the base has none, and with ``i2v_do_start_frame`` a frame
embedder on ``patch_embedding`` over each batch's first-frame conditioning;
an image batch's image is its first frame. The LoRA skips the expanded and
grafted Linears (JAX's ignore lists). Each save adds the expansion
(``transformer.x_embedder.weight``, the EMA copy) or the grafted pieces
(``attn_hog.*`` and ``image_embedder.*`` from the EMA copy,
``frame_embedder.*`` as it trains, as JAX writes them) to the LoRA file, f32;
a resume restores them exactly (JAX's resume restarts the i2v pieces from
their init: ROADMAP Queue 3). Samples run with the expansion and the graft
as they train and the LoRA's EMA copy (JAX's drop the graft: Queue 3); an
image batch of an i2v job carries its pixels (JAX's loader gives it none, so
its job raises on images: Queue 3); a control-LoRA sample takes its
``ctrl_img`` as the first control; an i2v job with ``i2v_do_start_frame``
and sample prompts raises (JAX builds no first-frame latents for a sample,
so every one of its samples fails).

IP-Adapter (``adapter: {type: ip_adapter | ip_adapter_plus}``, or
``is_plus``; JAX ``_build_trainable``, :751-817) on ``sd1`` / ``sd15`` /
``sdxl`` and ``flux`` / ``flux_schnell`` (``adapters/ip_adapter.py``): a
seeded CLIP ViT-H (tiny at ``size: tiny``) encodes each image batch's
``clip_pixels`` (the dataset's ``clip_image_path``), else its pixels,
resized bilinear to the tower's size: the pooled, projected embedding for
the base variant, the penultimate patch states for plus, uncached, as in
JAX. The trained projection (``ImageProjModel``, or the ``Resampler`` for
plus and always on flux, at ``num_tokens``: 4, 16 for plus; ``resampler_dim``
``resampler_depth``, ``resampler_heads``) turns them into ``ip_tokens``
inside the step. The UNet's every ``attn2`` site gets its decoupled K/V from
the frozen K / V weights; flux's every double and single block gets its K/V
at the hidden width, drawn uniformly (``init="random"``); ``scale`` sets their
start on flux (on a UNet JAX does not read it and every site starts at 1.0:
mirrored with a printed line). Everything trains in f32. Each save is JAX ``save_ip_adapter``'s file
of the trained tensors (not the EMA copy, as JAX): ``image_proj.*`` and
``ip_adapter.{i}.to_k_ip.weight`` / ``to_v_ip.weight``, on flux through
``flux_ip_flat(fmt="ip")`` (JAX's save finds no K/V there and writes
``image_proj.*`` alone: ROADMAP Queue 3); a resume restores the exact state
from the training state. A flux sample with a ``ctrl_img`` attends to that
image; a UNet one raises (JAX's ``generate_sd`` never reads the adapter
image, so its sample ignores it: Queue 3). A ``network`` beside the adapter
is not trained, with a printed line (the JAX fault; Queue 3).

The T2I adapter: trainable as the ``t2i`` custom adapter on the UNet archs
(``adapters/t2i_adapter.py``; each batch's ``control_pixels``, the dataset's
``control_path``, through the net into ``adapter_residuals`` inside the
step; the save is JAX ``save_custom_adapter``'s file, the EMA copy when EMA
is on, conv weights HWIO), or frozen as the assistant
(``adapter_assist_name_or_path`` in the train or process section; JAX
:218-240): the file, read as JAX ``load_custom_adapter`` reads it, or a
seeded net when the path is no file (as JAX); its residuals of each batch's
``control_pixels`` join the UNet, and the adapter-off prior runs without
them (JAX's ``match_adapter_chance`` at 0; another chance raises). On an
arch without a UNet the assistant raises (JAX skips it silently: Queue 3);
``adapter_assist_type`` is not read by JAX and prints a line when set.

The train-step knobs (``train/step.py``) get their inputs here, as JAX
``_prepare_batch`` builds them: ``prompt_dropout_prob`` (from a host
generator seeded by the job's seed, saved in the training state, where JAX
draws unseeded), ``latent_multiplier``, ``do_blank_stabilization``, the loss
mask (a dataset's ``mask_path``, area-averaged to latent size), the blank,
unconditional and negative prompts' conditioning (``blank_cond``,
``uncond_cond``, ``neg_cond``, with the batch's rope table), ``noise_seed``,
``pixel_values`` for ``train_turbo`` (the VAE decode in the step); in
``_build_data`` ``reg_weight``, ``standardize_images`` and
``img_multiplier``; the optimizer with ``optimizer_params`` and automagic's
``do_paramiter_swapping``; DDPM's learnable SNR state, written to
``learnable_snr.json`` beside every save and read back on a resume without
a matching training state, as JAX does.

Every network JAX ``_build_trainable`` builds (:1247-1297; ``_build_network``):
LoRA, with conv modules when ``network.conv`` is set (``type: locon``), LoKr
(``lokr`` / ``lycoris_lokr``, ``lokr_factor``), LoHa (``loha`` /
``lycoris_loha``), DoRA and LoRM (``network_kwargs``' extract knobs), on the
(dequantized) Linears of a quantized base too. LoKr, LoHa and DoRA adapt
every targeted block Linear where JAX's scanned layout adapts none (ROADMAP
Queue 3). Their saves are the JAX job's files (JAX ``_save``'s lorm and lyco
branches): the EMA copy when EMA is on, fp16, LoKr / LoHa keyed by the JAX
module paths under ``lora_transformer_`` on every arch, DoRA by the LoRA
file's names, LoRM in the PEFT layout with ``network_type: lorm`` (LoHa in
LyCORIS's layout, where JAX writes an empty file). A LoRM run resumes
exactly, as a LoRA run does; a LoKr, LoHa or DoRA one over its saves raises
(JAX cannot resume them). The network fields no JAX module reads
(``dropout``, ``transformer_only``, ``lokr_full_rank``) each print a line.

Every other branch of the JAX process raises ``NotImplementedError`` naming
its ROADMAP item (``_UNPORTED_TRAIN``): the other adapters, an input-expansion adapter
beside a network other than LoRA, a guidance loss, the adapter-off
prior knobs, an accuracy-recovery adapter or a multistage pair beside a
network other than LoRA, quantized text encoders (``quantize_te``),
text-encoder training, per-group learning rates. With ``AIT_PROFILE_DIR``
set, the last step runs under ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.adapters.embedding import (EMBEDDING_KEYS, TriggerTokenizer, init_embedding_bank,
                                                     load_embedding, save_embedding)
from ai_toolkit_tpu_torch.adapters.custom_adapter import init_custom_adapter, refuse_unported_type, save_custom_adapter
from ai_toolkit_tpu_torch.adapters.ip_adapter import (build_flux_ip_collection, build_ip_collection, flux_ip_flat,
                                                     init_ip_proj, ip_adapter_flat)
from ai_toolkit_tpu_torch.adapters.lora import (LoRASpec, attach_ara, build_lora, conv_count, count_lora_params,
                                                share_lora)
from ai_toolkit_tpu_torch.adapters.lorm import LoRMSpec, build_lorm, lorm_stats_str
from ai_toolkit_tpu_torch.adapters.lycoris import BUILD_FNS as LYCORIS_BUILD_FNS
from ai_toolkit_tpu_torch.adapters.quantize import quantized_bytes, quantized_count
from ai_toolkit_tpu_torch.config.modules import (GenerateImageConfig, ModelConfig, NetworkConfig, ProcessConfig,
                                                 TrainConfig, print_unread_network)
from ai_toolkit_tpu_torch.data.caching import TextEmbedCache, cache_latents, cache_latents_to_disk
from ai_toolkit_tpu_torch.data.loader import build_dataloader
from ai_toolkit_tpu_torch.io.checkpoint import CheckpointManager
from ai_toolkit_tpu_torch.io.lora_file import (is_lokr_file, load_lokr_file, load_lora_file, save_adapter_file,
                                               save_lora_file)
from ai_toolkit_tpu_torch.models.base import BaseModel
from ai_toolkit_tpu_torch.models.dfe import make_aux_loss
from ai_toolkit_tpu_torch.models.registry import get_model_class
from ai_toolkit_tpu_torch.samplers.factory import DDPM_NAMES, get_schedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer, lr_schedule
from ai_toolkit_tpu_torch.train.slider import GUIDANCE_KINDS, make_guidance_loss
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import LearnableSNR, TrainStepConfig, eval_loss, make_train_step
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

# TrainConfig knobs read by the JAX process (not its step) that this path does
# not take, each with where it comes (ROADMAP Queue 1)
_UNPORTED_TRAIN = {
    "train_text_encoder": "text-encoder training comes with ROADMAP Queue 1 item 3",
    "text_encoder_lr": "text-encoder training comes with ROADMAP Queue 1 item 3",
    "refiner_lr": "the SDXL refiner comes with ROADMAP Queue 1 item 3",
    "free_u": "FreeU comes with ROADMAP Queue 1 item 3",
    "unet_lr": "per-group learning rates (JAX's multi_transform) come with ROADMAP Queue 1 item 5",
    "adapter_lr": "per-group learning rates (JAX's multi_transform) come with ROADMAP Queue 1 item 5",
    "prompt_saturation_chance": "comes with ROADMAP Queue 1 item 5",
    "short_and_long_captions": "comes with ROADMAP Queue 1 item 5",
    "short_and_long_captions_encoder_split": "comes with ROADMAP Queue 1 item 5",
    "merge_network_on_save": "comes with ROADMAP Queue 1 item 5",
    "show_turbo_outputs": "the turbo step's debug images come with ROADMAP Queue 1 item 5",
}
# network.type -> the network the JAX job builds for it (_build_trainable, :1247-1297; NetworkConfig
# turns locon into lora with a conv rank)
NETWORK_KINDS = {"lora": "lora", "lokr": "lokr", "lycoris_lokr": "lokr", "loha": "loha", "lycoris_loha": "loha",
                 "dora": "dora", "lorm": "lorm"}
# train-step knobs that run the network off (JAX drops the 'lora' collection alone for them)
_ADAPTER_OFF_KNOBS = ("diff_output_preservation", "inverted_mask_prior", "blank_prompt_preservation")
_UNPORTED_MODEL = ("quantize_te", "lora_path", "assistant_lora_path",
                   "inference_lora_path", "unconditional_lora_path")
# the adapter keys the ported custom adapter types read; the JAX job reads no other for them
_ADAPTER_KEYS = ("type", "image_encoder_path", "image_encoder_arch", "cache_clip_vision_to_disk",
                 "flux_only_double", "train_scaler", "scale")
# the input-expansion adapters, trained beside a LoRA: the keys the JAX job reads for each, and the archs
EXPANSION_KEYS = {
    "control_lora": ("type", "num_control_images", "has_inpainting_input", "control_image_dropout",
                     "invert_inpaint_mask_chance", "lora_config", "name_or_path"),
    "i2v": ("type", "i2v_do_start_frame", "lora_config"),
}
EXPANSION_ARCHS = {"control_lora": ("flux", "flux_schnell"), "i2v": ("wan21",)}
# IP-Adapter: the keys the JAX job reads (:751-817) and the archs; the UNet archs (t2i, the assistant)
IP_TYPES = ("ip_adapter", "ip_adapter_plus")
IP_KEYS = ("type", "is_plus", "num_tokens", "resampler_dim", "resampler_depth", "resampler_heads", "scale")
IP_ARCHS = ("sd1", "sd15", "sdxl", "flux", "flux_schnell")
UNET_ARCHS = ("sd1", "sd15", "sd2", "ssd", "vega", "sdxl")
# t2i reads its downscale (num_tokens is read by JAX init_custom_adapter for every type, to no effect on t2i)
T2I_KEYS = ("type", "downscale", "num_tokens")
SD_IP_SAMPLE = ("a ctrl_img in a sample of an IP-Adapter job on a UNet arch: the JAX generate_sd never reads the "
                "encoded adapter image and SDModel.predict applies no ip_proj, so its sample ignores the image "
                "(ROADMAP Queue 3); drop the ctrl_img (a sample without one runs without the adapter, as in JAX)")
# what the LoRA skips beside each (JAX :1237-1246, in the port's module names)
EXPANSION_IGNORE = {"control_lora": ["img_in"],
                    "i2v": ["patch_embedding", "add_k_proj", "add_v_proj", "image_embedder"]}
# the host generators whose state rides in the training state (flex2's and control_lora's control draws,
# prompt_dropout_prob's), so a resume draws what the uninterrupted run would
HOST_RNGS = ("flex2_rng", "cl_rng", "dropout_rng")
I2V_START_FRAME_SAMPLE = ("i2v_do_start_frame with sample prompts: the JAX job's samples build no first-frame "
                          "control latents, so its frame embedder fails on every sample (ROADMAP Queue 3); set "
                          "train.disable_sampling or drop the start frame")


def _norm_pattern(p: str) -> str:
    p = p.strip().strip(".")
    if p.startswith("transformer."):
        p = p[len("transformer."):]
    return p.replace(".", "/")


def _pattern_variants(p: str) -> set[str]:
    """The reference's diffusers block-list names mapped onto the module names."""
    return {p, p.replace("single_transformer_blocks", "single_blocks"),
            p.replace("transformer_blocks", "double_blocks"), p.replace("transformer_blocks", "blocks")}


def filter_param_names(names, include: list[str] | None, exclude: list[str] | None) -> list[str]:
    """The parameter names that contain an ``include`` pattern (when any is
    given) and no ``exclude`` pattern, JAX ``_filter_param_tree`` over the
    port's names: patterns and names are compared '/'-joined, a leading
    ``transformer.`` is dropped, and reference configs' ``transformer_blocks``
    / ``single_transformer_blocks`` also match the block lists."""
    inc = [v for p in include or [] for v in _pattern_variants(_norm_pattern(p))]
    exc = [v for p in exclude or [] for v in _pattern_variants(_norm_pattern(p))]
    keep = []
    for name in names:
        path = name.replace(".", "/")
        if (not inc or any(p in path for p in inc)) and not any(p in path for p in exc):
            keep.append(name)
    return keep


def select_trainable(module: torch.nn.Module, include: list[str] | None,
                     exclude: list[str] | None) -> dict[str, torch.nn.Parameter]:
    """The full fine-tune's trainable parameters of ``module`` by name; they,
    and only they, get ``requires_grad``."""
    params = dict(module.named_parameters())
    names = set(filter_param_names(params, include, exclude))
    for name, p in params.items():
        p.requires_grad_(name in names)
    return {name: p for name, p in params.items() if name in names}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiler(out_dir: str | None, device: torch.device):
    """``torch.profiler`` over the block when ``out_dir`` is given (the last
    step of a run with ``AIT_PROFILE_DIR`` set, as the JAX process traces with
    it): writes ``train_step_profile.txt`` there, the ops by device time."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    sort = "device_time_total" if device.type == "cuda" else "cpu_time_total"
    with open(os.path.join(out_dir, "train_step_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=80))


class SDTrainProcess:
    """Process types ``sd_trainer`` / ``diffusion_trainer`` / ``ui_trainer`` /
    ``textual_inversion_trainer``."""

    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        if self.expansion and cfg.network is None and cfg.adapter.get("lora_config"):
            # the reference's layout nests the network under adapter.lora_config (JAX :741-749)
            cfg.network = NetworkConfig.from_dict(dict(cfg.adapter["lora_config"]))
        self.device = torch.device(device)
        self.save_root = os.path.join(cfg.training_folder, job_name)
        self.adapter = None  # the custom adapter's runtime (adapters/custom_adapter.py), when the job trains one
        self.ip = {}  # vision_direct's or IP-Adapter's decoupled K/V per site
        self.ip_mode = False  # an IP-Adapter job (_build_ip)
        self.assistant = None  # the frozen T2I assistant (_build_assistant)
        self.net_modules = {}  # the trained network's {module name: overlay} (_build_network)

    @property
    def textual_inversion(self) -> bool:
        return bool(self.cfg.embedding)

    @property
    def guidance_kind(self) -> str | None:
        """``guidance_loss`` of the train section, else of the process (JAX ``run``)."""
        return self.cfg.train.extras.get("guidance_loss") or self.cfg.extras.get("guidance_loss")

    @property
    def full_finetune(self) -> bool:
        if self.textual_inversion or self.cfg.adapter:
            return False
        return self.cfg.network is None or self.cfg.network.type in ("full", "fine_tune")

    @property
    def assist_path(self) -> str | None:
        """The assistant adapter's path, from the train section or the process (JAX :221-224)."""
        return self.cfg.train.adapter_assist_name_or_path or self.cfg.extras.get("adapter_assist_name_or_path")

    @property
    def expansion(self) -> str | None:
        """``control_lora`` or ``i2v``: an input-expansion adapter trained beside the network."""
        t = (self.cfg.adapter or {}).get("type")
        return t if t in EXPANSION_KEYS else None

    @property
    def network_kind(self) -> str | None:
        """The network the job trains: ``lora`` (``locon`` included), ``lokr``,
        ``loha``, ``dora`` or ``lorm``; None for a full fine-tune, a custom
        adapter or textual inversion."""
        if self.full_finetune or self.textual_inversion or (self.cfg.adapter and not self.expansion):
            return None
        return None if self.cfg.network is None else NETWORK_KINDS.get(self.cfg.network.type)

    @property
    def feature_loss_path(self):
        """The DFE path and weight (JAX ``run``: the diffusion extractor's, else the latent one's)."""
        tc = self.cfg.train
        if tc.diffusion_feature_extractor_path:
            return tc.diffusion_feature_extractor_path, float(tc.diffusion_feature_extractor_weight)
        if tc.latent_feature_extractor_path:
            return tc.latent_feature_extractor_path, float(tc.latent_feature_loss_weight)
        return None, 0.0

    def _refuse_unported(self) -> None:
        cfg, tc = self.cfg, self.cfg.train
        if cfg.slider:
            raise NotImplementedError("a slider section in an sd_trainer process: the slider jobs (type slider / "
                                      "ultimate_slider) train sliders")
        ara = cfg.model.accuracy_recovery_adapter
        if ara and cfg.network is not None and cfg.network.type == "lokr" and is_lokr_file(ara):
            raise ValueError("lokr-format ARA cannot be combined with a trainable lokr network (one lokr collection)")
        if cfg.adapter:
            self._refuse_adapter()
        elif self.textual_inversion:
            from ai_toolkit_tpu_torch.models.sd_model import SDModel

            if get_model_class(cfg.model.arch) is not SDModel:
                raise NotImplementedError(f"textual inversion (embedding) on arch '{cfg.model.arch}' comes with a "
                                          f"later slice (ported: {SDModel.archs})")
            if cfg.network is not None:
                raise NotImplementedError("embedding together with a network: the JAX job trains the bank alone "
                                          "and drops the network; give one of them")
            unknown = sorted(set(cfg.embedding) - set(EMBEDDING_KEYS))
            if unknown:
                raise NotImplementedError(f"embedding keys {unknown} are not read (read: {list(EMBEDDING_KEYS)})")
        elif not self.full_finetune and self.network_kind is None:
            raise NotImplementedError(f"network '{cfg.network.type}': only LoRA, LoCon, LoKr, LoHa, DoRA, LoRM and the "
                                      f"full fine-tune are ported (the types the JAX job builds; it trains another "
                                      f"type as a plain LoRA)")
        other_net = self.network_kind not in (None, "lora")
        if ara and other_net:
            raise NotImplementedError(f"network '{cfg.network.type}' beside an accuracy-recovery adapter is not ported "
                                      f"(ported: beside a LoRA; ROADMAP Queue 1 item 6e)")
        if other_net:
            off = [k for k in _ADAPTER_OFF_KNOBS if getattr(tc, k)]
            if off:
                raise NotImplementedError(f"{off} with network '{cfg.network.type}': the adapter-off prediction of a "
                                          f"network other than LoRA comes with ROADMAP Queue 1 item 6e (the JAX step "
                                          f"drops the 'lora' collection alone, so its prior keeps this network)")
        if ara and (self.full_finetune or self.guidance_kind or self.textual_inversion):
            raise NotImplementedError("an accuracy-recovery adapter with a full fine-tune, a guidance loss or "
                                      "textual inversion is not ported (ported: beside a trainable LoRA or adapter)")
        if self.full_finetune and cfg.model.quantize:
            raise NotImplementedError(
                "model.quantize with a full fine-tune comes with slice G (the JAX job trains only the "
                "weights that quantization leaves unquantized)")
        refuse_unported(tc, _UNPORTED_TRAIN, TrainConfig(), "train")
        if tc.train_turbo and any(d.cache_latents or d.cache_latents_to_disk for d in cfg.datasets):
            raise ValueError("train_turbo decodes to pixels in-graph — set cache_latents: false on every dataset "
                             "so batches carry raw images")
        if self.assist_path and cfg.model.arch not in UNET_ARCHS:
            raise NotImplementedError(f"adapter_assist_name_or_path on arch '{cfg.model.arch}': the assistant is a "
                                      f"T2I adapter on the UNet (ported: {', '.join(UNET_ARCHS)}); the JAX job skips "
                                      f"it silently on an arch without one (ROADMAP Queue 3)")
        if self.assist_path and tc.match_adapter_chance:
            raise NotImplementedError("match_adapter_chance > 0 (the prior keeping the assistant's residuals on a "
                                      "draw) comes with ROADMAP Queue 1 item 6e; at 0 the prior runs without them")
        kind = self.guidance_kind
        if kind and other_net:
            raise NotImplementedError(f"guidance_loss '{kind}' on network '{cfg.network.type}': the guidance losses "
                                      f"scale a LoRA (the JAX step's 'lora' tree); on other networks they come with "
                                      f"ROADMAP Queue 1 item 6e")
        if kind == "concept_replacer":
            raise NotImplementedError("guidance_loss 'concept_replacer' needs the replacement prompts that only the "
                                      "concept_replacer job builds (ROADMAP Queue 1 item 6h)")
        if kind and kind not in GUIDANCE_KINDS:
            raise NotImplementedError(f"guidance_loss '{kind}' is no guidance kind of the JAX package "
                                      f"(ported: {list(GUIDANCE_KINDS)})")
        if kind and (self.textual_inversion or self.full_finetune or cfg.adapter):
            raise NotImplementedError(f"guidance_loss '{kind}' trains a LoRA network (the JAX step scales the "
                                      f"'lora' tree); give a network of type lora")
        if kind and self.feature_loss_path[0]:
            key = ("diffusion_feature_extractor_path" if tc.diffusion_feature_extractor_path
                   else "latent_feature_extractor_path")
            raise NotImplementedError(f"guidance_loss '{kind}' with {key}: the JAX guidance step takes no aux loss "
                                      f"(its job drops the feature-extractor loss)")
        refuse_unported(cfg.model, _UNPORTED_MODEL, ModelConfig(), "model")
        if cfg.model.quantize_kwargs:
            raise NotImplementedError("model.quantize_kwargs come with slice G")
        if not tc.train_unet:
            raise NotImplementedError("train_unet: false trains nothing the port has")
        model_cls = get_model_class(cfg.model.arch)
        if ara and model_cls.load_variables is not BaseModel.load_variables:
            raise NotImplementedError(f"an accuracy-recovery adapter on arch '{cfg.model.arch}', whose experts are "
                                      f"quantized as they are built (ported: the single-DiT archs)")
        atype = (cfg.adapter or {}).get("type")
        archs = EXPANSION_ARCHS.get(atype) or (IP_ARCHS if atype in IP_TYPES else UNET_ARCHS if atype == "t2i"
                                               else ("flux", "flux_schnell"))
        if cfg.adapter and cfg.model.arch not in archs:
            raise NotImplementedError(f"adapter '{cfg.adapter.get('type')}' on arch '{cfg.model.arch}' (ported: "
                                      f"{', '.join(archs)}; the others: ROADMAP Queue 1 item 6e)")
        flow = model_cls.is_flow_matching
        if getattr(model_cls, "is_audio", False) and not tc.disable_sampling and cfg.sample.prompts:
            from ai_toolkit_tpu_torch.generation import GENERATE_AUDIO

            raise NotImplementedError(f"sample prompts on arch '{cfg.model.arch}': {GENERATE_AUDIO}")
        scheduler = (tc.noise_scheduler or "flowmatch").lower()
        if scheduler not in (("flowmatch", "flowmatch_euler") if flow else DDPM_NAMES):
            raise NotImplementedError(f"noise_scheduler '{tc.noise_scheduler}' for arch "
                                      f"'{cfg.model.arch}' (ported: flowmatch for the DiTs, ddpm for the UNets)")
        if not flow and (self.full_finetune or cfg.model.quantize):
            raise NotImplementedError("the UNet's full fine-tune and quantized base come with a later slice")
        lr_schedule(tc.lr_scheduler, tc.lr, tc.steps, tc.lr_scheduler_params)  # raises for an unported one
        self._schedule()  # raises for a scheduler_params field the schedule has not
        if cfg.save.push_to_hub:
            raise NotImplementedError("push_to_hub is not ported")
        sizes = [n for n in cfg.mesh.axes.values() if n not in (1, -1)]
        if cfg.mesh.axes.get("sp", 1) not in (1, -1) and cfg.model.arch.startswith("wan"):
            from ai_toolkit_tpu_torch.models.wan_model import SEQUENCE_PARALLEL

            raise NotImplementedError(f"mesh {cfg.mesh.axes}: {SEQUENCE_PARALLEL}")
        if sizes:
            raise NotImplementedError(f"mesh {cfg.mesh.axes}: multi-GPU comes with a later slice")
        if not cfg.datasets:
            raise ValueError("no datasets configured")

    def _refuse_adapter(self) -> None:
        """What the port takes of an adapter: redux and vision_direct, and the
        input-expansion adapters beside a LoRA, without textual inversion,
        with the keys the JAX job reads for them."""
        cfg, acfg = self.cfg, self.cfg.adapter
        atype = self.expansion
        ip = acfg.get("type") in IP_TYPES
        if atype is None and not ip:
            refuse_unported_type(acfg.get("type"))
        read = (EXPANSION_KEYS[atype] if atype else IP_KEYS if ip else T2I_KEYS if acfg.get("type") == "t2i"
                else _ADAPTER_KEYS)
        unknown = sorted(set(acfg) - set(read))
        if unknown:
            raise NotImplementedError(f"adapter keys {unknown} are not read for '{acfg['type']}' "
                                      f"(read: {list(read)})")
        if self.textual_inversion:
            raise NotImplementedError("an adapter together with embedding: the JAX job trains the adapter alone")
        if atype:
            if cfg.network is None:
                raise ValueError(f"{atype} requires network: {{type: lora, ...}} (or adapter.lora_config, the "
                                 f"reference's layout)")
            if self.network_kind != "lora":
                raise NotImplementedError(f"adapter '{atype}' beside network '{cfg.network.type}' comes with ROADMAP "
                                          f"Queue 1 item 6e (ported: beside a LoRA)")
            if atype == "i2v" and acfg.get("i2v_do_start_frame") and not cfg.train.disable_sampling \
                    and cfg.sample.prompts:
                raise NotImplementedError(I2V_START_FRAME_SAMPLE)
            if atype == "control_lora" and acfg.get("has_inpainting_input") \
                    and int(acfg.get("num_control_images", 1)) != 1:
                raise ValueError("control_lora: has_inpainting_input requires num_control_images=1 (the inpaint "
                                 "latent is the control)")
        arch = acfg.get("image_encoder_arch")
        if arch not in (None, "clip", "pixtral"):
            raise NotImplementedError(f"image_encoder_arch '{arch}' (ported: the CLIP ViT-H, pixtral)")
        if ip and cfg.model.arch in UNET_ARCHS and not cfg.train.disable_sampling \
                and any(getattr(item, "ctrl_img", None) for item in cfg.sample.prompts):
            raise NotImplementedError(SD_IP_SAMPLE)

    def _refuse_control_options(self, model) -> None:
        """Control images only for an arch that takes control latents or the
        control-LoRA adapter (or a T2I adapter, trained or the assistant), the
        inpaint folder only for flex2 or the control-LoRA adapter's
        inpainting input."""
        arch = self.cfg.model.arch
        control_lora = self.expansion == "control_lora"
        t2i = (self.cfg.adapter or {}).get("type") == "t2i" or bool(self.assist_path)
        inpaint = control_lora and bool(self.cfg.adapter.get("has_inpainting_input"))
        for d in self.cfg.datasets:
            if d.control_path and not (model.takes_control or control_lora or t2i):
                raise NotImplementedError(
                    f"dataset {d.folder_path}: control_path on arch '{arch}', which takes no control latents "
                    f"(ported: flex2, flux_kontext, model_kwargs.control, qwen_image_edit, omnigen2, and the "
                    f"control_lora, t2i and assistant adapters)")
            if d.inpaint_path and not (arch == "flex2" or inpaint):
                raise NotImplementedError(f"dataset {d.folder_path}: inpaint_path feeds flex2's inpaint channels "
                                          f"or the control-LoRA adapter's has_inpainting_input; arch '{arch}' "
                                          f"takes none")

    def run(self) -> dict:
        cfg, tc, dev = self.cfg, self.cfg.train, self.device
        self._refuse_unported()
        seed = self._seed = tc.seed if tc.seed is not None else int(os.environ.get("SEED", 42))
        # the JAX job's layouts: PEFT for flow-matching DiTs, kohya for the UNet
        flow = get_model_class(cfg.model.arch).is_flow_matching
        ckpt = CheckpointManager(self.save_root, self.job_name,
                                 max_step_saves_to_keep=cfg.save.max_step_saves_to_keep,
                                 dtype=np.float16 if cfg.save.dtype in ("float16", "fp16") else np.float32,
                                 fmt="peft" if flow else "kohya")

        # 1. model (1b. quantized DiT), 2. LoRA on the DiT / UNet or the full fine-tune's selection
        model = get_model_class(cfg.model.arch)(cfg.model, dev)
        if self.full_finetune and len(model.experts) > 1:
            raise NotImplementedError("the full fine-tune of a multistage pair comes with a later slice")
        ckpt.key_map = getattr(model, "lora_key", None)
        if hasattr(model, "lora_key_layout"):  # the JAX job's per-arch layout (Qwen-Image: comfy)
            ckpt.fmt = model.lora_key_layout()
        self._refuse_control_options(model)
        t0 = time.perf_counter()
        ara = cfg.model.accuracy_recovery_adapter
        qtype = cfg.model.qtype if cfg.model.quantize else None
        variables = model.load_variables(torch.Generator(device=dev).manual_seed(seed),
                                         qtype=None if ara else qtype)
        if ara:  # read before the base is quantized (JAX run, steps 1 and 1b)
            self._load_ara(model, variables, ara)
            if qtype:
                model.quantize(variables, qtype)
        _sync(dev)
        load_s = time.perf_counter() - t0
        print(f"model: {'loaded ' + cfg.model.name_or_path if cfg.model.name_or_path else 'seeded init'} "
              f"in {load_s:.2f} s")
        net = variables[model.main_component]
        experts = [variables[name] for name in model.experts]
        if cfg.model.quantize:
            print(f"quantized base: {sum(quantized_count(m) for m in experts)} weights, "
                  f"{sum(quantized_bytes(m) for m in experts) / 1e9:.2f} GB ({cfg.model.qtype})")
        if self.assist_path:
            self._build_assistant(model, seed)
        if (cfg.adapter or {}).get("type") in IP_TYPES:
            trainable, lora = self._build_ip(model, variables, seed), None
            n_params = sum(p.numel() for p in trainable.values())
        elif cfg.adapter and not self.expansion:
            trainable, lora = self._build_adapter(model, variables, seed), None
            n_params = sum(p.numel() for p in trainable.values())
        elif self.textual_inversion:
            trainable, lora = self._build_embedding(model, variables), None
            n_params = trainable["emb"].numel()
        elif self.full_finetune:
            ncfg = cfg.network
            inc = cfg.model.only_if_contains or (ncfg.only_if_contains if ncfg else None)
            exc = cfg.model.ignore_if_contains or (ncfg.ignore_if_contains if ncfg else None)
            trainable, lora = select_trainable(net, inc, exc), None
            n_params = sum(p.numel() for p in trainable.values())
            if inc or exc:
                print(f"full fine-tune (filtered to {n_params:,} params)")
        else:
            expansion = self._build_expansion(model, variables, seed) if self.expansion else {}
            trainable, lora = self._build_network(model, net, experts, seed)
            trainable.update(expansion)
            n_params = sum(p.numel() for p in trainable.values())
        for m in experts:
            if hasattr(m, "gradient_checkpointing"):  # the DiT; the UNet follows model.remat_policy
                m.gradient_checkpointing = tc.gradient_checkpointing

        # 3. optimizer + state, the generator of t and the noise; resume
        # the bank alone trains at embedding_lr when it is set (the JAX job's "emb" optimizer group)
        base_lr = tc.embedding_lr if self.textual_inversion and tc.embedding_lr else tc.lr
        opt_params = dict(tc.optimizer_params or {})
        if tc.do_paramiter_swapping and tc.optimizer.startswith("automagic"):
            opt_params.setdefault("paramiter_swapping", tc.paramiter_swapping_factor)
        tx = get_optimizer(tc.optimizer, list(trainable.values()),
                           lr_schedule(tc.lr_scheduler, base_lr, tc.steps, tc.lr_scheduler_params),
                           opt_params, tc.max_grad_norm)
        state = TrainState(trainable, tx, use_ema=tc.ema_config.use_ema)
        if tc.learnable_snr_gos:  # its own scalars and AdamW beside the trainable tensors (DDPM only, as in JAX)
            if flow:
                print("learnable_snr_gos: a flow-matching schedule has no SNR; the JAX job builds no learnable "
                      "SNR state for it and neither does the port")
            else:
                state.lsnr = LearnableSNR(dev)
        generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self.model, self.variables, self.state, self.lora = model, variables, state, lora  # introspection
        start_step = self._resume(ckpt, model, state, lora, generator)

        # 4. data, 5. step
        loader, text_cache = self._build_data(model, variables)
        step_cfg = TrainStepConfig.from_train_config(tc)
        if getattr(model, "multistage", False) and tc.switch_boundary_every > 1:
            step_cfg = dataclasses.replace(step_cfg, stage_boundary=model.stage_boundary,
                                           switch_every=tc.switch_boundary_every)
        predict = getattr(model, "predict_train", model.predict)  # as the JAX job picks it
        decode_fn = (lambda lat: model.decode_latents(variables, lat)) if tc.train_turbo else None
        adapter = self.adapter

        def predict_fn(noisy, t, cond):
            if adapter is not None:  # inside the differentiated step, as JAX's wrapped predict_fn
                cond = adapter.apply_cond(cond)
            return predict(variables, noisy, t, cond)

        schedule = self._schedule()
        aux_loss_fn = None
        path, weight = self.feature_loss_path
        if path:
            aux_loss_fn, line = make_aux_loss(path, weight, model, variables, schedule, dev,
                                              torch.Generator(device=dev).manual_seed(seed + 7))
            print(line)
        guidance = None
        if self.guidance_kind:
            if step_cfg.switch_every:
                raise NotImplementedError(f"guidance_loss '{self.guidance_kind}' on a switched multistage pair: "
                                          f"the JAX guidance step draws t over the whole range")
            weight = float(tc.extras.get("network_weight", 1.0))
            guidance = make_guidance_loss(self.guidance_kind, predict_fn, schedule, step_cfg.timestep_type, weight)
            print(f"guidance loss: {self.guidance_kind} (network_weight {weight})")
        train_step = make_train_step(predict_fn, schedule, step_cfg, micro_loss=guidance, aux_loss_fn=aux_loss_fn,
                                     decode_fn=decode_fn)
        val_batch = None
        if cfg.validation.validate_every > 0:  # JAX step 9: the first batch of dataset 0, unshuffled
            ds0 = loader.datasets[0]
            val_batch = self._prepare_batch(model, variables, loader._load_batch(
                ds0, ds0.build_batches(tc.batch_size, shuffle=False)[0]), text_cache)
        val_losses: list[tuple[int, float]] = []

        # 6. first sample, the loop, final save and sample
        sampling = not tc.disable_sampling and bool(cfg.sample.prompts)
        self.samples: list[dict] = []
        if sampling and not tc.skip_first_sample:
            self._sample(model, variables, state, lora, start_step)
        data_iter = loader.iter_from(start_step * step_cfg.grad_accum)
        losses: list[float] = []
        aux_losses: list[float] = []  # the feature-extractor loss of each step
        grad_norms: list[float] = []
        step_ms: list[float] = []
        experts_run: list[str] = []  # a multistage pair's expert at each step
        buckets: list[tuple[int, int]] = []  # the (w, h) pixel bucket of each step
        profile_dir = os.environ.get("AIT_PROFILE_DIR")
        for step in range(start_step, tc.steps):
            raws = [next(data_iter) for _ in range(step_cfg.grad_accum)]
            buckets.append(tuple(raws[0]["bucket"]))
            batches = [self._prepare_batch(model, variables, raw, text_cache) for raw in raws]
            _sync(dev)
            profile = profile_dir is not None and step == tc.steps - 1
            t0 = time.perf_counter()
            with _profiler(profile_dir if profile else None, dev):
                metrics = train_step(state, batches, generator)
                loss = float(metrics["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if len(experts) > 1:
                experts_run.append(model.last_expert)
            if "aux_loss" in metrics:
                aux_losses.append(float(metrics["aux_loss"]))
            if tc.max_loss_debug and float(metrics.get("max_loss_skipped", 0.0)) > 0:
                print(f"max_loss: step {step + 1} batch exceeded {tc.max_loss} — update zeroed")
            if (step + 1) % cfg.logging.log_every == 0 or step == start_step:
                expert = f" expert={model.last_expert}" if len(experts) > 1 else ""
                aux = f" aux_loss={aux_losses[-1]:.4f}" if "aux_loss" in metrics else ""
                print(f"step {step + 1}/{tc.steps} loss={loss:.4f}{aux} "
                      f"grad_norm={float(metrics['grad_norm']):.4f}{expert} ({step_ms[-1]:.1f} ms)")
            if val_batch is not None and (step + 1) % cfg.validation.validate_every == 0:
                val = float(eval_loss(predict_fn, schedule, step_cfg, val_batch,
                                      torch.Generator(device=dev).manual_seed(cfg.validation.seed)))
                val_losses.append((step + 1, val))
                print(f"  val_loss={val:.4f}")
            if cfg.save.save_every and (step + 1) % cfg.save.save_every == 0 and step + 1 < tc.steps:
                print(f"saved: {self._save(ckpt, state, lora, generator, step + 1)}")
            if sampling and cfg.sample.sample_every and (step + 1) % cfg.sample.sample_every == 0 \
                    and step + 1 < tc.steps:
                self._sample(model, variables, state, lora, step + 1)
        path = self._save(ckpt, state, lora, generator, tc.steps, final=True)
        print(f"saved: {path}")
        if sampling:
            self._sample(model, variables, state, lora, tc.steps)
        return {"final_loss": losses[-1] if losses else None, "steps": tc.steps, "start_step": start_step,
                "losses": losses, "aux_losses": aux_losses, "grad_norms": grad_norms, "step_ms": step_ms,
                "median_step_ms": statistics.median(step_ms) if step_ms else None,
                "trainable_params": n_params, "lora_modules": len(self.net_modules), "ip_sites": len(self.ip),
                "experts": experts_run, "buckets": buckets, "save_path": path, "load_s": load_s,
                "val_losses": val_losses,
                "latent_cache": self.latent_cache_report, "samples": self.samples}

    def _build_network(self, model, net, experts: list, seed: int) -> tuple[dict[str, torch.Tensor], dict | None]:
        """The trainable network on the main component (JAX
        ``_build_trainable``'s network branches, :1247-1297): LoRA (with
        conv modules when ``network.conv`` is set: LoCon), LoKr, LoHa and DoRA
        over the model's targets (``adapters/lora.py``,
        ``adapters/lycoris.py``), or LoRM's factors in place of the targeted
        kernels (``adapters/lorm.py``). Returns the trainable tensors
        ``{<module>.<leaf>: parameter}`` and the LoRA ``{module: LoRA}`` (None
        for the other networks, whose modules are ``self.net_modules``)."""
        ncfg, kind = self.cfg.network, self.network_kind
        print_unread_network(ncfg)
        if kind != "lora" and len(experts) > 1:
            raise NotImplementedError(f"network '{ncfg.type}' on a multistage pair (one network on both experts) "
                                      f"comes with ROADMAP Queue 1 item 6e (ported: LoRA)")
        spec = LoRASpec.from_network_config(ncfg, target_patterns=model.lora_targets())
        if self.expansion:  # the expanded and grafted Linears take no network (JAX's ignore lists)
            spec.ignore_if_contains = list(spec.ignore_if_contains or []) + EXPANSION_IGNORE[self.expansion]
        generator = torch.Generator(device=self.device).manual_seed(seed)
        lora = None
        if kind == "lorm":
            modules, stats = build_lorm(net, LoRMSpec.from_network_config(ncfg, spec.target_patterns),
                                        scanned=model.jax_scans_blocks)
            if not stats["modules"]:
                raise ValueError("lorm: no kernels matched the target patterns")
            print(lorm_stats_str(stats))
        elif kind == "lora":
            modules = lora = build_lora(net, spec, generator)
            for other in experts[1:]:
                share_lora(other, lora)
            print(f"LoRA: {len(lora)} modules, {count_lora_params(lora):,} trainable params (rank {spec.rank})")
            if spec.conv_rank:
                n_conv = conv_count(lora)
                print(f"LoCon: {n_conv} conv modules at rank {spec.conv_rank}"
                      + ("" if n_conv else " (JAX fault mirrored: the model's target patterns name no conv; "
                                          "only_if_contains reaches them; ROADMAP Queue 3)"))
        else:
            if model.jax_scans_blocks:
                print(f"JAX fault not mirrored: JAX build_{kind} takes 2-D kernels only, so on this model's scanned "
                      f"blocks it adapts none; the port adapts every targeted block Linear, as JAX does unrolled "
                      f"(ROADMAP Queue 3)")
            build = LYCORIS_BUILD_FNS[kind]
            modules = (build(net, spec, generator, factor=ncfg.lokr_factor) if kind == "lokr"
                       else build(net, spec, generator))
            label = {"lokr": "LoKr", "loha": "LoHa", "dora": "DoRA"}[kind]
            print(f"{label}: {len(modules)} modules" + ("" if kind == "lokr" else f" (rank {spec.rank})"))
        if kind != "lora":
            self._net_keys = {name: self._network_key(model, name) for name in modules}
        self.net_modules = modules
        return {f"{name}.{leaf}": p for name, m in modules.items() for leaf, p in m.named_parameters()}, lora

    def _network_key(self, model, name: str) -> str:
        """The module key the JAX job's file carries for ``name``: LoKr and
        LoHa under ``lora_transformer_`` and the JAX module path on every arch
        (JAX saves them with no key map), DoRA under ``lora_transformer_`` /
        ``lora_unet_`` and the LoRA file's module name, LoRM (PEFT) the JAX
        module path in the layout JAX's config has (:1282-1296, :1990-2028)."""
        kind = self.network_kind
        if kind == "lorm":
            return model.jax_module_path(name, scanned=model.jax_scans_blocks)
        if kind == "dora":
            ext = model.lora_key(name) if hasattr(model, "lora_key") else name
            prefix = "lora_transformer" if model.is_flow_matching else "lora_unet"
        else:
            ext, prefix = model.jax_module_path(name), "lora_transformer"
        return f"{prefix}_{ext.replace('.', '_')}"

    def _build_embedding(self, model, variables: dict) -> dict[str, torch.Tensor]:
        """The textual-inversion bank (JAX ``_build_trainable``'s embedding
        branch): ``vectors`` rows, each the token embedding of ``init_words``
        in turn (else normal(0, 0.02)), f32, as ``variables["emb"]``; the
        model's tokenizer then maps the trigger to the bank's virtual ids."""
        emb_cfg, clip_cfg = self.cfg.embedding, model.clip_config
        self.ti_trigger = emb_cfg.get("trigger", self.cfg.trigger_word or "sks")
        n_vec = int(emb_cfg.get("vectors", 4))
        init_from = None
        if emb_cfg.get("init_words"):
            ids = model.tokenizer.encode(emb_cfg["init_words"])
            valid = [int(i) for i in ids if i != model.tokenizer.eos_id]
            if valid:
                table = variables["clip"].text_model.embeddings.token_embedding.weight
                init_from = table[valid].detach().float().cpu().numpy()
        bank = init_embedding_bank(n_vec, clip_cfg.hidden_size, init_from=init_from)
        model.tokenizer = TriggerTokenizer(model.tokenizer, self.ti_trigger, clip_cfg.vocab_size, n_vec)
        variables["emb"] = torch.nn.Parameter(torch.from_numpy(bank).to(self.device))
        print(f"textual inversion: trigger '{self.ti_trigger}' -> {n_vec} vectors")
        return {"emb": variables["emb"]}

    def _load_ara(self, model, variables: dict, path: str) -> None:
        """The frozen accuracy-recovery adapter into the main component's
        ``ara`` slots (JAX ``run``, :120-152): LoKr when the file's first key
        starts with ``lycoris`` and a key names ``lokr``, else LoRA."""
        net = variables[model.main_component]
        names = [n for n, _ in net.named_modules()]
        if is_lokr_file(path):
            kind, tree = "lokr", load_lokr_file(path, names)
        else:
            kind = "lora"
            tree, _ = load_lora_file(path, module_names=names,
                                     module_name=getattr(model, "lora_module_name", None))
        n = attach_ara(net, tree, kind)
        print(f"accuracy recovery adapter active: {path} ({kind}, {n} modules)")

    def _build_adapter(self, model, variables: dict, seed: int) -> dict[str, torch.Tensor]:
        """The custom adapter's trainable tensors (JAX ``_build_trainable``'s
        CustomAdapter branch): the vision tower, the adapter module and, for
        vision_direct, the per-block decoupled K/V from the frozen K weights.
        Keys: ``adapter.<path>`` and ``ip.<block>.<leaf>``."""
        cfg, dev = self.cfg, self.device
        acfg = cfg.adapter
        atype = acfg["type"]
        if cfg.network is not None:
            print(f"JAX fault mirrored: network '{cfg.network.type}' beside adapter '{atype}' is not trained "
                  f"(JAX _build_trainable returns the adapter alone; ROADMAP Queue 3)")
        if atype == "t2i":  # the trainable T2I net on the UNet's levels, at the VAE's downscale (JAX :920-922)
            acfg = {**acfg, "downscale": acfg.get("downscale", model.vae_config.downscale)}
            self.adapter = init_custom_adapter(acfg, model.unet_config.cross_attention_dim, 0,
                                               torch.Generator(device=dev).manual_seed(seed + 98), dev,
                                               unet_channels=model.unet_config.block_out_channels)
            trainable = {f"adapter.{k}": p for k, p in self.adapter.module.named_parameters()}
            print(f"CustomAdapter[t2i]: {sum(p.numel() for p in trainable.values()):,} trainable params")
            return trainable
        dit_cfg = model.dit_config
        vision_dim = self._build_vision_tower(model, acfg, torch.Generator(device=dev).manual_seed(seed + 99))
        hidden = dit_cfg.hidden_size if atype == "vision_direct" else None
        self.adapter = init_custom_adapter(acfg, dit_cfg.context_dim, vision_dim,
                                           torch.Generator(device=dev).manual_seed(seed + 98), dev, dit_hidden=hidden)
        trainable = {f"adapter.{k}": p for k, p in self.adapter.module.named_parameters()}
        self.ip = {}
        if atype == "vision_direct":
            only_double = bool(acfg.get("flux_only_double", False))
            mid = dit_cfg.hidden_size if acfg.get("image_encoder_arch") == "pixtral" and only_double else vision_dim
            self.ip = build_flux_ip_collection(variables[model.main_component], mid,
                                               torch.Generator(device=dev).manual_seed(seed + 101),
                                               only_double=only_double, scale=float(acfg.get("scale", 1.0)))
            if "train_scaler" in acfg and not acfg["train_scaler"]:
                print("JAX fault mirrored: train_scaler: false is not read; each block's ip scale trains "
                      "(ROADMAP Queue 3)")
            trainable.update({f"ip.{b}.{leaf}": p for b, m in self.ip.items() for leaf, p in m.named_parameters()})
        print(f"CustomAdapter[{atype}]: {sum(p.numel() for p in trainable.values()):,} trainable params"
              + (f", decoupled K/V on {len(self.ip)} blocks" if self.ip else ""))
        return trainable

    def _build_ip(self, model, variables: dict, seed: int) -> dict[str, torch.Tensor]:
        """IP-Adapter's trainable tensors (JAX ``_build_trainable``, :751-817):
        the projection ``variables["ip_proj"]`` and the decoupled K/V of every
        site; keys ``ip_proj.<param>`` and ``ip.<site>.<leaf>``."""
        cfg, dev = self.cfg, self.device
        acfg = cfg.adapter
        if cfg.network is not None:
            print(f"JAX fault mirrored: network '{cfg.network.type}' beside adapter '{acfg['type']}' is not "
                  f"trained (JAX _build_trainable returns the IP-Adapter alone; ROADMAP Queue 3)")
        self._build_vision_tower(model, {}, torch.Generator(device=dev).manual_seed(seed + 99))
        vcfg = self.vision_tower.cfg
        self.ip_plus = acfg["type"] == "ip_adapter_plus" or bool(acfg.get("is_plus"))
        n_tokens = int(acfg.get("num_tokens", 16 if self.ip_plus else 4))
        rdim = int(acfg.get("resampler_dim", min(768, vcfg.hidden_size)))
        kw = dict(resampler_dim=rdim, resampler_depth=int(acfg.get("resampler_depth", 4)),
                  resampler_heads=int(acfg.get("resampler_heads", max(1, rdim // 64))))
        scale = float(acfg.get("scale", 1.0))
        main = variables[model.main_component]
        if model.is_flow_matching:  # the Resampler at the DiT's width feeds every block's K/V (JAX :788-808)
            hid = model.dit_config.hidden_size
            proj = init_ip_proj(vcfg.hidden_size, hid, n_tokens, torch.Generator(device=dev).manual_seed(seed + 98),
                                dev, plus=True, **kw)
            self.ip_plus = True  # flux always feeds the patch tokens
            self.ip = build_flux_ip_collection(main, hid, torch.Generator(device=dev).manual_seed(seed + 101),
                                               scale=scale, init="random")
        else:
            proj = init_ip_proj(vcfg.hidden_size if self.ip_plus else vcfg.projection_dim,
                                model.unet_config.cross_attention_dim, n_tokens,
                                torch.Generator(device=dev).manual_seed(seed + 98), dev, plus=self.ip_plus, **kw)
            if "scale" in acfg:
                print(f"JAX fault mirrored: adapter.scale {acfg['scale']!r} is not read on a UNet arch; every site "
                      f"starts at scale 1.0 (JAX init_ip_adapter builds the collection without it; ROADMAP Queue 3)")
            self.ip = build_ip_collection(main)
        variables["ip_proj"] = self.ip_proj = proj
        self.ip_mode = True
        print(f"IP-Adapter: {len(self.ip)} cross-attn sites, {n_tokens} tokens")
        trainable = {f"ip_proj.{k}": p for k, p in proj.named_parameters()}
        trainable.update({f"ip.{b}.{leaf}": p for b, m in self.ip.items() for leaf, p in m.named_parameters()})
        return trainable

    @torch.no_grad()
    def _ip_embeds(self, pixels: np.ndarray) -> torch.Tensor:
        """Images ``[B, H, W, 3]`` in [-1, 1] through the vision tower: the
        patch states for plus, else the pooled embedding (JAX ``_prepare_batch``)."""
        tokens, pooled = self.vision_encode(torch.from_numpy(np.ascontiguousarray(pixels, np.float32)))
        return tokens if self.ip_plus else pooled

    def _build_assistant(self, model, seed: int) -> None:
        """The frozen T2I assistant (JAX :218-240): the file when the path is
        one, read as ``load_custom_adapter`` reads it, else the seeded net."""
        from ai_toolkit_tpu_torch.adapters.custom_adapter import load_custom_adapter
        from ai_toolkit_tpu_torch.adapters.t2i_adapter import init_t2i_adapter, t2i_state_from_flat

        path, tc = str(self.assist_path), self.cfg.train
        if tc.adapter_assist_type != "t2i":
            print(f"JAX fault mirrored: adapter_assist_type {tc.adapter_assist_type!r} is not read; the assistant "
                  f"is a T2I adapter (ROADMAP Queue 3)")
        net = init_t2i_adapter(model.unet_config, torch.Generator(device=self.device).manual_seed(seed + 77),
                               self.device, downscale=model.vae_config.downscale)
        if os.path.isfile(path):
            loaded, _ = load_custom_adapter(path)
            if loaded:
                net.load_state_dict(t2i_state_from_flat(loaded))
        else:
            print(f"assistant adapter: {path!r} is no file: seeded init (as the JAX job)")
        self.assistant = net.eval().requires_grad_(False)
        print(f"assistant adapter active: {path}")

    def _build_expansion(self, model, variables: dict, seed: int) -> dict[str, torch.Tensor]:
        """The input-expansion adapter's trainable tensors (JAX
        ``_build_trainable``, :1105-1235), keys ``ctrl.w`` / ``ctrl.b`` (the
        expansion) and ``i2v.<DiT parameter>`` (the graft)."""
        from ai_toolkit_tpu_torch.ops.layers import Ctrl

        acfg, dev = self.cfg.adapter, self.device
        dit = variables[model.main_component]
        if self.expansion == "control_lora":
            from ai_toolkit_tpu_torch.adapters.control_lora import (init_control_lora, load_control_lora_expansion,
                                                                    upgrade_expansion)

            dc = model.dit_config
            if dc.control_channels:
                raise ValueError(f"control_lora needs a base arch; {self.cfg.model.arch} already takes control "
                                 f"channels (kontext / flex2-style)")
            nc = int(acfg.get("num_control_images", 1))
            inpaint = bool(acfg.get("has_inpainting_input", False))
            w = init_control_lora(dc.hidden_size, dc.in_channels, torch.Generator(device=dev).manual_seed(seed + 41),
                                  nc, inpaint, device=dev)
            lp = acfg.get("name_or_path")
            if lp and os.path.isfile(str(lp)):
                got = load_control_lora_expansion(str(lp))
                if got is not None:  # the weight alone, as JAX reads it
                    w = torch.from_numpy(upgrade_expansion(got["w"], w.shape[0])).float().to(dev)
                    print(f"control_lora: restored x_embedder expansion from {lp}")
            elif lp:
                print(f"control_lora: name_or_path {lp!r} is no file: the expansion keeps its seeded init (as the "
                      f"JAX job)")
            dit.img_in.ctrl = Ctrl(w)
            model.dit_config = dataclasses.replace(dc, control_channels=w.shape[0])
            model.control_lora_inpaint = inpaint
            self.control_lora_mode = {"inpaint": inpaint, "num_control": nc,
                                      "control_image_dropout": float(acfg.get("control_image_dropout", 0.0)),
                                      "invert_inpaint_mask_chance": float(acfg.get("invert_inpaint_mask_chance", 0.0))}
            print(f"CustomAdapter[control_lora]: +{w.shape[0]} packed input ch on img_in"
                  + (" (inpainting)" if inpaint else ""))
            return {"ctrl.w": dit.img_in.ctrl.w}
        from ai_toolkit_tpu_torch.adapters.i2v import graft_i2v, init_frame_embedder_ctrl
        from ai_toolkit_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
        from ai_toolkit_tpu_torch.ops.layers import init_parameters

        if len(model.experts) > 1:
            raise NotImplementedError("the i2v adapter on a multistage pair comes with ROADMAP Queue 1 item 6e "
                                      "(ported: a wan21 t2v base)")
        grafted = graft_i2v(dit, torch.Generator(device=dev).manual_seed(seed + 42))
        model.dit_config = dit.cfg
        if "clip_vision" not in variables:  # the frozen tower feeding the image K/V, seeded (JAX :1193-1204)
            tiny = self.cfg.model.model_kwargs.get("size") == "tiny"
            model.vision_config = CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig.vit_h()
            variables["clip_vision"] = init_parameters(
                CLIPVisionModel(model.vision_config, device=dev),
                torch.Generator(device=dev).manual_seed(seed + 99)).eval().requires_grad_(False)
        trainable = {f"i2v.{n}": p for n, p in grafted.items()}
        start = bool(acfg.get("i2v_do_start_frame", False))
        if start:
            vc, dc = model.vae_config, model.dit_config
            dit.patch_embedding.ctrl = init_frame_embedder_ctrl(
                dc.dim, vc.latent_channels, dc.patch_size, torch.Generator(device=dev).manual_seed(seed + 43),
                mask_channels=vc.temporal_downscale, device=dev)
            trainable.update({"ctrl.w": dit.patch_embedding.ctrl.w, "ctrl.b": dit.patch_embedding.ctrl.b})
        self.i2v_mode = {"start_frame": start}
        n = sum(p.numel() for p in grafted.values())
        print(f"CustomAdapter[i2v]: {n:,} grafted i2v params" + (" + first-frame embedder" if start else ""))
        return trainable

    def _expansion_extra_flat(self, state: TrainState) -> dict[str, np.ndarray]:
        """The expansion or the graft in the save layout (JAX ``_save``): the
        control-LoRA expansion and the i2v graft from the EMA copy when EMA is
        on, the frame embedder as it trains."""
        src = state.ema if state.ema is not None else state.trainable
        if self.expansion == "control_lora":
            from ai_toolkit_tpu_torch.adapters.control_lora import control_lora_extra_flat

            return control_lora_extra_flat(src["ctrl.w"])
        from ai_toolkit_tpu_torch.adapters.i2v import i2v_extra_flat

        grafted = {k[len("i2v."):]: src[k] for k in state.trainable if k.startswith("i2v.")}
        return i2v_extra_flat(grafted, state.trainable.get("ctrl.w"), state.trainable.get("ctrl.b"),
                              patch_size=self.model.dit_config.patch_size)

    def _expansion_from_file(self, path: str, want: dict[str, tuple]) -> dict[str, torch.Tensor]:
        """The expansion or the graft read back from a save file, keyed as in
        the trainable dict (the expansion resized to ``want``'s width, JAX
        ``upgrade_expansion``)."""
        if self.expansion == "control_lora":
            from ai_toolkit_tpu_torch.adapters.control_lora import load_control_lora_expansion, upgrade_expansion

            got = load_control_lora_expansion(path)
            return {} if got is None else {"ctrl.w": torch.from_numpy(upgrade_expansion(got["w"],
                                                                                       want["ctrl.w"][0]))}
        from safetensors.numpy import load_file

        from ai_toolkit_tpu_torch.adapters.i2v import load_i2v_from_flat

        flat = load_file(path)
        if not any(k.startswith("attn_hog.") for k in flat):
            return {}
        grafted, ctrl = load_i2v_from_flat(flat, self.model.dit_config.patch_size)
        out = {f"i2v.{n}": torch.from_numpy(np.ascontiguousarray(v)) for n, v in grafted.items()}
        if ctrl is not None:
            out["ctrl.w"], out["ctrl.b"] = (torch.from_numpy(np.ascontiguousarray(v)) for v in ctrl)
        return out

    def _build_vision_tower(self, model, acfg: dict, generator: torch.Generator) -> int:
        """The adapter's frozen vision tower (JAX :968-1020) as
        ``self.vision_encode(pixels [B, H, W, 3] in [-1, 1]) -> (tokens,
        pooled)``; returns the token width."""
        from ai_toolkit_tpu_torch.models.tipsv2 import resize_linear

        dev, tiny = self.device, self.cfg.model.model_kwargs.get("size") == "tiny"
        if acfg.get("image_encoder_arch") == "pixtral":
            from ai_toolkit_tpu_torch.models.text_encoders.pixtral_vision import (PIXTRAL_MEAN, PIXTRAL_STD,
                                                                                  PixtralVisionConfig,
                                                                                  init_pixtral_encoder,
                                                                                  load_pixtral_encoder)

            ppath = acfg.get("image_encoder_path") or ""
            if ppath and os.path.isdir(ppath):
                tower = load_pixtral_encoder(ppath, dev)
                print(f"pixtral vision tower loaded from {ppath}")
            else:
                pcfg = PixtralVisionConfig.tiny() if tiny else PixtralVisionConfig()
                tower = init_pixtral_encoder(pcfg, generator, dev)
                print(f"pixtral vision tower: no directory at {ppath!r}: seeded init (as the JAX job)")
            size = min(tower.cfg.image_size, 512)
            mean = torch.tensor(PIXTRAL_MEAN, device=dev)
            std = torch.tensor(PIXTRAL_STD, device=dev)

            def encode(px):
                px = resize_linear(px, size, size)
                tokens = tower((((px + 1.0) / 2.0) - mean) / std)  # [-1, 1] -> [0, 1] -> normalised
                return tokens, tokens.mean(dim=1)

            dim = tower.cfg.hidden_size
        else:
            from ai_toolkit_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
            from ai_toolkit_tpu_torch.ops.layers import init_parameters

            if acfg.get("image_encoder_path"):
                print(f"JAX fault mirrored: image_encoder_path {acfg['image_encoder_path']!r} is not read; the "
                      f"CLIP ViT-H tower is a seeded init (ROADMAP Queue 3)")
            vcfg = CLIPVisionConfig.tiny() if tiny else CLIPVisionConfig.vit_h()
            tower = init_parameters(CLIPVisionModel(vcfg, device=dev), generator).eval().requires_grad_(False)
            size = vcfg.image_size

            def encode(px):
                out = tower(resize_linear(px, size, size))
                return out["penultimate_hidden_state"], out["pooled_output"]

            dim = vcfg.hidden_size
        self.vision_tower, self.vision_size = tower, size

        @torch.no_grad()
        def vision_encode(px: torch.Tensor):
            return encode(px.to(dev).float())

        self.vision_encode = vision_encode
        return dim

    def _encode_vision_cached(self, pixels: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The vision tokens and pooled output of each image, cached in memory
        by an md5 of its pixels and the tower's size, and with
        ``cache_clip_vision_to_disk`` in ``<save_root>/clip_vision_cache/<key>.safetensors``
        (JAX ``_encode_vision_cached``)."""
        import hashlib

        from safetensors.torch import load_file, save_file

        if not hasattr(self, "_vision_cache"):
            self._vision_cache, self._vision_cache_dir = {}, None
            self.vision_cache_report = {"encoded": 0, "memory_hits": 0, "disk_hits": 0}
            if self.cfg.adapter.get("cache_clip_vision_to_disk"):
                self._vision_cache_dir = os.path.join(self.save_root, "clip_vision_cache")
                os.makedirs(self._vision_cache_dir, exist_ok=True)
        toks, pools, missing = [None] * len(pixels), [None] * len(pixels), []
        for i in range(len(pixels)):
            key = f"{hashlib.md5(np.ascontiguousarray(pixels[i]).tobytes()).hexdigest()}_{self.vision_size}"
            hit = self._vision_cache.get(key)
            if hit is not None:
                self.vision_cache_report["memory_hits"] += 1
            elif self._vision_cache_dir:
                path = os.path.join(self._vision_cache_dir, key + ".safetensors")
                if os.path.isfile(path):
                    d = load_file(path, device=str(self.device))
                    hit = self._vision_cache[key] = (d["tokens"], d["pooled"])
                    self.vision_cache_report["disk_hits"] += 1
            if hit is None:
                missing.append((i, key))
            else:
                toks[i], pools[i] = hit
        if missing:
            t_new, p_new = self.vision_encode(torch.from_numpy(np.stack([pixels[i] for i, _ in missing])))
            self.vision_cache_report["encoded"] += len(missing)
            for j, (i, key) in enumerate(missing):
                toks[i], pools[i] = t_new[j].contiguous(), p_new[j].contiguous()
                self._vision_cache[key] = (toks[i], pools[i])
                if self._vision_cache_dir:
                    save_file({"tokens": toks[i].cpu(), "pooled": pools[i].cpu()},
                              os.path.join(self._vision_cache_dir, key + ".safetensors"))
        return torch.stack(toks), torch.stack(pools)

    def _resume(self, ckpt: CheckpointManager, model, state: TrainState, lora: dict | None,
                generator: torch.Generator) -> int:
        """Restore the newest save and its training state; the step to go on
        from (0: a fresh run)."""
        from safetensors import safe_open

        path = ckpt.latest_save_path()
        if path is None:
            return 0
        if self.network_kind in ("lokr", "loha", "dora"):
            raise NotImplementedError(f"{path}: resuming network '{self.cfg.network.type}' is not ported: the JAX "
                                      f"job cannot (its resume reads LoRA keys into the 'lora' tree and trains this "
                                      f"network afresh from step 0); delete the output folder for a fresh run")
        if self.adapter is not None or self.ip_mode or self.network_kind == "lorm":  # the exact state alone
            with safe_open(path, framework="pt") as f:
                step = int((f.metadata() or {}).get("step", 0))
            saved = None
        elif lora is not None:
            tree, step = ckpt.load_latest(module_names=list(lora),
                                          module_name=getattr(model, "lora_module_name", None))
            saved = {f"{n}.{leaf}": t for n, leaves in tree.items() for leaf, t in leaves.items()}
            if self.expansion:  # the expansion or the graft beside the LoRA in the same file
                saved.update(self._expansion_from_file(path, {k: tuple(p.shape) for k, p in
                                                              state.trainable.items()}))
        elif self.textual_inversion:
            saved = {"emb": torch.from_numpy(load_embedding(path))}
            with safe_open(path, framework="pt") as f:
                step = int((f.metadata() or {}).get("step", 0))
        else:
            with safe_open(path, framework="pt") as f:
                saved = {k: f.get_tensor(k) for k in f.keys()}
                step = int((f.metadata() or {}).get("step", 0))
        cur = {k: tuple(p.shape) for k, p in state.trainable.items()}
        if saved is not None and {k: tuple(t.shape) for k, t in saved.items()} != cur:
            print("resume checkpoint has different network shape — starting fresh "
                  "(reference skips the optimizer in this case too)")
            return 0
        with torch.no_grad():
            for k, p in (state.trainable.items() if saved is not None else ()):
                p.copy_(saved[k])
        extra, state_step = ckpt.load_state()
        if saved is None and (extra is None or state_step != step):
            print(f"resume: {path} has no matching training state: starting fresh")
            return 0
        restored = False
        if extra is not None and state_step == step:
            rng = extra.pop("rng", None)
            host_rngs = {k: extra.pop(k, None) for k in HOST_RNGS}
            restored = state.load_state_dict(extra)
            if restored and rng is not None:
                generator.set_state(rng)
            for key, host_rng in host_rngs.items():
                if restored and host_rng is not None:
                    r = np.random.default_rng()
                    r.bit_generator.state = json.loads(bytes(host_rng.numpy()).decode())
                    setattr(self, f"_{key}", r)
        snr_json = os.path.join(self.save_root, "learnable_snr.json")
        if getattr(state, "lsnr", None) is not None and not restored and os.path.isfile(snr_json):
            with open(snr_json) as f:  # JAX's resume: the four scalars, the rest fresh
                state.lsnr.load_json(json.load(f))
            print("resumed learnable_snr.json")
        state.step = step
        print(f"resumed from step {step} ({path}; "
              f"{'optimizer state, EMA and generator restored' if restored else 'fresh optimizer state'})")
        return step

    def _schedule(self):
        """The schedule with the job's overrides (JAX ``run``, step 3):
        ``train.scheduler_params``, then ``num_train_timesteps`` and
        ``model.is_v_pred`` where those leave them unset."""
        tc = self.cfg.train
        overrides = dict(tc.extras.get("scheduler_params") or {})
        if tc.num_train_timesteps != 1000:
            overrides.setdefault("num_train_timesteps", tc.num_train_timesteps)
        if self.cfg.model.is_v_pred:
            overrides.setdefault("prediction_type", "v_prediction")
        return get_schedule(tc.noise_scheduler, self.cfg.model.arch, **overrides)

    def _save(self, ckpt: CheckpointManager, state: TrainState, lora: dict | None, generator: torch.Generator,
              step: int, final: bool = False) -> str:
        """A LoRA save: the EMA copy when EMA is on, in the PEFT layout, with
        rotation. A textual inversion's: the bank (its EMA copy when EMA is
        on) in the a1111 layout, f32. A full fine-tune's: the trained tensors
        themselves in their own dtype, keyed by parameter name, no rotation
        (JAX ``_save``). Each writes the training state a resume restores."""
        if self.ip_mode:  # JAX save_ip_adapter of the trained tensors, metadata {"step"}
            from safetensors.numpy import save_file

            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            save_file(ip_adapter_flat(self.ip_proj, self.ip, flux=self.model.is_flow_matching), path,
                      metadata={"step": str(step)})
        elif self.adapter is not None:
            # JAX _save: the module (its EMA copy when EMA is on) and the decoupled K/V as they train
            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            src = state.ema if state.ema is not None else state.trainable
            mod = {k[len("adapter."):]: src[k] for k in state.trainable if k.startswith("adapter.")}
            if self.adapter.adapter_type == "t2i":  # conv kernels HWIO, as JAX writes them
                from ai_toolkit_tpu_torch.adapters.t2i_adapter import t2i_flat

                mod = t2i_flat(mod)
            flat = {f"{self.adapter.adapter_type}.{k}": v.detach().float().cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in mod.items()}
            flat.update({f"{self.adapter.adapter_type}.{k}": v for k, v in flux_ip_flat(self.ip).items()})
            save_custom_adapter(flat, self.adapter.adapter_type, path, metadata={"step": step})
        elif self.textual_inversion:
            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            src = state.ema if state.ema is not None else state.trainable
            save_embedding(src["emb"].detach().float().cpu().numpy(), path, name=self.ti_trigger, step=step)
        elif lora is not None:
            src = state.ema if state.ema is not None else state.trainable
            tree = {name: {leaf: src[f"{name}.{leaf}"] for leaf in ("a", "b", "scale")} for name in lora}
            path = ckpt.save(tree, step, final=final,
                             extra_flat=self._expansion_extra_flat(state) if self.expansion else None)
        elif self.network_kind is not None:
            # JAX _save's lorm and lyco branches: the EMA copy when EMA is on, fp16 (their default)
            src = state.ema if state.ema is not None else state.trainable
            tree = {name: {leaf: src[f"{name}.{leaf}"] for leaf, _ in m.named_parameters()}
                    for name, m in self.net_modules.items()}
            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            meta = {"step": step, "software": "ai_toolkit_tpu"}
            if self.network_kind == "lorm":  # PEFT under the JAX module paths, rotated
                for leaf in tree.values():
                    leaf["scale"] = torch.tensor(1.0)
                save_lora_file(tree, path, metadata={**meta, "network_type": "lorm"}, fmt="peft",
                               key_map=self._net_keys.get)
                if not final:
                    ckpt.clean_up_saves()
            else:
                save_adapter_file(tree, self.network_kind, path, key=self._net_keys.get, metadata=meta)
        else:
            from safetensors.torch import save_file

            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            save_file({k: t.detach().contiguous().cpu() for k, t in state.trainable.items()}, path,
                      metadata={"step": str(step), "software": "ai_toolkit_tpu"})
        if getattr(state, "lsnr", None) is not None:  # beside the checkpoint, as JAX writes it
            with open(os.path.join(self.save_root, "learnable_snr.json"), "w") as f:
                json.dump(state.lsnr.to_json(), f)
        host = {}
        for key in HOST_RNGS:
            rng = getattr(self, f"_{key}", None)
            if rng is not None:
                host[key] = torch.frombuffer(bytearray(json.dumps(rng.bit_generator.state).encode()),
                                             dtype=torch.uint8)
        ckpt.save_state({**state.state_dict(), "rng": generator.get_state(), **host}, step)
        return path

    def _sample(self, model, variables: dict, state: TrainState, lora: dict | None, step: int) -> None:
        """Every sample prompt through ``generation.generate`` (JAX
        ``_sample``), with the EMA copy of the LoRA when EMA is on (a
        textual inversion's bank and an expansion as they train, as in JAX;
        an i2v graft as it trains, which JAX's samples drop), to
        ``<save_root>/samples/<name>_<step:09d>_<i>.<ext>``. Raises when a
        sample fails."""
        from ai_toolkit_tpu_torch.generation import generate, save_image_atomic, save_video_atomic, save_wav_atomic

        cfg = self.cfg
        sample_dir = os.path.join(self.save_root, "samples")
        swap = lora is not None and state.ema is not None
        # the LoRA's EMA copy; an expansion and a graft sample as they train (JAX _sample)
        raw = {k: p.detach().clone() for k, p in state.trainable.items()
               if not k.startswith(("ctrl.", "i2v."))} if swap else {}
        with torch.no_grad():
            for k in raw:
                state.trainable[k].copy_(state.ema[k])
        try:
            for i, item in enumerate(cfg.sample.prompts):
                seed = cfg.sample.seed + (i if cfg.sample.walk_seed else 0)
                gen = GenerateImageConfig.from_sample(cfg.sample, item, seed)
                extra = self._sample_adapter_cond(gen)
                _sync(self.device)
                t0 = time.perf_counter()
                out = generate(model, variables, gen, cond=extra)
                wav = None
                if isinstance(out, tuple):  # a joint AV model: the frames and the waveform
                    out, wav = out
                if hasattr(model, "frame_count_snapper"):
                    ext = "webp" if out.shape[0] > 1 else gen.output_ext
                    path = os.path.join(sample_dir, f"{self.job_name}_{step:09d}_{i}.{ext}")
                    save_video_atomic(out, path, fps=gen.fps)
                    if wav is not None:
                        save_wav_atomic(wav, os.path.splitext(path)[0] + ".wav")
                else:
                    path = os.path.join(sample_dir, f"{self.job_name}_{step:09d}_{i}.{gen.output_ext}")
                    save_image_atomic(out, path)
                secs = time.perf_counter() - t0
                self.samples.append({"step": step, "index": i, "path": path, "seconds": secs,
                                     **({"wav": os.path.splitext(path)[0] + ".wav"} if wav is not None else {})})
                print(f"sample: {path} ({secs:.2f} s)")
        finally:
            with torch.no_grad():
                for k, t in raw.items():
                    state.trainable[k].copy_(t)

    def _sample_adapter_cond(self, gen: GenerateImageConfig) -> dict | None:
        """A vision_direct sample with a ``ctrl_img``: the image (at its own
        size, [-1, 1]) through the vision tower and the adapter into
        ``ip_tokens``, and the ``ctrl_img`` consumed (JAX ``_sample``). The
        adapter runs as it trains (not its EMA copy), as in JAX."""
        vd = self.adapter is not None and self.adapter.adapter_type == "vision_direct"
        if not (vd or self.ip_mode) or not gen.ctrl_img:
            return None
        from PIL import Image

        px = np.asarray(Image.open(gen.ctrl_img).convert("RGB"), np.float32)[None] / 127.5 - 1.0
        gen.ctrl_img = None
        if self.ip_mode:  # flux: the embeddings through the Resampler in predict (UNet archs refuse the image)
            return {"ip_embeds": self._ip_embeds(px)}
        with torch.no_grad():
            tokens, _ = self.vision_encode(torch.from_numpy(px))
            return {"ip_tokens": self.adapter.module(tokens)}

    @property
    def _want_pixels(self) -> bool:
        """An image batch carries its pixels: a vision adapter's input, and the
        i2v adapter's first frame (JAX's loader gets no pixels for it, so its
        i2v job raises on an image batch: ROADMAP Queue 3); not for ``t2i``,
        whose input is the control image (JAX ``want_pixels``)."""
        vision = self.adapter is not None and self.adapter.adapter_type != "t2i"
        return vision or self.ip_mode or self.expansion == "i2v"

    def _build_data(self, model, variables):
        cfg = self.cfg
        # a video model snaps each dataset's frame count onto its VAE's grid (wan: 4k+1)
        if hasattr(model, "frame_count_snapper"):
            for d in cfg.datasets:
                if d.num_frames > 1:
                    snapped = model.frame_count_snapper(d.num_frames)
                    if snapped != d.num_frames:
                        print(f"dataset {d.folder_path}: num_frames {d.num_frames} -> {snapped} "
                              f"(VAE temporal grid)")
                        d.num_frames = snapped

        tc = cfg.train
        if tc.reg_weight != 1.0:  # the loss scale of regularisation datasets (JAX _build_data)
            for d in cfg.datasets:
                if d.is_reg:
                    d.loss_multiplier = d.loss_multiplier * tc.reg_weight

        @torch.no_grad()
        def encode_fn(imgs: np.ndarray) -> np.ndarray:
            self.latent_cache_report["encode_calls"] += 1
            if tc.standardize_images:  # per image to mean 0, std 1, on the host as JAX does
                ax = tuple(range(1, imgs.ndim))
                imgs = (imgs - imgs.mean(axis=ax, keepdims=True)) / np.maximum(imgs.std(axis=ax, keepdims=True), 1e-6)
            if tc.img_multiplier != 1.0:
                imgs = imgs * tc.img_multiplier
            lat = model.encode_images(variables, torch.from_numpy(np.ascontiguousarray(imgs, np.float32)))
            return lat.float().cpu().numpy()

        self.latent_cache_report = {"encode_calls": 0}
        to_disk = any(d.cache_latents_to_disk for d in cfg.datasets)
        if all(d.cache_latents or d.cache_latents_to_disk for d in cfg.datasets):
            # JAX _build_data: the disk cache when any dataset asks for it, else in memory
            cache_dir = os.path.join(self.save_root, "latent_cache") if to_disk else None
            loader = build_dataloader(cfg.datasets, cfg.train.batch_size, model.bucket_divisibility,
                                      trigger_word=cfg.trigger_word, latent_cache={} if cache_dir is None else None,
                                      latent_cache_dir=cache_dir, want_pixels=self._want_pixels)
            items = [it for ds in loader.datasets for it in ds.items]
            t0 = time.perf_counter()
            if cache_dir is not None:
                encoded, hits = cache_latents_to_disk(items, encode_fn, cache_dir, batch_size=cfg.train.batch_size)
                where = f"{cache_dir}: {encoded} encoded, {hits} read from disk"
                self.latent_cache_report.update(encoded=encoded, hits=hits, dir=cache_dir)
            else:
                loader.latent_cache = cache_latents(items, encode_fn, batch_size=cfg.train.batch_size)
                where = "in memory"
            _sync(self.device)
            secs = time.perf_counter() - t0
            self.latent_cache_report.update(items=len(items), seconds=secs)
            print(f"latent cache: {len(items)} items in {secs:.2f} s ({where})")
        else:
            loader = build_dataloader(cfg.datasets, cfg.train.batch_size, model.bucket_divisibility,
                                      trigger_word=cfg.trigger_word, encode_fn=encode_fn,
                                      want_pixels=self._want_pixels or tc.train_turbo)

        @torch.no_grad()
        def encode_prompt(prompts: list[str]) -> dict:
            return model.encode_prompt(variables, prompts)

        return loader, TextEmbedCache(encode_prompt)

    def _prepare_batch(self, model, variables: dict, raw: dict, text_cache: TextEmbedCache) -> dict:
        """One step's batch on the device (JAX ``_prepare_batch``): the
        captions (``prompt_dropout_prob`` empties each with that chance, from
        a host generator seeded by the job's seed that rides in the training
        state), their conditioning, the latents (``latent_multiplier``,
        ``do_blank_stabilization``'s zeroed blank-caption latents), the loss
        mask at latent size (the area mean of the pixel mask), the knobs'
        inputs, then the arch's own (rope tables, control latents, ...)."""
        dev, tc = self.device, self.cfg.train
        captions = raw["captions"]
        if tc.prompt_dropout_prob > 0:
            if getattr(self, "_dropout_rng", None) is None:
                self._dropout_rng = np.random.default_rng(self._seed + 3)
            captions = ["" if self._dropout_rng.random() < tc.prompt_dropout_prob else c for c in captions]
        if self.textual_inversion:  # raw token ids: CLIP runs inside the step, so the bank trains
            ids = np.stack([model.tokenizer.encode(c) for c in captions])
            cond = {"input_ids": torch.from_numpy(ids).long().to(dev)}
        else:
            cond = dict(text_cache.get(captions))
        ff = raw.get("first_frame")
        i2v = getattr(self, "i2v_mode", None)
        if ff is None and i2v is not None:  # the i2v adapter on an image batch: the image is the first frame
            px = raw.get("pixels")
            if px is None:
                raise ValueError("i2v adapter needs first-frame pixels: set datasets[].do_i2v for video data or "
                                 "disable latent-only caching")
            ff = px[:, 0] if px.ndim == 5 else px
        if ff is not None:  # i2v: the first frame through the vision tower
            with torch.no_grad():
                cond["img_cond"] = model.encode_image_cond(variables, torch.from_numpy(ff))
        if i2v is not None and i2v["start_frame"]:  # the frame embedder's first-frame conditioning
            from ai_toolkit_tpu_torch.adapters.i2v import assemble_first_frame_control

            cond["control_latents"] = torch.from_numpy(assemble_first_frame_control(
                ff, int(raw["latents"].shape[1]),
                lambda video: self._encode_control(model, variables, video).float().cpu().numpy(),
                temporal_downscale=model.vae_config.temporal_downscale)).to(dev)
        lat_np = raw["latents"]
        if tc.latent_multiplier != 1.0:
            lat_np = lat_np * tc.latent_multiplier
        if tc.do_blank_stabilization:  # blank-caption samples train against zeroed latents
            keep = np.asarray([1.0 if c.strip() else 0.0 for c in captions], lat_np.dtype)
            lat_np = lat_np * keep.reshape((-1,) + (1,) * (lat_np.ndim - 1))
        latents = torch.from_numpy(np.ascontiguousarray(lat_np)).to(dev)
        batch = {"latents": latents, "cond": cond, "is_reg": bool(raw.get("is_reg")),
                 "loss_multiplier": torch.from_numpy(raw["loss_multiplier"]).to(dev)}
        if tc.force_consistent_noise and "noise_seed" in raw:
            batch["noise_seed"] = [int(x) for x in raw["noise_seed"]]
        if tc.train_turbo:
            if "pixels" not in raw:
                raise ValueError("train_turbo needs raw image batches (cache_latents: false)")
            batch["pixel_values"] = torch.from_numpy(raw["pixels"]).to(dev)
        if "pixel_mask" in raw:  # the pixel mask to latent size by area mean
            m, lh, lw = raw["pixel_mask"], raw["latents"].shape[1], raw["latents"].shape[2]
            d = m.shape[1] // lh
            m = m.reshape(m.shape[0], lh, d, lw, d, 1).mean(axis=(2, 4))
            batch["mask"] = torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
        if not self.textual_inversion:  # the knobs' other prompts, encoded per batch (JAX :1685-1720)
            n = len(captions)
            if tc.blank_prompt_preservation:
                batch["blank_cond"] = dict(text_cache.get([""] * n))
            if tc.guidance_loss_target != 1.0:
                batch["uncond_cond"] = dict(text_cache.get([tc.unconditional_prompt or ""] * n))
            if tc.do_cfg:
                neg = tc.negative_prompt or tc.unconditional_prompt or self.cfg.sample.neg or ""
                batch["neg_cond"] = dict(text_cache.get([neg] * n))
        knob_conds = [batch[k] for k in ("blank_cond", "uncond_cond", "neg_cond") if k in batch]
        if "unconditional_pixels" in raw:  # the paired negatives through the VAE, every batch
            batch["unconditional_latents"] = self._encode_control(model, variables, raw["unconditional_pixels"])
        if raw.get("audio_waveform") is not None and getattr(model, "joint_audio", False):
            # joint AV: the sidecar audio through the audio VAE (its noise is drawn in the step)
            with torch.no_grad():
                batch["audio_latents"] = model.encode_audio(variables, torch.from_numpy(raw["audio_waveform"]))
            cond["pe_audio"] = model.audio_rope_table(int(batch["audio_latents"].shape[1]))
        if latents.dim() == 3:  # audio latents [B, T, C]: the 1-D rope over time
            cond["pe"] = model.rope_table(int(latents.shape[1]))
            batch["image_seq_len"] = int(latents.shape[1])
            for kc in knob_conds:  # JAX hands them the batch's rope table, nothing else of its conditioning
                kc["pe"] = cond["pe"]
            return batch
        if latents.dim() == 5:  # video latents [B, T, h, w, C]: rope over (t, y, x)
            tt, h, w = latents.shape[1:4]
            cond["pe"] = model.rope_table(tt, h, w)
            pt, ph, pw = model.dit_config.patch_size
            batch["image_seq_len"] = (tt // pt) * (h // ph) * (w // pw)
            for kc in knob_conds:
                kc["pe"] = cond["pe"]
            return batch
        b, h, w, _ = latents.shape
        extra_ctx = 0
        if self.ip_mode and "pixels" in raw:  # the paired image when the dataset has one (JAX :1710-1723)
            cond["ip_embeds"] = self._ip_embeds(raw.get("clip_pixels", raw["pixels"]))
        if "control_pixels" in raw and self.adapter is not None and self.adapter.adapter_type == "t2i":
            cond["control_pixels"] = torch.from_numpy(raw["control_pixels"]).to(dev)  # the net runs in the step
        if "control_pixels" in raw and self.assistant is not None:  # the frozen assistant's residuals (JAX :1834)
            with torch.no_grad():
                cond["adapter_residuals"] = self.assistant(torch.from_numpy(raw["control_pixels"]).to(dev))
        if self.adapter is not None and self.adapter.adapter_type != "t2i" and "pixels" in raw:
            # JAX _prepare_batch: the vision tokens of each image (the paired image when there is one)
            cond["vision_tokens"], cond["vision_pooled"] = self._encode_vision_cached(
                raw.get("clip_pixels", raw["pixels"]))
            if self.adapter.adapter_type == "redux":
                extra_ctx = int(cond["vision_tokens"].shape[1])  # the rope table covers the appended tokens
        if model.is_flow_matching:
            cond["pe"] = model.rope_table(h, w, int(cond["txt"].shape[1]) + extra_ctx)
            cond["guidance"] = torch.full((b,), 1.0, dtype=torch.float32, device=dev)
            batch["image_seq_len"] = (h // 2) * (w // 2)
            for kc in knob_conds:  # JAX hands them the batch's rope table and guidance
                kc["pe"], kc["guidance"] = cond["pe"], cond["guidance"]
        elif "pooled" in cond:  # SDXL: the added condition from the bucket's pixel size
            d = model.vae_config.downscale
            for c in [cond] + knob_conds:
                c["added_cond"] = model.added_cond(c.pop("pooled"), h * d, w * d)
        if self.cfg.model.arch == "flex2":
            # [inpaint latents, inpaint mask, control latents] with the per-batch dropouts, on the host
            if getattr(self, "_flex2_rng", None) is None:
                self._flex2_rng = np.random.default_rng(1234)
            ctrl = raw.get("control_pixels")
            ctrl_lat = None if ctrl is None else self._encode_control(model, variables, ctrl).float().cpu().numpy()
            cond["control_latents"] = torch.from_numpy(model.assemble_flex2_control(
                raw["latents"], raw.get("inpaint_keep"), ctrl_lat, self._flex2_rng)).to(dev)
        elif getattr(self, "control_lora_mode", None) is not None:
            cond["control_latents"] = torch.from_numpy(self._control_lora_latents(model, variables, raw)).to(dev)
        elif model.takes_control:
            if "control_pixels" not in raw:
                if model.control_optional:  # OmniGen2: no references in this batch
                    return batch
                raise ValueError(f"arch '{self.cfg.model.arch}' takes a control image and no item of this "
                                 f"{raw['bucket']} batch has one (give each image one in the dataset's control_path)")
            cond["control_latents"] = self._encode_control(model, variables, raw["control_pixels"])
        return batch

    def _control_lora_latents(self, model, variables: dict, raw: dict) -> np.ndarray:
        """The control-LoRA conditioning of a batch (JAX ``_prepare_batch``,
        :1771-1814): the inpainting ``[masked latents, mask]`` (the batch's
        ``inpaint_keep``, else its ``pixel_mask``), or the encoded controls in
        ``num_control_images`` slots; zeros when the dropout draw hits or the
        batch has none. Draws from the job's ``default_rng(4321)``."""
        from ai_toolkit_tpu_torch.adapters.control_lora import assemble_control, assemble_inpaint_control

        clm = self.control_lora_mode
        if getattr(self, "_cl_rng", None) is None:
            self._cl_rng = np.random.default_rng(4321)
        if clm["inpaint"]:
            keep = raw.get("inpaint_keep")
            if keep is None:
                keep = raw.get("pixel_mask")
            return assemble_inpaint_control(raw["latents"], keep, self._cl_rng, clm["control_image_dropout"],
                                            clm["invert_inpaint_mask_chance"])

        def enc(px: np.ndarray) -> np.ndarray:
            return self._encode_control(model, variables, px).float().cpu().numpy()

        one = multi = None
        if "control_pixels" in raw:
            def one():
                return enc(raw["control_pixels"])
        if "control_pixels_multi" in raw:
            cm = raw["control_pixels_multi"]  # [B, N, H, W, 3]

            def multi(nc: int) -> np.ndarray:
                n_have = min(nc, cm.shape[1])
                flat = enc(cm[:, :n_have].reshape((-1,) + cm.shape[2:]))
                return flat.reshape((cm.shape[0], n_have) + flat.shape[1:])
        return assemble_control(raw["latents"], self._cl_rng, clm["num_control"], clm["control_image_dropout"],
                                one, multi)

    @staticmethod
    @torch.no_grad()
    def _encode_control(model, variables: dict, pixels: np.ndarray) -> torch.Tensor:
        """Control images ``[B, H, W, 3]`` through the VAE (its posterior
        mode), every batch, as JAX ``_encode_control`` does."""
        return model.encode_images(variables, torch.from_numpy(pixels))
