"""The training job (``ai_toolkit_tpu/jobs/train_process.py``
``SDTrainProcess`` in PyTorch), on the paths of the LoRA job and of the full
fine-tune:

model (seeded random weights, or the local checkpoint of ``name_or_path``,
``models/base.py``) -> optional weight-only quantization of the DiT
(``model.quantize``, fp8 or int8: ``adapters/quantize.py``; each expert of a
multistage pair from its own weights, as it is built) -> LoRA on the
model's main component, the DiT or the UNet (the model's targets), one
network shared by a multistage pair's two experts ->
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

Every other branch of the JAX process raises ``NotImplementedError`` naming
its slice: other networks and adapters (the assistant adapter,
``adapter_assist_name_or_path``), quantized text encoders
(``quantize_te``), text-encoder training, the feature-extractor losses
(``diffusion_feature_extractor_*``, ``latent_feature_*``) and the train-step knobs
(``TrainStepConfig.from_train_config``). With ``AIT_PROFILE_DIR`` set, the
last step runs under ``torch.profiler``.
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
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora, count_lora_params, share_lora
from ai_toolkit_tpu_torch.adapters.quantize import quantized_bytes, quantized_count
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig, ProcessConfig, TrainConfig
from ai_toolkit_tpu_torch.data.caching import TextEmbedCache, cache_latents, cache_latents_to_disk
from ai_toolkit_tpu_torch.data.loader import build_dataloader
from ai_toolkit_tpu_torch.io.checkpoint import CheckpointManager
from ai_toolkit_tpu_torch.models.registry import get_model_class
from ai_toolkit_tpu_torch.samplers.factory import DDPM_NAMES, get_schedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer, lr_schedule
from ai_toolkit_tpu_torch.train.slider import GUIDANCE_KINDS, make_guidance_loss
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, eval_loss, make_train_step
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

# TrainConfig knobs read by the JAX process (not its step) that this path does not take
_UNPORTED_TRAIN = (
    "train_text_encoder", "free_u", "refiner_lr", "adapter_lr", "unet_lr",
    "text_encoder_lr", "do_blank_stabilization", "prompt_saturation_chance",
    "short_and_long_captions", "short_and_long_captions_encoder_split", "prompt_dropout_prob",
    "reg_weight", "img_multiplier", "latent_multiplier", "standardize_images",
    "merge_network_on_save", "learnable_snr_gos",
    # the frozen ControlNet / T2I assistant (ROADMAP Queue 1 item 6e)
    "adapter_assist_name_or_path",
    # the feature-extractor losses (ROADMAP Queue 1 item 6)
    "diffusion_feature_extractor_path", "diffusion_feature_extractor_weight",
    "latent_feature_extractor_path", "latent_feature_loss_weight",
)
_UNPORTED_MODEL = ("quantize_te", "lora_path", "assistant_lora_path",
                   "inference_lora_path", "unconditional_lora_path", "accuracy_recovery_adapter")


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
    """Process types ``sd_trainer`` / ``diffusion_trainer`` / ``ui_trainer``."""

    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        self.device = torch.device(device)
        self.save_root = os.path.join(cfg.training_folder, job_name)

    @property
    def textual_inversion(self) -> bool:
        return bool(self.cfg.embedding)

    @property
    def guidance_kind(self) -> str | None:
        """``guidance_loss`` of the train section, else of the process (JAX ``run``)."""
        return self.cfg.train.extras.get("guidance_loss") or self.cfg.extras.get("guidance_loss")

    @property
    def full_finetune(self) -> bool:
        if self.textual_inversion:
            return False
        return self.cfg.network is None or self.cfg.network.type in ("full", "fine_tune")

    def _refuse_unported(self) -> None:
        cfg, tc = self.cfg, self.cfg.train
        # before anything reads full_finetune: a file with an adapter and no network is no full fine-tune
        if cfg.adapter or cfg.slider:
            raise NotImplementedError("adapters / sliders come with later slices")
        if self.textual_inversion:
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
        elif not self.full_finetune and cfg.network.type not in ("lora", "locon"):
            raise NotImplementedError(f"network '{cfg.network.type}': only LoRA and the full fine-tune "
                                      f"are ported (other networks: later slices)")
        if self.full_finetune and cfg.model.quantize:
            raise NotImplementedError(
                "model.quantize with a full fine-tune comes with slice G (the JAX job trains only the "
                "weights that quantization leaves unquantized)")
        refuse_unported(tc, _UNPORTED_TRAIN, TrainConfig(), "train")
        if cfg.extras.get("adapter_assist_name_or_path"):
            raise NotImplementedError("adapter_assist_name_or_path: the assistant adapter comes with the adapters "
                                      "slice (ROADMAP Queue 1 item 6e)")
        kind = self.guidance_kind
        if kind == "concept_replacer":
            raise NotImplementedError("guidance_loss 'concept_replacer' needs the replacement prompts that only the "
                                      "concept_replacer job builds (ROADMAP Queue 1 item 6h)")
        if kind and kind not in GUIDANCE_KINDS:
            raise NotImplementedError(f"guidance_loss '{kind}' is no guidance kind of the JAX package "
                                      f"(ported: {list(GUIDANCE_KINDS)})")
        if kind and (self.textual_inversion or self.full_finetune):
            raise NotImplementedError(f"guidance_loss '{kind}' trains a LoRA network (the JAX step scales the "
                                      f"'lora' tree); give a network of type lora")
        refuse_unported(cfg.model, _UNPORTED_MODEL, ModelConfig(), "model")
        if cfg.model.quantize_kwargs:
            raise NotImplementedError("model.quantize_kwargs come with slice G")
        if not tc.train_unet:
            raise NotImplementedError("train_unet: false trains nothing the port has")
        model_cls = get_model_class(cfg.model.arch)
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

    def _refuse_control_options(self, model) -> None:
        """Control images only for an arch that takes control latents, the
        inpaint folder only for flex2 (in JAX it also feeds the control-LoRA
        adapter, a later slice)."""
        arch = self.cfg.model.arch
        for d in self.cfg.datasets:
            if d.control_path and not model.takes_control:
                raise NotImplementedError(
                    f"dataset {d.folder_path}: control_path on arch '{arch}', which takes no control latents "
                    f"(ported: flex2, flux_kontext, model_kwargs.control, qwen_image_edit, omnigen2; the control "
                    f"adapters: later slices)")
            if d.inpaint_path and arch != "flex2":
                raise NotImplementedError(f"dataset {d.folder_path}: inpaint_path feeds flex2's inpaint channels; "
                                          f"on arch '{arch}' it belongs to the control-LoRA adapter (later slice)")

    def run(self) -> dict:
        cfg, tc, dev = self.cfg, self.cfg.train, self.device
        self._refuse_unported()
        seed = tc.seed if tc.seed is not None else int(os.environ.get("SEED", 42))
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
        variables = model.load_variables(torch.Generator(device=dev).manual_seed(seed),
                                         qtype=cfg.model.qtype if cfg.model.quantize else None)
        _sync(dev)
        load_s = time.perf_counter() - t0
        print(f"model: {'loaded ' + cfg.model.name_or_path if cfg.model.name_or_path else 'seeded init'} "
              f"in {load_s:.2f} s")
        net = variables[model.main_component]
        experts = [variables[name] for name in model.experts]
        if cfg.model.quantize:
            print(f"quantized base: {sum(quantized_count(m) for m in experts)} weights, "
                  f"{sum(quantized_bytes(m) for m in experts) / 1e9:.2f} GB ({cfg.model.qtype})")
        if self.textual_inversion:
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
            spec = LoRASpec.from_network_config(cfg.network, target_patterns=model.lora_targets())
            lora = build_lora(net, spec, torch.Generator(device=dev).manual_seed(seed))
            for other in experts[1:]:
                share_lora(other, lora)
            n_params = count_lora_params(lora)
            print(f"LoRA: {len(lora)} modules, {n_params:,} trainable params (rank {spec.rank})")
            trainable = {f"{name}.{leaf}": p for name, m in lora.items() for leaf, p in m.named_parameters()}
        for m in experts:
            if hasattr(m, "gradient_checkpointing"):  # the DiT; the UNet follows model.remat_policy
                m.gradient_checkpointing = tc.gradient_checkpointing

        # 3. optimizer + state, the generator of t and the noise; resume
        # the bank alone trains at embedding_lr when it is set (the JAX job's "emb" optimizer group)
        base_lr = tc.embedding_lr if self.textual_inversion and tc.embedding_lr else tc.lr
        tx = get_optimizer(tc.optimizer, list(trainable.values()),
                           lr_schedule(tc.lr_scheduler, base_lr, tc.steps, tc.lr_scheduler_params),
                           tc.optimizer_params, tc.max_grad_norm)
        state = TrainState(trainable, tx, use_ema=tc.ema_config.use_ema)
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

        def predict_fn(noisy, t, cond):
            return predict(variables, noisy, t, cond)

        schedule = self._schedule()
        guidance = None
        if self.guidance_kind:
            if step_cfg.switch_every:
                raise NotImplementedError(f"guidance_loss '{self.guidance_kind}' on a switched multistage pair: "
                                          f"the JAX guidance step draws t over the whole range")
            weight = float(tc.extras.get("network_weight", 1.0))
            guidance = make_guidance_loss(self.guidance_kind, predict_fn, schedule, step_cfg.timestep_type, weight)
            print(f"guidance loss: {self.guidance_kind} (network_weight {weight})")
        train_step = make_train_step(predict_fn, schedule, step_cfg, micro_loss=guidance)
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
            if len(experts) > 1:
                experts_run.append(model.last_expert)
            if (step + 1) % cfg.logging.log_every == 0 or step == start_step:
                expert = f" expert={model.last_expert}" if len(experts) > 1 else ""
                print(f"step {step + 1}/{tc.steps} loss={loss:.4f} "
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
                "losses": losses, "step_ms": step_ms,
                "median_step_ms": statistics.median(step_ms) if step_ms else None,
                "trainable_params": n_params, "lora_modules": len(lora) if lora is not None else 0,
                "experts": experts_run, "buckets": buckets, "save_path": path, "load_s": load_s,
                "val_losses": val_losses,
                "latent_cache": self.latent_cache_report, "samples": self.samples}

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

    def _resume(self, ckpt: CheckpointManager, model, state: TrainState, lora: dict | None,
                generator: torch.Generator) -> int:
        """Restore the newest save and its training state; the step to go on
        from (0: a fresh run)."""
        from safetensors import safe_open

        path = ckpt.latest_save_path()
        if path is None:
            return 0
        if lora is not None:
            tree, step = ckpt.load_latest(module_names=list(lora),
                                          module_name=getattr(model, "lora_module_name", None))
            saved = {f"{n}.{leaf}": t for n, leaves in tree.items() for leaf, t in leaves.items()}
        elif self.textual_inversion:
            saved = {"emb": torch.from_numpy(load_embedding(path))}
            with safe_open(path, framework="pt") as f:
                step = int((f.metadata() or {}).get("step", 0))
        else:
            with safe_open(path, framework="pt") as f:
                saved = {k: f.get_tensor(k) for k in f.keys()}
                step = int((f.metadata() or {}).get("step", 0))
        cur = {k: tuple(p.shape) for k, p in state.trainable.items()}
        if {k: tuple(t.shape) for k, t in saved.items()} != cur:
            print("resume checkpoint has different network shape — starting fresh "
                  "(reference skips the optimizer in this case too)")
            return 0
        with torch.no_grad():
            for k, p in state.trainable.items():
                p.copy_(saved[k])
        extra, state_step = ckpt.load_state()
        restored = False
        if extra is not None and state_step == step:
            rng = extra.pop("rng", None)
            host_rng = extra.pop("flex2_rng", None)
            restored = state.load_state_dict(extra)
            if restored and rng is not None:
                generator.set_state(rng)
            if restored and host_rng is not None:
                self._flex2_rng = np.random.default_rng()
                self._flex2_rng.bit_generator.state = json.loads(bytes(host_rng.numpy()).decode())
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
        if self.textual_inversion:
            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            src = state.ema if state.ema is not None else state.trainable
            save_embedding(src["emb"].detach().float().cpu().numpy(), path, name=self.ti_trigger, step=step)
        elif lora is not None:
            src = state.ema if state.ema is not None else state.trainable
            tree = {name: {leaf: src[f"{name}.{leaf}"] for leaf in ("a", "b", "scale")} for name in lora}
            path = ckpt.save(tree, step, final=final)
        else:
            from safetensors.torch import save_file

            path = ckpt.final_path() if final else ckpt.path_for_step(step)
            save_file({k: t.detach().contiguous().cpu() for k, t in state.trainable.items()}, path,
                      metadata={"step": str(step), "software": "ai_toolkit_tpu"})
        host = {}
        if getattr(self, "_flex2_rng", None) is not None:
            host["flex2_rng"] = torch.frombuffer(bytearray(json.dumps(self._flex2_rng.bit_generator.state).encode()),
                                                 dtype=torch.uint8)
        ckpt.save_state({**state.state_dict(), "rng": generator.get_state(), **host}, step)
        return path

    def _sample(self, model, variables: dict, state: TrainState, lora: dict | None, step: int) -> None:
        """Every sample prompt through ``generation.generate`` (JAX
        ``_sample``), with the EMA copy of the LoRA when EMA is on (a
        textual inversion's bank as it is trained, as in JAX), to
        ``<save_root>/samples/<name>_<step:09d>_<i>.<ext>``. Raises when a
        sample fails."""
        from ai_toolkit_tpu_torch.generation import generate, save_image_atomic, save_video_atomic, save_wav_atomic

        cfg = self.cfg
        sample_dir = os.path.join(self.save_root, "samples")
        swap = lora is not None and state.ema is not None
        raw = {k: p.detach().clone() for k, p in state.trainable.items()} if swap else {}
        with torch.no_grad():
            for k in raw:
                state.trainable[k].copy_(state.ema[k])
        try:
            for i, item in enumerate(cfg.sample.prompts):
                seed = cfg.sample.seed + (i if cfg.sample.walk_seed else 0)
                gen = GenerateImageConfig.from_sample(cfg.sample, item, seed)
                _sync(self.device)
                t0 = time.perf_counter()
                out = generate(model, variables, gen)
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

        @torch.no_grad()
        def encode_fn(imgs: np.ndarray) -> np.ndarray:
            self.latent_cache_report["encode_calls"] += 1
            lat = model.encode_images(variables, torch.from_numpy(imgs))
            return lat.float().cpu().numpy()

        self.latent_cache_report = {"encode_calls": 0}
        to_disk = any(d.cache_latents_to_disk for d in cfg.datasets)
        if all(d.cache_latents or d.cache_latents_to_disk for d in cfg.datasets):
            # JAX _build_data: the disk cache when any dataset asks for it, else in memory
            cache_dir = os.path.join(self.save_root, "latent_cache") if to_disk else None
            loader = build_dataloader(cfg.datasets, cfg.train.batch_size, model.bucket_divisibility,
                                      trigger_word=cfg.trigger_word, latent_cache={} if cache_dir is None else None,
                                      latent_cache_dir=cache_dir)
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
                                      trigger_word=cfg.trigger_word, encode_fn=encode_fn)

        @torch.no_grad()
        def encode_prompt(prompts: list[str]) -> dict:
            return model.encode_prompt(variables, prompts)

        return loader, TextEmbedCache(encode_prompt)

    def _prepare_batch(self, model, variables: dict, raw: dict, text_cache: TextEmbedCache) -> dict:
        dev = self.device
        if self.textual_inversion:  # raw token ids: CLIP runs inside the step, so the bank trains
            ids = np.stack([model.tokenizer.encode(c) for c in raw["captions"]])
            cond = {"input_ids": torch.from_numpy(ids).long().to(dev)}
        else:
            cond = dict(text_cache.get(raw["captions"]))
        if raw.get("first_frame") is not None:  # i2v: the clip's first frame through the vision tower
            with torch.no_grad():
                cond["img_cond"] = model.encode_image_cond(variables, torch.from_numpy(raw["first_frame"]))
        latents = torch.from_numpy(raw["latents"]).to(dev)
        batch = {"latents": latents, "cond": cond,
                 "loss_multiplier": torch.from_numpy(raw["loss_multiplier"]).to(dev)}
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
            return batch
        if latents.dim() == 5:  # video latents [B, T, h, w, C]: rope over (t, y, x)
            tt, h, w = latents.shape[1:4]
            cond["pe"] = model.rope_table(tt, h, w)
            pt, ph, pw = model.dit_config.patch_size
            batch["image_seq_len"] = (tt // pt) * (h // ph) * (w // pw)
            return batch
        b, h, w, _ = latents.shape
        if model.is_flow_matching:
            cond["pe"] = model.rope_table(h, w, int(cond["txt"].shape[1]))
            cond["guidance"] = torch.full((b,), 1.0, dtype=torch.float32, device=dev)
            batch["image_seq_len"] = (h // 2) * (w // 2)
        elif "pooled" in cond:  # SDXL: the added condition from the bucket's pixel size
            d = model.vae_config.downscale
            cond["added_cond"] = model.added_cond(cond.pop("pooled"), h * d, w * d)
        if self.cfg.model.arch == "flex2":
            # [inpaint latents, inpaint mask, control latents] with the per-batch dropouts, on the host
            if getattr(self, "_flex2_rng", None) is None:
                self._flex2_rng = np.random.default_rng(1234)
            ctrl = raw.get("control_pixels")
            ctrl_lat = None if ctrl is None else self._encode_control(model, variables, ctrl).float().cpu().numpy()
            cond["control_latents"] = torch.from_numpy(model.assemble_flex2_control(
                raw["latents"], raw.get("inpaint_keep"), ctrl_lat, self._flex2_rng)).to(dev)
        elif model.takes_control:
            if "control_pixels" not in raw:
                if model.control_optional:  # OmniGen2: no references in this batch
                    return batch
                raise ValueError(f"arch '{self.cfg.model.arch}' takes a control image and no item of this "
                                 f"{raw['bucket']} batch has one (give each image one in the dataset's control_path)")
            cond["control_latents"] = self._encode_control(model, variables, raw["control_pixels"])
        return batch

    @staticmethod
    @torch.no_grad()
    def _encode_control(model, variables: dict, pixels: np.ndarray) -> torch.Tensor:
        """Control images ``[B, H, W, 3]`` through the VAE (its posterior
        mode), every batch, as JAX ``_encode_control`` does."""
        return model.encode_images(variables, torch.from_numpy(pixels))
