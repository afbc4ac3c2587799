"""Typed job-config sections (the port's copy of ``ai_toolkit_tpu/config/modules.py``).

Schema parity with the reference's ``toolkit/config_modules.py`` (the YAML keys a
user writes are the same), implemented as plain dataclasses with tolerant
``from_dict`` constructors: unknown keys are preserved in ``extras`` rather than
crashing, so configs written for the reference load here unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


# Reference knobs that are deliberate no-ops in the TPU runtime (hardware or
# backend concepts with no analog). These load silently; everything ELSE that
# lands in ``extras`` triggers a warning (or an error with AIT_STRICT_CONFIG=1)
# so features never silently vanish.
_TPU_NA_KEYS = {
    # torch/cuda backend toggles
    "xformers", "sdp", "attention_backend", "low_vram", "device", "gpu_ids",
    "use_flash_attention", "compile", "torch_compile", "cpu_offload",
    "layer_offloading", "layer_offloading_transformer_percent",
    "layer_offloading_text_encoder_percent",
    # trainer-internal bookkeeping keys some configs carry
    "orig_batch_size", "num_workers_dataloader",
    # torch device/dtype placement + torch.compile knobs: XLA jit compiles
    # the whole step and the mesh handles placement, so these have no TPU
    # meaning (reference ModelConfig.{vae,te}_device/dtype, compile_*)
    "vae_device", "vae_dtype", "te_device", "te_dtype",
    "split_model_over_gpus", "auto_memory", "compile_mode",
    "compile_fullgraph", "compile_dynamic", "cache_size_limit",
    "unet_sample_size", "latent_space_version", "experimental_xl",
}


# keys some subsystems intentionally read FROM extras (our extension points)
_CONSUMED_EXTRAS = {
    "process": {"guidance_loss", "adapter_assist_name_or_path", "slider",
                "replacements", "caption"},
    "train": {"guidance_loss", "scheduler_params", "network_weight",
              "weighting_table"},
    "sample": {"sample_rate"},
}

# non-trainer process types read their own keys straight from process extras
_TRAINER_TYPES = {"sd_trainer", "ui_trainer", "diffusion_trainer", "slider",
                  "concept_slider", "textual_inversion"}


def unconsumed_keys(proc) -> list[tuple[str, str]]:
    """Every (section, key) a loaded config carries that nothing consumes."""
    out: list[tuple[str, str]] = []

    def scan(name, obj):
        ok = _CONSUMED_EXTRAS.get(name, set())
        for k in (getattr(obj, "extras", None) or {}):
            if k not in _TPU_NA_KEYS and k not in ok:
                out.append((name, k))

    if getattr(proc, "type", "") in _TRAINER_TYPES:
        scan("process", proc)
    for name in ("save", "train", "model", "sample", "logging", "validation", "mesh"):
        scan(name, getattr(proc, name, None))
    scan("train.ema_config", getattr(proc.train, "ema_config", None))
    for i, d in enumerate(getattr(proc, "datasets", []) or []):
        scan(f"datasets[{i}]", d)
    return out


def warn_unconsumed(proc, source: str = "") -> None:
    """Print one warning per unapplied knob; raise under AIT_STRICT_CONFIG=1.

    Round-2 honesty fix: the reference's ~120 TrainConfig knobs can't all be
    implemented at once, but a knob that silently no-ops is worse than a
    crash — a user's config "loads" while features quietly vanish."""
    import os

    keys = unconsumed_keys(proc)
    if not keys:
        return
    where = f" in {source}" if source else ""
    for section, key in keys:
        print(f"config warning{where}: '{section}.{key}' is not implemented "
              f"and will be IGNORED (see docs/PARITY.md for the knob matrix)")
    if os.environ.get("AIT_STRICT_CONFIG") == "1":
        raise ValueError(
            f"unimplemented config keys (AIT_STRICT_CONFIG=1): "
            f"{[f'{s}.{k}' for s, k in keys]}"
        )


def _build(cls, data: dict[str, Any] | None):
    data = dict(data or {})
    names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in data.items() if k in names}
    extras = {k: v for k, v in data.items() if k not in names and k != "extras"}
    obj = cls(**known)
    # unknown keys are tolerated as extras; an explicit `extras:` mapping in
    # the config merges with (and loses to) them
    explicit = getattr(obj, "extras", None) or {}
    obj.extras = {**explicit, **extras}
    return obj


@dataclass
class SaveConfig:
    """Mirrors reference SaveConfig (toolkit/config_modules.py)."""

    dtype: str = "float16"
    save_every: int = 250
    max_step_saves_to_keep: int = 4
    save_format: str = "safetensors"
    push_to_hub: bool = False
    hf_repo_id: str | None = None
    hf_private: bool = True
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "SaveConfig":
        return _build(cls, d)


@dataclass
class LoggingConfig:
    log_every: int = 100
    verbose: bool = False
    use_wandb: bool = False
    use_tensorboard: bool = True
    project_name: str = "ai-toolkit-tpu"
    run_name: str | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "LoggingConfig":
        return _build(cls, d)


@dataclass
class SampleItem:
    prompt: str = ""
    negative_prompt: str = ""
    width: int | None = None
    height: int | None = None
    seed: int | None = None
    guidance_scale: float | None = None
    sample_steps: int | None = None
    network_multiplier: float = 1.0
    num_frames: int | None = None
    fps: int | None = None
    ctrl_img: str | None = None
    # extra reference images for multi-control edit archs (reference
    # gen_config.ctrl_img_1/2/3, qwen_image_edit_plus.py:105-122)
    ctrl_img_2: str | None = None
    ctrl_img_3: str | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_any(cls, item: "str | dict[str, Any] | SampleItem") -> "SampleItem":
        if isinstance(item, SampleItem):
            return item
        if isinstance(item, str):
            return cls._from_prompt_string(item)
        return _build(cls, item)

    @classmethod
    def _from_prompt_string(cls, prompt: str) -> "SampleItem":
        """Parse the reference's inline ``--flag value`` prompt syntax.

        e.g. ``"a cat --w 768 --h 512 --seed 7 --cfg 3.5 --steps 12 --n bad"``
        (cf. GenerateImageConfig._process_prompt_string,
        toolkit/config_modules.py:1363).
        """
        out = cls()
        if "--" not in prompt:
            out.prompt = prompt.strip()
            return out
        parts = prompt.split("--")
        out.prompt = parts[0].strip()
        for chunk in parts[1:]:
            chunk = chunk.strip()
            if not chunk:
                continue
            key, _, val = chunk.partition(" ")
            val = val.strip()
            if key == "w":
                out.width = int(val)
            elif key == "h":
                out.height = int(val)
            elif key == "seed":
                out.seed = int(val)
            elif key in ("cfg", "gs"):
                out.guidance_scale = float(val)
            elif key == "steps":
                out.sample_steps = int(val)
            elif key == "n":
                out.negative_prompt = val
            elif key == "m":
                out.network_multiplier = float(val)
            elif key == "frames":
                out.num_frames = int(val)
            elif key == "fps":
                out.fps = int(val)
            elif key in ("ctrl_img", "ctrl_img_1"):
                out.ctrl_img = val
            elif key == "ctrl_img_2":
                out.ctrl_img_2 = val
            elif key == "ctrl_img_3":
                out.ctrl_img_3 = val
            else:
                out.extras[key] = val
        return out


@dataclass
class SampleConfig:
    sampler: str = "flowmatch"
    sample_every: int = 250
    sample_start_step: int = 0
    width: int = 512
    height: int = 512
    prompts: list[Any] = field(default_factory=list)
    neg: str = ""
    seed: int = 42
    walk_seed: bool = True
    guidance_scale: float = 4.0
    sample_steps: int = 20
    network_multiplier: float = 1.0
    num_frames: int = 1
    fps: int = 16
    format: str = "png"
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "SampleConfig":
        obj = _build(cls, d)
        if not obj.prompts and "samples" in obj.extras:
            # UI-style configs use `samples: [{prompt: ...}]`
            obj.prompts = obj.extras.pop("samples") or []
        obj.prompts = [SampleItem.from_any(p) for p in obj.prompts]
        return obj


@dataclass
class NetworkConfig:
    """LoRA / LyCORIS / full-tune network settings (reference NetworkConfig)."""

    type: str = "lora"
    linear: int = 16  # rank
    linear_alpha: float = 16.0
    conv: int | None = None
    conv_alpha: float | None = None
    dropout: float | None = None
    network_kwargs: dict[str, Any] = field(default_factory=dict)
    # targeting (reference: only_if_contains / ignore_if_contains in network_kwargs)
    only_if_contains: list[str] | None = None
    ignore_if_contains: list[str] | None = None
    transformer_only: bool = False
    lokr_full_rank: bool = False
    lokr_factor: int = -1
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "NetworkConfig | None":
        if d is None:
            return None
        obj = _build(cls, d)
        kw = obj.network_kwargs or {}
        if obj.only_if_contains is None:
            obj.only_if_contains = kw.get("only_if_contains")
        if obj.ignore_if_contains is None:
            obj.ignore_if_contains = kw.get("ignore_if_contains")
        if obj.type == "locon":
            # reference NetworkType 'locon' == LoRA with conv modules
            # (lora_special.py LoConModule targeting); identical here once
            # a conv rank is set
            obj.type = "lora"
            if obj.conv is None:
                obj.conv = obj.linear
        # 'lorm' (low-rank module REPLACEMENT, reference toolkit/lorm.py) is
        # supported since r5: targeted kernels are SVD-factored into a
        # trainable 'lorm' collection and the base kernels are dropped
        # (adapters/lorm.py); extract knobs ride in network_kwargs
        # (lorm_extract_mode / lorm_extract_mode_param / parameter_threshold,
        # mirroring BaseSDTrainProcess.py:209-211 + LoRMConfig).
        return obj

    @property
    def rank(self) -> int:
        return int(self.linear)

    @property
    def alpha(self) -> float:
        return float(self.linear_alpha)


@dataclass
class EMAConfig:
    use_ema: bool = False
    ema_decay: float = 0.99
    use_feedback: bool = False
    param_multiplier: float = 1.0
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "EMAConfig":
        return _build(cls, d)


@dataclass
class MeshConfig:
    """TPU-native addition: named-mesh layout for the train step.

    No reference equivalent — replaces Accelerate DP + the flux GPU splitter
    (toolkit/models/flux.py:121) with jax.sharding.
    ``axes`` maps axis name -> size; -1 means "fill with remaining devices".
    """

    axes: dict[str, int] = field(default_factory=lambda: {"dp": 1, "fsdp": -1, "tp": 1})
    axis_order: tuple[str, ...] = ()
    extras: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.axis_order and isinstance(self.axes, dict):
            self.axis_order = tuple(self.axes.keys())

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "MeshConfig":
        obj = _build(cls, d)
        if isinstance(obj.axes, dict):
            obj.axis_order = tuple(obj.axes.keys())
        return obj


@dataclass
class TrainConfig:
    """Training loop knobs (reference TrainConfig, ~120 keys)."""

    batch_size: int = 1
    steps: int = 1000
    start_step: int | None = None
    gradient_accumulation_steps: int = 1
    gradient_accumulation: int = 1  # alias used by some reference configs
    train_unet: bool = True
    train_text_encoder: bool = False
    gradient_checkpointing: bool = True
    noise_scheduler: str = "flowmatch"
    timestep_type: str = "sigmoid"  # sigmoid | linear | shift | flux_shift | weighted | lognorm_blend | one_step
    timestep_bias: float = 1.0
    content_or_style: str = "balanced"
    # reg-batch override; the reference declares this but (bug) reads the
    # content_or_style key for it — we honor an explicit value, defaulting
    # to content_or_style (config_modules.py:378-379)
    content_or_style_reg: str | None = None
    do_differential_guidance: bool = False
    differential_guidance_scale: float = 3.0
    # pick the closest of K candidate noises per sample (reference
    # get_optimal_noise, BaseSDTrainProcess.py:953-968)
    optimal_noise_pairing_samples: int = 1
    # per-image deterministic noise seeded by the file path (reference
    # get_consistent_noise, BaseSDTrainProcess.py:971-988)
    force_consistent_noise: bool = False
    # noise-shaping family (BaseSDTrainProcess.py:1324-1385)
    dynamic_noise_offset: bool = False
    do_signal_correction_noise: bool = False
    signal_correction_noise_scale: float = 1.0
    do_batch_noise_correction: bool = False
    batch_noise_correction_scale: float = 1.0
    random_noise_shift: float = 0.0
    random_noise_multiplier: float = 0.0
    # output/target shaping (SDTrainer.py:520-526, 995-999)
    pred_scaler: float = 1.0
    target_noise_multiplier: float = 1.0
    target_norm_std: bool = False
    target_norm_std_value: float = 1.0
    adaptive_scaling_factor: bool = False
    min_denoising_steps: int = 0
    max_denoising_steps: int | None = None
    # SDXL refiner training (reference config_modules.py:384,402 +
    # BaseSDTrainProcess.py:1168-1175): with train_unet the batch halves are
    # routed base/refiner across refiner_start_at; without, all timesteps
    # land in the refiner range and only the refiner trains
    train_refiner: bool = True
    refiner_lr: float | None = None
    # one-big-step turbo/LCM-style training (SDTrainer.py:398-478): euler-
    # ancestral step to a random later sigma, residual noise removed, decoded
    # to pixels, pixel-space loss (ddpm schedules only)
    # blank-prompt samples train against zeroed latents
    # (BaseSDTrainProcess.py:1397-1402)
    do_blank_stabilization: bool = False
    train_turbo: bool = False
    show_turbo_outputs: bool = False
    # repeat short captions to saturate ~77 tokens with some probability
    # (BaseSDTrainProcess.py:1076-1082); non-reg batches only
    prompt_saturation_chance: float = 0.0
    # dual-caption training (BaseSDTrainProcess.py:1037-1044 + 1433-1451):
    # non-reg batches double up — every image trains against its long AND its
    # short caption (same latents/noise/timesteps for both halves)
    short_and_long_captions: bool = False
    # SDXL only, alternative to the above (config_modules.py:470-471): the
    # short caption feeds TE1 (CLIP-L) and the long caption TE2 (CLIP-G)
    # (SDTrainer.py:1528-1532)
    short_and_long_captions_encoder_split: bool = False
    # hold the adapter's blank-prompt output at the base model's
    blank_prompt_preservation: bool = False
    blank_prompt_preservation_multiplier: float = 1.0
    # prompt used for the unconditional side of guidance losses / train-CFG
    unconditional_prompt: str = ""
    do_guidance_loss_cfg_zero: bool = False  # CFG-Zero* anchor projection
    guidance_loss_schedule: str = "constant"  # constant | sigma
    match_adapter_chance: float = 0.0  # prior keeps assist residuals w/ prob
    free_u: bool = False  # FreeU skip/backbone modulation on the train forward
    adapter_lr: float | None = None  # per-group LR for adapter collections
    embedding_lr: float | None = None  # per-group LR for textual-inversion bank
    # flow target becomes noise - latents*(1 + (1-t)*strength)
    # (reference do_signal_amplification, SDTrainer.py:594-603)
    do_signal_amplification: bool = False
    signal_amplification_strength: float = 1.0
    next_sample_timesteps: int | None = None  # K-step ladder for next_sample
    max_loss_debug: bool = False  # print when max_loss zeroes a batch
    optimizer: str = "adamw"
    optimizer_params: dict[str, Any] = field(default_factory=dict)
    lr: float = 1e-4
    unet_lr: float | None = None
    text_encoder_lr: float | None = None
    embedding_lr: float | None = None
    lr_scheduler: str = "constant"
    lr_scheduler_params: dict[str, Any] = field(default_factory=dict)
    max_grad_norm: float = 1.0
    dtype: str = "bf16"
    weight_dtype: str | None = None
    noise_offset: float = 0.0
    noise_multiplier: float = 1.0
    num_train_timesteps: int = 1000
    min_snr_gamma: float | None = None
    snr_gamma: float | None = None
    # learnable SNR loss balancing (reference learnable_snr_gos)
    learnable_snr_gos: bool = False
    loss_type: str = "mse"  # mse | mae | pseudo_huber | wavelet | stepped | mean_flow
    loss_target: str | None = None
    # x0-space losses (reference SDTrainer.py:836-870): step the velocity pred
    # to a t=0 latent and regress it against the clean latents
    t0_loss_target: bool = False
    t0_velocity_equiv_weight: bool = False
    # auxiliary FFT-magnitude loss on the stepped t=0 prediction
    do_fft_loss: bool = False
    do_fft_velocity_equiv_weight: bool = False
    pseudo_huber_c: float = 0.001
    ema_config: EMAConfig = field(default_factory=EMAConfig)
    skip_first_sample: bool = False
    disable_sampling: bool = False
    force_first_sample: bool = False
    linear_timesteps: bool = False
    linear_timesteps2: bool = False
    do_cfg: bool = False
    cfg_scale: float = 1.0
    do_random_cfg: bool = False  # sample cfg_scale ~ U(1, max_cfg_scale) per step
    max_cfg_scale: float = 4.0
    cfg_rescale: float = 0.0  # std-matching rescale of the CFG-combined pred
    negative_prompt: str | None = None  # train-time CFG negative
    max_negative_prompts: int = 1
    prompt_dropout_prob: float = 0.0  # chance a caption trains unconditionally
    unload_text_encoder: bool = False
    cache_text_embeddings: bool = False
    diff_output_preservation: bool = False
    diff_output_preservation_multiplier: float = 1.0
    diff_output_preservation_class: str = ""
    prior_divergence_loss: bool = False
    mask_loss_multiplier: float = 1.0  # masked-loss weighting
    inverted_mask_prior: bool = False
    inverted_mask_prior_multiplier: float = 0.5
    do_prior_divergence: bool = False
    random_scale: bool = False
    match_noise_norm: bool = False
    loss_multiplier: float = 1.0
    reg_weight: float = 1.0  # loss scale for is_reg datasets
    img_multiplier: float = 1.0  # scales pixels before VAE encode
    latent_multiplier: float = 1.0  # scales cached/encoded latents
    noisy_latent_multiplier: float = 1.0  # scales the noised model input
    standardize_images: bool = False  # per-sample mean0/std1 before encode
    standardize_latents: bool = False  # per-sample mean0/std1 on latents
    max_loss: float | None = None  # skip updates whose loss exceeds this
    audio_loss_multiplier: float = 1.0  # joint-AV audio stream loss weight
    correct_pred_norm: bool = False
    correct_pred_norm_multiplier: float = 1.0
    # multistage (wan22): which expert trains alternates every N steps, with
    # timesteps drawn from that expert's noise range
    switch_boundary_every: int = 1
    adapter_assist_name_or_path: str | None = None
    adapter_assist_type: str = "t2i"
    merge_network_on_save: bool = False  # also export the merged full model
    merge_network_on_save_strength: float = 1.0
    # automagic: rotate updates over a param subset (reference automagic.py)
    do_paramiter_swapping: bool = False
    paramiter_swapping_factor: float = 0.1
    diffusion_feature_extractor_path: str | None = None
    diffusion_feature_extractor_weight: float = 1.0
    latent_feature_extractor_path: str | None = None
    latent_feature_loss_weight: float = 1.0
    blended_blur_noise: bool = False
    do_guidance_loss: bool = False
    guidance_loss_target: float = 1.0
    performance_log_every: int = 0
    dynamic_timestep_shifting: bool = False
    bypass_guidance_embedding: bool = False
    seed: int | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "TrainConfig":
        d = dict(d or {})
        ema = d.pop("ema_config", None)
        obj = _build(cls, d)
        obj.ema_config = EMAConfig.from_dict(ema)
        if obj.gradient_accumulation_steps == 1 and obj.gradient_accumulation > 1:
            obj.gradient_accumulation_steps = obj.gradient_accumulation
        if obj.min_snr_gamma is None and obj.snr_gamma is not None:
            obj.min_snr_gamma = obj.snr_gamma
        return obj


@dataclass
class ModelConfig:
    """Model selection + load-time options (reference ModelConfig, ~60 keys)."""

    name_or_path: str = ""
    arch: str | None = None
    # reference legacy arch flags
    is_flux: bool = False
    is_xl: bool = False
    is_v2: bool = False
    is_v3: bool = False
    is_pixart: bool = False
    is_pixart_sigma: bool = False
    is_auraflow: bool = False
    is_lumina2: bool = False
    is_ssd: bool = False
    is_vega: bool = False
    # merge a LoRA into the base weights at load (reference ModelConfig
    # lora_path, stable_diffusion_model load_model)
    lora_path: str | None = None
    # alias of text_encoder_path in newer reference configs
    te_name_or_path: str | None = None
    # SDXL: gate which text encoder trains (reference param filtering)
    use_text_encoder_1: bool = True
    use_text_encoder_2: bool = True
    # load the diffusion core from a different checkpoint dir than
    # name_or_path (reference ModelConfig.unet_path)
    unet_path: str | None = None
    # flux: sample with a real negative-prompt CFG pass instead of the
    # distilled guidance embedding alone (reference use_flux_cfg)
    use_flux_cfg: bool = False
    # kept for metadata parity (reference stores the pre-resolution path)
    name_or_path_original: str | None = None
    is_v_pred: bool = False  # v-prediction fine-tune (sd2-768 style)
    quantize: bool = False
    quantize_te: bool = False
    qtype: str = "qfloat8"
    qtype_te: str = "qfloat8"
    # accuracy recovery adapter: a frozen LoRA shipped with a quantized base
    # that compensates the quantization error (reference
    # config_modules.py:739-743; parsed from ``qtype: "<q>|<path>"`` too)
    accuracy_recovery_adapter: str | None = None
    quantize_kwargs: dict[str, Any] = field(default_factory=dict)
    text_encoder_bits: int = 16  # 8 -> quantize the TE
    low_vram: bool = False
    attn_masking: bool = False
    model_kwargs: dict[str, Any] = field(default_factory=dict)
    vae_path: str | None = None
    refiner_name_or_path: str | None = None
    # fraction of the schedule where the refiner takes over (reference
    # config_modules.py:95,649)
    refiner_start_at: float = 0.5
    text_encoder_path: str | None = None
    # aux component dir (reference: wan vae path etc.)
    extras_name_or_path: str | None = None
    assistant_lora_path: str | None = None
    inference_lora_path: str | None = None
    # LoRA that is active ONLY on the unconditional (negative) CFG pass at
    # sampling time, never trained (reference ideogram4.py:276-355 +
    # src/pipeline.py:381-395)
    unconditional_lora_path: str | None = None
    # accepted for config compatibility, no behavior BY DESIGN: the reference
    # parses these (config_modules.py:760-762) but contains zero consumers —
    # not the trainer, not the model plugins, not the UI. supports_model_paths
    # is set by three archs (ltx2/anima/minimax_h3) and never read.
    model_paths: dict[str, Any] = field(default_factory=dict)
    in_context: bool = False
    # full fine-tune param filters (reference model.only_if_contains,
    # train_full_fine_tune_flex.yaml:78)
    only_if_contains: list[str] | None = None
    ignore_if_contains: list[str] | None = None
    dtype: str | None = None  # reference alias for the weights dtype
    # TPU-native additions
    param_dtype: str = "bf16"
    remat_policy: str = "block"  # none | block | full
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "ModelConfig":
        obj = _build(cls, d)
        if obj.dtype:
            obj.param_dtype = obj.dtype
        if obj.text_encoder_bits and obj.text_encoder_bits <= 8:
            obj.quantize_te = True
        if obj.qtype and "|" in obj.qtype:
            # reference config_modules.py:741-743: qtype "<q>|<ara_path>"
            obj.qtype, obj.accuracy_recovery_adapter = obj.qtype.split("|", 1)
        if obj.accuracy_recovery_adapter and obj.assistant_lora_path:
            raise ValueError(
                "Cannot use accuracy recovery adapter and assistant lora at "
                "the same time (reference config_modules.py:1479)."
            )
        if obj.arch is None:
            # map legacy flags to arch ids (reference toolkit/config_modules.py:623-821)
            if obj.is_flux:
                obj.arch = "flux"
            elif obj.is_xl:
                obj.arch = "sdxl"
            elif obj.is_v3:
                obj.arch = "sd3"
            elif obj.is_lumina2:
                obj.arch = "lumina2"
            elif obj.is_pixart_sigma:
                obj.arch = "pixart_sigma"
            elif obj.is_pixart:
                obj.arch = "pixart"
            elif obj.is_auraflow:
                obj.arch = "auraflow"
            elif obj.is_ssd:
                obj.arch = "ssd"
            elif obj.is_vega:
                obj.arch = "vega"
            elif obj.is_v2:
                obj.arch = "sd2"
            else:
                obj.arch = "sd1"
        if obj.name_or_path_original is None:
            obj.name_or_path_original = obj.name_or_path
        if obj.te_name_or_path and not obj.text_encoder_path:
            obj.text_encoder_path = obj.te_name_or_path
        return obj


@dataclass
class ValidationConfig:
    validate_every: int = 0
    num_samples: int = 8
    seed: int = 123
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "ValidationConfig":
        return _build(cls, d)


@dataclass
class DatasetConfig:
    """One dataset entry (reference DatasetConfig, ~70 keys)."""

    folder_path: str = ""
    dataset_path: str | None = None
    caption_ext: str = "txt"
    # json caption files: take 'caption_short' as THE caption
    # (reference dataloader_mixins.py:333-337)
    use_short_captions: bool = False
    caption_dropout_rate: float = 0.0
    caption_shuffle: bool = False
    shuffle_tokens: bool = False
    keep_tokens: int = 0
    token_dropout_rate: float = 0.0
    trigger_word: str | None = None
    default_caption: str = ""
    resolution: Any = 512  # int or list[int]
    bucket_tolerance: int = 64
    enable_bucketing: bool = True
    cache_latents: bool = True
    cache_latents_to_disk: bool = True
    cache_clip_vision_to_disk: bool = False
    is_reg: bool = False
    network_weight: float = 1.0
    loss_multiplier: float = 1.0
    flip_x: bool = False
    flip_y: bool = False
    # albumentations-style augmentation specs (reference DatasetConfig
    # .augmentations, config_modules.py:1013): [{method: ..., params: {...}}];
    # applied host-side by data/augmentations.py, incompatible with latent
    # caching (the reference raises too)
    augmentations: list | None = None
    shuffle_augmentations: bool = False
    replay_transforms: bool = True  # replay spatial ops onto controls/masks
    clip_image_augmentations: list | None = None
    clip_image_shuffle_augmentations: bool = False
    random_crop: bool = False
    random_scale: bool = False
    alpha_mask: bool = False
    mask_path: str | None = None
    # inpainting condition images (flex2): RGBA alpha = keep area, or
    # grayscale where white marks the inpaint region (reference
    # DatasetConfig.inpaint_path, config_modules.py:983)
    inpaint_path: str | None = None
    unconditional_path: str | None = None  # paired negative images (sliders)
    mask_min_value: float = 0.0
    # paired vision-encoder images (IP-adapter/redux: same stem, any ext;
    # reference dataloader clip_image_path)
    clip_image_path: str | None = None
    control_path: Any = None
    # auto-generated control maps (reference DatasetConfig.controls,
    # config_modules.py:1070): e.g. ["depth", "line", "inpaint"]
    controls: list = field(default_factory=list)
    num_repeats: int = 1
    num_workers: int = 4
    buckets: bool = True
    # video
    num_frames: int = 1
    fps: int | None = None
    shrink_video_to_frames: bool = True
    do_i2v: bool = False
    # audio
    audio_sample_rate: int = 44100
    audio_duration: float | None = None
    # joint AV training (LTX-2): load sidecar audio (<stem>.wav/.flac) for
    # each video (reference DatasetConfig.do_audio)
    do_audio: bool = False
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "DatasetConfig":
        obj = _build(cls, d)
        if not obj.folder_path and obj.dataset_path:
            obj.folder_path = obj.dataset_path
        if isinstance(obj.resolution, (int, float)):
            obj.resolution = [int(obj.resolution)]
        else:
            obj.resolution = [int(r) for r in obj.resolution]
        return obj


@dataclass
class GenerateImageConfig:
    """One generation request resolved against SampleConfig defaults."""

    prompt: str = ""
    negative_prompt: str = ""
    width: int = 512
    height: int = 512
    seed: int = 42
    guidance_scale: float = 4.0
    sample_steps: int = 20
    network_multiplier: float = 1.0
    num_frames: int = 1
    fps: int = 16
    output_path: str | None = None
    output_ext: str = "png"
    sampler: str | None = None  # ddim | euler_a | dpmpp_2m | flowmatch ...
    ctrl_img: str | None = None  # control/edit image for control archs
    ctrl_img_2: str | None = None
    ctrl_img_3: str | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_sample(
        cls, sample: SampleConfig, item: SampleItem, seed: int, output_path: str | None = None
    ) -> "GenerateImageConfig":
        return cls(
            prompt=item.prompt,
            negative_prompt=item.negative_prompt or sample.neg,
            width=item.width or sample.width,
            height=item.height or sample.height,
            seed=item.seed if item.seed is not None else seed,
            guidance_scale=(
                item.guidance_scale if item.guidance_scale is not None else sample.guidance_scale
            ),
            sample_steps=(
                item.sample_steps if item.sample_steps is not None else sample.sample_steps
            ),
            network_multiplier=item.network_multiplier,
            num_frames=item.num_frames or sample.num_frames,
            fps=item.fps or sample.fps,
            output_path=output_path,
            output_ext=sample.format,
            sampler=sample.sampler,
            ctrl_img=item.ctrl_img if hasattr(item, "ctrl_img") else None,
            ctrl_img_2=getattr(item, "ctrl_img_2", None),
            ctrl_img_3=getattr(item, "ctrl_img_3", None),
            extras={**sample.extras, **getattr(item, "extras", {})},
        )


@dataclass
class ProcessConfig:
    """One ``config.process[]`` entry, fully typed."""

    type: str = "sd_trainer"
    training_folder: str = "output"
    device: str = "tpu"
    trigger_word: str | None = None
    performance_log_every: int = 0
    network: NetworkConfig | None = None
    save: SaveConfig = field(default_factory=SaveConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    sample: SampleConfig = field(default_factory=SampleConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    validation: ValidationConfig = field(default_factory=ValidationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    datasets: list[DatasetConfig] = field(default_factory=list)
    embedding: dict[str, Any] | None = None
    adapter: dict[str, Any] | None = None
    slider: dict[str, Any] | None = None
    extras: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ProcessConfig":
        d = dict(d)
        sub = {
            "network": NetworkConfig.from_dict(d.pop("network", None)),
            "save": SaveConfig.from_dict(d.pop("save", None)),
            "train": TrainConfig.from_dict(d.pop("train", None)),
            "model": ModelConfig.from_dict(d.pop("model", None)),
            "sample": SampleConfig.from_dict(d.pop("sample", None)),
            "logging": LoggingConfig.from_dict(d.pop("logging", None)),
            "validation": ValidationConfig.from_dict(d.pop("validation", None)),
            "mesh": MeshConfig.from_dict(d.pop("mesh", None)),
            "datasets": [DatasetConfig.from_dict(x) for x in (d.pop("datasets", None) or [])],
        }
        obj = _build(cls, d)
        for k, v in sub.items():
            setattr(obj, k, v)
        return obj


@dataclass
class JobConfig:
    """The whole parsed job file."""

    job: str = "extension"
    name: str = "unnamed"
    processes: list[ProcessConfig] = field(default_factory=list)
    meta: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_raw(cls, raw: dict[str, Any]) -> "JobConfig":
        cfg = raw.get("config", {})
        obj = cls(
            job=str(raw.get("job", "extension")),
            name=str(cfg.get("name", "unnamed")),
            processes=[ProcessConfig.from_dict(p) for p in cfg.get("process", [])],
            meta=dict(raw.get("meta", {}) or {}),
            raw=raw,
        )
        for proc in obj.processes:
            warn_unconsumed(proc, source=obj.name)
        return obj
