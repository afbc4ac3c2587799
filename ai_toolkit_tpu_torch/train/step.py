"""The train step (``ai_toolkit_tpu/train/step.py`` ``make_train_step`` in
PyTorch), the core path the flux and SDXL LoRA jobs take:

    t ~ schedule, noise ~ N(0, 1)                     (one torch.Generator)
    flow matching (flux_shift ...):  x_t = (1 - t) x0 + t noise,  target = noise - x0
    DDPM (balanced integer t):       x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) noise,
                                     target = noise (epsilon) or v,
                                     per-sample weight min(snr, gamma) / snr with min_snr_gamma
    loss = mse(predict(x_t, t, cond), target)
    joint audio-video (a batch with ``audio_latents``): the audio tokens are
    noised at the same t with their own noise (drawn after the video's), the
    model returns both predictions, and
    loss += audio_loss_multiplier * mse(audio_pred, audio_target)
    grads of the trainable tensors only; clip, AdamW(8bit), EMA

with metrics ``loss``, ``loss_raw`` and ``grad_norm`` (the global norm of the
unclipped gradients). A multistage pair (``stage_boundary`` with
``switch_every`` > 0) trains one expert's noise range at a time: steps
alternate every ``switch_every`` between ``[boundary, 1]`` and ``[0,
boundary]``, high first, and the sampled flow t is squeezed into the range
(``lo + t (hi - lo)``). The two halves run in ``torch.profiler`` ranges
(``train_step: forward and backward``, ``train_step: clip, optimizer and
EMA``) that split a profiled step's host and device time. :func:`eval_loss`
is the validation loss (JAX ``make_eval_step``): the same loss of a fixed
batch at draws from a seeded generator, unweighted, with no update. ``grad_accum > 1`` sums the gradients of that many
micro-batches and divides, as the JAX ``lax.scan`` over micro-batches does. Every other knob of
the JAX ``TrainStepConfig`` raises ``NotImplementedError`` when it is set away
from its default (:meth:`TrainStepConfig.from_train_config`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch
from torch.profiler import record_function

from ai_toolkit_tpu_torch.config.modules import TrainConfig
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.losses import compute_loss
from ai_toolkit_tpu_torch.train.optimizers import global_norm
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

# TrainConfig knobs the JAX TrainStepConfig reads that this port does not
# take yet (the "train-step knobs" slice); each must stay at its default
_UNPORTED_KNOBS = (
    "linear_timesteps", "linear_timesteps2", "noise_offset",
    "noise_multiplier", "blended_blur_noise", "diff_output_preservation", "inverted_mask_prior",
    "do_cfg", "do_random_cfg", "cfg_rescale", "noisy_latent_multiplier", "standardize_latents",
    "max_loss", "correct_pred_norm", "learnable_snr_gos", "t0_loss_target", "do_fft_loss",
    "loss_target", "do_differential_guidance", "optimal_noise_pairing_samples",
    "force_consistent_noise", "dynamic_noise_offset", "do_signal_correction_noise",
    "do_batch_noise_correction", "random_noise_shift", "random_noise_multiplier", "pred_scaler",
    "target_noise_multiplier", "target_norm_std", "adaptive_scaling_factor",
    "blank_prompt_preservation", "guidance_loss_target", "do_signal_amplification",
    "train_turbo", "content_or_style_reg",
)
# the DDPM schedule's discrete timestep grids (JAX ``microbatch_loss``); any
# other timestep_type is ignored by a DDPM schedule, as in JAX
_DDPM_TIMESTEP_TYPES = ("two_step", "four_step", "eight_step", "one_step", "next_sample")


@dataclass(frozen=True)
class TrainStepConfig:
    timestep_type: str = "sigmoid"
    timestep_bias: float = 1.0
    loss_type: str = "mse"
    ema_decay: float | None = None
    grad_accum: int = 1
    min_snr_gamma: float | None = None  # DDPM schedules only; a flow schedule ignores it
    content_or_style: str = "balanced"
    min_denoising_steps: int = 0
    max_denoising_steps: int | None = None
    audio_loss_multiplier: float = 1.0  # the joint AV audio stream's loss weight
    # multistage: the trained expert alternates every switch_every steps, t drawn from its noise range
    stage_boundary: float | None = None
    switch_every: int = 0

    @classmethod
    def from_train_config(cls, tc: TrainConfig) -> "TrainStepConfig":
        refuse_unported(tc, _UNPORTED_KNOBS, TrainConfig(), "train-step knobs")
        if tc.loss_type != "mse":
            raise NotImplementedError(f"loss_type '{tc.loss_type}' comes with the train-step knobs slice")
        if tc.timestep_type == "weighted":
            raise NotImplementedError("timestep_type 'weighted' comes with the train-step knobs slice")
        return cls(
            timestep_type=tc.timestep_type,
            timestep_bias=tc.timestep_bias,
            loss_type=tc.loss_type,
            ema_decay=tc.ema_config.ema_decay if tc.ema_config.use_ema else None,
            grad_accum=max(1, tc.gradient_accumulation_steps),
            min_snr_gamma=tc.min_snr_gamma,
            content_or_style=tc.content_or_style,
            min_denoising_steps=int(tc.min_denoising_steps or 0),
            max_denoising_steps=tc.max_denoising_steps,
            audio_loss_multiplier=float(tc.audio_loss_multiplier),
        )


PredictFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def train_loss(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, batch: dict,
               noise: torch.Tensor, t: torch.Tensor,
               noise_audio: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """The loss of one micro-batch for given noise and timesteps (JAX
    ``microbatch_loss`` on the paths the ported jobs take); a DDPM schedule's
    ``t`` are integer indices, and the UNet is called on them. A joint
    audio-video batch (``audio_latents``) takes ``noise_audio`` and adds the
    audio stream's weighted loss, with the metric ``audio_loss``."""
    latents = batch["latents"]
    noisy = schedule.add_noise(latents, noise, t)
    target = schedule.target(latents, noise, t)
    cond = batch.get("cond", {})
    audio = batch.get("audio_latents")
    if audio is not None:
        cond = {**cond, "noisy_audio": schedule.add_noise(audio, noise_audio, t)}
    pred = predict_fn(noisy, t, cond)
    if audio is not None:
        pred, audio_pred = pred
    tw = None
    if cfg.min_snr_gamma and not isinstance(schedule, FlowMatchSchedule):
        tw = schedule.min_snr_weight(t, cfg.min_snr_gamma)
    loss, aux = compute_loss(pred, target, loss_type=cfg.loss_type, timestep_weights=tw,
                             loss_multiplier=batch.get("loss_multiplier"))
    if audio is not None:
        audio_loss, _ = compute_loss(audio_pred, schedule.target(audio, noise_audio, t), loss_type=cfg.loss_type,
                                     timestep_weights=tw, loss_multiplier=batch.get("loss_multiplier"))
        loss = loss + cfg.audio_loss_multiplier * audio_loss
        aux = {**aux, "audio_loss": audio_loss}
    return loss, aux


def _audio_noise(batch: dict, generator: torch.Generator) -> torch.Tensor | None:
    audio = batch.get("audio_latents")
    if audio is None:
        return None
    return torch.randn(audio.shape, generator=generator, dtype=audio.dtype, device=audio.device)


@torch.no_grad()
def eval_loss(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, batch: dict,
              generator: torch.Generator) -> torch.Tensor:
    """The validation loss of ``batch`` (JAX ``make_eval_step`` /
    ``_eval_loss``): t and then the noise drawn from ``generator`` (the job
    seeds it with ``validation.seed`` for every evaluation), flow t at the
    step's ``timestep_type`` without its bias, DDPM t from the full balanced
    range, and :func:`train_loss` without per-sample weights (no min-SNR, no
    loss multiplier), as JAX's eval loss has none; a joint AV batch adds its
    audio loss unweighted by ``audio_loss_multiplier``, as JAX's does. No
    gradient; the optimizer and the EMA are not touched."""
    latents = batch["latents"]
    if isinstance(schedule, FlowMatchSchedule):
        t = schedule.sample_timesteps(generator, latents.shape[0], cfg.timestep_type,
                                      batch.get("image_seq_len"), device=latents.device)
    else:
        t = schedule.sample_timesteps(generator, latents.shape[0], device=latents.device)
    noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype, device=latents.device)
    unweighted = {k: v for k, v in batch.items() if k != "loss_multiplier"}
    return train_loss(predict_fn, schedule, replace(cfg, min_snr_gamma=None, audio_loss_multiplier=1.0), unweighted,
                      noise, t, _audio_noise(batch, generator))[0]


def stage_range(cfg: TrainStepConfig, step: int) -> tuple[float, float] | None:
    """The noise range ``(lo, hi)`` step ``step`` trains (JAX ``train_step``'s
    ``t_range``): the high-noise expert's ``[boundary, 1]`` in even phases of
    ``switch_every`` steps, the low-noise one's ``[0, boundary]`` in odd ones;
    None when the model is not a switched multistage pair."""
    if cfg.switch_every <= 0 or cfg.stage_boundary is None:
        return None
    if (step // cfg.switch_every) % 2 == 0:
        return cfg.stage_boundary, 1.0
    return 0.0, cfg.stage_boundary


def make_train_step(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, micro_loss=None):
    """``train_step(state, batches, generator) -> metrics`` over ``grad_accum``
    micro-batches. Each holds ``latents`` ``[B, h, w, C]`` (video: ``[B, T, h, w, C]``), ``cond``,
    ``loss_multiplier`` and (flow matching) ``image_seq_len``; t and the noise are drawn from
    ``generator`` on the latents' device. ``micro_loss(batch, generator, t_range) -> (loss,
    aux)`` takes the place of the diffusion loss (the paired-image guidance losses,
    ``train/slider.make_guidance_loss``); accumulation, clipping, the optimizer and the EMA
    stay as they are."""

    def micro(batch, generator, t_range):
        latents = batch["latents"]
        if isinstance(schedule, FlowMatchSchedule):
            t = schedule.sample_timesteps(generator, latents.shape[0], cfg.timestep_type,
                                          batch.get("image_seq_len"), cfg.timestep_bias,
                                          device=latents.device)
            if t_range is not None:
                lo, hi = t_range
                t = lo + t * (hi - lo)
        else:
            tt = cfg.timestep_type if cfg.timestep_type in _DDPM_TIMESTEP_TYPES else None
            t = schedule.sample_timesteps(generator, latents.shape[0], cfg.min_denoising_steps,
                                          cfg.max_denoising_steps, cfg.content_or_style, tt,
                                          device=latents.device)
        noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype,
                            device=latents.device)
        return train_loss(predict_fn, schedule, cfg, batch, noise, t, _audio_noise(batch, generator))

    def train_step(state: TrainState, batches: list[dict], generator: torch.Generator) -> dict:
        if len(batches) != cfg.grad_accum:
            raise ValueError(f"train_step got {len(batches)} micro-batches, grad_accum is {cfg.grad_accum}")
        params = list(state.trainable.values())
        grads, loss, aux = None, 0.0, {}
        t_range = stage_range(cfg, state.step)
        with record_function("train_step: forward and backward"):
            for batch in batches:
                l_i, a_i = (micro_loss or micro)(batch, generator, t_range)
                g_i = torch.autograd.grad(l_i, params)
                grads = g_i if grads is None else [g + x for g, x in zip(grads, g_i)]
                loss = loss + l_i.detach()
                aux = {k: aux.get(k, 0.0) + v.detach() for k, v in a_i.items()}
        with record_function("train_step: clip, optimizer and EMA"):
            if cfg.grad_accum > 1:
                grads = [g / cfg.grad_accum for g in grads]
                loss = loss / cfg.grad_accum
                aux = {k: v / cfg.grad_accum for k, v in aux.items()}
            grad_norm = global_norm(grads)
            state.apply_gradients(list(grads), ema_decay=cfg.ema_decay)
        return {"loss": loss, "grad_norm": grad_norm, **aux}

    return train_step
