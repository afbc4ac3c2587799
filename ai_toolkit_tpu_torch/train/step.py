"""The train step (``ai_toolkit_tpu/train/step.py`` ``make_train_step`` in
PyTorch), the core path the flux LoRA job takes:

    t ~ schedule (flux_shift), noise ~ N(0, 1)        (one torch.Generator)
    x_t = (1 - t) x0 + t noise,  target = noise - x0
    loss = mse(predict(x_t, t, cond), target)
    grads of the trainable tensors only; clip, AdamW(8bit), EMA

with metrics ``loss``, ``loss_raw`` and ``grad_norm`` (the global norm of the
unclipped gradients). ``grad_accum > 1`` sums the gradients of that many
micro-batches and divides, as the JAX ``lax.scan`` over micro-batches does. Every other knob of
the JAX ``TrainStepConfig`` raises ``NotImplementedError`` when it is set away
from its default (:meth:`TrainStepConfig.from_train_config`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ai_toolkit_tpu_torch.config.modules import TrainConfig
from ai_toolkit_tpu_torch.train.losses import compute_loss
from ai_toolkit_tpu_torch.train.optimizers import global_norm
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

# TrainConfig knobs the JAX TrainStepConfig reads that this port does not
# take yet (the "train-step knobs" slice); each must stay at its default
_UNPORTED_KNOBS = (
    "linear_timesteps", "linear_timesteps2", "min_snr_gamma", "noise_offset",
    "noise_multiplier", "blended_blur_noise", "diff_output_preservation", "inverted_mask_prior",
    "do_cfg", "do_random_cfg", "cfg_rescale", "noisy_latent_multiplier", "standardize_latents",
    "max_loss", "correct_pred_norm", "learnable_snr_gos", "t0_loss_target", "do_fft_loss",
    "loss_target", "do_differential_guidance", "optimal_noise_pairing_samples",
    "force_consistent_noise", "dynamic_noise_offset", "do_signal_correction_noise",
    "do_batch_noise_correction", "random_noise_shift", "random_noise_multiplier", "pred_scaler",
    "target_noise_multiplier", "target_norm_std", "adaptive_scaling_factor",
    "blank_prompt_preservation", "guidance_loss_target", "do_signal_amplification",
    "train_turbo",
)


@dataclass(frozen=True)
class TrainStepConfig:
    timestep_type: str = "sigmoid"
    timestep_bias: float = 1.0
    loss_type: str = "mse"
    ema_decay: float | None = None
    grad_accum: int = 1

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
        )


PredictFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def train_loss(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, batch: dict,
               noise: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The loss of one micro-batch for given noise and timesteps (JAX
    ``microbatch_loss`` on the path this slice takes)."""
    latents = batch["latents"]
    noisy = schedule.add_noise(latents, noise, t)
    target = schedule.target(latents, noise, t)
    pred = predict_fn(noisy, t, batch.get("cond", {}))
    return compute_loss(pred, target, loss_type=cfg.loss_type,
                        loss_multiplier=batch.get("loss_multiplier"))


def make_train_step(predict_fn: PredictFn, schedule, cfg: TrainStepConfig):
    """``train_step(state, batches, generator) -> metrics`` over ``grad_accum``
    micro-batches. Each holds ``latents`` ``[B, h, w, C]``, ``cond``,
    ``loss_multiplier`` and ``image_seq_len``; t and the noise are drawn from
    ``generator`` on the latents' device."""

    def micro(batch, generator):
        latents = batch["latents"]
        t = schedule.sample_timesteps(generator, latents.shape[0], cfg.timestep_type,
                                      batch.get("image_seq_len"), cfg.timestep_bias,
                                      device=latents.device)
        noise = torch.randn(latents.shape, generator=generator, dtype=latents.dtype,
                            device=latents.device)
        return train_loss(predict_fn, schedule, cfg, batch, noise, t)

    def train_step(state: TrainState, batches: list[dict], generator: torch.Generator) -> dict:
        if len(batches) != cfg.grad_accum:
            raise ValueError(f"train_step got {len(batches)} micro-batches, grad_accum is {cfg.grad_accum}")
        params = list(state.trainable.values())
        grads, loss, aux = None, 0.0, {}
        for batch in batches:
            l_i, a_i = micro(batch, generator)
            g_i = torch.autograd.grad(l_i, params)
            grads = g_i if grads is None else [g + x for g, x in zip(grads, g_i)]
            loss = loss + l_i.detach()
            aux = {k: aux.get(k, 0.0) + v.detach() for k, v in a_i.items()}
        if cfg.grad_accum > 1:
            grads = [g / cfg.grad_accum for g in grads]
            loss = loss / cfg.grad_accum
            aux = {k: v / cfg.grad_accum for k, v in aux.items()}
        grad_norm = global_norm(grads)
        state.apply_gradients(list(grads), ema_decay=cfg.ema_decay)
        return {"loss": loss, "grad_norm": grad_norm, **aux}

    return train_step
