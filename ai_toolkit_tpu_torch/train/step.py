"""The train step (``ai_toolkit_tpu/train/step.py`` ``make_train_step`` in
PyTorch), every knob of the JAX ``TrainStepConfig``:

    t ~ schedule, noise ~ N(0, 1)                     (one torch.Generator)
    flow matching (flux_shift ...):  x_t = (1 - t) x0 + t noise,  target = noise - x0
    DDPM (integer t):                x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) noise,
                                     target = noise (epsilon) or v
    loss = loss_type(predict(x_t, t, cond), target) [+ the terms below]
    grads of the trainable tensors only; clip, the optimizer, EMA

The knobs, in the JAX ``microbatch_loss``'s order (:func:`microbatch_loss`,
:func:`train_loss`):

- latents: ``standardize_latents``, ``adaptive_scaling_factor``;
- noise: ``optimal_noise_pairing_samples`` (the closest of K candidates),
  ``force_consistent_noise`` (per image, from the batch's ``noise_seed``),
  ``noise_multiplier``, ``noise_offset``, ``blended_blur_noise``,
  ``dynamic_noise_offset``, signal and batch noise correction,
  ``random_noise_shift`` / ``random_noise_multiplier``; the target's
  ``target_noise_multiplier`` and ``do_signal_amplification``; the model
  input's ``noisy_multiplier``;
- extra forwards: ``do_cfg`` (the negative prompt's prediction, the
  combined one trained; ``do_random_cfg``, ``cfg_rescale``), the adapter-off
  prior (``diff_output_preservation``, ``inverted_mask_prior``; the LoRA
  under ``ops.layers.ADAPTER_OFF``, no gradient), the unconditional anchor
  of ``guidance_loss_target`` (CFG-Zero*, the ``sigma`` schedule) and
  ``blank_prompt_preservation``;
- weights: the bell / half-bell / table weights of the linear and
  ``weighted`` timesteps, the learnable SNR gamma (its four scalars and
  their own AdamW in :class:`LearnableSNR`), min-SNR-gamma;
  ``correct_pred_norm``, ``pred_scaler``, ``do_differential_guidance``;
- x0-space losses: ``train_turbo`` (DDPM: an Euler-ancestral step, the VAE
  decode in the graph, the loss in pixels), ``loss_target`` ``source`` /
  ``unaugmented``, ``loss_type: stepped``, ``t0_loss_target`` and
  ``do_fft_loss``; then ``target_norm_std``, the DOP and blank-prompt terms,
  the joint audio loss, the aux loss and ``max_loss`` (the loss, and so the
  gradient, zeroed on an outlier batch; the optimizer still steps, as in JAX).

Every draw the knobs make comes from the step's generator through
:class:`Draws`, in the JAX step's order, so a test can hand the same values
to JAX. A multistage pair (``stage_boundary`` with ``switch_every`` > 0)
trains one expert's noise range at a time (``lo + t (hi - lo)``). The two
halves run in ``torch.profiler`` ranges (``train_step: forward and
backward``, ``train_step: clip, optimizer and EMA``). :func:`eval_loss` is
JAX ``make_eval_step``: the plain loss of a fixed batch, no knob, no update.
``grad_accum > 1`` sums the gradients of that many micro-batches and
divides. What stays refused (:meth:`TrainStepConfig.from_train_config`):
``match_adapter_chance`` above 0 (the prior keeping the assistant adapter's
residuals on a draw, ROADMAP Queue 1 item 6e; at 0 the prior runs without
them, as JAX's does);
the SDXL refiner's double-up is the refiner's (item 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ai_toolkit_tpu_torch.config.modules import TrainConfig
from ai_toolkit_tpu_torch.ops.layers import ADAPTER_OFF, lora_multiplier
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.losses import compute_loss, diff_output_preservation_loss
from ai_toolkit_tpu_torch.train.optimizers import global_norm

# the DDPM schedule's discrete timestep grids (JAX ``microbatch_loss``); any
# other timestep_type is ignored by a DDPM schedule, as in JAX
_DDPM_TIMESTEP_TYPES = ("two_step", "four_step", "eight_step", "one_step", "next_sample")
_LOSS_TYPES = ("mse", "mae", "pseudo_huber", "wavelet", "stepped")


@dataclass(frozen=True)
class TrainStepConfig:
    timestep_type: str = "sigmoid"
    timestep_bias: float = 1.0
    loss_type: str = "mse"
    huber_c: float = 0.001
    min_snr_gamma: float | None = None  # DDPM schedules only; a flow schedule ignores it
    use_timestep_weights: bool = False  # linear_timesteps / weighted
    timestep_weights_v2: bool = False
    noise_offset: float = 0.0
    noise_multiplier: float = 1.0
    blended_blur_noise: bool = False
    ema_decay: float | None = None
    grad_accum: int = 1
    diff_output_preservation: bool = False
    dop_multiplier: float = 1.0
    inverted_mask_prior: bool = False
    inverted_mask_prior_multiplier: float = 0.5
    do_prior_pred: bool = False  # an adapter-off forward (DOP / the inverted-mask prior)
    do_cfg: bool = False
    cfg_scale: float = 1.0
    do_random_cfg: bool = False
    max_cfg_scale: float = 4.0
    cfg_rescale: float = 0.0
    noisy_multiplier: float = 1.0
    standardize_latents: bool = False
    max_loss: float | None = None
    audio_loss_multiplier: float = 1.0  # the joint AV audio stream's loss weight
    correct_pred_norm: bool = False
    correct_pred_norm_multiplier: float = 1.0
    # multistage: the trained expert alternates every switch_every steps, t drawn from its noise range
    stage_boundary: float | None = None
    switch_every: int = 0
    train_turbo: bool = False
    learnable_snr: bool = False
    t0_loss_target: bool = False
    t0_velocity_equiv_weight: bool = False
    do_fft_loss: bool = False
    do_fft_velocity_equiv_weight: bool = False
    loss_target_mode: str = "noise"
    content_or_style: str = "balanced"
    content_or_style_reg: str = "balanced"
    min_denoising_steps: int = 0
    max_denoising_steps: int | None = None
    do_differential_guidance: bool = False
    differential_guidance_scale: float = 3.0
    optimal_noise_pairing_samples: int = 1
    force_consistent_noise: bool = False
    dynamic_noise_offset: bool = False
    do_signal_correction_noise: bool = False
    signal_correction_noise_scale: float = 1.0
    do_batch_noise_correction: bool = False
    batch_noise_correction_scale: float = 1.0
    random_noise_shift: float = 0.0
    random_noise_multiplier: float = 0.0
    pred_scaler: float = 1.0
    target_noise_multiplier: float = 1.0
    target_norm_std: bool = False
    target_norm_std_value: float = 1.0
    adaptive_scaling_factor: bool = False
    blank_prompt_preservation: bool = False
    blank_prompt_preservation_multiplier: float = 1.0
    guidance_loss_target: float = 1.0
    do_guidance_loss_cfg_zero: bool = False
    guidance_loss_schedule: str = "constant"  # constant | sigma
    do_signal_amplification: bool = False
    signal_amplification_strength: float = 1.0
    next_sample_timesteps: int | None = None

    @classmethod
    def from_train_config(cls, tc: TrainConfig) -> "TrainStepConfig":
        """JAX ``TrainStepConfig.from_train_config``. Two JAX faults are
        mirrored with a printed line: a ``loss_type`` the JAX step does not
        know trains as mse, and ``diff_output_preservation_class`` is not
        read (the DOP prior runs on the batch's own caption)."""
        if tc.match_adapter_chance:
            raise NotImplementedError("train-step knobs: match_adapter_chance > 0 keeps the assistant adapter's "
                                      "residuals in the prior on a draw; it comes with ROADMAP Queue 1 item 6e "
                                      "(at 0 the prior runs without them, as in JAX)")
        if tc.loss_type not in _LOSS_TYPES:
            print(f"JAX fault mirrored: loss_type '{tc.loss_type}' is no loss of the JAX step; it trains as mse "
                  f"(ROADMAP Queue 3)")
        if tc.diff_output_preservation and tc.diff_output_preservation_class:
            print(f"JAX fault mirrored: diff_output_preservation_class {tc.diff_output_preservation_class!r} is not "
                  f"read; the prior regresses on each batch's own caption (ROADMAP Queue 3)")
        return cls(
            timestep_type="linear" if tc.linear_timesteps or tc.linear_timesteps2 else tc.timestep_type,
            timestep_bias=tc.timestep_bias,
            loss_type=tc.loss_type if tc.loss_type in _LOSS_TYPES else "mse",
            huber_c=tc.pseudo_huber_c,
            min_snr_gamma=tc.min_snr_gamma,
            use_timestep_weights=bool(tc.linear_timesteps or tc.linear_timesteps2 or tc.timestep_type == "weighted"),
            timestep_weights_v2=bool(tc.linear_timesteps2),
            noise_offset=tc.noise_offset,
            noise_multiplier=tc.noise_multiplier,
            blended_blur_noise=bool(tc.blended_blur_noise),
            ema_decay=tc.ema_config.ema_decay if tc.ema_config.use_ema else None,
            grad_accum=max(1, tc.gradient_accumulation_steps),
            diff_output_preservation=tc.diff_output_preservation,
            dop_multiplier=tc.diff_output_preservation_multiplier,
            inverted_mask_prior=tc.inverted_mask_prior,
            inverted_mask_prior_multiplier=tc.inverted_mask_prior_multiplier,
            do_prior_pred=tc.diff_output_preservation or tc.inverted_mask_prior,
            do_cfg=tc.do_cfg,
            cfg_scale=tc.cfg_scale,
            do_random_cfg=bool(tc.do_random_cfg),
            max_cfg_scale=float(tc.max_cfg_scale),
            cfg_rescale=float(tc.cfg_rescale),
            noisy_multiplier=float(tc.noisy_latent_multiplier),
            standardize_latents=bool(tc.standardize_latents),
            max_loss=tc.max_loss,
            audio_loss_multiplier=float(tc.audio_loss_multiplier),
            correct_pred_norm=bool(tc.correct_pred_norm),
            correct_pred_norm_multiplier=float(tc.correct_pred_norm_multiplier),
            learnable_snr=bool(tc.learnable_snr_gos),
            t0_loss_target=bool(tc.t0_loss_target),
            t0_velocity_equiv_weight=bool(tc.t0_velocity_equiv_weight),
            do_fft_loss=bool(tc.do_fft_loss),
            do_fft_velocity_equiv_weight=bool(tc.do_fft_velocity_equiv_weight),
            loss_target_mode=tc.loss_target or "noise",
            content_or_style=tc.content_or_style,
            content_or_style_reg=tc.content_or_style_reg or tc.content_or_style,
            do_differential_guidance=bool(tc.do_differential_guidance),
            differential_guidance_scale=float(tc.differential_guidance_scale),
            optimal_noise_pairing_samples=int(tc.optimal_noise_pairing_samples or 1),
            force_consistent_noise=bool(tc.force_consistent_noise),
            dynamic_noise_offset=bool(tc.dynamic_noise_offset),
            do_signal_correction_noise=bool(tc.do_signal_correction_noise),
            signal_correction_noise_scale=float(tc.signal_correction_noise_scale),
            do_batch_noise_correction=bool(tc.do_batch_noise_correction),
            batch_noise_correction_scale=float(tc.batch_noise_correction_scale),
            random_noise_shift=float(tc.random_noise_shift),
            random_noise_multiplier=float(tc.random_noise_multiplier),
            pred_scaler=float(tc.pred_scaler),
            target_noise_multiplier=float(tc.target_noise_multiplier),
            target_norm_std=bool(tc.target_norm_std),
            target_norm_std_value=float(tc.target_norm_std_value),
            adaptive_scaling_factor=bool(tc.adaptive_scaling_factor),
            min_denoising_steps=int(tc.min_denoising_steps or 0),
            max_denoising_steps=tc.max_denoising_steps,
            blank_prompt_preservation=bool(tc.blank_prompt_preservation),
            blank_prompt_preservation_multiplier=float(tc.blank_prompt_preservation_multiplier),
            guidance_loss_target=float(tc.guidance_loss_target),
            do_guidance_loss_cfg_zero=bool(tc.do_guidance_loss_cfg_zero),
            guidance_loss_schedule=str(tc.guidance_loss_schedule or "constant"),
            do_signal_amplification=bool(tc.do_signal_amplification),
            signal_amplification_strength=float(tc.signal_amplification_strength),
            next_sample_timesteps=tc.next_sample_timesteps,
            train_turbo=bool(tc.train_turbo),
        )

    def check(self, is_flow: bool, decode: bool) -> None:
        """JAX ``make_train_step``'s refusals of knobs the schedule cannot take."""
        if self.loss_type == "stepped" and not is_flow:
            raise ValueError("loss_type='stepped' requires a flow-matching schedule")
        if (self.t0_loss_target or self.do_fft_loss) and not is_flow:
            raise ValueError("t0_loss_target/do_fft_loss need a flow-matching schedule (or an x0-pred arch)")
        if self.loss_target_mode not in ("noise", "source", "unaugmented"):
            raise ValueError(f"unknown loss_target: {self.loss_target_mode!r}")
        if self.loss_target_mode != "noise" and not is_flow:
            raise ValueError(f"loss_target='{self.loss_target_mode}' needs a flow-matching schedule")
        if self.train_turbo and is_flow:
            raise ValueError("train_turbo is an eps-pred/DDPM feature (the reference implements it for euler_a "
                             "schedules) — not flow matching")
        if self.train_turbo and not decode:
            raise ValueError("train_turbo requires the VAE decode in-graph and raw pixels in the batch — set "
                             "cache_latents: false")


class Draws:
    """The knobs' random draws from the step's generator, on ``device``:
    ``normal`` and ``uniform`` tensors and ``randint`` scalars, made in the
    JAX step's order."""

    def __init__(self, generator: torch.Generator | None, device):
        self.generator, self.device = generator, torch.device(device)

    def _gen(self) -> torch.Generator:
        if self.generator is None:
            raise ValueError("this knob draws random numbers: give the step's generator")
        return self.generator

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._gen(), dtype=dtype, device=self.device)

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._gen(), dtype=torch.float32, device=self.device)
        return u if (lo, hi) == (0.0, 1.0) else lo + u * (hi - lo)

    def randint(self, lo: int, hi: int) -> int:
        return int(torch.randint(lo, hi, (), generator=self._gen(), device=self.device))


class LearnableSNR:
    """The learnable SNR gamma (JAX ``init_lsnr_state`` / ``_lsnr_update``):
    four scalars with the per-sample weight ``|gamma / ((snr + o1) scale +
    o2)|``, one AdamW(0.01) step a micro-batch of ``mean((loss w -
    target)^2)``, the target the mean of a rolling buffer of the last 20
    batch losses. f32 scalars on ``device``."""

    KEYS = ("offset_1", "offset_2", "scale", "gamma")
    INIT = (0.0, 0.777, 4.14, 2.03)

    def __init__(self, device):
        z = lambda v=0.0: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        self.params = {k: z(v) for k, v in zip(self.KEYS, self.INIT)}
        self.m = {k: z() for k in self.KEYS}
        self.v = {k: z() for k in self.KEYS}
        self.buffer = torch.zeros(20, dtype=torch.float32, device=device)
        self.count = z()

    @staticmethod
    def weight(params: dict, snr: torch.Tensor) -> torch.Tensor:
        return torch.abs(params["gamma"] / ((snr + params["offset_1"]) * params["scale"] + params["offset_2"]))

    @torch.no_grad()
    def update(self, per_sample_loss: torch.Tensor, snr: torch.Tensor) -> "LearnableSNR":
        """The state after one AdamW step on this micro-batch (a new object)."""
        per = per_sample_loss.detach().float()
        new = LearnableSNR.__new__(LearnableSNR)
        n = self.buffer.shape[0]
        new.buffer = torch.roll(self.buffer, -1)
        new.buffer[-1] = per.mean()
        new.count = torch.clamp(self.count + 1.0, max=float(n))
        filled = torch.arange(n, dtype=torch.float32, device=per.device) >= (n - new.count)
        target = torch.where(filled, new.buffer, 0.0).sum() / torch.clamp(new.count, min=1.0)
        with torch.enable_grad():
            p = {k: v.clone().requires_grad_(True) for k, v in self.params.items()}
            local = ((per * self.weight(p, snr.detach()) - target) ** 2).mean()
            g = dict(zip(self.KEYS, torch.autograd.grad(local, [p[k] for k in self.KEYS])))
        lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
        new.m = {k: b1 * self.m[k] + (1 - b1) * g[k] for k in self.KEYS}
        new.v = {k: b2 * self.v[k] + (1 - b2) * g[k] ** 2 for k in self.KEYS}
        new.params = {k: self.params[k] - lr * new.m[k] / (torch.sqrt(new.v[k]) + eps) for k in self.KEYS}
        return new

    def to_json(self) -> dict[str, float]:
        return {k: float(v) for k, v in self.params.items()}

    def load_json(self, saved: dict) -> None:
        """The four scalars from ``learnable_snr.json`` (JAX's resume: the
        AdamW slots and the buffer start fresh)."""
        for k in self.KEYS:
            self.params[k] = torch.tensor(float(saved[k]), dtype=torch.float32, device=self.buffer.device)


PredictFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _std(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.std(x.float(), dim=dims, keepdim=True, correction=0)


def prepare_latents(cfg: TrainStepConfig, latents: torch.Tensor) -> torch.Tensor:
    """``standardize_latents`` (per sample to mean 0, std 1) and
    ``adaptive_scaling_factor`` (per sample and channel to std 1)."""
    if cfg.standardize_latents:
        ax = tuple(range(1, latents.dim()))
        mu = latents.mean(dim=ax, keepdim=True)
        latents = (latents - mu) / torch.clamp(_std(latents, ax), min=1e-6).to(latents.dtype)
    if cfg.adaptive_scaling_factor:
        sd = _std(latents, tuple(range(1, latents.dim() - 1)))
        latents = (latents.float() / (sd + 1e-6)).to(latents.dtype)
    return latents


def draw_noise(cfg: TrainStepConfig, batch: dict, latents: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The step's noise before its shaping: the closest of K candidates per
    sample (``optimal_noise_pairing_samples``), a per-image constant noise
    from the batch's ``noise_seed`` (``force_consistent_noise``), or one draw."""
    b = latents.shape[0]
    if cfg.optimal_noise_pairing_samples > 1:
        cands = draws.normal((cfg.optimal_noise_pairing_samples,) + tuple(latents.shape), latents.dtype)
        mse = ((cands.float() - latents[None].float()) ** 2).mean(dim=tuple(range(2, latents.dim() + 1)))
        return cands[torch.argmin(mse, dim=0), torch.arange(b, device=latents.device)]
    if cfg.force_consistent_noise and "noise_seed" in batch:
        return torch.stack([torch.randn(tuple(latents.shape[1:]), dtype=latents.dtype, device=latents.device,
                                        generator=torch.Generator(latents.device).manual_seed(int(s)))
                            for s in batch["noise_seed"]])
    return draws.normal(latents.shape, latents.dtype)


def _shape_noise(cfg: TrainStepConfig, latents: torch.Tensor, noise: torch.Tensor, draws: Draws) -> torch.Tensor:
    """JAX ``microbatch_loss``'s noise shaping; ``cs`` is one scalar per
    (sample, channel), channels last."""
    from ai_toolkit_tpu_torch.models.tipsv2 import resize_linear

    b = latents.shape[0]
    cs = latents.shape[:1] + (1,) * (latents.dim() - 2) + latents.shape[-1:]
    if cfg.noise_multiplier != 1.0:
        noise = noise * cfg.noise_multiplier
    if cfg.noise_offset:
        noise = noise + cfg.noise_offset * draws.normal(cs).to(latents.dtype)
    if cfg.blended_blur_noise and latents.dim() == 4:
        _, h, w, _ = latents.shape
        lat32 = latents.float()
        small = resize_linear(lat32, max(1, h // 4), max(1, w // 4))
        blur = resize_linear(small, h, w) - lat32
        noise = noise + (blur * draws.uniform((b, 1, 1, 1)) * 2.0).to(noise.dtype)
    if cfg.dynamic_noise_offset:
        noise = noise + (latents.mean(dim=tuple(range(1, latents.dim() - 1)), keepdim=True) / 2).to(noise.dtype)
    if cfg.do_signal_correction_noise:
        noise = noise + latents * (draws.normal(cs) * cfg.signal_correction_noise_scale).to(noise.dtype)
    if cfg.do_batch_noise_correction and b > 1:
        rolled = torch.roll(latents, draws.randint(1, b), dims=0)
        noise = noise + rolled * (draws.normal(cs) * cfg.batch_noise_correction_scale).to(noise.dtype)
    if cfg.random_noise_shift > 0.0:
        noise = noise + (draws.normal(cs) * cfg.random_noise_shift).to(noise.dtype)
    if cfg.random_noise_multiplier > 0.0:
        noise = noise * torch.exp(draws.normal(cs) * cfg.random_noise_multiplier).to(noise.dtype)
    return noise


def _adapter_off(predict_fn: PredictFn, noisy, t, cond):
    """The prediction with the LoRA off and no gradient (JAX's ``base_vars``
    under ``stop_gradient``)."""
    with torch.no_grad(), lora_multiplier(ADAPTER_OFF):
        return predict_fn(noisy, t, cond)


def _extrapolate(cfg: TrainStepConfig, target: torch.Tensor, anchor: torch.Tensor, t: torch.Tensor,
                 is_flow: bool) -> torch.Tensor:
    """Target-side CFG: ``anchor + g (target - anchor)``, the anchor projected
    on the target (CFG-Zero*) and ``g`` decaying with sigma on request."""
    anchor, tf = anchor.detach().float(), target.float()
    if cfg.do_guidance_loss_cfg_zero:
        axes = tuple(range(1, anchor.dim()))
        dot = (tf * anchor).sum(dim=axes, keepdim=True)
        anchor = anchor * (dot / ((anchor * anchor).sum(dim=axes, keepdim=True) + 1e-8))
    g = torch.tensor(cfg.guidance_loss_target, dtype=torch.float32, device=tf.device)
    if cfg.guidance_loss_schedule == "sigma" and is_flow:
        g = 1.0 + (g - 1.0) * _bcast(t, tf).float()
    return (anchor + g * (tf - anchor)).to(target.dtype)


def train_loss(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, batch: dict,
               noise: torch.Tensor, t: torch.Tensor, noise_audio: torch.Tensor | None = None,
               aux_loss_fn=None, draws: Draws | None = None, decode_fn=None,
               lsnr: LearnableSNR | None = None) -> tuple[torch.Tensor, dict]:
    """The loss of one micro-batch for its (prepared) latents, its noise
    before shaping and its timesteps (JAX ``microbatch_loss`` after the draws
    of t and the noise); a DDPM schedule's ``t`` are integer indices. The
    knobs' other draws come from ``draws``, the joint audio noise too unless
    ``noise_audio`` is given. ``aux_loss_fn(pred, noisy, latents, noise, t)``
    adds its term (metric ``aux_loss``), ``decode_fn(latents)`` is the VAE
    decode of ``train_turbo``, and with ``lsnr`` the metrics carry
    ``new_lsnr``, its state after this micro-batch."""
    draws = draws if draws is not None else Draws(None, batch["latents"].device)
    is_flow = isinstance(schedule, FlowMatchSchedule)
    cfg.check(is_flow, decode_fn is not None)
    latents = batch["latents"]
    noise = _shape_noise(cfg, latents, noise, draws)
    noisy = schedule.add_noise(latents, noise, t)
    target_noise = noise * cfg.target_noise_multiplier if cfg.target_noise_multiplier != 1.0 else noise
    target = schedule.target(latents, target_noise, t)
    if cfg.do_signal_amplification and is_flow:
        nas = _bcast((1.0 - t) * cfg.signal_amplification_strength, latents).to(latents.dtype)
        target = target_noise - (latents + latents * nas)
    if cfg.noisy_multiplier != 1.0:
        noisy = noisy * cfg.noisy_multiplier
    cond = batch.get("cond", {})
    audio = batch.get("audio_latents")
    audio_target = None
    if audio is not None:
        if cfg.do_cfg or cfg.do_prior_pred or cfg.blank_prompt_preservation:
            raise NotImplementedError("do_cfg, the adapter-off prior and blank_prompt_preservation on a joint "
                                      "audio-video model: the JAX step fails on its two-stream prediction")
        noise_audio = noise_audio if noise_audio is not None else draws.normal(audio.shape, audio.dtype)
        cond = {**cond, "noisy_audio": schedule.add_noise(audio, noise_audio, t)}
        audio_target = schedule.target(audio, noise_audio, t)

    pred = predict_fn(noisy, t, cond)
    audio_pred = None
    if audio is not None:
        pred, audio_pred = pred
        if cfg.pred_scaler != 1.0:
            pred, audio_pred = pred * cfg.pred_scaler, audio_pred * cfg.pred_scaler
    elif cfg.pred_scaler != 1.0:
        pred = pred * cfg.pred_scaler
    if cfg.do_cfg and "neg_cond" in batch:
        pred_neg = predict_fn(noisy, t, batch["neg_cond"])
        pred_pos = pred
        if cfg.do_random_cfg:  # an f32 scale tensor: the combined prediction is f32, as in JAX
            pred = pred_neg.float() + draws.uniform((), 1.0, cfg.max_cfg_scale) * (pred - pred_neg).float()
        else:
            pred = pred_neg + cfg.cfg_scale * (pred - pred_neg)
        if cfg.cfg_rescale > 0.0:
            ax = tuple(range(1, pred.dim()))
            rescaled = pred * (_std(pred_pos, ax) / torch.clamp(_std(pred, ax), min=1e-6)).to(pred.dtype)
            pred = cfg.cfg_rescale * rescaled + (1.0 - cfg.cfg_rescale) * pred
    prior_pred = None
    if cfg.do_prior_pred:
        pcond = cond
        if "adapter_residuals" in cond:  # the assistant's residuals leave the prior (JAX match_adapter_chance 0)
            pcond = {**cond, "adapter_residuals": tuple(r * 0 for r in cond["adapter_residuals"])}
        prior_pred = _adapter_off(predict_fn, noisy, t, pcond)

    tw = None
    if cfg.use_timestep_weights and is_flow:
        tw = schedule.loss_weights(t, cfg.timestep_type, cfg.timestep_weights_v2)
    elif cfg.learnable_snr and not is_flow and lsnr is not None and not cfg.train_turbo:
        tw = LearnableSNR.weight(lsnr.params, schedule.snr(t)).detach()
    elif cfg.min_snr_gamma and not is_flow and not cfg.train_turbo:
        tw = schedule.min_snr_weight(t, cfg.min_snr_gamma)

    if cfg.correct_pred_norm:
        ax = tuple(range(1, pred.dim() - 1))
        tn = torch.linalg.vector_norm(target.float(), dim=ax, keepdim=True)
        pn = torch.linalg.vector_norm(pred.float(), dim=ax, keepdim=True)
        factor = (tn / torch.clamp(pn, min=1e-6)) ** cfg.correct_pred_norm_multiplier
        pred = pred * factor.detach().to(pred.dtype)
    if cfg.guidance_loss_target != 1.0 and "uncond_cond" in batch:
        with torch.no_grad():
            u_all = predict_fn(noisy, t, batch["uncond_cond"])
        if audio is not None:
            u_all, u_audio = u_all
            audio_target = _extrapolate(cfg, audio_target, u_audio, t, is_flow)
        target = _extrapolate(cfg, target, u_all, t, is_flow)
    if cfg.do_differential_guidance:
        target = (pred + cfg.differential_guidance_scale * (target.float() - pred)).detach().to(target.dtype)

    loss_pred, loss_target, loss_kind = pred, target, cfg.loss_type
    fft_loss = None
    loss_mask = batch.get("mask")
    if cfg.train_turbo:
        loss_pred, loss_target, loss_mask = _turbo(schedule, batch, pred, noisy, noise, t, draws, decode_fn,
                                                   loss_mask)
        loss_kind = "mse"
    if cfg.loss_target_mode in ("source", "unaugmented"):
        tv = torch.clamp(t, min=1.0 / getattr(schedule, "num_train_timesteps", 1000))
        loss_pred = noisy.float() - _bcast(tv, pred) * pred.float()
        tgt = batch.get("unaugmented_latents", latents) if cfg.loss_target_mode == "unaugmented" else latents
        loss_target, loss_kind = tgt.float().detach(), "mse"
        w = tv.float() ** -2.0
        tw = w if tw is None else tw * w
    elif cfg.loss_type == "stepped":
        loss_pred = schedule.stepped_x0(pred, noisy, noise, t)
        loss_target, loss_kind = latents.float().detach(), "mse"
    elif cfg.t0_loss_target or cfg.do_fft_loss:
        tv = _bcast(torch.clamp(t, min=0.001), pred)
        t0 = noisy.float() - tv * pred.float()
        if cfg.t0_loss_target:
            loss_pred, loss_target = t0, latents.float().detach()
            if cfg.t0_velocity_equiv_weight:
                vw = 1.0 / torch.clamp(t, min=0.1) ** 2
                tw = vw if tw is None else tw * vw
        if cfg.do_fft_loss and latents.dim() >= 4:
            tmag = torch.fft.rfft2(latents.float(), dim=(-3, -2), norm="ortho").abs()
            pmag = torch.fft.rfft2(t0, dim=(-3, -2), norm="ortho").abs()
            fft_elem = (pmag - tmag.detach()) ** 2
            if cfg.do_fft_velocity_equiv_weight:
                fft_elem = fft_elem * (1.0 / torch.clamp(tv, min=0.1) ** 2)
            fft_loss = fft_elem.mean()

    loss, aux = compute_loss(loss_pred, loss_target, loss_type=loss_kind, huber_c=cfg.huber_c, timestep_weights=tw,
                             loss_multiplier=batch.get("loss_multiplier"), mask=loss_mask,
                             prior_pred=prior_pred if cfg.inverted_mask_prior and not cfg.train_turbo else None,
                             inverted_mask_prior_multiplier=cfg.inverted_mask_prior_multiplier)
    if fft_loss is not None:
        loss = loss + fft_loss
        aux = {**aux, "fft_loss": fft_loss}
    if cfg.target_norm_std:
        pred_std = _std(pred, tuple(range(1, pred.dim() - 1)))
        loss = loss + torch.abs(cfg.target_norm_std_value - pred_std).mean()
    if cfg.diff_output_preservation and prior_pred is not None:
        loss = loss + diff_output_preservation_loss(pred, prior_pred, cfg.dop_multiplier)
    if cfg.blank_prompt_preservation and "blank_cond" in batch:
        bcond = batch["blank_cond"]
        blank_prior = _adapter_off(predict_fn, noisy, t, bcond)
        bpp = ((predict_fn(noisy, t, bcond).float() - blank_prior.float()) ** 2).mean()
        loss = loss + cfg.blank_prompt_preservation_multiplier * bpp
        aux = {**aux, "bpp_loss": bpp}
    if audio_pred is not None:
        audio_loss, _ = compute_loss(audio_pred, audio_target, loss_type=cfg.loss_type, huber_c=cfg.huber_c,
                                     timestep_weights=tw, loss_multiplier=batch.get("loss_multiplier"))
        loss = loss + cfg.audio_loss_multiplier * audio_loss
        aux = {**aux, "audio_loss": audio_loss}
    if aux_loss_fn is not None:
        extra = aux_loss_fn(pred, noisy, latents, noise, t)
        loss = loss + extra
        aux = {**aux, "aux_loss": extra}
    if cfg.learnable_snr and not is_flow and lsnr is not None:
        per = ((pred.float() - target.float()) ** 2).mean(dim=tuple(range(1, pred.dim())))
        aux = {**aux, "new_lsnr": lsnr.update(per, schedule.snr(t))}
    if cfg.max_loss is not None:
        aux = {**aux, "max_loss_skipped": (loss >= cfg.max_loss).float()}
        loss = torch.where(loss < cfg.max_loss, loss, torch.zeros_like(loss))
    return loss, aux


def _turbo(schedule, batch, pred, noisy, noise, t, draws: Draws, decode_fn, mask):
    """``train_turbo``: an Euler-ancestral step in sigma space from sigma(t)
    to a random earlier table entry, its fresh noise drawn, the batch's noise
    removed, the result decoded to pixels (in the graph) and regressed on the
    batch's ``pixel_values``; the mask nearest-resized to pixel size."""
    ac = torch.as_tensor(schedule.alphas_cumprod, dtype=torch.float32, device=pred.device)
    sig_tab = torch.sqrt((1.0 - ac) / ac)
    ti = t.long()
    s_from = _bcast(sig_tab[ti], pred)
    end_i = (draws.uniform(t.shape) * ti.float()).long()
    s_to = _bcast(sig_tab[end_i], pred)
    x_sig = noisy.float() / torch.sqrt(_bcast(ac[ti], pred))
    var_up = s_to ** 2 * (s_from ** 2 - s_to ** 2) / torch.clamp(s_from ** 2, min=1e-8)
    s_up = torch.sqrt(torch.clamp(var_up, min=0.0))
    s_down = torch.sqrt(torch.clamp(s_to ** 2 - s_up ** 2, min=0.0))
    z = draws.normal(noisy.shape)
    x_end = x_sig + pred.float() * (s_down - s_from) + z * s_up
    pixels = decode_fn(x_end - noise.float() * s_to).float()
    if mask is not None:
        m = F.interpolate(mask.float().permute(0, 3, 1, 2), size=tuple(pixels.shape[1:-1]), mode="nearest-exact")
        mask = m.permute(0, 2, 3, 1)
    return pixels, batch["pixel_values"].float().detach(), mask


def microbatch_loss(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, batch: dict, t: torch.Tensor,
                    draws: Draws, aux_loss_fn=None, decode_fn=None,
                    lsnr: LearnableSNR | None = None) -> tuple[torch.Tensor, dict]:
    """JAX ``microbatch_loss`` after its draw of t: the latents prepared, the
    noise drawn (:func:`draw_noise`), then :func:`train_loss`."""
    latents = prepare_latents(cfg, batch["latents"])
    batch = {**batch, "latents": latents}
    noise = draw_noise(cfg, batch, latents, draws)
    return train_loss(predict_fn, schedule, cfg, batch, noise, t, None, aux_loss_fn, draws, decode_fn, lsnr)


def sample_t(schedule, cfg: TrainStepConfig, batch: dict, generator: torch.Generator,
             t_range: tuple[float, float] | None = None) -> torch.Tensor:
    """The step's timesteps ``[B]``: flow t at ``timestep_type`` with its
    bias (squeezed into ``t_range``), or DDPM indices in the denoising window
    at the grid type or the content / style skew (a regularisation batch's
    own, ``content_or_style_reg``)."""
    latents = batch["latents"]
    if isinstance(schedule, FlowMatchSchedule):
        t = schedule.sample_timesteps(generator, latents.shape[0], cfg.timestep_type, batch.get("image_seq_len"),
                                      cfg.timestep_bias, device=latents.device)
        if t_range is not None:
            lo, hi = t_range
            t = lo + t * (hi - lo)
        return t
    tt = cfg.timestep_type if cfg.timestep_type in _DDPM_TIMESTEP_TYPES else None
    cos = cfg.content_or_style_reg if batch.get("is_reg") else cfg.content_or_style
    return schedule.sample_timesteps(generator, latents.shape[0], cfg.min_denoising_steps, cfg.max_denoising_steps,
                                     cos, tt, cfg.next_sample_timesteps, device=latents.device)


@torch.no_grad()
def eval_loss(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, batch: dict,
              generator: torch.Generator) -> torch.Tensor:
    """The validation loss of ``batch`` (JAX ``make_eval_step`` /
    ``_eval_loss``): t and then the noise drawn from ``generator`` (the job
    seeds it with ``validation.seed`` for every evaluation), flow t at the
    step's ``timestep_type`` without its bias, DDPM t from the full balanced
    range, the plain loss at the step's ``loss_type``: no knob, no weight, no
    mask, no aux loss; a joint AV batch adds its audio loss unweighted, as
    JAX's does. No gradient; the optimizer and the EMA are not touched."""
    latents = batch["latents"]
    if isinstance(schedule, FlowMatchSchedule):
        t = schedule.sample_timesteps(generator, latents.shape[0], cfg.timestep_type,
                                      batch.get("image_seq_len"), device=latents.device)
    else:
        t = schedule.sample_timesteps(generator, latents.shape[0], device=latents.device)
    draws = Draws(generator, latents.device)
    noise = draws.normal(latents.shape, latents.dtype)
    plain = {k: batch[k] for k in ("latents", "cond", "audio_latents", "image_seq_len") if k in batch}
    return train_loss(predict_fn, schedule, TrainStepConfig(loss_type=cfg.loss_type, huber_c=cfg.huber_c), plain,
                      noise, t, draws=draws)[0]


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


def make_train_step(predict_fn: PredictFn, schedule, cfg: TrainStepConfig, micro_loss=None, aux_loss_fn=None,
                    decode_fn=None):
    """``train_step(state, batches, generator) -> metrics`` over ``grad_accum``
    micro-batches. Each holds ``latents`` ``[B, h, w, C]`` (video: ``[B, T, h, w, C]``), ``cond``,
    ``loss_multiplier``, (flow matching) ``image_seq_len`` and what the knobs read (``mask``,
    ``neg_cond``, ``blank_cond``, ``uncond_cond``, ``noise_seed``, ``pixel_values``, ``is_reg``);
    t, the noise and every other draw come from ``generator`` on the latents' device.
    ``micro_loss(batch, generator, t_range) -> (loss, aux)`` takes the place of the diffusion loss
    (the paired-image guidance losses, ``train/slider.make_guidance_loss``); accumulation,
    clipping, the optimizer and the EMA stay as they are. ``aux_loss_fn`` adds its term to the
    diffusion loss, ``decode_fn`` is ``train_turbo``'s VAE decode. The learnable SNR state rides
    on ``state.lsnr`` (None: off), one update a micro-batch."""
    cfg.check(isinstance(schedule, FlowMatchSchedule), decode_fn is not None)

    def micro(batch, generator, t_range, lsnr):
        t = sample_t(schedule, cfg, batch, generator, t_range)
        return microbatch_loss(predict_fn, schedule, cfg, batch, t, Draws(generator, batch["latents"].device),
                               aux_loss_fn, decode_fn, lsnr)

    def train_step(state, batches: list[dict], generator: torch.Generator) -> dict:
        if len(batches) != cfg.grad_accum:
            raise ValueError(f"train_step got {len(batches)} micro-batches, grad_accum is {cfg.grad_accum}")
        params = list(state.trainable.values())
        grads, loss, aux = None, 0.0, {}
        t_range = stage_range(cfg, state.step)
        lsnr = getattr(state, "lsnr", None)
        with record_function("train_step: forward and backward"):
            for batch in batches:
                if micro_loss is not None:
                    l_i, a_i = micro_loss(batch, generator, t_range)
                else:
                    l_i, a_i = micro(batch, generator, t_range, lsnr)
                    lsnr = a_i.pop("new_lsnr", lsnr)
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
            if lsnr is not None:
                state.lsnr = lsnr
        return {"loss": loss, "grad_norm": grad_norm, **aux}

    return train_step
