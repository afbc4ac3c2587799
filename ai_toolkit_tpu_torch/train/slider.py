"""Slider and paired-image guidance losses (``ai_toolkit_tpu/train/slider.py``
in PyTorch).

Every function takes ``predict_fn(noisy, t, cond)``: the model with its LoRA
attached. Where JAX applies ``scale_lora(lora, mult)`` to the ``lora`` tree,
the forward here runs under ``ops.layers.lora_multiplier(mult)``, and where
JAX drops the tree for an adapter-off prior, under ``ADAPTER_OFF``; the
priors and targets carry no gradient (JAX ``stop_gradient``). The noise and
t are arguments, drawn by the caller (:func:`pair_draws`), so the losses can
be held against JAX's on the same draws.

- :func:`concept_slider_loss` (JAX ``:84``): the adapter at ``multiplier``
  on the neutral prompt regresses to prior(neutral) + strength *
  (prior(positive) - prior(negative)).
- :func:`polarity_loss` (JAX ``make_polarity_train_step``): the positive
  and negative images of a pair in one batch, the adapter at +w on the
  first half and -w on the second, each regressed to its own target.
- :func:`guided_loss` (JAX ``make_guided_train_step``): the kinds
  ``targeted``, ``targeted_polarity``, ``direct``, ``tnt`` and
  ``targeted_flow`` over the same pairs.
- :func:`ultimate_slider_loss`: the image-pair and the concept loss of
  the ultimate slider, weighted, in one graph.
- :func:`partial_denoise`: the flow slider's start, Euler steps with the
  LoRA at the step's multiplier (JAX ``slider_process`` ``partial_denoise``).

``concept_replacer`` (JAX ``make_concept_replacer_train_step``) needs the
replacement prompts that only the ``concept_replacer`` job builds, and is
not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from ai_toolkit_tpu_torch.ops.layers import ADAPTER_OFF, lora_multiplier
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule

PredictFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]

GUIDED_KINDS = ("targeted", "targeted_polarity", "direct", "tnt", "targeted_flow")
GUIDANCE_KINDS = ("polarity",) + GUIDED_KINDS


def _double(v):
    """A cond entry for the doubled batch: a tensor whose leading dim is not
    1 is concatenated with itself (JAX ``_double``)."""
    if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] != 1:
        return torch.cat([v, v], 0)
    return v


def _value_map(x, in_min, in_max, out_min, out_max):
    return out_min + (x - in_min) * (out_max - out_min) / torch.clamp(in_max - in_min, min=1e-8)


def _per_sample_minmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """min and max over all non-batch dims, kept as dims of size 1."""
    flat = x.flatten(1)
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return flat.min(1).values.reshape(shape), flat.max(1).values.reshape(shape)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.square(a.float() - b.float())


def _full(b: int, value, like: torch.Tensor) -> torch.Tensor:
    """A ``[b]`` f32 multiplier vector (``value`` a float or a 0-d tensor)."""
    return torch.ones(b, dtype=torch.float32, device=like.device) * value


def _predict(predict_fn: PredictFn, noisy, t, cond, mult):
    with lora_multiplier(mult):
        return predict_fn(noisy, t, cond)


@torch.no_grad()
def _prior(predict_fn: PredictFn, noisy, t, cond) -> torch.Tensor:
    return _predict(predict_fn, noisy, t, cond, ADAPTER_OFF)


def concept_slider_loss(predict_fn: PredictFn, noisy: torch.Tensor, t: torch.Tensor, cond_target: dict,
                        cond_neutral: dict, cond_negative: dict, guidance_strength: float = 3.0,
                        multiplier=1.0) -> torch.Tensor:
    """Prompt-pair concept slider (JAX ``concept_slider_loss``): the
    adapter-off priors on the neutral, target and negative prompts give the
    target prior(neutral) + strength * (prior(target) - prior(negative)),
    and the adapter at ``multiplier`` on the neutral prompt regresses to it."""
    prior_neutral = _prior(predict_fn, noisy, t, cond_neutral)
    prior_pos = _prior(predict_fn, noisy, t, cond_target)
    prior_neg = _prior(predict_fn, noisy, t, cond_negative)
    target = prior_neutral + guidance_strength * (prior_pos - prior_neg)
    pred = _predict(predict_fn, noisy, t, cond_neutral, multiplier)
    return torch.mean(_mse(pred, target))


def _pair_prediction(predict_fn: PredictFn, schedule, batch: dict, noise: torch.Tensor, t: torch.Tensor,
                     network_weight) -> tuple[torch.Tensor, torch.Tensor]:
    """The positive and negative images of a pair noised alike, one batch at
    multipliers ``[+w] * B + [-w] * B``: (prediction, target), each ``2B``
    long, positives first. ``network_weight`` is a float or a 0-d f32 tensor."""
    pos, neg = batch["latents"], batch["unconditional_latents"]
    b = pos.shape[0]
    lats = torch.cat([schedule.add_noise(pos, noise, t), schedule.add_noise(neg, noise, t)], 0)
    mult = torch.cat([_full(b, network_weight, pos), _full(b, -network_weight, pos)])
    cond = {k: _double(v) for k, v in batch.get("cond", {}).items()}
    pred = _predict(predict_fn, lats, torch.cat([t, t]), cond, mult)
    return pred, torch.cat([schedule.target(pos, noise, t), schedule.target(neg, noise, t)], 0)


def polarity_loss(predict_fn: PredictFn, schedule, batch: dict, noise: torch.Tensor, t: torch.Tensor,
                  network_weight=1.0) -> torch.Tensor:
    """Image-pair slider (JAX ``make_polarity_train_step``'s loss): the sum
    of both halves' MSE against their own targets."""
    pred, target = _pair_prediction(predict_fn, schedule, batch, noise, t, network_weight)
    (pred_pos, pred_neg), (target_pos, target_neg) = pred.chunk(2, 0), target.chunk(2, 0)
    return torch.mean(_mse(pred_pos, target_pos)) + torch.mean(_mse(pred_neg, target_neg))


def ultimate_slider_loss(predict_fn: PredictFn, schedule, batch: dict, img_noise: torch.Tensor,
                         img_t: torch.Tensor, network_weight, noisy: torch.Tensor, t: torch.Tensor,
                         cond_target: dict, cond_neutral: dict, cond_negative: dict, guidance_strength: float,
                         multiplier, img_loss_weight: float = 1.0,
                         cfg_loss_weight: float = 1.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ultimate slider's objective (JAX ``ultimate_slider_process``
    ``total_loss``): ``img_loss_weight`` times the image-pair loss (the
    pair at ``[+w] * B + [-w] * B``, one MSE over the joined ``2B`` batch:
    JAX ``img_pair_loss``, half the polarity step's sum) plus
    ``cfg_loss_weight`` times :func:`concept_slider_loss`, one graph for one
    backward. Returns (total, image loss, concept loss)."""
    pred, target = _pair_prediction(predict_fn, schedule, batch, img_noise, img_t, network_weight)
    l_img = torch.mean(_mse(pred, target))
    l_cfg = concept_slider_loss(predict_fn, noisy, t, cond_target, cond_neutral, cond_negative,
                                guidance_strength, multiplier)
    return img_loss_weight * l_img + cfg_loss_weight * l_cfg, l_img, l_cfg


def _targeted_half(predict_fn, schedule, cond, cond_lat, uncond_lat, t, noise, w) -> torch.Tensor:
    noisy_c = schedule.add_noise(cond_lat, noise, t)
    noisy_u = schedule.add_noise(uncond_lat, noise, t)
    prior_loss = _mse(_prior(predict_fn, noisy_u, t, cond), noise)
    diff = torch.abs(uncond_lat - cond_lat).float()
    dmin, dmax = _per_sample_minmax(diff)
    scaler = _value_map(diff, dmin, dmax, 1.0, 2.0)
    b = cond_lat.shape[0]
    mult = torch.cat([_full(b, w, cond_lat), _full(b, w - 1.0, cond_lat)])
    cond2 = {k: _double(v) for k, v in cond.items()}
    pred = _predict(predict_fn, torch.cat([noisy_c, noisy_u]), torch.cat([t, t]), cond2, mult)
    pred_c, pred_u = pred.chunk(2, 0)
    cond_loss = _mse(pred_c, noise)
    uncond_loss = _mse(pred_u, noise)
    positive = torch.mean(torch.abs(cond_loss - prior_loss) * scaler)
    polar = torch.mean(torch.abs(cond_loss - uncond_loss))
    return positive + polar


def guided_loss(kind: str, predict_fn: PredictFn, schedule, batch: dict, noise: torch.Tensor,
                t: torch.Tensor, network_weight: float = 1.0) -> torch.Tensor:
    """The paired-image guidance objectives (JAX ``make_guided_train_step``'s
    loss), on ``latents`` (conditional), ``unconditional_latents`` and the
    shared ``cond``:

    - ``targeted``: the adapter-off prior on the unconditional image anchors
      ``|cond_loss - prior_loss|`` scaled by the latent difference mapped to
      [1, 2], plus the polar ``|cond_loss - uncond_loss|``; the
      unconditional half runs at ``w - 1``;
    - ``targeted_polarity``: ``targeted`` at +w and with the pair swapped at
      -w, averaged;
    - ``direct``: ``pred_u + 1.1 (pred_c - pred_u)`` regressed to the noise;
    - ``tnt``: the loss on the conditional half minus the one on the
      unconditional half, scaled by their ratio and 0.01;
    - ``targeted_flow``: the noise recovered from the adapter-off prediction
      on the unconditional image, blended with the true noise by the latent
      difference mapped to [0, 1], minus the conditional latents, is the
      target of the adapter at +w."""
    cond = batch.get("cond", {})
    pos, neg = batch["latents"], batch["unconditional_latents"]
    b = pos.shape[0]
    w = network_weight
    if kind == "targeted":
        return _targeted_half(predict_fn, schedule, cond, pos, neg, t, noise, w)
    if kind == "targeted_polarity":
        l1 = _targeted_half(predict_fn, schedule, cond, pos, neg, t, noise, w)
        l2 = _targeted_half(predict_fn, schedule, cond, neg, pos, t, noise, -w)
        return 0.5 * (l1 + l2)
    noisy_c = schedule.add_noise(pos, noise, t)
    noisy_u = schedule.add_noise(neg, noise, t)
    cond2 = {k: _double(v) for k, v in cond.items()}
    tt = torch.cat([t, t])
    if kind == "direct":
        pred_u, pred_c = _predict(predict_fn, torch.cat([noisy_u, noisy_c]), tt, cond2,
                                  _full(2 * b, w, pos)).chunk(2, 0)
        guided = pred_u + 1.1 * (pred_c - pred_u)
        return torch.mean(_mse(guided, noise))
    if kind == "tnt":
        pred_this, pred_that = _predict(predict_fn, torch.cat([noisy_c, noisy_u]), tt, cond2,
                                        _full(2 * b, w, pos)).chunk(2, 0)
        dims = tuple(range(1, pos.dim()))
        this_loss = _mse(pred_this, noise).mean(dims)
        that_loss = -_mse(pred_that, noise).mean(dims)
        scaler = (torch.abs(this_loss) / torch.clamp(torch.abs(that_loss), min=1e-8)).detach()
        return torch.mean(this_loss + that_loss * scaler * 0.01)
    if kind == "targeted_flow":
        diff = torch.abs(neg - pos).float()
        dmin, dmax = _per_sample_minmax(diff)
        mask = _value_map(diff, dmin, dmax, 0.0, 1.0)
        baseline_noise = _prior(predict_fn, noisy_u, t, cond).float() + neg.float()
        target_noise = mask * noise.float() + (1.0 - mask) * baseline_noise
        target_pred = target_noise - pos.float()
        pred = _predict(predict_fn, noisy_c, t, cond, _full(b, w, pos))
        return torch.mean(_mse(pred, target_pred))
    raise NotImplementedError(f"guidance kind '{kind}' (ported: {list(GUIDANCE_KINDS)})")


def pair_draws(schedule, timestep_type: str, batch: dict,
               generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """t ``[B]`` and then the noise of a paired batch, from ``generator`` (JAX
    ``_pair_setup``'s draws): flow t at ``timestep_type`` without the step's
    bias, DDPM t from the full balanced range, the noise normal in f32 cast
    to the latents' dtype."""
    pos = batch["latents"]
    if isinstance(schedule, FlowMatchSchedule):
        t = schedule.sample_timesteps(generator, pos.shape[0], timestep_type, batch.get("image_seq_len"),
                                      device=pos.device)
    else:
        t = schedule.sample_timesteps(generator, pos.shape[0], device=pos.device)
    noise = torch.randn(pos.shape, generator=generator, dtype=torch.float32, device=pos.device).to(pos.dtype)
    return t, noise


def make_guidance_loss(kind: str, predict_fn: PredictFn, schedule, timestep_type: str,
                       network_weight: float = 1.0):
    """``micro(batch, generator, t_range) -> (loss, aux)`` for
    ``train/step.make_train_step``: ``polarity`` or one of
    :data:`GUIDED_KINDS` on a paired batch, its draws from the step's
    generator (:func:`pair_draws`). A batch without ``unconditional_latents``
    raises, naming the dataset option that gives them."""
    if kind not in GUIDANCE_KINDS:
        raise NotImplementedError(f"guidance kind '{kind}' (ported: {list(GUIDANCE_KINDS)})")

    def micro(batch: dict, generator: torch.Generator, t_range=None):
        if "unconditional_latents" not in batch:
            raise ValueError(f"guidance_loss '{kind}' trains on image pairs: give every dataset an "
                             f"unconditional_path whose images share the training images' file names")
        t, noise = pair_draws(schedule, timestep_type, batch, generator)
        if kind == "polarity":
            return polarity_loss(predict_fn, schedule, batch, noise, t, network_weight), {}
        return guided_loss(kind, predict_fn, schedule, batch, noise, t, network_weight), {}

    return micro


@torch.no_grad()
def partial_denoise(predict_fn: PredictFn, sigmas: torch.Tensor, x: torch.Tensor, steps_to: int, cond: dict,
                    multiplier) -> tuple[torch.Tensor, torch.Tensor]:
    """``steps_to`` Euler steps from the noise ``x`` over the sigma table
    ``sigmas`` (the schedule's ``inference_sigmas``), the LoRA at
    ``multiplier``: ``x + (sigmas[i + 1] - sigmas[i]) v`` in ``x``'s dtype.
    Returns the latent and its t ``[B]`` = ``sigmas[steps_to]`` (JAX
    ``slider_process`` ``partial_denoise``'s ``fori_loop``)."""
    b = x.shape[0]
    with lora_multiplier(multiplier):
        for i in range(steps_to):
            s0 = sigmas[i]
            v = predict_fn(x, torch.full((b,), float(s0), device=x.device), cond)
            x = x + (sigmas[i + 1] - s0).to(x.device) * v.to(x.dtype)
    return x, torch.full((b,), float(sigmas[steps_to]), device=x.device)
