"""The concept slider job (``ai_toolkit_tpu/jobs/slider_process.py``
``TrainSliderProcess`` in PyTorch), process types ``slider``,
``concept_slider`` and ``slider_trainer``: a LoRA whose +/- multiplier
steers a concept, trained from prompt pairs alone (no images).

model (seeded with 42, or the local checkpoint of ``name_or_path``) -> LoRA
on its main component (``network``, else rank 8 / alpha 8, seeded with 1) ->
AdamW(8bit) at a constant lr -> each target's neutral (``target_class``),
positive and negative prompts encoded once (a flow model's rope table and
guidance 1 added at ``slider.resolutions[0]``) -> steps: target ``step %
targets``, multiplier +weight on even steps and -weight on odd ones (at -w
the positive and negative conditions swap and the step trains at |w|); the
start is pure noise at a sampled t (DDPM) or, on a flow model, the noise
denoised a random ``[1, max_denoising_steps - 1)`` Euler steps by the LoRA at
the step's multiplier (``train/slider.partial_denoise``; the count from
``np.random.default_rng(0)``, as the JAX job draws it); then
``train/slider.concept_slider_loss`` at ``guidance_strength`` -> the final
save, ``<training_folder>/<name>/<name>.safetensors``, in fp16 with the JAX
job's keys: kohya ``lora_unet_...`` for the UNet, PEFT ``transformer....``
for a flow DiT. The noise and t come from a ``torch.Generator`` seeded with
0, so their values differ from the JAX job's ``jax.random`` draws.

Archs: the SD 1.x / 2.x UNets and the flux DiTs that take no control
latents (the JAX job builds no added condition for SDXL and no control
latents); the others raise. Every option the JAX job does not read raises
when it is set (``_refuse_unported``).
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora, count_lora_params
from ai_toolkit_tpu_torch.config.modules import (ModelConfig, ProcessConfig, SaveConfig, TrainConfig,
                                                 print_unread_network)
from ai_toolkit_tpu_torch.io.checkpoint import CheckpointManager
from ai_toolkit_tpu_torch.jobs.train_process import _UNPORTED_MODEL, _sync
from ai_toolkit_tpu_torch.models.registry import get_model_class
from ai_toolkit_tpu_torch.samplers.factory import get_schedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.slider import concept_slider_loss, partial_denoise
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

SLIDER_KEYS = ("targets", "resolutions", "guidance_strength", "max_denoising_steps")
TARGET_KEYS = ("target_class", "positive", "negative", "weight")
# the TrainConfig fields the slider jobs read; every other one must stay at its default
TRAIN_READ = ("steps", "optimizer", "lr", "optimizer_params", "max_grad_norm", "noise_scheduler")

def refuse_slider_config(cfg: ProcessConfig, slider_keys, train_read, datasets: bool) -> dict:
    """The checks both slider jobs share: the ``slider`` section's keys and
    targets, the train fields (``train_read`` are read), the sections the
    JAX jobs do not read (``save``, ``sample`` prompts, ``validation``, an
    adapter or embedding, a mesh, datasets unless ``datasets``), the network
    type and the arch. Returns the slider section."""
    from ai_toolkit_tpu_torch.models.flux_model import FluxModel
    from ai_toolkit_tpu_torch.models.sd_model import SDModel, SDXLModel

    slider = cfg.slider or cfg.extras.get("slider") or {}
    unknown = sorted(set(slider) - set(slider_keys))
    if unknown:
        raise NotImplementedError(f"slider keys {unknown} are not read (read: {list(slider_keys)})")
    targets = slider.get("targets") or []
    if not targets:
        raise ValueError("slider config needs targets: [{positive, negative, ...}]")
    for tgt in targets:
        extra = sorted(set(tgt) - set(TARGET_KEYS))
        if extra:
            raise NotImplementedError(f"slider target keys {extra} are not read (read: {list(TARGET_KEYS)})")
        if "positive" not in tgt or "negative" not in tgt:
            raise ValueError(f"slider target {tgt} needs a positive and a negative prompt")
    defaults = TrainConfig()
    unread = [f.name for f in dataclasses.fields(TrainConfig)
              if f.name not in train_read and f.name != "extras"
              and getattr(cfg.train, f.name) != getattr(defaults, f.name)]
    unread += sorted(cfg.train.extras)
    if unread:
        raise NotImplementedError(f"train {unread}: the {cfg.type} job does not read them")
    refuse_unported(cfg.model, ("quantize",) + _UNPORTED_MODEL, ModelConfig(), "model")
    if cfg.save != SaveConfig():
        raise NotImplementedError(f"save: the {cfg.type} job saves once, at the end, in fp16 (as the JAX job)")
    if cfg.sample.prompts:
        raise NotImplementedError(f"sample prompts: the {cfg.type} job does not sample")
    if cfg.validation.validate_every:
        raise NotImplementedError(f"validate_every: the {cfg.type} job does not validate")
    if cfg.adapter or cfg.embedding:
        raise NotImplementedError(f"an adapter or embedding in a {cfg.type} job (it trains a LoRA)")
    if any(n not in (1, -1) for n in cfg.mesh.axes.values()):
        raise NotImplementedError(f"mesh {cfg.mesh.axes}: multi-GPU comes with a later slice")
    if cfg.datasets and not datasets:
        raise NotImplementedError(f"datasets: the {cfg.type} job trains from prompts alone")
    if cfg.trigger_word and not datasets:
        raise NotImplementedError(f"trigger_word: the {cfg.type} job reads no captions")
    extras = sorted(set(cfg.extras) - {"slider"})
    if extras:
        raise NotImplementedError(f"process keys {extras}: the {cfg.type} job does not read them")
    if cfg.network is not None and cfg.network.type not in ("lora", "locon"):
        raise NotImplementedError(f"network '{cfg.network.type}': the {cfg.type} job trains a LoRA (its per-sample "
                                  f"multiplier on other networks comes with ROADMAP Queue 1 item 6e)")
    cls = get_model_class(cfg.model.arch)
    sd = issubclass(cls, SDModel) and not issubclass(cls, SDXLModel)
    if not (sd or (issubclass(cls, FluxModel) and cfg.model.arch not in ("flex2", "flux_kontext"))):
        raise NotImplementedError(f"a {cfg.type} job on arch '{cfg.model.arch}' (ported: the SD 1.x / 2.x UNets "
                                  f"{SDModel.archs} and the flux DiTs without control latents)")
    return slider


class SliderSetup:
    """What both slider jobs build: the model and its variables, the
    schedule, the LoRA (its trainable tensors in a :class:`TrainState`
    with the optimizer), ``predict_fn`` and each target's conditions."""

    def __init__(self, cfg: ProcessConfig, device: torch.device, resolution):
        tc = cfg.train
        self.device = device
        t0 = time.perf_counter()
        self.model = model = get_model_class(cfg.model.arch)(cfg.model, device)
        self.variables = variables = model.load_variables(torch.Generator(device=device).manual_seed(42))
        _sync(device)
        self.load_s = time.perf_counter() - t0
        self.is_flow = model.is_flow_matching
        self.schedule = get_schedule(tc.noise_scheduler, cfg.model.arch)
        print_unread_network(cfg.network)
        spec = (LoRASpec.from_network_config(cfg.network, target_patterns=model.lora_targets())
                if cfg.network is not None else LoRASpec(rank=8, alpha=8, target_patterns=model.lora_targets()))
        self.lora = build_lora(variables[model.main_component], spec, torch.Generator(device=device).manual_seed(1))
        self.trainable = {f"{n}.{leaf}": p for n, m in self.lora.items() for leaf, p in m.named_parameters()}
        self.params = list(self.trainable.values())
        tx = get_optimizer(tc.optimizer, self.params, tc.lr, tc.optimizer_params, tc.max_grad_norm)
        self.state = TrainState(self.trainable, tx)
        print(f"LoRA: {len(self.lora)} modules, {count_lora_params(self.lora):,} trainable params "
              f"(rank {spec.rank})")
        self.latent_hw = model.latent_shape(resolution[1], resolution[0])

    def predict_fn(self, noisy: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        return self.model.predict(self.variables, noisy, t, cond)

    @torch.no_grad()
    def encode(self, prompts: list[str], h: int, w: int) -> dict:
        """The prompts' conditions; a flow model's with its rope table at the
        latent ``h`` x ``w`` and guidance 1 per prompt (JAX ``rope_table``)."""
        cond = dict(self.model.encode_prompt(self.variables, prompts))
        if hasattr(self.model, "rope_table"):
            txt_len = int(next(iter(cond.values())).shape[1])
            cond["pe"] = self.model.rope_table(h, w, txt_len)
            cond["guidance"] = torch.ones(len(prompts), device=self.device)
        return cond

    def target_conds(self, targets: list[dict]) -> list[tuple[dict, dict, dict, float]]:
        """(neutral, positive, negative, weight) of each target, encoded once."""
        h, w, _ = self.latent_hw
        return [(self.encode([tgt.get("target_class", "")], h, w), self.encode([tgt["positive"]], h, w),
                 self.encode([tgt["negative"]], h, w), float(tgt.get("weight", 1.0))) for tgt in targets]

    def step(self, loss: torch.Tensor) -> float:
        """One optimizer step on the LoRA from ``loss``'s gradients."""
        grads = torch.autograd.grad(loss, self.params)
        self.state.apply_gradients(list(grads))
        return float(loss.detach())

    def save(self, save_root: str, name: str, steps: int) -> str:
        """The final save with the JAX job's keys: kohya ``lora_unet_...`` for
        the UNet, PEFT for a flow DiT, fp16, the step in the metadata."""
        ckpt = CheckpointManager(save_root, name, fmt="peft" if self.is_flow else "kohya",
                                 key_map=getattr(self.model, "lora_key", None))
        tree = {n: {leaf: self.trainable[f"{n}.{leaf}"].detach() for leaf in ("a", "b", "scale")} for n in self.lora}
        return ckpt.save(tree, steps, final=True)


class TrainSliderProcess:
    """Process types ``slider`` / ``concept_slider`` / ``slider_trainer``."""

    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        self.device = torch.device(device)
        self.save_root = os.path.join(cfg.training_folder, job_name)

    def _refuse_unported(self) -> dict:
        return refuse_slider_config(self.cfg, SLIDER_KEYS, TRAIN_READ, datasets=False)

    def run(self) -> dict:
        cfg, tc, dev = self.cfg, self.cfg.train, self.device
        slider = self._refuse_unported()
        res = (slider.get("resolutions") or [[512, 512]])[0]
        strength = float(slider.get("guidance_strength", 3.0))
        max_dn = int(slider.get("max_denoising_steps", 40))
        setup = self.setup = SliderSetup(cfg, dev, res)
        conds = setup.target_conds(slider["targets"])
        sigmas = setup.schedule.inference_sigmas(max_dn) if setup.is_flow else None
        generator = torch.Generator(device=dev).manual_seed(0)
        host_rng = np.random.default_rng(0)
        losses, step_ms, plan = [], [], []
        for step in range(tc.steps):
            index = step % len(conds)
            cond_n, cond_p, cond_g, weight = conds[index]
            mult = weight if step % 2 == 0 else -weight  # +weight enhances, -weight suppresses
            _sync(dev)
            t0 = time.perf_counter()
            h, w, c = setup.latent_hw
            x = torch.randn((1, h, w, c), generator=generator, dtype=torch.float32, device=dev)
            if setup.is_flow:  # the start: the noise denoised a random count of Euler steps at mult
                steps_to = int(host_rng.integers(1, max_dn - 1))
                noisy, t = partial_denoise(setup.predict_fn, sigmas, x, steps_to, cond_n, mult)
            else:  # pure noise at a sampled t
                steps_to, noisy, t = 0, x, setup.schedule.sample_timesteps(generator, 1, device=dev)
            if mult < 0:
                cond_p, cond_g = cond_g, cond_p
            losses.append(setup.step(concept_slider_loss(setup.predict_fn, noisy, t, cond_p, cond_n, cond_g,
                                                         strength, abs(mult))))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            plan.append({"target": index, "multiplier": mult, "swapped": mult < 0, "denoise_steps": steps_to})
            if (step + 1) % cfg.logging.log_every == 0 or step == 0:
                print(f"slider step {step + 1}/{tc.steps} loss={losses[-1]:.5f} multiplier={mult:+g}"
                      f"{f' denoise_steps={steps_to}' if setup.is_flow else ''} ({step_ms[-1]:.1f} ms)")
        path = setup.save(self.save_root, self.job_name, tc.steps)
        print(f"saved: {path}")
        return {"final_loss": losses[-1] if losses else None, "losses": losses, "step_ms": step_ms,
                "median_step_ms": statistics.median(step_ms) if step_ms else None, "plan": plan,
                "steps": tc.steps, "save_path": path, "lora_modules": len(setup.lora),
                "trainable_params": count_lora_params(setup.lora), "load_s": setup.load_s}
