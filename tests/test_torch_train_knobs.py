"""The train-step knobs (``ai_toolkit_tpu_torch/train/{step,losses}.py``,
``samplers/{flowmatch,ddpm}.py``) against the JAX package's
``train/step.make_train_step`` on the CPU.

Each case runs one micro-batch of a tiny linear ``predict_fn`` (a LoRA delta
on it, so an adapter-off forward differs) through both steps: the same
seeded latents, conditions, mask and timesteps, and every draw the port's
step makes (the noise, then each knob's, in the JAX step's order) handed to
JAX through ``jax.random``. The loss, the metrics and the LoRA gradients
are held at f32 ``rtol`` 1e-5 with ``atol`` 1e-5 of max|ref|. The JAX
reference compiles once per case at XLA's backend optimization level 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ai_toolkit_tpu.train.step as jstep
from ai_toolkit_tpu.config.modules import TrainConfig as JTrainConfig
from ai_toolkit_tpu.samplers.ddpm import DDPMSchedule as JDDPM
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JFlow
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.config.modules import TrainConfig
from ai_toolkit_tpu_torch.ops import layers
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import Draws, LearnableSNR, TrainStepConfig, microbatch_loss

from test_torch_flux_family import OPT0
from torch_jax_opt import jax_opt0  # noqa: F401

B, H, W, C, T_TXT, D_TXT = 2, 8, 8, 4, 3, 6


def _weights():
    rng = np.random.default_rng(0)
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)  # noqa: E731
    params = {"w": f(C, C), "wc": f(D_TXT, C), "bias": f(C), "wd": f(C, 3)}
    lora = {"a": f(C, 2), "b": f(2, C)}
    conds = {k: {"txt": f(B, T_TXT, D_TXT)} for k in ("cond", "neg_cond", "blank_cond", "uncond_cond")}
    latents = (rng.standard_normal((B, H, W, C)) * 0.8 + 0.1).astype(np.float32)
    mask = rng.uniform(0.0, 1.0, (B, H, W, 1)).astype(np.float32)
    pixels = rng.uniform(-1, 1, (B, 2 * H, 2 * W, 3)).astype(np.float32)
    return params, lora, conds, latents, mask, pixels


def _tf(t, ddpm):
    return t / 1000.0 if ddpm else t


def jax_predict(ddpm):
    def predict(variables, x, t, cond):
        p = variables["params"]
        tt = _tf(t.astype(jnp.float32), ddpm)
        y = x @ p["w"] + (cond["txt"].mean(1) @ p["wc"])[:, None, None, :] + tt[:, None, None, None] * p["bias"]
        if "lora" in variables:
            y = y + (x @ variables["lora"]["a"]) @ variables["lora"]["b"]
        return y
    return predict


def port_predict(params, lora, ddpm):
    p = {k: torch.from_numpy(v) for k, v in params.items()}

    def predict(x, t, cond):
        tt = _tf(t.float(), ddpm)
        y = x @ p["w"] + (cond["txt"].mean(1) @ p["wc"])[:, None, None, :] + tt[:, None, None, None] * p["bias"]
        if layers._Multiplier.value != layers.ADAPTER_OFF:  # the LoRA overlay's adapter-off switch
            y = y + (x @ lora["a"]) @ lora["b"]
        return y
    return predict


def _upsample(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2) if isinstance(x, torch.Tensor) else \
        jnp.repeat(jnp.repeat(x, 2, 1), 2, 2)


class Recording(Draws):
    """The port's draws, kept in order for JAX."""

    def __init__(self, generator, device):
        super().__init__(generator, device)
        self.log = []

    def normal(self, shape, dtype=torch.float32):
        v = super().normal(shape, dtype)
        self.log.append(("normal", v.float().numpy()))
        return v

    def uniform(self, shape, lo=0.0, hi=1.0):
        v = super().uniform(shape, lo, hi)
        self.log.append(("uniform", v.numpy()))
        return v

    def randint(self, lo, hi):
        v = super().randint(lo, hi)
        self.log.append(("randint", v))
        return v


def _inject(monkeypatch, log):
    queue = list(log)

    def pop(kind, shape):
        got, v = queue.pop(0)
        assert got == kind, f"JAX drew {kind}{tuple(shape)} where the port drew {got}"
        return v

    def normal(key, shape=(), dtype=jnp.float32):
        v = pop("normal", shape)
        assert v.shape == tuple(shape), (v.shape, shape)
        return jnp.asarray(v, dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(pop("uniform", shape), dtype).reshape(shape)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.full(shape, pop("randint", shape), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)
    return queue


FLOW_T, DDPM_T = np.array([0.3, 0.85], np.float32), np.array([120, 730], np.int32)
CASES = {
    "mae_weighted": dict(loss_type="mae", timestep_type="weighted", use_timestep_weights=True),
    "pseudo_huber_half_bell": dict(loss_type="pseudo_huber", huber_c=0.05, timestep_type="linear",
                                   use_timestep_weights=True, timestep_weights_v2=True),
    "wavelet_mask_prior": dict(loss_type="wavelet", inverted_mask_prior=True, inverted_mask_prior_multiplier=0.3,
                               do_prior_pred=True, _mask=True),
    "noise_shaping": dict(standardize_latents=True, adaptive_scaling_factor=True, optimal_noise_pairing_samples=3,
                          noise_multiplier=1.1, noise_offset=0.1, blended_blur_noise=True, dynamic_noise_offset=True,
                          do_signal_correction_noise=True, signal_correction_noise_scale=0.3,
                          do_batch_noise_correction=True, batch_noise_correction_scale=0.2, random_noise_shift=0.05,
                          random_noise_multiplier=0.1, target_noise_multiplier=0.9, do_signal_amplification=True,
                          signal_amplification_strength=0.5, noisy_multiplier=1.05),
    "prior_and_cfg": dict(diff_output_preservation=True, dop_multiplier=0.7, do_prior_pred=True, do_cfg=True,
                          do_random_cfg=True, max_cfg_scale=3.0, cfg_rescale=0.5),
    "weighting_and_target": dict(correct_pred_norm=True, correct_pred_norm_multiplier=0.8, guidance_loss_target=2.5,
                                 do_guidance_loss_cfg_zero=True, guidance_loss_schedule="sigma", pred_scaler=1.2,
                                 target_norm_std=True, target_norm_std_value=0.9, do_differential_guidance=True,
                                 differential_guidance_scale=2.0),
    "t0_and_fft": dict(t0_loss_target=True, t0_velocity_equiv_weight=True, do_fft_loss=True,
                       do_fft_velocity_equiv_weight=True),
    "loss_target_source": dict(loss_target_mode="source", timestep_type="weighted", use_timestep_weights=True),
    "stepped": dict(loss_type="stepped"),
    "blank_prompt_preservation": dict(blank_prompt_preservation=True, blank_prompt_preservation_multiplier=0.5,
                                      max_loss=1e6),
    "ddpm_learnable_snr_max_loss": dict(learnable_snr=True, max_loss=1e-9, _ddpm=True),
    "ddpm_turbo_mask": dict(train_turbo=True, min_snr_gamma=5.0, _ddpm=True, _mask=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_knob_group_matches_jax(case, monkeypatch):
    kw = dict(CASES[case])
    ddpm, masked = kw.pop("_ddpm", False), kw.pop("_mask", False)
    params, lora_np, conds, latents, mask, pixels = _weights()
    t_np = DDPM_T if ddpm else FLOW_T

    # the port
    lora = {k: torch.tensor(v, requires_grad=True) for k, v in lora_np.items()}
    sched = DDPMSchedule() if ddpm else FlowMatchSchedule()
    batch = {"latents": torch.from_numpy(latents), "loss_multiplier": torch.tensor([1.0, 0.5]),
             **{k: {"txt": torch.from_numpy(v["txt"])} for k, v in conds.items()}}
    if masked:
        batch["mask"] = torch.from_numpy(mask)
    if kw.get("train_turbo"):
        batch["pixel_values"] = torch.from_numpy(pixels)
    wd = torch.from_numpy(params["wd"])
    decode = (lambda lat: _upsample(lat @ wd)) if kw.get("train_turbo") else None
    lsnr = LearnableSNR("cpu") if kw.get("learnable_snr") else None
    rec = Recording(torch.Generator().manual_seed(5), "cpu")
    loss, aux = microbatch_loss(port_predict(params, lora, ddpm), sched, TrainStepConfig(**kw), batch,
                                torch.from_numpy(t_np), rec, decode_fn=decode, lsnr=lsnr)
    grads = torch.autograd.grad(loss, [lora["a"], lora["b"]])

    # JAX, with the port's t and draws
    base = JDDPM if ddpm else JFlow

    class Injected(base):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t_np)

    jcfg = jstep.TrainStepConfig(**kw)
    jdecode = (lambda v, lat: _upsample(lat @ v["params"]["wd"])) if kw.get("train_turbo") else None
    train = jstep.make_train_step(jax_predict(ddpm), Injected(), jcfg, decode_fn=jdecode)
    trainable = {"lora": {k: jnp.asarray(v) for k, v in lora_np.items()}}
    if lsnr is not None:
        trainable["lsnr"] = jstep.init_lsnr_state()
    jstate = JTrainState.create({"params": {k: jnp.asarray(v) for k, v in params.items()}}, trainable,
                                optax.sgd(0.0))
    jbatch = {"latents": jnp.asarray(latents), "loss_multiplier": jnp.asarray([1.0, 0.5]),
              **{k: {"txt": jnp.asarray(v["txt"])} for k, v in conds.items()}}
    if masked:
        jbatch["mask"] = jnp.asarray(mask)
    if kw.get("train_turbo"):
        jbatch["pixel_values"] = jnp.asarray(pixels)
    queue = _inject(monkeypatch, rec.log)
    real_apply = JTrainState.apply_gradients

    def run(s, b):
        seen = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, g, **k: seen.append(g) or real_apply(self, g,
                                                                                                           **k))
        new, metrics = train(s, b, jax.random.key(0))
        return new, metrics, seen[0]

    new, metrics, jgrads = jax.jit(run, compiler_options=OPT0)(jstate, jbatch)
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    assert not queue, f"JAX left {len(queue)} of the port's draws unused"

    np.testing.assert_allclose(float(loss), float(metrics["loss"]), rtol=1e-5, atol=1e-7)
    for k, v in aux.items():
        if k == "new_lsnr":
            for name in LearnableSNR.KEYS:
                np.testing.assert_allclose(float(v.params[name]), float(new.trainable["lsnr"]["params"][name]),
                                           rtol=1e-5, atol=1e-7, err_msg=f"lsnr {name}")
            continue
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-5, atol=1e-7, err_msg=f"{case}: aux {k}")
    for g, k in zip(grads, ("a", "b")):
        ref = np.asarray(jgrads["lora"][k])
        scale = float(np.abs(ref).max())
        if "max_loss" in kw and kw["max_loss"] < 1:
            assert scale == 0.0 and float(g.abs().max()) == 0.0
            continue
        assert scale > 0, f"{case}: zero reference gradient {k}"
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5, atol=1e-5 * scale, err_msg=f"{case}: grad {k}")


def test_lognorm_blend_and_one_step_match_jax():
    """``lognorm_blend`` from JAX's own draws of one key (u, the normal, the
    pick from ``fold_in(key, 1)``), and ``one_step``, through the port."""
    key = jax.random.key(7)
    ref = np.asarray(JFlow().sample_timesteps(key, 16, "lognorm_blend"))
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (16,), minval=1e-4, maxval=1.0 - 1e-4)))
    z = torch.from_numpy(np.asarray(jax.random.normal(key, (16,))))
    pick = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (16,))))
    got = FlowMatchSchedule()._finish(FlowMatchSchedule.lognorm_blend(u, z, pick), 1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    one = FlowMatchSchedule().sample_timesteps(g, 3, "one_step", timestep_bias=2.0)
    np.testing.assert_array_equal(one.numpy(), np.asarray(JFlow().sample_timesteps(key, 3, "one_step", None, 2.0)))
    assert FlowMatchSchedule().sample_timesteps(g, 64, "lognorm_blend").min() >= 1e-5


@pytest.mark.parametrize("kind", ["weighted_table", "weighted_bell", "linear", "linear2"])
def test_loss_weights_match_jax(kind):
    t = np.linspace(0.0, 1.0, 37, dtype=np.float32)
    table = tuple(float(x) for x in np.linspace(0.5, 2.0, 1000)) if kind == "weighted_table" else None
    tt = "weighted" if kind.startswith("weighted") else "linear"
    ref = JFlow(weighting_table=table).loss_weights(jnp.asarray(t), tt, v2=kind == "linear2")
    got = FlowMatchSchedule(weighting_table=table).loss_weights(torch.from_numpy(t), tt, kind == "linear2")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["content", "style", "two_step", "four_step", "eight_step", "one_step",
                                  "next_sample"])
def test_ddpm_timestep_types_match_jax(kind):
    """The cubic skews from the same uniform draws, bit for bit; the grids'
    values are among JAX's draws (4096 of them: each grid point of at most
    ten turns up)."""
    key = jax.random.key(3)
    grid = kind not in ("content", "style")
    ref = np.asarray(JDDPM().sample_timesteps(key, 4096 if grid else 64, 100, 900, "balanced" if grid else kind,
                                              kind if grid else None, 10))
    if grid:
        got = DDPMSchedule().sample_timesteps(torch.Generator().manual_seed(0), 64, 100, 900, "balanced", kind, 10)
        assert set(got.tolist()) <= set(np.unique(ref).tolist())
        return
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (64,))))
    np.testing.assert_array_equal(DDPMSchedule().skewed_timesteps(u, kind, 100, 900).numpy(), ref)


KNOBS = dict(
    linear_timesteps2=True, loss_type="pseudo_huber", pseudo_huber_c=0.02, noise_offset=0.05, noise_multiplier=1.1,
    blended_blur_noise=True, diff_output_preservation=True, diff_output_preservation_multiplier=0.4,
    inverted_mask_prior=True, do_cfg=True, cfg_scale=2.0, do_random_cfg=True, max_cfg_scale=5.0, cfg_rescale=0.3,
    noisy_latent_multiplier=1.02, standardize_latents=True, max_loss=3.0, correct_pred_norm=True,
    learnable_snr_gos=True, t0_loss_target=True, do_fft_loss=True, loss_target="source",
    content_or_style="content", content_or_style_reg="style", do_differential_guidance=True,
    optimal_noise_pairing_samples=4, force_consistent_noise=True, dynamic_noise_offset=True,
    do_signal_correction_noise=True, do_batch_noise_correction=True, random_noise_shift=0.1,
    random_noise_multiplier=0.2, pred_scaler=1.1, target_noise_multiplier=0.9, target_norm_std=True,
    adaptive_scaling_factor=True, min_denoising_steps=10, max_denoising_steps=900, blank_prompt_preservation=True,
    guidance_loss_target=3.0, do_guidance_loss_cfg_zero=True, guidance_loss_schedule="sigma",
    do_signal_amplification=True, next_sample_timesteps=8, train_turbo=True, timestep_bias=1.3,
    min_snr_gamma=5.0, audio_loss_multiplier=0.5)


@pytest.mark.parametrize("loss_type", ["pseudo_huber", "mean_flow"])
def test_step_config_from_train_config_matches_jax(loss_type, capsys):
    """Every field of JAX ``TrainStepConfig.from_train_config`` the port has,
    from one TrainConfig that sets every knob; a loss type JAX does not know
    trains as mse in both, and the port says so."""
    knobs = {**KNOBS, "loss_type": loss_type}
    ref = jstep.TrainStepConfig.from_train_config(JTrainConfig(**knobs))
    got = TrainStepConfig.from_train_config(TrainConfig(**knobs))
    for f in dataclasses.fields(got):
        if f.name in ("stage_boundary", "switch_every"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert ("JAX fault mirrored" in capsys.readouterr().out) == (loss_type == "mean_flow")


def test_match_adapter_chance_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 6e"):
        TrainStepConfig.from_train_config(TrainConfig(match_adapter_chance=0.5))
