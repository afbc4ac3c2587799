"""Validation and ``train.scheduler_params`` in the port against the JAX
package on the CPU: ``train/step.eval_loss`` against JAX ``make_eval_step``
on the same batch, noise and timesteps (the port's draws from its seeded
generator handed to JAX), with no per-sample weights as in JAX; the job's
``val_loss`` at ``validate_every``, the same value for the same state; and the
schedules that ``scheduler_params`` overrides give (a ``weighting_table`` as
a list, an ``.npy`` or a JSON file, the sd2 default, the job's
``num_train_timesteps`` and ``is_v_pred`` under them) against JAX's
``get_schedule``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.samplers.ddpm import DDPMSchedule as JDDPMSchedule
from ai_toolkit_tpu.samplers.factory import get_schedule as jget_schedule
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JFlowMatchSchedule
from ai_toolkit_tpu.train.step import TrainStepConfig as JTrainStepConfig
from ai_toolkit_tpu.train.step import make_eval_step
from ai_toolkit_tpu_torch.config.modules import ProcessConfig
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.samplers.factory import get_schedule
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, eval_loss
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


def _jpredict(variables, noisy, t, cond):
    return 0.5 * noisy + 1e-3 * t.astype(jnp.float32)[:, None, None, None] + cond["context"].mean()


def _predict(noisy, t, cond):
    return 0.5 * noisy + 1e-3 * t.float()[:, None, None, None] + cond["context"].mean()


@pytest.mark.parametrize("case", ["ddpm_eps", "ddpm_v", "flow"])
def test_eval_loss_matches_jax(case, monkeypatch):
    """The port's t then noise from a generator seeded like the job's
    (``validation.seed``), handed to JAX's eval step (its schedule's draw and
    ``jax.random.normal`` replaced by them): the same loss (f32, 1e-6). The
    step's min-SNR gamma and the batch's loss multiplier weigh nothing, as
    in JAX; the flow case draws flux_shift t at the batch's image_seq_len,
    without the step's timestep bias."""
    rng = np.random.default_rng(0)
    latents = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    context = rng.standard_normal((2, 5, 16), dtype=np.float32)
    if case == "flow":
        schedule, cfg = FlowMatchSchedule(), TrainStepConfig(timestep_type="flux_shift", timestep_bias=2.0)
        jcfg = JTrainStepConfig(timestep_type="flux_shift", timestep_bias=2.0)
        jbase = JFlowMatchSchedule
    else:
        pred_type = "v_prediction" if case == "ddpm_v" else "epsilon"
        schedule, cfg = DDPMSchedule(prediction_type=pred_type), TrainStepConfig(min_snr_gamma=5.0)
        jcfg, jbase = JTrainStepConfig(min_snr_gamma=5.0), JDDPMSchedule
    batch = {"latents": torch.from_numpy(latents), "cond": {"context": torch.from_numpy(context)},
             "loss_multiplier": torch.tensor([3.0, 0.5]), "image_seq_len": 16}
    loss = eval_loss(_predict, schedule, cfg, batch, torch.Generator().manual_seed(123))
    g = torch.Generator().manual_seed(123)  # the draws eval_loss made, in its order
    if case == "flow":
        t = schedule.sample_timesteps(g, 2, "flux_shift", 16)
    else:
        t = schedule.sample_timesteps(g, 2)
    noise = torch.randn(latents.shape, generator=g).numpy()
    seen = {}

    class Injected(jbase):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            seen.update(kwargs)
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jschedule = Injected(**{f.name: getattr(schedule, f.name) for f in dataclasses.fields(jbase)})
    eval_step = make_eval_step(_jpredict, jschedule, jcfg)
    ref = eval_step({}, {}, {"latents": jnp.asarray(latents), "cond": {"context": jnp.asarray(context)},
                             "loss_multiplier": jnp.asarray([3.0, 0.5])}, jax.random.key(123),
                    image_seq_len=16 if case == "flow" else None)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    if case == "flow":
        assert seen == {"timestep_type": "flux_shift", "image_seq_len": 16}
    else:
        assert seen == {}  # the full balanced range


def _flux_job(tmp_path, steps=4, **over):
    from PIL import Image

    folder = tmp_path / "imgs"
    folder.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(folder / f"im_{i}.png")
        (folder / f"im_{i}.txt").write_text(f"photo of thing {i}")
    proc = {"type": "sd_trainer", "training_folder": str(tmp_path / "out"),
            "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
            "datasets": [{"folder_path": str(folder), "caption_ext": "txt", "caption_dropout_rate": 0.2,
                          "cache_latents_to_disk": False, "resolution": [64]}],
            "train": {"batch_size": 2, "steps": steps, "noise_scheduler": "flowmatch", "timestep_type": "flux_shift",
                      "optimizer": "adamw", "lr": 1e-3, "dtype": "float32", "seed": 3},
            "validation": {"validate_every": 2, "seed": 11},
            "model": {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}}
    proc.update(over)
    return {"job": "extension", "config": {"name": "val", "process": [proc]}}


def test_job_logs_val_loss_at_validate_every(tmp_path, capsys, monkeypatch):
    """Four steps with ``validate_every: 2``: ``val_loss`` after steps 2 and 4,
    printed, finite and not equal (the LoRA moved), each the eval loss of the
    job's fixed batch (dataset 0's first, unshuffled) at the validation seed:
    evaluated again on the same state it gives the same value."""
    import ai_toolkit_tpu_torch.jobs.train_process as tp

    seen, real = [], tp.eval_loss

    def twice(predict_fn, schedule, cfg, batch, generator):
        first = real(predict_fn, schedule, cfg, batch, generator)
        again = real(predict_fn, schedule, cfg, batch, torch.Generator().manual_seed(11))
        seen.append((float(first), float(again), batch["latents"].shape))
        return first

    monkeypatch.setattr(tp, "eval_loss", twice)
    job = get_job(_flux_job(tmp_path), device="cpu")
    (result,) = job.run()
    vals = result["val_losses"]
    assert [s for s, _ in vals] == [2, 4] and all(np.isfinite(v) for _, v in vals) and vals[0][1] != vals[1][1]
    assert [(a, b) for a, b, _ in seen] == [(v, v) for _, v in vals] and seen[0][2][0] == 2
    assert capsys.readouterr().out.count("val_loss=") == 2


@pytest.mark.parametrize("name,arch,params", [
    ("ddpm", "sd1", {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02, "num_train_timesteps": 500}),
    ("ddpm", "sd2", {}),
    ("ddpm", "sd2", {"prediction_type": "epsilon", "beta_schedule": "squaredcos_cap_v2"}),
    ("flowmatch", "flux", {"shift": 2.0, "use_dynamic_shifting": False, "weighting_table": "list"}),
    ("flowmatch", "sd3", {"weighting_table": "npy", "base_shift": 0.3}),
    ("flowmatch", "wan21", {"weighting_table": "json", "time_shift_type": "linear"}),
    *(("flowmatch", arch, {}) for arch in ("chroma", "flex1", "flex2", "flux_kontext")),  # the flux family's defaults
])
def test_scheduler_params_match_jax(tmp_path, name, arch, params):
    """``get_schedule`` with the overrides: every field equal to JAX's (the
    weighting table read from a list, an ``.npy`` or a JSON file), the DDPM
    tables bit for bit."""
    params = dict(params)
    table = np.linspace(0.5, 1.5, 1000).astype(np.float32)
    kind = params.get("weighting_table")
    if kind == "list":
        params["weighting_table"] = table.tolist()
    elif kind == "npy":
        np.save(tmp_path / "w.npy", table)
        params["weighting_table"] = str(tmp_path / "w.npy")
    elif kind == "json":
        (tmp_path / "w.json").write_text(json.dumps(table.tolist()))
        params["weighting_table"] = str(tmp_path / "w.json")
    ours, ref = get_schedule(name, arch, **params), jget_schedule(name, arch, **params)
    assert type(ours).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    if kind:
        assert ours.weighting_table == tuple(table.tolist())
    if name == "ddpm":
        np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)


def test_schedules_take_every_jax_field_and_name_the_others():
    """Both schedules have the JAX dataclass's fields; an override that is no
    field raises, naming it."""
    for ours, ref in ((DDPMSchedule, JDDPMSchedule), (FlowMatchSchedule, JFlowMatchSchedule)):
        assert {f.name for f in dataclasses.fields(ours)} == {f.name for f in dataclasses.fields(ref)}
    with pytest.raises(ValueError, match="'shift'"):
        get_schedule("ddpm", "sd1", shift=3.0)
    with pytest.raises(ValueError, match="'prediction_type'"):
        get_schedule("flowmatch", "flux", prediction_type="v_prediction")


@pytest.mark.parametrize("over", [
    {"train": {"scheduler_params": {"beta_schedule": "linear"}, "num_train_timesteps": 800},
     "model": {"is_v_pred": True}},
    {"train": {"scheduler_params": {"prediction_type": "sample", "num_train_timesteps": 600},
               "num_train_timesteps": 800}, "model": {"is_v_pred": True}},
])
def test_job_schedule_follows_jax_precedence(over):
    """The job's schedule (JAX ``run`` step 3): ``scheduler_params``, then
    ``num_train_timesteps`` and ``is_v_pred`` only where those leave a field
    unset; the same schedule as JAX builds from the same settings."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    proc = {"train": {"noise_scheduler": "ddpm", **over["train"]},
            "model": {"name_or_path": "", "arch": "sd1", "model_kwargs": {"size": "tiny"}, **over["model"]}}
    ours = SDTrainProcess("x", ProcessConfig.from_dict(proc), "cpu")._schedule()
    want = dict(over["train"]["scheduler_params"])
    want.setdefault("num_train_timesteps", over["train"]["num_train_timesteps"])
    want.setdefault("prediction_type", "v_prediction")
    ref = jget_schedule("ddpm", "sd1", **want)
    assert {f.name: getattr(ours, f.name) for f in dataclasses.fields(ref)} == dataclasses.asdict(ref)


class _Stop(Exception):
    pass


def _recording(cls, made):
    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    return Recorded


def _stop(*args, **kwargs):
    raise _Stop()


def test_jax_fault_samples_during_training_take_an_epsilon_schedule(monkeypatch):
    """[jax_fault] The JAX job's ``_sample`` calls ``generate(model,
    variables, gen, lora=..., uncond_lora=...)`` with no schedule, and
    ``generate_sd`` builds ``DDPMSchedule()``: epsilon, for every arch. A
    v-prediction ``sd2`` (its train schedule's ``prediction_type``) is
    sampled as epsilon. The call is stopped once the schedule is built."""
    import inspect

    import ai_toolkit_tpu.generation as jgen
    from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
    from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
    from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
    from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel

    assert "generate(self.model, variables, gen, lora=lora," in inspect.getsource(JSDTrainProcess._sample)
    made = []
    monkeypatch.setattr(jgen, "DDPMSchedule", _recording(JDDPMSchedule, made))
    jm = JSDModel(JModelConfig.from_dict({"name_or_path": "", "arch": "sd2", "model_kwargs": {"size": "tiny"}}))
    monkeypatch.setattr(jm, "latent_shape", _stop)
    with pytest.raises(_Stop):
        jgen.generate(jm, {}, JGenerateImageConfig(prompt="a fox"), lora=None, uncond_lora=None)
    assert [s.prediction_type for s in made] == ["epsilon"]
    assert jget_schedule("ddpm", "sd2").prediction_type == "v_prediction"


def test_port_samples_during_training_as_jax(monkeypatch, tmp_path):
    """[port] The port's ``_sample`` mirrors the JAX fault: ``generate``
    without a schedule, so ``generate_sd`` builds ``DDPMSchedule()``,
    epsilon, for the v-prediction ``sd2`` whose train schedule is
    ``v_prediction``."""
    import ai_toolkit_tpu_torch.generation as tgen
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess
    from ai_toolkit_tpu_torch.models.sd_model import SDModel

    made = []
    monkeypatch.setattr(tgen, "DDPMSchedule", _recording(DDPMSchedule, made))
    cfg = ProcessConfig.from_dict({"training_folder": str(tmp_path), "sample": {"prompts": ["a fox"]},
                                   "model": {"name_or_path": "", "arch": "sd2", "model_kwargs": {"size": "tiny"}},
                                   "train": {"noise_scheduler": "ddpm"}})
    proc = SDTrainProcess("ti", cfg, "cpu")
    model = SDModel(cfg.model, device="cpu")
    monkeypatch.setattr(model, "latent_shape", _stop)
    proc.samples = []
    with pytest.raises(_Stop):
        proc._sample(model, {}, None, None, 0)
    assert [s.prediction_type for s in made] == ["epsilon"]
    assert proc._schedule().prediction_type == "v_prediction"
