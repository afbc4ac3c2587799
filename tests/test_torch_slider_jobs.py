"""The slider jobs and the trainer's guidance losses end to end on the CPU,
in f32 at tiny sizes: the slider job on tiny sd1 and tiny flux and the
ultimate slider on tiny sd1 (finite losses, a LoRA that moved, the JAX
job's LoRA keys and shapes); the trainer's ``guidance_loss: polarity`` on a
tiny flux job over a paired folder, whose first step trains the polarity
loss of JAX ``make_polarity_train_step`` (loss and every LoRA gradient,
the step's t and noise injected; 1e-4 of the largest reference value, as
the flux-family tests hold flux); and the refusals: ``concept_replacer``,
a kind JAX does not know, and the assistant adapter."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flux_family import _jax_tree, _leaf
from test_torch_slider import TARGETS, W, _pair_folders, _slider_job, jax_loss_fn

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models.flux_model import FluxModel as JFluxModel
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import slider as jslider
from ai_toolkit_tpu.train.step import TrainStepConfig as JStepConfig
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.train import slider as tslider
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the jobs end to end, tiny ----

def _job_keys(jm, tree, rank, fmt, prefix):
    """Keys and shapes of the LoRA file the JAX slider job writes for ``tree``."""
    shapes = jax.eval_shape(lambda: jlora.build_lora(
        tree, jlora.LoRASpec(rank=rank, alpha=float(rank), target_patterns=jm.lora_targets()), jax.random.key(0)))
    jtree = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
    flat = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jm, jtree), fmt=fmt, prefix=prefix)
    return {k: v.shape for k, v in flat.items()}


def _file_keys(path):
    from safetensors import safe_open

    with safe_open(path, framework="np") as f:
        return {k: f.get_tensor(k).shape for k in f.keys()}, dict(f.metadata())


def _tiny_job(tmp_path, ptype, arch, steps, **proc):
    raw = _slider_job(tmp_path, arch, steps=steps, max_denoising_steps=5) if arch == "flux" else \
        _slider_job(tmp_path, arch, steps=steps)
    p = raw["config"]["process"][0]
    p.update(type=ptype, network={"type": "lora", "linear": 4, "linear_alpha": 4})
    p["slider"].update(resolutions=[[64, 64]], targets=TARGETS[:1])
    p["model"]["model_kwargs"] = {"size": "tiny"}
    p.update(proc)
    return raw


@pytest.mark.parametrize("arch", ["sd1", "flux"])
def test_slider_job_tiny(arch, tmp_path):
    """The slider job on the tiny model (64^2, 3 steps; flux with the
    partial denoise): finite losses, every LoRA b factor moved, and the final
    file with the keys and shapes the JAX job writes for the same modules
    (kohya ``lora_unet_...`` for sd1, PEFT ``transformer....`` for flux)."""
    raw = _tiny_job(tmp_path, "slider", arch, 3)
    (result,) = run_job(raw, device="cpu")
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
    keys, meta = _file_keys(result["save_path"])
    flow = arch == "flux"
    jm = (JFluxModel if flow else JSDModel)(JModelConfig.from_dict(raw["config"]["process"][0]["model"]))
    tree = jax.eval_shape(jm.init_variables, jax.random.key(0))["dit" if flow else "unet"]
    assert keys == _job_keys(jm, tree, 4, "peft" if flow else "kohya", "lora_transformer" if flow else "lora_unet")
    assert meta["step"] == "3" and result["save_path"].endswith(os.path.join("seq", "seq.safetensors"))
    b = {k: v for k, v in _file_values(result["save_path"]).items() if "up" in k or "lora_B" in k}
    assert b and all(np.abs(v).max() > 0 for v in b.values())


def _file_values(path):
    from safetensors.numpy import load_file

    return load_file(path)


def test_ultimate_slider_job_tiny(tmp_path):
    """The ultimate slider job on tiny sd1: batch 2 of pairs at 64^2, 2
    steps; each step's total is 0.7 img_loss + 1.3 cfg_loss, all finite, the
    LoRA moved, the JAX job's kohya keys."""
    pos, neg = _pair_folders(str(tmp_path))
    raw = _tiny_job(tmp_path, "ultimate_slider", "sd1", 2,
                    datasets=[{"folder_path": pos, "unconditional_path": neg, "caption_ext": "txt",
                               "resolution": [64], "cache_latents": False, "cache_latents_to_disk": False}])
    p = raw["config"]["process"][0]
    p["train"]["batch_size"] = 2
    p["slider"].update(img_loss_weight=0.7, cfg_loss_weight=1.3, weight_jitter=0.2)
    (result,) = run_job(raw, device="cpu")
    for total, img, cfg in zip(result["losses"], result["img_losses"], result["cfg_losses"]):
        assert np.isfinite([total, img, cfg]).all()
        np.testing.assert_allclose(total, 0.7 * img + 1.3 * cfg, rtol=1e-5)
    jm = JSDModel(JModelConfig.from_dict(p["model"]))
    tree = jax.eval_shape(jm.init_variables, jax.random.key(0))["unet"]
    keys, _ = _file_keys(result["save_path"])
    assert keys == _job_keys(jm, tree, 4, "kohya", "lora_unet")
    assert all(np.abs(v).max() > 0 for k, v in _file_values(result["save_path"]).items() if "lora_up" in k)


def test_ultimate_slider_needs_pairs(tmp_path):
    pos, _ = _pair_folders(str(tmp_path))
    raw = _tiny_job(tmp_path, "ultimate_slider", "sd1", 1,
                    datasets=[{"folder_path": pos, "caption_ext": "txt", "resolution": [64]}])
    with pytest.raises(ValueError, match="unconditional_path"):
        run_job(raw, device="cpu")


# ---- the trainer's guidance losses ----

def _guided_flux_job(tmp_path, kind="polarity", **train):
    pos, neg = _pair_folders(str(tmp_path))
    return {"job": "extension", "config": {"name": "guided", "process": [{
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"),
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "datasets": [{"folder_path": pos, "unconditional_path": neg, "caption_ext": "txt", "resolution": [32],
                      "cache_latents_to_disk": False}],
        "train": {"batch_size": 2, "steps": 1, "noise_scheduler": "flowmatch", "timestep_type": "flux_shift",
                  "optimizer": "adamw", "lr": 1e-3, "dtype": "float32", "disable_sampling": True,
                  "guidance_loss": kind, "network_weight": W, **train},
        "model": {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}}]}}


def test_guidance_loss_polarity_trains_the_polarity_loss(tmp_path, monkeypatch):
    """[port] ``train.guidance_loss: polarity`` (once silently plain MSE):
    the tiny flux job over a paired folder (batch 2, the negatives' latents
    encoded per batch) trains the polarity loss. Its first step's loss and
    LoRA gradients equal JAX ``make_polarity_train_step``'s loss on the same
    batch, weights and LoRA at ``network_weight`` 0.8, with the step's t and
    noise injected; the step logs that loss."""
    job = get_job(_guided_flux_job(tmp_path), device="cpu")
    proc = job.processes[0]
    seen = {}
    real = tslider.polarity_loss

    def spy(predict_fn, schedule, batch, noise, t, network_weight):
        if not seen:
            seen.update(batch=batch, noise=noise.clone(), t=t.clone(), weight=network_weight,
                        init={k: v.detach().clone() for k, v in proc.state.trainable.items()})
            step = proc.state.optimizer.step

            def keep(grads):
                seen.setdefault("grads", [g.clone() for g in grads])
                return step(grads)

            proc.state.optimizer.step = keep
        loss = real(predict_fn, schedule, batch, noise, t, network_weight)
        seen.setdefault("loss", float(loss.detach()))
        return loss

    monkeypatch.setattr(tslider, "polarity_loss", spy)
    (result,) = job.run()
    assert seen["weight"] == W and result["losses"][0] == pytest.approx(seen["loss"], rel=1e-7)
    batch = seen["batch"]
    assert batch["unconditional_latents"].shape == batch["latents"].shape and batch["latents"].shape[0] == 2
    jm = JFluxModel(JModelConfig.from_dict({"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}))
    tree = _jax_tree(proc.variables["dit"])
    shapes = jax.eval_shape(lambda: jlora.build_lora(
        tree, jlora.LoRASpec(rank=4, alpha=4.0, target_patterns=jm.lora_targets()), jax.random.key(0)))
    paths = {}

    def fill(node, prefix=""):
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if "a" in v:
                name = from_jax._flux_module(path)
                paths[name] = path
                out[k] = {leaf: seen["init"][f"{name}.{leaf}"].numpy() for leaf in ("a", "b", "scale")}
            else:
                out[k] = fill(v, path)
        return out

    jtree = fill(shapes)
    assert sorted(paths) == sorted(proc.lora)
    cond = batch["cond"]
    h, w = batch["latents"].shape[1:3]
    jcond = {"txt": jnp.asarray(cond["txt"].numpy()), "y": jnp.asarray(cond["y"].numpy()),
             "guidance": jnp.asarray(cond["guidance"].numpy()), "pe": jm.rope_table(h, w, cond["txt"].shape[1])}
    t, noise = seen["t"].numpy(), seen["noise"].numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t)

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    loss_fn = jax_loss_fn(jslider.make_polarity_train_step(jm.predict, Injected(),
                                                           JStepConfig(timestep_type="flux_shift"),
                                                           network_weight=W))
    jbatch = {"latents": jnp.asarray(batch["latents"].numpy()),
              "unconditional_latents": jnp.asarray(batch["unconditional_latents"].numpy()), "cond": jcond}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda lora: loss_fn(
        {"lora": lora}, {"dit": tree}, jbatch, jax.random.key(0), batch["image_seq_len"])[0]))(jtree)
    np.testing.assert_allclose(seen["loss"], float(ref_loss), rtol=1e-5)
    names = list(proc.state.trainable)
    ref = {k: np.asarray(_leaf(ref_grads, paths[k.rsplit(".", 1)[0]])[k.rsplit(".", 1)[1]]) for k in names}
    gmax = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in zip(names, seen["grads"]):
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-5, atol=1e-4 * gmax, err_msg=k)


def _flux_file(**train):
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_flux_tpu.yaml"))
    proc = raw["config"]["process"][0]
    for k, v in train.items():
        if k.startswith("process."):
            proc[k[len("process."):]] = v
        else:
            proc["train"][k] = v
    return raw


@pytest.mark.parametrize("change,cause", [
    ({"guidance_loss": "concept_replacer"}, "concept_replacer"),
    ({"guidance_loss": "contrastive"}, "'contrastive' is no guidance kind"),
    ({"process.guidance_loss": "concept_replacer"}, "concept_replacer"),
    ({"adapter_assist_name_or_path": "/x"}, "adapter_assist_name_or_path"),
    ({"process.adapter_assist_name_or_path": "/x"}, "adapter_assist_name_or_path"),
])
def test_unported_guidance_raises(change, cause):
    """[port] What the trainer does not take raises, naming its cause: the
    ``concept_replacer`` kind (its job builds the replacement prompts), a
    kind the JAX package does not know, and the assistant adapter on flux,
    which has no UNet for it (JAX skips it silently), in the train section
    or the process."""
    with pytest.raises(NotImplementedError, match=cause):
        for proc in get_job(_flux_file(**change), device="cpu").processes:
            proc._refuse_unported()


@pytest.mark.parametrize("where", ["guidance_loss", "process.guidance_loss"])
def test_guidance_loss_is_read_from_train_or_process(where):
    """``guidance_loss`` in the train section or the process: the shipped
    flux file takes either, and the trainer reads the kind."""
    (proc,) = get_job(_flux_file(**{where: "targeted_flow"}), device="cpu").processes
    proc._refuse_unported()
    assert proc.guidance_kind == "targeted_flow"
