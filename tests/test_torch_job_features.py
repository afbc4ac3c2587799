"""The train job's features, the port against the JAX package on the CPU at
tiny sizes: several resolutions per dataset (items and buckets), the disk
latent cache (file names, latents, a second build that encodes nothing),
the lr schedules (values against optax's as the jitted JAX step computes
them, and the bf16 update under each), resume (4 steps against 2 plus a
resume of 2, bit for bit; sampling during training:
tests/test_torch_job_sampling.py) and the shipped job files, which the port takes as
they are written (but the DFE file, whose losses raise)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ai_toolkit_tpu.config.modules import DatasetConfig as JDatasetConfig
from ai_toolkit_tpu.config.modules import TrainConfig as JTrainConfig
from ai_toolkit_tpu.data import caching as jcaching
from ai_toolkit_tpu.data.dataset import FolderDataset as JFolderDataset
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import DatasetConfig
from ai_toolkit_tpu_torch.data import caching
from ai_toolkit_tpu_torch.data.dataset import FolderDataset
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer, lr_schedule
from ai_toolkit_tpu_torch.train.state import TrainState

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(folder, sizes=((80, 64), (64, 64), (48, 96))):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(os.path.join(folder, f"im_{i}.png"))
        with open(os.path.join(folder, f"im_{i}.txt"), "w") as f:
            f.write(f"[trigger] photo of thing {i}")
    return folder


# ---- several resolutions, the disk cache ----

def _datasets(folder):
    d = {"folder_path": folder, "caption_ext": "txt", "resolution": [32, 48, 64], "num_repeats": 2,
         "flip_x": True, "caption_dropout_rate": 0.3}
    return (FolderDataset(DatasetConfig.from_dict(dict(d)), 16, "sks", seed=42),
            JFolderDataset(JDatasetConfig.from_dict(dict(d)), 16, "sks", seed=42))


def test_several_resolutions_give_the_jax_items_and_buckets(tmp_path):
    ours, ref = _datasets(_images(str(tmp_path / "imgs")))
    key = lambda it: (it.path, it.bucket, it.resolution, it.flip, it.flip_y)  # noqa: E731
    assert [key(it) for it in ours.items] == [key(it) for it in ref.items]
    assert len(ours.items) == 3 * 3 * 2 and {it.resolution for it in ours.items} == {32, 48, 64}
    batches = [[key(it) for it in b] for b in ours.build_batches(2)]
    assert batches == [[key(it) for it in b] for b in ref.build_batches(2)]
    assert all(len({it[1] for it in b}) == 1 for b in batches)  # one bucket a batch


def _encode(imgs: np.ndarray) -> np.ndarray:
    """A stand-in VAE: 8x8 mean pooling to 4 channels."""
    b, h, w, _ = imgs.shape
    pooled = imgs.reshape(b, h // 8, 8, w // 8, 8, 3).mean(axis=(2, 4))
    return np.concatenate([pooled, pooled[..., :1] * 0.5], axis=-1).astype(np.float32)


def test_disk_cache_names_latents_and_second_build(tmp_path, monkeypatch):
    monkeypatch.setenv("AIT_NATIVE_LOADER", "0")  # JAX's PIL path, as the port's
    ours, ref = _datasets(_images(str(tmp_path / "imgs")))
    cache = str(tmp_path / "latent_cache")
    assert ([caching.latent_cache_path(it, cache) for it in ours.items]
            == [jcaching.latent_cache_path(it, cache) for it in ref.items])
    calls = []

    def encode(imgs):
        calls.append(len(imgs))
        return _encode(imgs)

    encoded, hits = caching.cache_latents_to_disk(ours.items, encode, cache, batch_size=2)
    files = sorted(glob.glob(os.path.join(cache, "*.safetensors")))
    assert encoded == len(files) == len({caching.latent_cache_path(it, cache) for it in ours.items}) and hits == 0
    memory = caching.cache_latents(ours.items, _encode, batch_size=2)
    jdir = str(tmp_path / "jax_cache")
    jcaching.cache_latents(ref.items, _encode, jdir, batch_size=2)
    for it, jit in zip(ours.items, ref.items):
        lat = caching.load_cached_latent(it, cache)
        np.testing.assert_array_equal(lat, memory[caching.latent_key(it)].astype(np.float16).astype(np.float32))
        np.testing.assert_array_equal(lat, jcaching.load_cached_latent(jit, jdir))
    calls.clear()
    assert caching.cache_latents_to_disk(ours.items, encode, cache, batch_size=2) == (0, len(files))
    assert calls == []


# ---- lr schedules ----

SCHEDULES = [("constant", {}), ("linear", {}), ("linear", {"end_lr": 1e-6}), ("cosine", {}),
             ("cosine", {"alpha": 0.1}), ("cosine_with_restarts", {"num_cycles": 3}),
             ("constant_with_warmup", {"num_warmup_steps": 5}), ("step", {"step_size": 4, "gamma": 0.5}),
             ("step", {})]


def _jax_schedule(name, params, lr, steps):
    tc = JTrainConfig(lr=lr, steps=steps, lr_scheduler=name, lr_scheduler_params=params)
    return JSDTrainProcess._lr_schedule(None, tc)


def _f32_ulps(a: float, b: float) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedule_values_match_optax(name, params):
    """Each schedule at every step of a 23-step run against optax's value as
    the JAX train step computes it, inside jit: the linear ramps and the
    step decay by 0.5 bit for bit; the step decay by 0.1 within one f32 ULP
    and the cosines within two f32 ULPs of the base lr, because XLA's pow
    and cos are not correctly rounded where the port's are."""
    lr, steps = 3e-4, 23
    ref, ours = _jax_schedule(name, params, lr, steps), lr_schedule(name, lr, steps, params)
    if name == "constant":
        assert ref == ours == lr
        return
    jitted = jax.jit(ref)
    for count in range(steps + 2):
        want = float(np.asarray(jitted(jnp.asarray(count, jnp.int32))))
        got = ours(count)
        if name.startswith("cosine"):
            assert abs(got - want) <= 2 * 2.0 ** -23 * lr, (count, got, want)
        else:
            assert _f32_ulps(got, want) <= (1 if params.get("gamma", 0.1) == 0.1 and name == "step" else 0), \
                (count, got, want)
    with pytest.raises(NotImplementedError, match="one_cycle"):
        lr_schedule("one_cycle", lr, steps)


@pytest.mark.parametrize("name,params", [s for s in SCHEDULES if s[0] != "constant"])
@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_bf16_update_under_a_schedule_matches_jax(name, params, opt):
    """bf16 parameters and gradients through three updates under the
    schedule (its f32 lr is rounded to f32, then to the update's dtype) and
    the EMA against the JAX state: adamw's parameters bit for bit where the
    lr values agree bit for bit; adamw8bit's within one bf16 ULP in at most
    one element in 10^4 (the f32 update XLA fuses, as
    tests/test_torch_full_finetune.py states for the constant lr)."""
    lr, steps = 3e-3, 6
    rng = np.random.default_rng(4)
    init = {f"w{i}": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
            for i, shape in enumerate([(64, 48), (300,), (17, 33)])}
    jsched = _jax_schedule(name, params, lr, steps)
    jstate = JTrainState.create({}, {n: jnp.asarray(t.float().numpy(), jnp.bfloat16) for n, t in init.items()},
                                jget_optimizer(opt, jsched, max_grad_norm=1.0), use_ema=True)
    p = {n: t.clone() for n, t in init.items()}
    state = TrainState(p, get_optimizer(opt, list(p.values()), lr_schedule(name, lr, steps, params),
                                        max_grad_norm=1.0), use_ema=True)
    apply = jax.jit(lambda st, g: st.apply_gradients(g, ema_decay=0.99))
    for scale in (0.3, 1e-3, 0.05):
        grads = {n: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32) * scale).bfloat16()
                 for n, t in init.items()}
        jstate = apply(jstate, {n: jnp.asarray(g.float().numpy(), jnp.bfloat16) for n, g in grads.items()})
        state.apply_gradients([grads[n] for n in p], ema_decay=0.99)
    exact_lr = name in ("linear", "constant_with_warmup") or all(
        _f32_ulps(lr_schedule(name, lr, steps, params)(c), float(np.asarray(jax.jit(jsched)(c)))) == 0
        for c in range(3))
    off = total = 0
    for n in p:
        assert not torch.equal(p[n], init[n])
        for ours, ref in ((p[n], jstate.trainable[n]), (state.ema[n], jstate.ema[n])):
            ref = torch.from_numpy(np.asarray(ref).view(np.int16).astype(np.int32))
            d = (ours.view(torch.int16).to(torch.int32) - ref).abs()
            assert int(d.max()) <= (0 if opt == "adamw" and exact_lr else 1), n
            off, total = off + int((d > 0).sum()), total + d.numel()
    assert off <= (0 if opt == "adamw" and exact_lr else max(1, 1e-4 * total))


# ---- the job: resume, sampling ----

TINY_FLUX = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}
TINY_SDXL = {"name_or_path": "", "arch": "sdxl", "model_kwargs": {"size": "tiny"}}


def _proc(tmp_path, out, steps, model=TINY_FLUX, **over):
    """A tiny job over the images of ``tmp_path / "imgs"`` (written once: the
    disk cache's names carry the files' mtimes)."""
    if not os.path.isdir(tmp_path / "imgs"):
        _images(str(tmp_path / "imgs"), ((64, 64), (64, 48), (48, 64)))
    flow = model["arch"] == "flux"
    proc = {
        "type": "sd_trainer", "training_folder": str(tmp_path / out), "trigger_word": "sks",
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "save": {"dtype": "float16", "save_every": 2, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": str(tmp_path / "imgs"), "caption_ext": "txt", "caption_dropout_rate": 0.3,
                      "cache_latents_to_disk": True, "resolution": [32, 48]}],
        "train": {"batch_size": 1, "steps": steps, "noise_scheduler": "flowmatch" if flow else "ddpm",
                  "timestep_type": "flux_shift" if flow else "sigmoid", "optimizer": "adamw8bit", "lr": 1e-3,
                  "lr_scheduler": "cosine", "max_grad_norm": 1.0, "ema_config": {"use_ema": True, "ema_decay": 0.9},
                  "dtype": "float32", "seed": 3, "disable_sampling": True},
        "model": dict(model), "logging": {"log_every": 1},
    }
    for key, val in over.items():
        proc[key] = {**proc.get(key, {}), **val}
    return {"job": "extension", "config": {"name": "feat", "process": [proc]}}


def test_resume_continues_bit_for_bit(tmp_path, monkeypatch):
    """A 4-step run against the same job cut after its step-2 save and run
    again (the cosine lr over 4 steps, adamw8bit, EMA, the disk cache, two
    resolutions, caption dropout): the losses of steps 3 and 4, the LoRA
    factors, the 8-bit moments and the EMA equal bit for bit in f32; the
    rerun reads every latent from the disk cache."""
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    job = get_job(_proc(tmp_path, "whole", 4), device="cpu")
    (whole,) = job.run()
    ref = job.processes[0].state
    assert whole["start_step"] == 0 and whole["latent_cache"]["encoded"] > 0

    prepare, calls = SDTrainProcess._prepare_batch, []

    def cut_after_two(self, *args):
        calls.append(1)
        if len(calls) > 2:
            raise KeyboardInterrupt  # the run is killed after its step-2 save
        return prepare(self, *args)

    with monkeypatch.context() as m:
        m.setattr(SDTrainProcess, "_prepare_batch", cut_after_two)
        with pytest.raises(KeyboardInterrupt):
            run_job(_proc(tmp_path, "cut", 4), device="cpu")
    job = get_job(_proc(tmp_path, "cut", 4), device="cpu")
    (resumed,) = job.run()
    state = job.processes[0].state
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 2
    assert resumed["latent_cache"]["encoded"] == 0 and resumed["latent_cache"]["encode_calls"] == 0
    assert resumed["losses"] == whole["losses"][2:]
    assert state.step == ref.step == 4 and state.optimizer.count == ref.optimizer.count == 4
    for k in ref.trainable:
        assert torch.equal(state.trainable[k], ref.trainable[k]), k
        assert torch.equal(state.ema[k], ref.ema[k]), k
    for mine, theirs in zip(state.optimizer.mu + state.optimizer.nu, ref.optimizer.mu + ref.optimizer.nu):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))


def test_resume_of_another_network_shape_starts_fresh(tmp_path, capsys):
    run_job(_proc(tmp_path, "out", 2), device="cpu")
    (result,) = run_job(_proc(tmp_path, "out", 3, network={"linear": 8, "linear_alpha": 8}), device="cpu")
    assert result["start_step"] == 0 and len(result["losses"]) == 3
    assert "different network shape — starting fresh" in capsys.readouterr().out


# ---- the shipped files ----

SHIPPED = ["train_lora_flux_tpu", "train_full_finetune_flux_tpu", "train_lora_hidream_tpu",
           "train_lora_sdxl_tpu", "train_lora_wan21_tpu", "train_lora_wan22_14b_tpu",
           "train_textual_inversion_sd15", "train_lora_chroma_tpu", "train_lora_flex_tpu",
           "train_lora_flex2_tpu", "train_lora_flux_kontext_tpu", "train_lora_sd35_large_tpu",
           "train_lora_qwen_image_tpu", "train_lora_qwen_image_edit_tpu", "train_lora_lumina2_tpu",
           "train_lora_omnigen2_tpu", "train_lora_ace_step_audio", "train_lora_ltx2_av_tpu",
           "train_lora_flux_dfe7_tpu", "train_lora_flux_ara_tpu", "train_redux_adapter_flux_tpu",
           "train_vision_direct_pixtral_flux_tpu"]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_train_files_are_taken_as_written(name):
    raw = get_config(os.path.join(ROOT, "configs", "examples", f"{name}.yaml"))
    job = get_job(raw, device="cpu")
    for proc in job.processes:
        proc._refuse_unported()


# the shipped files of the slider and extract jobs (process types slider, ultimate_slider, extract_lora)
SHIPPED_JOBS = ["train_slider", "train_ultimate_slider", "extract_lora"]


@pytest.mark.parametrize("name", SHIPPED_JOBS)
def test_shipped_job_files_are_taken_as_written(name):
    raw = get_config(os.path.join(ROOT, "configs", "examples", f"{name}.yaml"))
    job = get_job(raw, device="cpu")
    assert len(job.processes) == 1
    for proc in job.processes:
        proc._refuse_unported()


def test_pixtral_train_file_raises_on_its_adapter():
    """The file has an ``adapter:`` and no ``network``: it is taken as an
    adapter run (the vision_direct adapter on the pixtral tower), not as a
    full fine-tune, whose quantize refusal would fire on it."""
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_vision_direct_pixtral_flux_tpu.yaml"))
    (proc,) = get_job(raw, device="cpu").processes
    proc._refuse_unported()
    assert not proc.full_finetune and proc.cfg.network is None and proc.cfg.model.quantize
    assert proc.cfg.adapter["type"] == "vision_direct" and proc.cfg.adapter["image_encoder_arch"] == "pixtral"


def test_dfe_train_file_raises_on_its_losses():
    """The DFE v7 file is taken with its loss: the path and weight the job
    hands ``models/dfe.make_aux_loss``."""
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_flux_dfe7_tpu.yaml"))
    (proc,) = get_job(raw, device="cpu").processes
    proc._refuse_unported()
    assert proc.feature_loss_path == ("v7:/path/to/tipsv2-b14-dpt", 1.0)
