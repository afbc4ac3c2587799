"""The port's ACE-Step stand-in (``ace_step_15``) and the audio data path
against the JAX package on the CPU, in f32: the 1-D causal waveform VAE
(encode, decode, its nearest upsample, the 10 s clip's 1,722 tokens), the
Wan DiT in 1-D mode at head_dim 128 over a ragged 45 tokens (its attentions
take the flash kernel's plain version) and one LoRA step, the model's
``predict`` / ``encode_audio`` / ``rope_table``, ``load_audio`` with its
linear resample, sidecar pairing and the loader's ``audio_waveform``, the
LoRA keys of the JAX job, the refusals, and the shipped file as a tiny job
through ``run.py``. Weights come from the JAX package's own init through
``io/from_jax``; inputs are made with numpy."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ai_toolkit_tpu.config.modules import DatasetConfig as JDatasetConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.data.dataset import FileItem as JFileItem
from ai_toolkit_tpu.data.dataset import FolderDataset as JFolderDataset
from ai_toolkit_tpu.data.loader import DataLoader as JDataLoader
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models import audio_vae as jaudio_vae
from ai_toolkit_tpu.models import wan_dit as jwan_dit
from ai_toolkit_tpu.models.audio_model import AudioModel as JAudioModel
from ai_toolkit_tpu.samplers import FlowMatchSchedule as JFlowMatchSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import DatasetConfig, ModelConfig
from ai_toolkit_tpu_torch.data.dataset import FolderDataset, load_audio
from ai_toolkit_tpu_torch.data.loader import DataLoader
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io import lora_file as tlora_file
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.models import audio_vae as taudio_vae
from ai_toolkit_tpu_torch.models import wan_dit as twan_dit
from ai_toolkit_tpu_torch.models.audio_model import EXACT_MODE, AudioModel
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope
from ai_toolkit_tpu_torch.run import main as run_main
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from test_torch_lumina2 import filled
from test_torch_flux_family import fast_jit
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"name_or_path": "", "arch": "ace_step_15", "model_kwargs": {"size": "tiny"}}
# the 1-D DiT at head_dim 128 (2 heads), so every attention takes the flash dispatch
DIT1D = dict(in_channels=4, dim=256, ffn_dim=128, num_heads=2, num_layers=2, text_dim=64, freq_dim=32,
             patch_size=(1, 1, 1), axes_dim=(128, 0, 0))
VAE3 = dict(latent_channels=4, base_channels=8, channel_multipliers=(1, 2, 4), stride=4)


# ---- the waveform VAE ----

@pytest.mark.parametrize("kw", [{}, VAE3], ids=["tiny", "three_levels"])
def test_audio_vae_matches_jax(kw):
    """encode (the posterior mean) and decode of a [2, 400, 2] waveform in
    f32, 1e-5 relative and 1e-5 of max|ref|: the tiny VAE (one stride-4
    stage) and three levels (two stages: 400 -> 25 latent frames, the
    decoder's nearest upsample twice); the kernels are the config's dtype."""
    jcfg = jaudio_vae.AudioVAEConfig(**kw, dtype=jnp.float32) if kw else jaudio_vae.AudioVAEConfig.tiny()
    tcfg = taudio_vae.AudioVAEConfig(**kw, dtype=torch.float32) if kw else taudio_vae.AudioVAEConfig.tiny()
    jmod = jaudio_vae.AudioAutoencoderKL(jcfg)
    wav = np.random.default_rng(0).uniform(-1, 1, (2, 400, 2)).astype(np.float32)
    params = jax.tree.map(np.asarray, seeded_init(jmod.init, jax.random.key(1), jnp.asarray(wav))["params"])
    params = jax.tree.map(lambda v: v + 0.01 if v.ndim == 1 else v, params)  # non-zero biases

    def run(p, x):  # one program: the latents and their decode
        lat = jmod.apply({"params": p}, x, method=jaudio_vae.AudioAutoencoderKL.encode)
        return lat, jmod.apply({"params": p}, lat, method=jaudio_vae.AudioAutoencoderKL.decode)

    ref_lat, ref_dec = (np.asarray(r) for r in fast_jit(run, params, wav))
    mod = taudio_vae.AudioAutoencoderKL(tcfg)
    mod.load_state_dict(from_jax.audio_vae_state_dict(params))
    assert all(p.dtype == torch.float32 for p in mod.parameters())
    with torch.inference_mode():
        lat = mod.encode(torch.from_numpy(wav)).numpy()
        dec = mod.decode(torch.from_numpy(ref_lat)).numpy()
    assert lat.shape == (2, 400 // tcfg.downscale, tcfg.latent_channels) and dec.shape == wav.shape
    for got, ref in ((lat, ref_lat), (dec, ref_dec)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_nearest_resize_is_repeat_interleave():
    """The decoder's ``jax.image.resize(..., 'nearest')`` by the stride equals
    ``repeat_interleave`` along time, bit for bit."""
    h = np.random.default_rng(2).standard_normal((2, 13, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(h), (2, 52, 5), "nearest"))
    np.testing.assert_array_equal(torch.from_numpy(h).repeat_interleave(4, dim=1).numpy(), ref)


def test_ten_second_clip_gives_1722_tokens_and_bf16_kernels():
    """The shipped file's 10 s at 44.1 kHz through the full-size geometry
    (four stride-4 causal stages; channels narrowed) is 1,722 latent frames;
    the full-size VAE keeps its kernels in bf16, as JAX creates them."""
    cfg = taudio_vae.AudioVAEConfig(base_channels=2, latent_channels=4, dtype=torch.float32)
    mod = taudio_vae.AudioAutoencoderKL(cfg)
    with torch.inference_mode():
        assert mod.encode(torch.zeros(1, 441_000, 2)).shape == (1, 1722, 4)
    full = taudio_vae.AudioAutoencoderKL(taudio_vae.AudioVAEConfig(), device="meta")
    assert {p.dtype for p in full.parameters()} == {torch.bfloat16}


# ---- the 1-D DiT ----

def _jax_dit():
    cfg = jwan_dit.WanConfig(**DIT1D, dtype=jnp.float32, param_dtype=jnp.float32, remat=False, scan_blocks=False)
    return cfg, jwan_dit.WanDiT(cfg)


@pytest.fixture(scope="module")
def jax_dit():
    cfg, mod = _jax_dit()
    pe = jnp.zeros((1, 8, cfg.head_dim // 2, 2, 2))
    params = seeded_init(mod.init, jax.random.key(3), jnp.zeros((1, 8, 4)), jnp.zeros((1, 7, 64)), jnp.zeros((1,)), pe)
    return jax.tree.map(np.asarray, params["params"])


def _pe1d(n):
    ids = jwan_dit.wan_position_ids(n, 1, 1)
    return jwan_dit.multi_axis_rope(ids[..., :1], [128])


def _port_dit(params):
    dit = twan_dit.WanDiT(twan_dit.WanConfig(**DIT1D, dtype=torch.float32, remat=False))
    dit.load_state_dict(from_jax.wan_dit_state_dict(params))
    return dit.requires_grad_(False)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 45, 4), dtype=np.float32)
    return {"x0": lat, "noise": rng.standard_normal(lat.shape, dtype=np.float32),
            "ctx": rng.standard_normal((1, 7, 64), dtype=np.float32), "t": np.asarray([0.41], np.float32)}


def test_1d_dit_forward_matches_jax(jax_dit, monkeypatch):
    """The Wan DiT in 1-D mode (patch (1, 1, 1), the rope over time only:
    the zero-width axes drop out of the table) on 45 tokens; f32, 1e-4 of
    max|ref| (``time_in``-style embeddings meet XLA's exp); both attentions
    of each block run the flash kernel's plain version; the rope tables agree
    to 1e-6 (sin and cos of f32 angles on each side)."""
    cfg, jmod = _jax_dit()
    inp = _inputs(4)
    pe = _pe1d(45)
    tport = multi_axis_rope(torch.from_numpy(twan_dit.wan_position_ids(45, 1, 1)), [128, 0, 0])
    np.testing.assert_allclose(tport.numpy(), np.asarray(pe), rtol=0, atol=1e-6)  # zero-width axes add nothing
    ref = np.asarray(jax.jit(jmod.apply)({"params": jax_dit}, jnp.asarray(inp["x0"]), jnp.asarray(inp["ctx"]),
                                         jnp.asarray(inp["t"]), pe))
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", lambda *a: calls.append(a[1].shape) or real(*a))
    with torch.inference_mode():
        out = _port_dit(jax_dit)(torch.from_numpy(inp["x0"]), torch.from_numpy(inp["ctx"]),
                                 torch.from_numpy(inp["t"]), tport).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=1e-5)
    assert [s[1] for s in calls] == [45, 7] * 2


def test_1d_dit_lora_step_matches_jax(jax_dit):
    """One flow-matching LoRA step over every block Linear (the JAX
    ``wan_lora_targets``), noise and t injected: the loss to 1e-5 and every
    a and b gradient within 1e-4 of its max."""
    cfg, jmod = _jax_dit()
    dit = _port_dit(jax_dit)
    lora = tlora.build_lora(dit, tlora.LoRASpec(rank=4, alpha=8.0, target_patterns=twan_dit.wan_lora_targets()),
                            torch.Generator().manual_seed(5))
    gb = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    jtree: dict = {}
    for name, m in lora.items():
        block, leaf = twan_dit.wan_lora_key(name, scanned=False).split(".")
        jtree.setdefault(block, {})[leaf] = {k: jnp.asarray(getattr(m, k).detach().numpy()) for k in ("a", "b", "scale")}
    inp = _inputs(7)
    pe = _pe1d(45)
    x0, noise, t = (jnp.asarray(inp[k]) for k in ("x0", "noise", "t"))
    sched = JFlowMatchSchedule()

    def jloss(tree):
        pred = jmod.apply({"params": jax_dit, "lora": tree}, sched.add_noise(x0, noise, t), jnp.asarray(inp["ctx"]),
                          t, pe)
        return jcompute_loss(pred, sched.target(x0, noise, t))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jtree)

    def predict(noisy, tt, cond):
        return dit(noisy, cond["txt"], tt, cond["pe"])

    batch = {"latents": torch.from_numpy(inp["x0"]),
             "cond": {"txt": torch.from_numpy(inp["ctx"]), "pe": torch.from_numpy(np.asarray(pe))}}
    loss, _ = train_loss(predict, FlowMatchSchedule(), TrainStepConfig(), batch, torch.from_numpy(inp["noise"]),
                         torch.from_numpy(inp["t"]))
    names = [(n, leaf) for n in lora for leaf in ("a", "b")]
    grads = torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for (name, leaf), g in zip(names, grads):
        block, mod = twan_dit.wan_lora_key(name, scanned=False).split(".")
        ref = np.asarray(ref_grads[block][mod][leaf])
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0, err_msg=f"{name}.{leaf}")


# ---- the model ----

@pytest.fixture(scope="module")
def ace_tiny():
    jm = JAudioModel(JModelConfig.from_dict(dict(TINY)))
    jvars = filled(jax.eval_shape(jm.init_variables, jax.random.key(0)), 0)  # traced, not compiled
    model = AudioModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.ace_model_state(jvars))
    return jm, jvars, model, variables


def test_ace_model_matches_jax(ace_tiny):
    """``encode_audio`` of a [1, 64, 2] waveform, ``encode_prompt``,
    ``rope_table`` and ``predict`` of the tiny model; f32, 1e-5 relative and
    1e-4 of max|ref| (1e-5 for the VAE and T5)."""
    jm, jvars, model, variables = ace_tiny
    wav = np.random.default_rng(8).uniform(-1, 1, (1, 64, 2)).astype(np.float32)
    ref_lat = np.asarray(jm.encode_audio(jvars, jnp.asarray(wav)))
    with torch.inference_mode():
        lat = model.encode_images(variables, torch.from_numpy(wav)).numpy()
        cond = model.encode_prompt(variables, ["upbeat electronic music"])
        cond["pe"] = model.rope_table(lat.shape[1])
        out = model.predict(variables, torch.from_numpy(ref_lat), torch.tensor([0.3]), cond).numpy()
    np.testing.assert_allclose(lat, ref_lat, rtol=1e-5, atol=1e-5 * np.abs(ref_lat).max())
    jcond = jm.encode_prompt(jvars, ["upbeat electronic music"])
    np.testing.assert_allclose(cond["txt"].numpy(), np.asarray(jcond["txt"]), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jcond["txt"])).max())
    np.testing.assert_allclose(cond["pe"].numpy(), np.asarray(jm.rope_table(lat.shape[1])), rtol=0, atol=1e-6)
    ref = np.asarray(jm.predict(jvars, jnp.asarray(ref_lat), jnp.asarray([0.3]), {**jcond, "pe": jm.rope_table(16)}))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4 * np.abs(ref).max())
    assert model.latent_shape_audio(64) == jm.latent_shape_audio(64) == (16, 4)


@pytest.mark.parametrize("arch,dims", [("ace_step_15", (1536, 24, 12, 6144)), ("ace_step", (1536, 24, 12, 6144)),
                                       ("ace_step_15_xl", (2560, 32, 20, 10240))])
def test_full_size_configs_match_jax(arch, dims):
    """Each arch's full-size DiT, VAE and T5 config against the JAX class's."""
    cfg = {"name_or_path": "", "arch": arch}
    jm = JAudioModel(JModelConfig.from_dict(dict(cfg)))
    model = AudioModel(ModelConfig.from_dict(dict(cfg)), device="meta")
    d = model.dit_config
    assert (d.dim, d.num_layers, d.num_heads, d.ffn_dim) == dims
    for k in ("in_channels", "dim", "ffn_dim", "num_heads", "num_layers", "text_dim", "freq_dim", "patch_size",
              "axes_dim"):
        assert getattr(d, k) == getattr(jm.dit_config, k), k
    for k in ("latent_channels", "base_channels", "channel_multipliers", "stride", "downscale"):
        assert getattr(model.vae_config, k) == getattr(jm.vae_config, k), k
    assert model.t5_config.d_model == jm.t5_config.d_model and model.max_txt_len == jm.max_txt_len == 256


def test_ace_lora_keys_match_the_jax_job(ace_tiny):
    """The PEFT keys of JAX ``flatten_lora`` with the JAX job's key map over
    the tiny (unrolled) DiT's LoRA: the port's ``lora_key`` gives them."""
    from ai_toolkit_tpu.adapters import lora as jlora

    jm, jvars, model, variables = ace_tiny
    jtree = jlora.build_lora(jvars["dit"], jlora.LoRASpec(rank=4, target_patterns=jm.lora_targets()),
                             jax.random.key(1))
    ref = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jm, jtree), fmt="peft")
    lora = tlora.build_lora(variables["dit"], tlora.LoRASpec(rank=4, target_patterns=model.lora_targets()),
                            torch.Generator().manual_seed(1))
    tree = {n: {k: getattr(m, k).detach() for k in ("a", "b", "scale")} for n, m in lora.items()}
    ours = tlora_file.flatten_lora(tree, key_map=model.lora_key)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}


# ---- audio data ----

def _write_wavs(folder):
    from scipy.io import wavfile

    rng = np.random.default_rng(9)
    os.makedirs(folder, exist_ok=True)
    wavfile.write(os.path.join(folder, "stereo16.wav"), 44100,
                  (rng.uniform(-1, 1, (5000, 2)) * 20000).astype(np.int16))
    wavfile.write(os.path.join(folder, "mono_u8.wav"), 48000, rng.integers(0, 255, 6000).astype(np.uint8))
    wavfile.write(os.path.join(folder, "mono_f32.wav"), 22050, rng.uniform(-1, 1, 1000).astype(np.float32))
    for stem in ("stereo16", "mono_u8", "mono_f32"):
        with open(os.path.join(folder, f"{stem}.txt"), "w") as f:
            f.write(f"a {stem} clip")


@pytest.mark.parametrize("num_samples", [None, 4410, 9000])
def test_load_audio_matches_jax(tmp_path, num_samples):
    """int16 stereo at the rate asked for, uint8 mono at 48 kHz and f32 mono
    at 22.05 kHz (both resampled to 44.1 kHz by linear interpolation, mono
    doubled), cropped or padded to ``num_samples``: bit for bit with JAX
    ``FileItem.load_audio``."""
    _write_wavs(str(tmp_path))
    for stem in ("stereo16", "mono_u8", "mono_f32"):
        path = str(tmp_path / f"{stem}.wav")
        ref = JFileItem(path=path, caption="").load_audio(44100, num_samples)
        out = load_audio(path, 44100, num_samples)
        assert out.dtype == np.float32 and out.shape[1] == 2
        np.testing.assert_array_equal(out, ref, err_msg=stem)


def _av_folder(folder):
    """Two clips (one with a sidecar .wav), a lone song, their captions."""
    import cv2
    from scipy.io import wavfile

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(10)
    for stem in ("clip_a", "clip_b"):
        wr = cv2.VideoWriter(os.path.join(folder, f"{stem}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 8, (32, 32))
        for _ in range(5):
            wr.write(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
        wr.release()
    wavfile.write(os.path.join(folder, "clip_a.wav"), 16000, (rng.uniform(-1, 1, (3000, 2)) * 9000).astype(np.int16))
    wavfile.write(os.path.join(folder, "song.wav"), 16000, (rng.uniform(-1, 1, 800) * 9000).astype(np.int16))
    for stem in ("clip_a", "clip_b", "song"):
        with open(os.path.join(folder, f"{stem}.txt"), "w") as f:
            f.write(stem)


@pytest.mark.parametrize("do_audio", [True, False])
def test_sidecar_pairing_and_waveform_batch_match_jax(tmp_path, do_audio, capsys):
    """A clip's same-stem .wav is its sidecar, never an item (with or
    without ``do_audio``); a lone .wav is an audio item of ``audio_duration``
    samples in bucket (0, 0). With ``do_audio`` a clip batch carries
    ``audio_waveform`` over frames / fps seconds, zeros for the clip without a
    sidecar: items and waveforms bit for bit with JAX's dataset and loader."""
    folder = str(tmp_path / "av")
    _av_folder(folder)
    kw = dict(folder_path=folder, resolution=[32], num_frames=5, fps=10, do_audio=do_audio,
              audio_sample_rate=16000, audio_duration=None)
    jds = JFolderDataset(JDatasetConfig.from_dict(dict(kw)), 16)
    ds = FolderDataset(DatasetConfig.from_dict(dict(kw)), 16)
    got = [(os.path.basename(i.path), i.kind, i.bucket, i.num_samples) for i in ds.items]
    assert got == [(os.path.basename(i.path), i.kind, i.bucket, i.num_samples) for i in jds.items]
    assert sorted(g[:2] for g in got) == [("clip_a.avi", "video"), ("clip_b.avi", "video"), ("song.wav", "audio")]
    assert ("ignoring sidecar audio files" in capsys.readouterr().out) is not do_audio
    clips = [i for i in ds.items if i.kind == "video"]
    jclips = [i for i in jds.items if i.kind == "video"]
    out = DataLoader([ds], 2, encode_fn=lambda x: np.zeros((len(x), 1, 1, 1, 4), np.float32))._load_batch(ds, clips)
    ref = JDataLoader([jds], 2, encode_fn=lambda x: np.zeros((len(x), 1, 1, 1, 4), np.float32))._load_batch(
        jds, jclips)
    assert ("audio_waveform" in out) is do_audio and ("audio_waveform" in ref) is do_audio
    if do_audio:
        assert out["audio_waveform"].shape == (2, 8000, 2)
        np.testing.assert_array_equal(out["audio_waveform"], ref["audio_waveform"])
        assert not out["audio_waveform"][0].any() or not out["audio_waveform"][1].any()


# ---- refusals and the shipped file ----

def test_exact_mode_and_audio_sampling_raise(tmp_path):
    """A ``.safetensors`` ``name_or_path`` (the exact ACE-Step 1.5 mode) and
    sample prompts on an audio arch raise, naming Queue 1 item 6a."""
    cfg = ModelConfig.from_dict({"name_or_path": str(tmp_path / "ace.safetensors"), "arch": "ace_step_15"})
    with pytest.raises(NotImplementedError, match="item 6a") as e:
        AudioModel(cfg, device="cpu")
    assert str(e.value) == EXACT_MODE
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_ace_step_audio.yaml"))
    raw["config"]["process"][0]["sample"] = {"sample_every": 10, "prompts": ["a drum loop"]}
    with pytest.raises(NotImplementedError, match="generate_audio.*item 6a"):
        for proc in get_job(raw, device="cpu").processes:
            proc._refuse_unported()


def test_shipped_file_runs_through_run_py(tmp_path, capsys):
    """``python -m ai_toolkit_tpu_torch.run`` on the shipped ACE file at
    ``size: tiny`` over the three wavs, 2 steps: finite losses, the disk cache
    of [T, C] fp16 latents (one file per wav), and a PEFT LoRA whose keys are
    the JAX job's unrolled module paths."""
    from safetensors.numpy import load_file

    folder = str(tmp_path / "wavs")
    _write_wavs(folder)
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_ace_step_audio.yaml"))
    proc = raw["config"]["process"][0]
    proc["training_folder"] = str(tmp_path / "out")
    proc["datasets"][0].update(folder_path=folder, audio_duration=0.1)
    proc["train"]["steps"] = 2
    proc["model"]["model_kwargs"] = {"size": "tiny"}
    path = str(tmp_path / "job.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    assert run_main([path, "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert "step 1/2" in log and "nan" not in log
    out_dir = str(tmp_path / "out" / raw["config"]["name"])
    cache = os.path.join(out_dir, "latent_cache")
    files = sorted(os.listdir(cache))
    assert len(files) == 3
    lat = load_file(os.path.join(cache, files[0]))["latent"]
    assert lat.dtype == np.float16 and lat.shape == (4410 // 4, 4)
    keys = load_file(os.path.join(out_dir, f"{raw['config']['name']}.safetensors"))
    assert "transformer.block_0.self_q.lora_A.weight" in keys and len(keys) == 2 * 20
