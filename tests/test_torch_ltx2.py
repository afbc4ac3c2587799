"""The port's LTX-2 slice against the JAX package on the CPU, in f32: the
video VAE (LTX-2's four downsamplers and three residual upsamplers, narrowed),
the joint audio-video DiT at head dims 128 and 64 over ragged token counts
(all six attentions of a block take the flash kernel's plain version) and
one joint LoRA step with the audio loss and ``audio_loss_multiplier``, the
model's ``predict`` (joint, a video-only batch on the joint model, and the
video-only LTX-2), the joint sampler for 2 steps, the checkpoint directory
against ``load_ltx2_checkpoint``, the LoRA keys of the JAX job, the JAX-side
faults (each a ``[jax_fault]`` / ``[port]`` pair), the refusals and the
shipped file as a tiny job through ``run.py``. Weights come from the JAX
package's own init through ``io/from_jax``; inputs, noise and timesteps are
made with numpy and handed to both sides."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.generation import generate_video as jax_generate_video
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models import ltx2_av as jav
from ai_toolkit_tpu.models import ltx_audio_vae as jmel
from ai_toolkit_tpu.models import ltx_video_vae as jvae
from ai_toolkit_tpu.models import wan_dit as jwan_dit
from ai_toolkit_tpu.models.ltx2_model import LTX2Model as JLTX2Model
from ai_toolkit_tpu.samplers import FlowMatchSchedule as JFlowMatchSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.generation import generate_video
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io import lora_file as tlora_file
from ai_toolkit_tpu_torch.io.ltx2_layout import JOINT_DIT, ltx2_fill
from ai_toolkit_tpu_torch.models import ltx2_av as tav
from ai_toolkit_tpu_torch.models import ltx_audio_vae as tmel
from ai_toolkit_tpu_torch.models import ltx_video_vae as tvae
from ai_toolkit_tpu_torch.models import wan_dit as twan_dit
from ai_toolkit_tpu_torch.models.ltx2_model import LTX2Model
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
from ai_toolkit_tpu_torch.run import main as run_main
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from test_torch_flux_family import OPT0, fast_jit, jit_decode
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINT = {"name_or_path": "", "arch": "ltx2", "model_kwargs": {"size": "tiny", "joint_audio": True, "audio_vae": "mel"}}
VIDEO = {"name_or_path": "", "arch": "ltx2", "model_kwargs": {"size": "tiny"}}
# LTX-2's VAE structure, narrowed: spatial, temporal and two spatiotemporal downsamplers; three upsamplers
VAE_NARROW = dict(latent_channels=4, block_out_channels=(8, 16, 32, 32), layers_per_block=(1, 1, 1, 1, 1),
                  decoder_channels=(32, 16, 8), decoder_layers=(1, 1, 1, 1), patch_size=2)
# the joint DiT at video head_dim 128 and audio head_dim 64 (the AV width 128 over 2 heads)
VIDEO128 = dict(in_channels=4, dim=256, ffn_dim=128, num_heads=2, num_layers=2, text_dim=64, freq_dim=32,
                axes_dim=(44, 42, 42))
AUDIO64 = dict(audio_in_channels=4, audio_dim=128, audio_ffn_dim=64, audio_heads=2)


def _tol(got, ref, rel=1e-4):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=rel * np.abs(ref).max())


# ---- the video VAE ----

@pytest.fixture(scope="module")
def jax_vae():
    cfg = jvae.LTXVideoVAEConfig(**VAE_NARROW, dtype=jnp.float32)
    mod = jvae.LTXVideoVAE(cfg)
    params = seeded_init(mod.init, jax.random.key(0), jnp.zeros((1, 9, 32, 32, 3)))["params"]
    return jax.tree.map(lambda v: np.asarray(v) + (0.01 if v.ndim == 1 else 0.0), params)  # non-zero biases


def _port_vae(params, **kw):
    mod = tvae.LTXVideoVAE(tvae.LTXVideoVAEConfig(**VAE_NARROW, dtype=torch.float32, **kw))
    mod.load_state_dict(from_jax.ltx_video_vae_state_dict(params))
    return mod


def test_video_vae_matches_jax(jax_vae):
    """raw moments, encode (normalized by latent statistics) and decode of a
    [1, 9, 32, 32, 3] clip: 2 x 2 x 2 latents, 9 frames back; the causal
    encoder's replicated front frames, the decoder's split replicate and
    reflect padding, space-to-depth with its channel order, the grouped-mean
    residual and the upsampler residual; f32, 1e-5 relative and 1e-4 of
    max|ref|."""
    stats = dict(latents_mean=(0.1, -0.2, 0.3, 0.0), latents_std=(1.5, 0.5, 2.0, 1.0))
    jmod = jvae.LTXVideoVAE(jvae.LTXVideoVAEConfig(**VAE_NARROW, dtype=jnp.float32, **stats))
    vid = np.random.default_rng(1).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)

    def run(p, x):  # one program: the moments, the latents and their decode
        lat = jmod.apply({"params": p}, x, method=jvae.LTXVideoVAE.encode)
        return (jmod.apply({"params": p}, x, method=jvae.LTXVideoVAE.raw_moments), lat,
                jmod.apply({"params": p}, lat, method=jvae.LTXVideoVAE.decode))

    ref_mom, ref_lat, ref_dec = (np.asarray(r) for r in fast_jit(run, jax_vae, vid))
    mod = _port_vae(jax_vae, **stats)
    with torch.inference_mode():
        mom = mod.raw_moments(torch.from_numpy(vid)).numpy()
        lat = mod.encode(torch.from_numpy(vid)).numpy()
        dec = mod.decode(torch.from_numpy(ref_lat)).numpy()
    assert lat.shape == (1, 2, 2, 2, 4) and dec.shape == vid.shape
    for got, ref in ((mom, ref_mom), (lat, ref_lat), (dec, ref_dec)):
        _tol(got, ref)


def test_video_vae_names_are_the_importer_keys(jax_vae):
    """JAX ``ltx_video_vae_rules`` over the port's state dict (the diffusers
    ``AutoencoderKLLTX2Video`` names) rebuild the JAX tree."""
    from ai_toolkit_tpu.io.torch_import import torch_to_tree
    from ai_toolkit_tpu.io.video_vae_import import ltx_video_vae_rules

    sd = {k: v.numpy() for k, v in _port_vae(jax_vae).state_dict().items()}
    tree, unmatched = torch_to_tree(sd, ltx_video_vae_rules())
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(jax_vae)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ---- the joint DiT ----

def _jax_av():
    v = jwan_dit.WanConfig(**VIDEO128, dtype=jnp.float32, param_dtype=jnp.float32, remat=False, scan_blocks=False)
    return jav.LTX2AVDiT(jav.LTX2AVConfig(video=v, **AUDIO64))


@pytest.fixture(scope="module")
def jax_av():
    mod = _jax_av()
    pe = jnp.zeros((1, 8, 64, 2, 2))
    pa = jnp.zeros((1, 4, 32, 2, 2))
    params = seeded_init(mod.init, jax.random.key(2), jnp.zeros((1, 8, 16)), jnp.zeros((1, 4, 4)),
                               jnp.zeros((1, 7, 64)), jnp.zeros((1,)), pe, pa)["params"]
    return jax.tree.map(np.asarray, params)


def _port_av(params):
    cfg = tav.LTX2AVConfig(video=twan_dit.WanConfig(**VIDEO128, dtype=torch.float32, remat=False), **AUDIO64)
    dit = tav.LTX2AVDiT(cfg)
    dit.load_state_dict(from_jax.ltx2_av_state_dict(params))
    return dit.requires_grad_(False)


def _av_inputs(seed):
    """3 x 6 x 10 video latents (45 tokens), 11 audio tokens, 7 text tokens."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 3, 6, 10, 4), dtype=np.float32)
    aud = rng.standard_normal((1, 11, 4), dtype=np.float32)
    return {"x0": lat, "noise": rng.standard_normal(lat.shape, dtype=np.float32), "a0": aud,
            "noise_a": rng.standard_normal(aud.shape, dtype=np.float32),
            "ctx": rng.standard_normal((1, 7, 64), dtype=np.float32), "t": np.asarray([0.37], np.float32)}


def _ropes():
    pe = jwan_dit.multi_axis_rope(jwan_dit.wan_position_ids(3, 3, 5), [44, 42, 42])
    pa = jwan_dit.multi_axis_rope(jnp.arange(11, dtype=jnp.int32)[None, :, None], [64])
    return pe, pa


def test_av_dit_forward_matches_jax(jax_av, monkeypatch):
    """Both streams of the joint DiT over 45 video and 11 audio tokens; f32,
    1e-5 relative and 1e-4 of max|ref| (``time_in``-style embeddings meet
    XLA's exp); the six attentions of each block (video self, audio self,
    a2v, v2a, video and audio text) run the flash kernel's plain version, at
    head dims 128 and 64."""
    jmod = _jax_av()
    inp = _av_inputs(3)
    pe, pa = _ropes()
    tok = jwan_dit.wan_patchify(jnp.asarray(inp["x0"]), (1, 2, 2))
    ref_v, ref_a = jax.jit(jmod.apply)({"params": jax_av}, tok, jnp.asarray(inp["a0"]), jnp.asarray(inp["ctx"]),
                                       jnp.asarray(inp["t"]), pe, pa)
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", lambda *a: calls.append(a[1].shape) or real(*a))
    with torch.inference_mode():
        out_v, out_a = _port_av(jax_av)(torch.from_numpy(np.asarray(tok)), torch.from_numpy(inp["a0"]),
                                        torch.from_numpy(inp["ctx"]), torch.from_numpy(inp["t"]),
                                        torch.from_numpy(np.asarray(pe)), torch.from_numpy(np.asarray(pa)))
    _tol(out_v.numpy(), np.asarray(ref_v))
    _tol(out_a.numpy(), np.asarray(ref_a))
    assert [(s[1], s[3]) for s in calls] == [(45, 128), (11, 64), (11, 64), (45, 64), (7, 128), (7, 64)] * 2


def _av_lora(dit, seed=4):
    lora = tlora.build_lora(dit, tlora.LoRASpec(rank=4, alpha=8.0, target_patterns=twan_dit.wan_lora_targets()),
                            torch.Generator().manual_seed(seed))
    gb = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    jtree: dict = {}
    for name, m in lora.items():
        block, leaf = tav.av_lora_key(name, scanned=False).split(".")
        jtree.setdefault(block, {})[leaf] = {k: jnp.asarray(getattr(m, k).detach().numpy()) for k in ("a", "b", "scale")}
    return lora, jtree


def test_av_lora_step_matches_jax(jax_av):
    """One joint LoRA step over the 28 Linears of each block: video and
    audio noised at one t (injected), the audio loss weighted by
    ``audio_loss_multiplier`` 0.25 and a loss multiplier of 2, as JAX
    ``make_train_step``'s joint branch computes it: the loss and the audio
    loss to 1e-5, every a and b gradient within 1e-4 of its max."""
    jmod = _jax_av()
    dit = _port_av(jax_av)
    lora, jtree = _av_lora(dit)
    assert len(lora) == 2 * 28
    assert sorted(from_jax.ltx2_av_lora_tree(jax.tree.map(np.asarray, jtree))) == sorted(lora)
    inp = _av_inputs(5)
    pe, pa = _ropes()
    x0, noise, a0, noise_a, t = (jnp.asarray(inp[k]) for k in ("x0", "noise", "a0", "noise_a", "t"))
    mult = jnp.asarray([2.0])
    sched = JFlowMatchSchedule()

    def jloss(tree):
        tok = jwan_dit.wan_patchify(sched.add_noise(x0, noise, t), (1, 2, 2))
        out_v, out_a = jmod.apply({"params": jax_av, "lora": tree}, tok, sched.add_noise(a0, noise_a, t),
                                  jnp.asarray(inp["ctx"]), t, pe, pa)
        pred = jwan_dit.wan_unpatchify(out_v, 3, 6, 10, (1, 2, 2), 4)
        loss, _ = jcompute_loss(pred, sched.target(x0, noise, t), loss_multiplier=mult)
        audio_loss, _ = jcompute_loss(out_a, sched.target(a0, noise_a, t), loss_multiplier=mult)
        return loss + 0.25 * audio_loss, audio_loss

    (ref_loss, ref_audio), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtree)

    def predict(noisy, tt, cond):
        out_v, out_a = dit(twan_dit.wan_patchify(noisy, (1, 2, 2)), cond["noisy_audio"], cond["txt"], tt, cond["pe"],
                           cond["pe_audio"])
        return twan_dit.wan_unpatchify(out_v, 3, 6, 10, (1, 2, 2), 4), out_a

    batch = {"latents": torch.from_numpy(inp["x0"]), "audio_latents": torch.from_numpy(inp["a0"]),
             "loss_multiplier": torch.tensor([2.0]),
             "cond": {"txt": torch.from_numpy(inp["ctx"]), "pe": torch.from_numpy(np.asarray(pe)),
                      "pe_audio": torch.from_numpy(np.asarray(pa))}}
    cfg = TrainStepConfig(audio_loss_multiplier=0.25)
    loss, aux = train_loss(predict, FlowMatchSchedule(), cfg, batch, torch.from_numpy(inp["noise"]),
                           torch.from_numpy(inp["t"]), torch.from_numpy(inp["noise_a"]))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["audio_loss"]), float(ref_audio), rtol=1e-5)
    names = [(n, leaf) for n in lora for leaf in ("a", "b")]
    grads = torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])
    for (name, leaf), g in zip(names, grads):
        block, mod = tav.av_lora_key(name, scanned=False).split(".")
        ref = np.asarray(ref_grads[block][mod][leaf])
        assert np.abs(ref).max() > 0, f"{name}.{leaf}"
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0, err_msg=f"{name}.{leaf}")


def test_audio_loss_multiplier_reaches_the_step():
    """``train.audio_loss_multiplier`` goes into the step's config, and the
    eval loss adds the audio loss unweighted, as JAX's does."""
    from ai_toolkit_tpu_torch.config.modules import TrainConfig

    assert TrainStepConfig.from_train_config(TrainConfig(audio_loss_multiplier=0.3)).audio_loss_multiplier == 0.3


# ---- the model ----

_INITS = {}


def _jit_init(jm, cfg: dict, compiled: bool = False):
    """``jm.init_variables`` once per model config for the file (the models of
    one config differ only in their path, which the init does not read), the
    JAX loader's too: seeded values at its shapes (``seeded_init``: traced,
    not compiled), or with ``compiled`` JAX's own init compiled at XLA's
    optimization level 0, where a test needs its identity norms."""
    key = (repr(sorted(cfg["model_kwargs"].items())), compiled)
    if key not in _INITS:
        if compiled:
            _INITS[key] = jax.jit(jm.init_variables, compiler_options=OPT0)
        else:
            shapes = jax.eval_shape(jm.init_variables, jax.random.key(0))
            _INITS[key] = lambda rng: seeded_init(lambda _: shapes, rng)
    return _INITS[key]


@pytest.fixture(scope="module")
def joint_tiny():
    jm = JLTX2Model(JModelConfig.from_dict(dict(JOINT)))
    jvars = jax.tree.map(np.asarray, _jit_init(jm, JOINT)(jax.random.key(0)))
    model = LTX2Model(ModelConfig.from_dict(dict(JOINT)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.ltx2_model_state(jvars, gemma=False, joint=True, mel=True))
    return jm, jvars, model, variables


def test_joint_model_predict_and_audio_match_jax(joint_tiny):
    """The tiny joint model: ``encode_images`` of a 5-frame clip,
    ``encode_audio`` (log-mel, the mel VAE, packing) of a 0.2 s 48 kHz
    waveform, ``predict`` with the audio stream and on a video-only batch
    (one silent audio token), and ``decode_audio`` through the vocoder; f32,
    1e-5 relative and 1e-4 of max|ref|."""
    jm, jvars, model, variables = joint_tiny
    rng = np.random.default_rng(6)
    vid = rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    wav = rng.uniform(-1, 1, (1, 9600, 2)).astype(np.float32)
    # eager flax compiles one program per op: every JAX call is jitted
    ref_lat = np.asarray(jax.jit(jm.encode_images)(jvars, jnp.asarray(vid)))
    ref_aud = np.asarray(jax.jit(jm.encode_audio)(jvars, jnp.asarray(wav)))
    jcond = jm.encode_prompt(jvars, ["a dog barking"])
    jcond.update(pe=jm.rope_table(*ref_lat.shape[1:4]), pe_audio=jm.audio_rope_table(ref_aud.shape[1]))
    t = jnp.asarray([0.6])
    predict = jax.jit(jm.predict)
    ref_v, ref_a = predict(jvars, jnp.asarray(ref_lat), t, {**jcond, "noisy_audio": jnp.asarray(ref_aud)})
    ref_silent = predict(jvars, jnp.asarray(ref_lat), t, jcond)
    ref_wav = np.asarray(jax.jit(jm.decode_audio)(jvars, jnp.asarray(ref_aud)))
    with torch.inference_mode():
        lat = model.encode_images(variables, torch.from_numpy(vid))
        aud = model.encode_audio(variables, torch.from_numpy(wav))
        cond = model.encode_prompt(variables, ["a dog barking"])
        cond.update(pe=model.rope_table(*lat.shape[1:4]), pe_audio=model.audio_rope_table(aud.shape[1]))
        tt = torch.tensor([0.6])
        out_v, out_a = model.predict(variables, torch.from_numpy(ref_lat), tt,
                                     {**cond, "noisy_audio": torch.from_numpy(ref_aud)})
        silent = model.predict(variables, torch.from_numpy(ref_lat), tt, cond)
        out_wav = model.decode_audio(variables, torch.from_numpy(ref_aud))
    assert lat.shape == (1, 3, 8, 8, 4) and aud.shape == ref_aud.shape == (1, 27, 4)
    for got, ref in ((lat, ref_lat), (aud, ref_aud), (out_v, ref_v), (out_a, ref_a), (silent, ref_silent),
                     (out_wav, ref_wav)):
        _tol(got.numpy(), np.asarray(ref))
    assert out_wav.shape == (1, (2 * 27 - 1) * 4, 2)


def test_video_only_ltx2_predict_matches_jax():
    """The video-only LTX-2 (the Wan DiT at LTX-2's layout) through ``predict``; f32, 1e-4 of max|ref|."""
    jm = JLTX2Model(JModelConfig.from_dict(dict(VIDEO)))
    jvars = jax.tree.map(np.asarray, _jit_init(jm, VIDEO)(jax.random.key(1)))
    model = LTX2Model(ModelConfig.from_dict(dict(VIDEO)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.ltx2_model_state(jvars, gemma=False, joint=False, mel=False))
    lat = np.random.default_rng(7).standard_normal((1, 3, 8, 8, 4)).astype(np.float32)
    jcond = {**jm.encode_prompt(jvars, ["a cat"]), "pe": jm.rope_table(3, 8, 8)}
    ref = np.asarray(jax.jit(jm.predict)(jvars, jnp.asarray(lat), jnp.asarray([0.4]), jcond))
    with torch.inference_mode():
        cond = {**model.encode_prompt(variables, ["a cat"]), "pe": model.rope_table(3, 8, 8)}
        out = model.predict(variables, torch.from_numpy(lat), torch.tensor([0.4]), cond).numpy()
    _tol(out, ref)
    assert isinstance(variables["dit"], twan_dit.WanDiT) and "audio_vae" not in variables


def test_full_size_configs_match_jax():
    """The full-size joint model's DiT, AV, VAE, mel VAE, vocoder and caption-tower configs against JAX's."""
    cfg = {"name_or_path": "", "arch": "ltx2", "model_kwargs": {"joint_audio": True, "audio_vae": "mel"}}
    jm = JLTX2Model(JModelConfig.from_dict(dict(cfg)))
    model = LTX2Model(ModelConfig.from_dict(dict(cfg)), device="meta")
    pairs = [(model.dit_config, jm.dit_config, ("in_channels", "dim", "ffn_dim", "num_heads", "num_layers",
                                                "text_dim", "freq_dim", "patch_size", "axes_dim")),
             (model.av_config, jm.av_config, ("audio_in_channels", "audio_dim", "audio_ffn_dim", "audio_heads",
                                              "audio_head_dim", "av_inner_dim")),
             (model.vae_config, jm.vae_config, ("latent_channels", "block_out_channels", "layers_per_block",
                                                "downsample_type", "decoder_channels", "decoder_layers",
                                                "spatial_downscale", "temporal_downscale")),
             (model.audio_vae_config, jm.audio_vae_config, ("base_channels", "ch_mult", "latent_channels",
                                                            "mel_bins", "sample_rate", "hop_length", "downscale")),
             (model.vocoder_config, jm.vocoder_config, ("in_channels", "hidden_channels", "upsample_kernel_sizes",
                                                        "upsample_factors", "total_upsample")),
             (model.llm_config, jm.llm_config, ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
                                                "head_dim", "d_ff", "rope_theta", "rms_eps", "post_norms",
                                                "gemma_gelu", "scale_embeddings", "attn_softcap"))]
    for ours, ref, keys in pairs:
        for k in keys:
            assert getattr(ours, k) == getattr(ref, k), k
    assert model.frame_count_snapper(49) == jm.frame_count_snapper(49) == 49
    assert model.latent_shape(512, 512, 49) == jm.latent_shape(512, 512, 49) == (7, 16, 16, 128)
    assert model.audio_vae_config.downscale == 640


def test_joint_sampler_matches_jax(joint_tiny):
    """Two Euler steps of both streams at the shared sigmas, 5 frames at
    32 x 32 with 8 fps (0.625 s: round(0.625 * 48000 / 320) = 94 audio
    tokens), the JAX draws injected: uint8 frames within 1 and the vocoder's
    waveform within 1e-5 relative and 1e-4 of max|ref|."""
    jm, jvars, model, variables = joint_tiny
    kw = dict(prompt="a dog barking in the rain", width=32, height=32, seed=3, sample_steps=2, num_frames=5, fps=8)
    ref_frames, ref_wav = jax_generate_video(jit_decode(jm), jvars, JGenerateImageConfig(**kw))
    key = jax.random.key(3)
    noise = np.asarray(jax.random.normal(key, (1, *model.latent_shape(32, 32, 5)), jnp.float32))
    noise_a = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (1, 94, 4), jnp.float32))
    stats = {}
    frames, wav = generate_video(model, variables, GenerateImageConfig(**kw), noise=noise, noise_audio=noise_a,
                                 stats=stats)
    assert frames.shape == np.asarray(ref_frames).shape == (5, 32, 32, 3) and stats["audio_tokens"] == 94
    assert np.abs(frames.astype(np.int16) - np.asarray(ref_frames).astype(np.int16)).max() <= 1
    assert wav.shape == ref_wav.shape == ((2 * 94 - 1) * 4, 2)  # one causal mel upsample, the vocoder's 4x
    _tol(wav, ref_wav)


# ---- LoRA keys, the checkpoint directory, the JAX faults ----

def test_lora_keys_match_the_jax_job(joint_tiny):
    """The PEFT keys and fp16 values of JAX ``flatten_lora`` with the JAX
    job's key map over the joint DiT's LoRA, unrolled (``tiny``:
    ``transformer.block_0.a2v_q``) and scanned (full size:
    ``transformer.blocks.block.a2v_q.0``); both read back to the port's modules."""
    jm, jvars, model, variables = joint_tiny
    lora, jtree = _av_lora(variables["dit"])
    tlora.detach_lora(variables["dit"])
    tree = {n: {k: getattr(m, k).detach() for k in ("a", "b", "scale")} for n, m in lora.items()}
    stacked = {"blocks": {"block": jax.tree.map(lambda *xs: jnp.stack(xs), jtree["block_0"], jtree["block_1"])}}
    for scanned, jt in ((False, jtree), (True, stacked)):
        ref = jlora_file.flatten_lora(jt, key_map=JSDTrainProcess._key_map(jm, jt), fmt="peft")
        ours = tlora_file.flatten_lora(tree, key_map=lambda n: tav.av_lora_key(n, scanned))
        assert sorted(ours) == sorted(ref) and len(ref) == 2 * 2 * 28
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert sorted(tlora_file.unflatten_lora(ours, module_name=tav.av_module_name)) == sorted(tree)
    assert "transformer.block_1.v2a_k.lora_A.weight" in ours or "transformer.blocks.block.v2a_k.1.lora_A.weight" in ours


def _diffusers_dit(sd):
    """The port's video-only LTX-2 DiT state dict under diffusers LTX-2 names (norm2 has none)."""
    ren = [("blocks.", "transformer_blocks."), ("condition_embedder.time_embedder.", "time_embed.emb.timestep_embedder."),
           ("condition_embedder.time_proj.", "time_embed.linear."),
           ("condition_embedder.text_embedder.", "caption_projection."), ("patch_embedding.", "proj_in.")]
    out = {}
    for k, v in sd.items():
        if ".norm2." in k:
            continue
        for a, b in ren:
            if k.startswith(a):
                k = b + k[len(a):]
        out[k.replace(".ffn.net.", ".ff.net.")] = v.contiguous()
    return out


def _write_dir(root, model, variables, rng):
    """A tiny LTX-2 directory: transformer/ (diffusers names), audio_vae/
    with statistics and vocoder/ (a joint model's). No vae/: JAX rebuilds the
    VAE on LTX-2's full config, so a tiny one does not load there."""
    from safetensors.torch import save_file

    def perturbed(sd):
        return {k: (v + 0.1 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))).contiguous()
                for k, v in sd.items()}

    os.makedirs(os.path.join(root, "transformer"))
    save_file(_diffusers_dit(perturbed(variables["dit"].state_dict())),
              os.path.join(root, "transformer", "diffusion_pytorch_model.safetensors"))
    for name in ("audio_vae", "vocoder"):
        if name not in variables:
            continue
        os.makedirs(os.path.join(root, name))
        sd = perturbed(variables[name].state_dict())
        if name == "audio_vae":
            sd.update(latents_mean=torch.linspace(-0.2, 0.2, 2), latents_std=torch.linspace(0.5, 1.5, 2))
        save_file(sd, os.path.join(root, name, "diffusion_pytorch_model.safetensors"))


def test_checkpoint_directory_matches_load_ltx2_checkpoint(tmp_path, capsys):
    """A tiny video-only LTX-2 directory (transformer/ in diffusers names)
    through the port's loader and JAX ``load_ltx2_checkpoint``: every DiT
    tensor equal (the cross-attention's ``norm2`` at its identity init in
    both), the caption tower and VAE (no text_encoder/, vae/) left seeded
    with a line that says so."""
    from ai_toolkit_tpu.io.dit_importers import load_ltx2_checkpoint

    model = LTX2Model(ModelConfig.from_dict(dict(VIDEO)), device="cpu")
    _write_dir(str(tmp_path), model, model.init_variables(torch.Generator().manual_seed(0)),
               np.random.default_rng(8))
    cfg = {**VIDEO, "name_or_path": str(tmp_path)}
    jm = JLTX2Model(JModelConfig.from_dict(dict(cfg)))
    jm.init_variables = _jit_init(jm, cfg, compiled=True)  # the loader's init: norm2 stays at its identity
    jvars = jax.tree.map(np.asarray, load_ltx2_checkpoint(str(tmp_path), jm))
    model = LTX2Model(ModelConfig.from_dict(dict(cfg)), device="cpu")
    variables = model.load_variables(torch.Generator().manual_seed(0))
    ref = from_jax.wan_dit_state_dict(jvars["dit"])
    sd = variables["dit"].state_dict()
    assert sorted(sd) == sorted(ref)
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0, msg=k)
    assert "keeps its seeded init" in capsys.readouterr().out


def test_vae_config_from_a_directory_matches_jax(tmp_path):
    """vae/ with statistics and a config.json: the port builds the VAE
    config JAX ``load_ltx_video_vae`` builds (LTX-2's, with the file's
    widths and the statistics), before any module is made."""
    import json

    from safetensors.torch import save_file

    from ai_toolkit_tpu.io.video_vae_import import load_ltx_video_vae
    from ai_toolkit_tpu_torch.io.ltx2_layout import ltx2_prepare

    (tmp_path / "vae").mkdir()
    save_file({"latents_mean": torch.linspace(-1, 1, 64), "latents_std": torch.linspace(0.5, 2, 64)},
              str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    (tmp_path / "vae" / "config.json").write_text(json.dumps({"latent_channels": 64, "patch_size": 2}))
    jcfg, _, _ = load_ltx_video_vae(str(tmp_path / "vae"))
    model = LTX2Model(ModelConfig.from_dict(dict(VIDEO)), device="meta")
    ltx2_prepare(model, str(tmp_path))
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(model.vae_config, f.name) == getattr(jcfg, f.name), f.name


def test_mel_chain_directories_match_jax(tmp_path, joint_tiny):
    """audio_vae/ (with statistics) and vocoder/ of a directory read by the
    port's loader and by JAX ``load_ltx_audio_vae`` / ``vocoder_rules``: equal tensors and statistics."""
    from ai_toolkit_tpu.io.torch_import import load_safetensors_dir, torch_to_tree
    from ai_toolkit_tpu.io.video_vae_import import load_ltx_audio_vae
    from ai_toolkit_tpu.models.ltx_vocoder import vocoder_rules

    _, _, model, variables = joint_tiny
    _write_dir(str(tmp_path), model, variables, np.random.default_rng(9))
    acfg, atree, unmatched = load_ltx_audio_vae(str(tmp_path / "audio_vae"))
    assert not unmatched
    vtree, unmatched = torch_to_tree(load_safetensors_dir(str(tmp_path / "vocoder")), vocoder_rules())
    assert not unmatched
    fresh = LTX2Model(ModelConfig.from_dict({**JOINT, "name_or_path": str(tmp_path)}), device="cpu")
    fill = ltx2_fill(fresh, str(tmp_path))
    assert fresh.audio_vae_config.latents_mean == acfg.latents_mean  # the statistics read before the build
    avae = tmel.LTXAudioVAE(fresh.audio_vae_config)
    voc = type(variables["vocoder"])(fresh.vocoder_config)
    fill("audio_vae", avae)
    fill("vocoder", voc)
    for mod, ref in ((avae, from_jax.ltx_audio_vae_state_dict(atree)), (voc, from_jax.vocoder_state_dict(vtree))):
        sd = mod.state_dict()
        assert sorted(sd) == sorted(ref)
        for k in sd:
            torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0, msg=k)


def test_jax_fault_checkpoint_audio_stream_stays_seeded(tmp_path, joint_tiny):
    """[jax_fault] JAX ``load_ltx2_checkpoint`` on a joint model reads the
    video keys of transformer/ and leaves the audio stream at its seeded
    init, and the checkpoint's time projection lands on ``time_projection``,
    a name the joint tree has not: its ``time_proj`` stays seeded too."""
    from ai_toolkit_tpu.io.dit_importers import load_ltx2_checkpoint

    video = LTX2Model(ModelConfig.from_dict(dict(VIDEO)), device="cpu")
    _write_dir(str(tmp_path), video, video.init_variables(torch.Generator().manual_seed(0)),
               np.random.default_rng(10))
    jm = JLTX2Model(JModelConfig.from_dict({**JOINT, "name_or_path": str(tmp_path)}))
    jm.init_variables = _jit_init(jm, JOINT)  # the loader's seeded init, once for the file
    seeded = jax.tree.map(np.asarray, jm.init_variables(jax.random.key(0)))["dit"]
    loaded = jax.tree.map(np.asarray, load_ltx2_checkpoint(str(tmp_path), jm))["dit"]
    for k in ("audio_proj_in", "audio_time_proj", "time_proj"):
        np.testing.assert_array_equal(loaded[k]["kernel"], seeded[k]["kernel"])
    np.testing.assert_array_equal(loaded["block_0"]["audio_self_q"]["kernel"], seeded["block_0"]["audio_self_q"]["kernel"])
    assert not np.array_equal(loaded["block_0"]["self_q"]["kernel"], seeded["block_0"]["self_q"]["kernel"])


def test_port_refuses_a_joint_checkpoint_dit(tmp_path):
    """[port] The same directory on the port's joint model raises, naming the fault."""
    video = LTX2Model(ModelConfig.from_dict(dict(VIDEO)), device="cpu")
    _write_dir(str(tmp_path), video, video.init_variables(torch.Generator().manual_seed(0)),
               np.random.default_rng(10))
    model = LTX2Model(ModelConfig.from_dict({**JOINT, "name_or_path": str(tmp_path)}), device="cpu")
    with pytest.raises(NotImplementedError) as e:
        model.load_variables(torch.Generator().manual_seed(0))
    assert str(e.value) == JOINT_DIT and "Queue 3" in JOINT_DIT


def test_jax_fault_48khz_waveform_goes_to_a_16khz_mel():
    """[jax_fault] The shipped file loads its sidecar audio at 48 kHz
    (``audio_sample_rate: 48000``) and JAX ``encode_audio`` frames it with the
    mel VAE's 16 kHz filterbank and hop of 160: the 2.04 s of a 49-frame clip
    at 24 fps (98,000 samples) make 607 mel frames, 151 tokens, three times
    the 25 tokens a second of LTX-2's latent rate."""
    cfg = jmel.LTXAudioVAEConfig.ltx2()
    assert cfg.sample_rate == 16000 and cfg.hop_length == 160
    mel = jax.eval_shape(lambda w: jmel.log_mel_jax(w, cfg.sample_rate, n_mels=cfg.mel_bins),
                         jax.ShapeDtypeStruct((1, int(49 / 24 * 48000), 2), jnp.float32))
    assert mel.shape == (1, 607, 64, 2) and mel.shape[1] // cfg.time_downscale == 151


def test_port_mirrors_the_48khz_mel():
    """[port] The port frames the 48 kHz waveform the same way: 607 mel frames, 151 tokens."""
    model = LTX2Model(ModelConfig.from_dict({"name_or_path": "", "arch": "ltx2",
                                             "model_kwargs": {"joint_audio": True, "audio_vae": "mel"}}),
                      device="meta")
    mc = model.audio_vae_config
    mel = tmel.log_mel(torch.zeros(1, int(49 / 24 * 48000), 2), mc.sample_rate, n_mels=mc.mel_bins)
    assert mel.shape == (1, 607, 64, 2) and mel.shape[1] // mc.time_downscale == 151


def test_unported_knobs_raise():
    """An audio backend and a size the JAX class reads as another (it takes
    any backend but ``mel`` as ``waveform`` and any size but ``tiny`` as
    ``full``) raise ``NotImplementedError`` naming Queue 1 item 6a, as a
    joint checkpoint's DiT (above) raises naming Queue 3."""
    for kw, match in (({"joint_audio": True, "audio_vae": "ogg"}, "audio_vae 'ogg'.*item 6a"),
                      ({"size": "2b"}, "size '2b'.*item 6a")):
        with pytest.raises(NotImplementedError, match=match):
            LTX2Model(ModelConfig.from_dict({"name_or_path": "", "arch": "ltx2", "model_kwargs": kw}), device="cpu")


@pytest.mark.parametrize("arch", ["ltx2", "ltx2_3", "ltx2.3", "ltxv", "minimax_h3"])
def test_every_arch_name_is_the_one_class(arch):
    from ai_toolkit_tpu_torch.models.registry import get_model_class

    assert get_model_class(arch) is LTX2Model


# ---- the shipped file ----

def test_shipped_file_runs_through_run_py(tmp_path, capsys):
    """``python -m ai_toolkit_tpu_torch.run`` on the shipped LTX-2 file at
    ``size: tiny`` (its resolution cut to 32, samples to 32 x 32 at 2 steps),
    two 49-frame clips, one with a 48 kHz sidecar: 2 steps with the audio
    loss, the qfloat8 base, adamw8bit and EMA; the disk cache; the first and
    final samples each a webp with a wav beside it; a LoRA with the JAX job's
    keys of the joint blocks."""
    import cv2
    from safetensors.numpy import load_file
    from scipy.io import wavfile

    data = tmp_path / "clips"
    data.mkdir()
    rng = np.random.default_rng(11)
    for i in range(2):
        wr = cv2.VideoWriter(str(data / f"v_{i}.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 24, (32, 32))
        for _ in range(49):
            wr.write(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
        wr.release()
        (data / f"v_{i}.txt").write_text(f"a clip of thing {i}")
    wavfile.write(str(data / "v_0.wav"), 48000, (rng.uniform(-1, 1, (98000, 2)) * 9000).astype(np.int16))
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_ltx2_av_tpu.yaml"))
    proc = raw["config"]["process"][0]
    proc["training_folder"] = str(tmp_path / "out")
    proc["datasets"][0].update(folder_path=str(data), resolution=[32])
    proc["train"].update(steps=2)
    proc["model"].update(name_or_path="", model_kwargs={**proc["model"]["model_kwargs"], "size": "tiny"})
    proc["sample"].update(width=32, height=32, sample_steps=2)
    proc["logging"] = {"log_every": 1}
    path = str(tmp_path / "job.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    assert run_main([path, "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert "step 2/2" in log and "nan" not in log and "quantized base" in log
    name = raw["config"]["name"]
    out_dir = tmp_path / "out" / name
    assert len(os.listdir(out_dir / "latent_cache")) == 2
    samples = sorted(os.listdir(out_dir / "samples"))
    assert samples == [f"{name}_{s:09d}_0.{e}" for s in (0, 2) for e in ("wav", "webp")]
    sr, wav = wavfile.read(str(out_dir / "samples" / samples[0]))
    assert sr == 48000 and wav.shape[1] == 2 and wav.dtype == np.int16
    keys = load_file(str(out_dir / f"{name}.safetensors"))
    assert len(keys) == 2 * 2 * 28 and "transformer.block_1.a2v_q.lora_A.weight" in keys
