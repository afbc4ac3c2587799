"""The port's SD 1.x / 2.x models against the JAX package on the CPU at the
tiny f32 size: ``sd1``, ``sd15`` and ``sd2`` (the UNet at global heads on the
plain attention path, CLIP's final states as the context, the DDPM epsilon or
v-prediction target through the train loss, a DDIM step, ``generate_sd``),
the full-size configurations (SD 1.5's 40 / 80 / 160-wide heads, SD 2.1's
64), and the full-size archs the JAX package cannot build, which raise in
the port; ``[jax_fault]`` pins the JAX widths that make them so. Weights come
from the JAX package's own init through ``io/from_jax``; inputs, noise and
timesteps are made with numpy and handed to both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.generation import generate_sd as jax_generate_sd
from ai_toolkit_tpu.io.sd_import import clip_rules, unet_rules, vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.models import unet as junet
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu.samplers.factory import get_schedule as jget_schedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.generation import generate_sd
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.models import unet as tunet
from ai_toolkit_tpu_torch.models.registry import get_model_class
from ai_toolkit_tpu_torch.models.sd_model import SDModel
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
from ai_toolkit_tpu_torch.samplers.factory import get_schedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from test_torch_flux_family import jit_decode
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ARCHS = ("sd1", "sd15", "sd2")


def _cfg(arch, size="tiny"):
    return {"name_or_path": "", "arch": arch, "model_kwargs": {"size": size}}


def port_init_as_jax(arch="sd1", seed=0):
    """The JAX tree (``unet``, ``vae``, ``clip``, SDXL's ``clip2``) of the
    port's seeded tiny init, through the JAX package's importer rules (as the
    flux-family tests build theirs): the same weights in both packages, with
    no JAX init to compile."""
    model = get_model_class(arch)(ModelConfig.from_dict(_cfg(arch)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(seed))
    ucfg, vcfg = model.unet_config, model.vae_config
    out = {}
    for key, rules in (("unet", unet_rules(len(ucfg.block_out_channels))),
                       ("vae", vae_rules(len(vcfg.channel_multipliers), vcfg.layers_per_block)),
                       ("clip", clip_rules()), ("clip2", clip_rules())):
        if key not in variables:
            continue
        out[key], unmatched = torch_to_tree({k: v.detach().numpy() for k, v in variables[key].state_dict().items()},
                                            rules)
        assert not unmatched, unmatched[:3]
    return out


@pytest.fixture(scope="module")
def jax_vars():
    # one seeded init serves the three archs: at the tiny size they share their widths
    return port_init_as_jax("sd1")


def _port(arch, jax_vars):
    model = SDModel(ModelConfig.from_dict(_cfg(arch)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, {"unet": from_jax.unet_state_dict(jax_vars["unet"]),
                                       "vae": from_jax.vae_state_dict(jax_vars["vae"]),
                                       "clip": from_jax.clip_state_dict(jax_vars["clip"])})
    return model, variables


def _inputs(b=2, hh=8, ww=8, seed=5):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, hh, ww, 4), dtype=np.float32),
            "noise": rng.standard_normal((b, hh, ww, 4), dtype=np.float32),
            "t": np.asarray([37, 811], np.int64)[:b]}


@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_sd_matches_jax(arch, jax_vars, monkeypatch):
    """The arch's tiny model against JAX ``SDModel``: the registry's class,
    the configs, the prompt's context (CLIP's final states; 1e-5), the UNet
    at global 2 heads (16 and 32 wide: the plain attention, no flash call)
    and one DDPM train loss with noise and integer timesteps injected through
    ``get_schedule('ddpm', arch)``'s target (sd2: v-prediction; 1e-5), and a
    DDIM step of that schedule (1e-5)."""
    jmodel = JSDModel(JModelConfig.from_dict(_cfg(arch)))
    model, variables = _port(arch, jax_vars)
    assert get_model_class(arch) is SDModel and model.unet_config.head_dim is None
    for ours, ref in ((model.unet_config, jmodel.unet_config), (model.clip_config, jmodel.clip_config),
                      (model.vae_config, jmodel.vae_config)):
        for f in dataclasses.fields(ours):
            if f.name not in ("dtype", "remat"):
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    prompts = ["a watercolor fox", "photo of a lighthouse at dusk"]
    ref_ctx = jmodel.encode_prompt(jax_vars, prompts)["context"]
    with torch.inference_mode():
        ctx = model.encode_prompt(variables, prompts)
    assert set(ctx) == {"context"}
    np.testing.assert_allclose(ctx["context"].numpy(), np.asarray(ref_ctx), atol=1e-5, rtol=1e-5)

    schedule, jschedule = get_schedule("ddpm", arch), jget_schedule("ddpm", arch)
    assert schedule.prediction_type == jschedule.prediction_type == (
        "v_prediction" if arch == "sd2" else "epsilon")
    inp = _inputs()
    x0, noise, t = jnp.asarray(inp["x"]), jnp.asarray(inp["noise"]), jnp.asarray(inp["t"], jnp.int32)
    cond = {"context": ref_ctx}

    def jloss(unet):
        pred = jmodel.predict({"unet": unet}, jschedule.add_noise(x0, noise, t), t, cond)
        return jcompute_loss(pred, jschedule.target(x0, noise, t))[0], pred

    ref_loss, ref_pred = jax.jit(jloss)(jax_vars["unet"])
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", lambda *a: calls.append(a) or real(*a))
    preds = []
    with torch.no_grad():
        loss, _ = train_loss(lambda noisy, tt, c: preds.append(model.predict(variables, noisy, tt, c)) or preds[-1],
                             schedule, TrainStepConfig(), {"latents": torch.from_numpy(inp["x"]), "cond": ctx},
                             torch.from_numpy(inp["noise"]), torch.from_numpy(inp["t"]))
    assert not calls
    np.testing.assert_allclose(preds[0].numpy(), np.asarray(ref_pred), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    step = schedule.ddim_step(torch.from_numpy(inp["x"][:1]), preds[0][:1], torch.tensor([811]), torch.tensor([771]))
    jstep = jschedule.ddim_step(x0[:1], ref_pred[:1], jnp.full((1,), 811, jnp.int32), jnp.full((1,), 771, jnp.int32))
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=1e-5, rtol=1e-5)


def test_generate_sd1_matches_jax(jax_vars):
    """``generate_sd`` on the SD 1.x model: DDIM 3 steps, guidance 7.5 as a
    batch of two over the one CLIP's context and no added condition, the JAX
    noise injected: uint8 images within 1 (f32 both sides)."""
    model, variables = _port("sd1", jax_vars)
    kw = dict(prompt="a watercolor fox", negative_prompt="blurry", width=64, height=64, seed=7,
              guidance_scale=7.5, sample_steps=3, sampler="ddpm")
    ref = np.asarray(jax_generate_sd(jit_decode(JSDModel(JModelConfig.from_dict(_cfg("sd1")))), jax_vars,
                                     JGenerateImageConfig(**kw)))
    h, w, c = model.latent_shape(64, 64)
    noise = np.asarray(jax.random.normal(jax.random.key(7), (1, h, w, c), jnp.float32))
    stats = {}
    ours = generate_sd(model, variables, GenerateImageConfig(**kw), noise=noise, stats=stats)
    assert ours.shape == ref.shape == (64, 64, 3) and len(stats["step_ms"]) == 3
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    assert len(np.unique(ours)) > 8


def test_full_size_configs_match_jax(monkeypatch):
    """SD 1.5 and SD 2.1 at full size: every field as in JAX; SD 1.5's global
    8 heads are 40, 80 and 160 wide, which take the plain attention (the
    flash kernels take 64 and 128), SD 2.1's are 64 wide. The full-size
    ``sd1`` model builds its configs without weights."""
    for ours, ref in ((tunet.UNetConfig.sd15(), junet.UNetConfig.sd15()),
                      (tunet.UNetConfig.sd21(), junet.UNetConfig.sd21())):
        for f in dataclasses.fields(ref):
            if f.name not in ("dtype", "param_dtype", "free_u"):
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    sd15 = tunet.UNetConfig.sd15()
    dims = [c // sd15.heads(c) for c in sd15.block_out_channels[:3]]
    assert dims == [40, 80, 160] and not set(dims) & set(fa.HEAD_DIMS)
    sd21 = tunet.UNetConfig.sd21()
    assert {c // sd21.heads(c) for c in sd21.block_out_channels} == {64}
    model = SDModel(ModelConfig.from_dict(_cfg("sd15", "full")), device="meta")
    assert model.unet_config == sd15 and model.clip_config.hidden_size == 768
    # a full-width SD 1.5 attention at 40-wide heads runs the plain path
    calls = []
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", lambda *a: calls.append(a))
    attn = tunet.Attention(320, 768, sd15.heads(320), torch.float32)
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.02, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = attn(torch.randn(1, 16, 320), torch.randn(1, 7, 768))
    assert out.shape == (1, 16, 320) and not calls


@pytest.mark.parametrize("arch", ["sd2", "ssd", "vega"])
@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_full_size_archs_jax_cannot_build(arch, side):
    """``port``: at full size ``sd2``, ``ssd`` and ``vega`` raise, naming the
    JAX fault. ``jax_fault``: the JAX package builds ``sd2`` with CLIP-L's
    768-wide states before a UNet whose cross-attention takes 1024 (a real SD
    2.x file carries the 1024-wide OpenCLIP-H), and ``ssd`` / ``vega``
    (SDXL distillations) as SD 1.5: the SD 1.5 UNet, CLIP-L, no added
    condition."""
    if side == "port":
        with pytest.raises(NotImplementedError, match="JAX package builds") as err:
            SDModel(ModelConfig.from_dict(_cfg(arch, "full")), device="meta")
        assert ("1024" in str(err.value)) == (arch == "sd2")
        return
    jmodel = JSDModel(JModelConfig.from_dict(_cfg(arch, "full")))
    if arch == "sd2":
        assert jmodel.unet_config.cross_attention_dim == 1024
        assert (jmodel.clip_config.hidden_size, jmodel.clip_config.num_layers) == (768, 12)
    else:
        assert jmodel.unet_config == junet.UNetConfig.sd15()
        assert jmodel.unet_config.addition_time_embed_dim is None and jmodel.clip_config.hidden_size == 768
