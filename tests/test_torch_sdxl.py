"""The port's SDXL slice against the JAX package on the CPU at tiny f32 sizes:
CLIP ``clip_skip``, the SD VAE with its quant convs, the DDPM schedule, the
UNet (head_dim 64, so its attention takes the flash kernel's plain version),
its diffusers names against ``io/sd_import.unet_rules``, its LoRA targets, one
DDPM train step with min-SNR weighting, ``generate_sd`` (DDIM, CFG as a batch
of two) and the train job's kohya save. Weights come from the JAX package's
own init and go through ``io/from_jax``; inputs and noise are made with numpy
and handed to both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.generation import generate_sd as jax_generate_sd
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.sd_import import unet_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.models import unet as junet
from ai_toolkit_tpu.models import vae as jvae
from ai_toolkit_tpu.models.sd_model import SDXLModel as JSDXLModel
from ai_toolkit_tpu.models.text_encoders import clip as jclip
from ai_toolkit_tpu.samplers.ddpm import DDPMSchedule as JDDPMSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.generation import generate_sd
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io import lora_file as tlora_file
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.models import unet as tunet
from ai_toolkit_tpu_torch.models import vae as tvae
from ai_toolkit_tpu_torch.models.sd_model import SDXLModel
from ai_toolkit_tpu_torch.models.text_encoders import clip as tclip
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from test_torch_flux_family import OPT0

torch.set_num_threads(1)
TINY = {"name_or_path": "", "arch": "sdxl", "model_kwargs": {"size": "tiny"}}
# the tiny SDXL UNet at head_dim 64 (1 head at 64 channels, 2 at 128), three
# levels: a plain resnet level, then two transformer levels (the mid block takes
# the last depth), as SDXL's (0, 2, 10) at (320, 640, 1280)
UNET64 = dict(block_out_channels=(64, 64, 128), transformer_layers=(0, 1, 2), head_dim=64)


def _jax_model():
    model = JSDXLModel(JModelConfig.from_dict(dict(TINY)))
    model.unet_config = dataclasses.replace(model.unet_config, **UNET64)
    model.unet = junet.UNet2DCondition(model.unet_config)
    return model


@pytest.fixture(scope="module")
def jax_vars():
    # jitted: one compile instead of one per initializer
    return jax.tree.map(np.asarray, jax.jit(_jax_model().init_variables, compiler_options=OPT0)(jax.random.key(0)))


def _port(jax_vars):
    model = SDXLModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    model.unet_config = dataclasses.replace(model.unet_config, **UNET64)
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.sdxl_model_state(jax_vars))
    return model, variables


# ---- components ----

def test_clip_skip_matches_jax():
    """clip_skip=1: the penultimate layer's states, un-normalized, while the
    pooled output still comes from the final-LN states; f32, 1e-5."""
    jcfg = jclip.CLIPTextConfig.tiny()
    ids = np.random.default_rng(0).integers(0, 999, (2, 12)).astype(np.int32)
    ids[:, 9] = jcfg.eos_token_id
    jmod = jclip.CLIPTextModel(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmod.init, compiler_options=OPT0)(jax.random.key(1), jnp.asarray(ids))["params"])
    mod = tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny())
    mod.load_state_dict(from_jax.clip_state_dict(params))
    apply = jax.jit(jmod.apply, static_argnums=2)
    for skip in (0, 1):
        ref = apply({"params": params}, jnp.asarray(ids), skip)
        with torch.inference_mode():
            out = mod(torch.from_numpy(ids).long(), clip_skip=skip)
        for key in ("last_hidden_state", "pooled_output"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["last_hidden_state"].numpy(), np.asarray(ref["penultimate_hidden_state"]),
                               atol=1e-5, rtol=1e-5)


def test_sd_vae_with_quant_convs_matches_jax():
    """The SD VAE's quant_conv after the encoder and post_quant_conv before the
    decoder; encode (mode) and decode in f32 within 1e-4; SDXL's scale."""
    assert tvae.VAEConfig.sdxl().scaling_factor == jvae.VAEConfig.sdxl().scaling_factor == 0.13025
    assert tvae.VAEConfig.sdxl().use_quant_conv and not tvae.VAEConfig.flux().use_quant_conv
    jcfg = jvae.VAEConfig.tiny(use_quant_conv=True)
    jmod = jvae.AutoencoderKL(jcfg)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmod.init, compiler_options=OPT0)(jax.random.key(2), jnp.asarray(img))["params"])
    assert "quant_conv" in params and "post_quant_conv" in params
    mod = tvae.AutoencoderKL(tvae.VAEConfig.tiny(use_quant_conv=True))
    mod.load_state_dict(from_jax.vae_state_dict(params))
    ref_lat = jax.jit(lambda p, x: jmod.apply(p, x, method=jvae.AutoencoderKL.encode))({"params": params}, img)
    ref_img = jax.jit(lambda p, z: jmod.apply(p, z, method=jvae.AutoencoderKL.decode))({"params": params}, ref_lat)
    with torch.inference_mode():
        lat = mod.encode(torch.from_numpy(img))
        out = mod.decode(torch.from_numpy(np.asarray(ref_lat)))
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref_lat), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_img), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_ddpm_schedule_matches_jax(beta_schedule, prediction_type):
    """The tables bit for bit (numpy on both sides); add_noise, target, snr,
    min_snr_weight (gamma 5), pred_to_x0 and one DDIM step in f32 within 1e-6
    relative; the DDIM timesteps exactly."""
    ours = DDPMSchedule(beta_schedule=beta_schedule, prediction_type=prediction_type)
    ref = JDDPMSchedule(beta_schedule=beta_schedule, prediction_type=prediction_type)
    np.testing.assert_array_equal(ours.betas, ref.betas)
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)
    np.testing.assert_array_equal(ours.ddim_timesteps(8), ref.ddim_timesteps(8))
    rng = np.random.default_rng(3)
    x0, noise, pred = (rng.standard_normal((3, 4, 4, 4), dtype=np.float32) for _ in range(3))
    t = np.asarray([1, 500, 998], np.int64)
    tt, jt = torch.from_numpy(t), jnp.asarray(t, jnp.int32)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), tt).numpy(),
                               np.asarray(ref.add_noise(jnp.asarray(x0), jnp.asarray(noise), jt)), **close)
    np.testing.assert_allclose(ours.target(torch.from_numpy(x0), torch.from_numpy(noise), tt).numpy(),
                               np.asarray(ref.target(jnp.asarray(x0), jnp.asarray(noise), jt)), **close)
    np.testing.assert_allclose(ours.snr(tt).numpy(), np.asarray(ref.snr(jt)), rtol=1e-6)
    np.testing.assert_allclose(ours.min_snr_weight(tt, 5.0).numpy(), np.asarray(ref.min_snr_weight(jt, 5.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(ours.pred_to_x0(torch.from_numpy(pred), torch.from_numpy(x0), tt).numpy(),
                               np.asarray(ref.pred_to_x0(jnp.asarray(pred), jnp.asarray(x0), jt)), rtol=1e-5,
                               atol=1e-5)
    for t_i, t_prev in ((876, 751), (1, -1)):
        step = ours.ddim_step(torch.from_numpy(x0[:1]), torch.from_numpy(pred[:1]), torch.tensor([t_i]),
                              torch.tensor([t_prev]))
        jstep = ref.ddim_step(jnp.asarray(x0[:1]), jnp.asarray(pred[:1]), jnp.full((1,), t_i, jnp.int32),
                              jnp.full((1,), t_prev, jnp.int32))
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=1e-5, atol=1e-5)


def test_ddpm_timesteps_and_unported_branches():
    """The balanced draw lies in [min_t + 1, max_t - 1), as JAX's randint;
    the other distributions and the k-diffusion steppers raise."""
    s = DDPMSchedule()
    t = s.sample_timesteps(torch.Generator().manual_seed(0), 4096)
    assert t.dtype == torch.int64 and int(t.min()) >= 1 and int(t.max()) <= 998
    t = s.sample_timesteps(torch.Generator().manual_seed(0), 512, min_t=100, max_t=300)
    assert int(t.min()) >= 101 and int(t.max()) <= 298
    with pytest.raises(NotImplementedError):
        s.sample_timesteps(torch.Generator(), 2, timestep_type="two_step")
    with pytest.raises(NotImplementedError):
        s.sample_timesteps(torch.Generator(), 2, content_or_style="style")
    with pytest.raises(NotImplementedError):
        s.euler_ancestral_step


# ---- the UNet ----

def _inputs(model, b=2, hh=8, ww=8, seed=11):
    rng = np.random.default_rng(seed)
    cfg = model.unet_config
    return {
        "x": rng.standard_normal((b, hh, ww, cfg.in_channels), dtype=np.float32),
        "noise": rng.standard_normal((b, hh, ww, cfg.in_channels), dtype=np.float32),
        "t": np.asarray([37, 811], np.int64)[:b],
        "context": rng.standard_normal((b, 13, cfg.cross_attention_dim), dtype=np.float32),
        "pooled": rng.standard_normal((b, 64), dtype=np.float32),
    }


def _jcond(jmodel, inp, hw=(64, 64)):
    return {"context": jnp.asarray(inp["context"]),
            "added_cond": jmodel.added_cond(jnp.asarray(inp["pooled"]), *hw)}


def _tcond(model, inp, hw=(64, 64)):
    return {"context": torch.from_numpy(inp["context"]),
            "added_cond": model.added_cond(torch.from_numpy(inp["pooled"]), *hw)}


def test_unet_forward_matches_jax(jax_vars, monkeypatch):
    """The UNet with time_ids and text_embeds (added_cond) through
    from_jax.unet_state_dict; f32 through three levels: summation order only
    (1e-4). Every attention of the UNet is at head_dim 64, so the plain
    version of the flash kernel runs twice in each of the 11 transformer
    blocks (down 1 + 2, mid 2, up 2 x 2 + 2 x 1: one layer per block, two on
    the way up)."""
    jmodel = _jax_model()
    model, variables = _port(jax_vars)
    inp = _inputs(model)
    ref = jax.jit(jmodel.predict)({"unet": jax_vars["unet"]}, jnp.asarray(inp["x"]),
                                  jnp.asarray(inp["t"], jnp.int32), _jcond(jmodel, inp))
    calls = []
    real = fa.flash_attention_fwd_plain

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention_fwd_plain", counted)
    with torch.inference_mode():
        out = model.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                            _tcond(model, inp))
    assert out.shape == inp["x"].shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert len(calls) == 2 * 11 and all(s[-1] == 64 for s in calls)


def test_unet_names_are_the_importer_keys(jax_vars):
    """JAX ``unet_rules`` applied to the port's state dict (its diffusers
    names) rebuilds the JAX UNet tree: every key matched, the same paths,
    the same values."""
    _, variables = _port(jax_vars)
    flat = {k: v.numpy() for k, v in variables["unet"].state_dict().items()}
    tree, unmatched = torch_to_tree(flat, unet_rules(len(UNET64["block_out_channels"])))
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(jax_vars["unet"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k], np.float32), np.asarray(ref[k], np.float32), err_msg=k)


def test_sdxl_configs_match_jax():
    """The full-size configurations: widths, depths, heads per level (10 x 64
    at 640, 20 x 64 at 1280) and the added-condition widths (the port has no
    FreeU field: the train job refuses ``train.free_u``)."""
    ours, ref = tunet.UNetConfig.sdxl(), junet.UNetConfig.sdxl()
    for f in dataclasses.fields(ref):
        if f.name not in ("dtype", "param_dtype", "free_u"):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ours.heads(640), ours.heads(1280)) == (10, 20)


def _lora_pair(jax_vars, model, variables, rank=4, seed=3):
    """The same LoRA on both sides: the port's factors (b non-zero, else a's
    gradient is zero) copied into JAX ``build_lora``'s tree; returns (port LoRA,
    JAX tree, {port name: JAX path})."""
    jmodel = _jax_model()
    lora = tlora.build_lora(variables["unet"], tlora.LoRASpec(rank=rank, alpha=8.0,
                                                              target_patterns=model.lora_targets()),
                            torch.Generator().manual_seed(seed))
    gb = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    jtree = jlora.build_lora(jax_vars["unet"], jlora.LoRASpec(rank=rank, alpha=8.0,
                                                              target_patterns=jmodel.lora_targets()),
                             jax.random.key(0))
    n = len(UNET64["block_out_channels"])
    paths = {from_jax._unet_module("/".join(p), n): "/".join(p) for p in jlora.lora_paths(jtree)}
    assert sorted(paths) == sorted(lora)

    def fill(node, prefix=""):
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else k
            if "a" in v:
                name = from_jax._unet_module(p, n)
                node[k] = {leaf: jnp.asarray(getattr(lora[name], leaf).detach().numpy())
                           for leaf in ("a", "b", "scale")}
            else:
                fill(v, p)

    jtree = jax.tree.map(lambda x: x, jtree)
    fill(jtree)
    return lora, jtree, paths


def test_lora_targets_and_count_match_jax(jax_vars):
    """The same modules and parameter count as JAX ``build_lora`` at the tiny
    size; at full size 722 modules (the 70 blocks' 8 attention and 2
    feed-forward projections, the 11 spatial transformers' proj_in / proj_out),
    built on the meta device."""
    model, variables = _port(jax_vars)
    lora, jtree, _ = _lora_pair(jax_vars, model, variables)
    assert len(lora) == 11 * 10 + 7 * 2  # 11 transformer blocks, 7 spatial transformers
    assert tlora.count_lora_params(lora) == jlora.count_lora_params(jtree)
    converted = from_jax.unet_lora_tree(jax.tree.map(np.asarray, jtree), num_levels=3)
    assert sorted(converted) == sorted(lora)
    for name, leaf in converted.items():
        for k in ("a", "b", "scale"):
            np.testing.assert_array_equal(leaf[k].numpy(), getattr(lora[name], k).detach().numpy())
    full = tunet.UNet2DCondition(tunet.UNetConfig.sdxl(), device="meta")
    big = tlora.build_lora(full, tlora.LoRASpec(rank=16, alpha=16.0, target_patterns=model.lora_targets(),
                                                init_std=0.0), torch.Generator())
    assert len(big) == 722


def test_train_step_loss_and_lora_grads_match_jax(jax_vars):
    """One DDPM step's loss (epsilon target, min_snr_gamma 5 weighting each
    sample) and every LoRA a/b/scale gradient against jax.value_and_grad of
    the JAX predict with the lora collection, noise and integer timesteps
    injected; f32 through the UNet: 1e-5 of the largest gradient."""
    jmodel = _jax_model()
    model, variables = _port(jax_vars)
    lora, jtree, paths = _lora_pair(jax_vars, model, variables)
    inp = _inputs(model)
    x0, noise = jnp.asarray(inp["x"]), jnp.asarray(inp["noise"])
    t = jnp.asarray(inp["t"], jnp.int32)
    sched, jcond = JDDPMSchedule(), _jcond(jmodel, inp)

    def jloss(lora_tree):
        pred = jmodel.predict({"unet": jax_vars["unet"], "lora": lora_tree}, sched.add_noise(x0, noise, t), t,
                              jcond)
        return jcompute_loss(pred, sched.target(x0, noise, t), timestep_weights=sched.min_snr_weight(t, 5.0))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jtree)
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": _tcond(model, inp)}
    loss, _ = train_loss(lambda noisy, tt, cond: model.predict(variables, noisy, tt, cond), DDPMSchedule(),
                         TrainStepConfig(min_snr_gamma=5.0), batch, torch.from_numpy(inp["noise"]),
                         torch.from_numpy(inp["t"]))
    names = [(name, leaf) for name in lora for leaf in ("a", "b", "scale")]
    grads = torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for (name, leaf), g in zip(names, grads):
        node = ref_grads
        for part in paths[name].split("/"):
            node = node[part]
        ref = np.asarray(node[leaf])
        assert np.abs(ref).max() > 0, f"{name}.{leaf}: zero reference gradient"
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=f"{name}.{leaf}")


def test_generate_sd_matches_jax(jax_vars):
    """DDIM, 3 steps, guidance 7 as a batch of two (negative prompt, prompt),
    with a LoRA on the UNet, the JAX noise injected: uint8 images within 1
    (f32 both sides; rounding to uint8 can flip on summation order)."""
    model, variables = _port(jax_vars)
    lora, jtree, _ = _lora_pair(jax_vars, model, variables)
    tlora.detach_lora(variables["unet"])
    tree = {name: {leaf: getattr(m, leaf).detach().clone() for leaf in ("a", "b", "scale")}
            for name, m in lora.items()}
    kw = dict(prompt="a watercolor fox", negative_prompt="blurry", width=64, height=64, seed=7,
              guidance_scale=7.0, sample_steps=3, sampler="ddim")
    ref = np.asarray(jax_generate_sd(_jax_model(), jax_vars, JGenerateImageConfig(**kw), lora=jtree))
    h, w, c = model.latent_shape(64, 64)
    noise = np.asarray(jax.random.normal(jax.random.key(7), (1, h, w, c), jnp.float32))
    stats = {}
    ours = generate_sd(model, variables, GenerateImageConfig(**kw), lora=tree, noise=noise, stats=stats)
    assert ours.shape == ref.shape == (64, 64, 3) and len(stats["step_ms"]) == 3
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    assert len(np.unique(ours)) > 8
    assert all(m.lora is None for m in variables["unet"].modules() if isinstance(m, tlora.Linear))
    with pytest.raises(NotImplementedError):
        generate_sd(model, variables, GenerateImageConfig(**{**kw, "sampler": "euler_a"}), noise=noise)


def test_min_snr_gamma_weights_ddpm_only():
    """TrainStepConfig reads min_snr_gamma; a DDPM schedule weights each
    sample's loss by min(snr, gamma) / snr, a flow schedule ignores it (as in
    JAX); f32, 1e-6."""
    from ai_toolkit_tpu_torch.config.modules import TrainConfig
    from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule

    assert TrainStepConfig.from_train_config(TrainConfig(min_snr_gamma=5.0)).min_snr_gamma == 5.0
    rng = np.random.default_rng(5)
    x0, noise = (torch.from_numpy(rng.standard_normal((3, 4, 4, 4), dtype=np.float32)) for _ in range(2))
    batch = {"latents": x0}

    def predict(noisy, t, cond):
        return 0.5 * noisy

    t = torch.tensor([3, 400, 990])
    plain = TrainStepConfig()
    snr = TrainStepConfig(min_snr_gamma=5.0)
    ddpm = DDPMSchedule()
    per_ex = ((predict(ddpm.add_noise(x0, noise, t), t, None) - noise) ** 2).mean(dim=(1, 2, 3))
    weighted, _ = train_loss(predict, ddpm, snr, batch, noise, t)
    np.testing.assert_allclose(float(weighted), float((per_ex * ddpm.min_snr_weight(t, 5.0)).mean()), rtol=1e-6)
    assert abs(float(weighted) - float(train_loss(predict, ddpm, plain, batch, noise, t)[0])) > 1e-3
    tf = torch.tensor([0.1, 0.5, 0.9])
    flow = FlowMatchSchedule()
    assert float(train_loss(predict, flow, snr, batch, noise, tf)[0]) == float(
        train_loss(predict, flow, plain, batch, noise, tf)[0])


# ---- the jobs ----

def _dataset(folder, n=2, size=64):
    from PIL import Image

    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(folder / f"im_{i}.png")
        (folder / f"im_{i}.txt").write_text(f"photo of thing {i}")
    return str(folder)


def test_kohya_file_matches_jax_flatten_lora(jax_vars, tmp_path):
    """The kohya layout: the same keys and values as JAX ``flatten_lora(...,
    fmt='kohya', prefix='lora_unet')`` over the UNet key map (fp16 bits), and
    the file loads back through the model's module names."""
    model, variables = _port(jax_vars)
    lora, jtree, _ = _lora_pair(jax_vars, model, variables)
    tree = {name: {leaf: getattr(m, leaf).detach() for leaf in ("a", "b", "scale")} for name, m in lora.items()}
    ref = jlora_file.flatten_lora(jtree, key_map=junet.unet_lora_key_map(jtree, num_levels=3), fmt="kohya",
                                  prefix="lora_unet")
    ours = tlora_file.flatten_lora(tree, fmt="kohya")
    assert sorted(ours) == sorted(ref) and any(k.endswith(".alpha") for k in ours)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.float16
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    path = str(tmp_path / "lora.safetensors")
    tlora_file.save_lora_file(tree, path, fmt="kohya")
    names = [n for n, _ in variables["unet"].named_modules()]
    back, _ = tlora_file.load_lora_file(path, module_names=names)
    assert sorted(back) == sorted(tree)
    for name, leaf in back.items():
        np.testing.assert_allclose(leaf["a"].numpy(), tree[name]["a"].numpy(), atol=1e-3)
        assert float(leaf["scale"]) == pytest.approx(float(tree[name]["scale"]))
    with pytest.raises(ValueError):
        tlora_file.load_lora_file(path)  # kohya keys need the module names


def test_train_job_saves_kohya_and_generate_loads_it(tmp_path):
    """The tiny SDXL LoRA job (ddpm, min_snr_gamma, adamw8bit, EMA, remat_policy
    none) on the CPU: finite losses, a kohya file whose keys are the JAX
    layout's for the job's modules and whose factors are the EMA copy in
    fp16; then the generate job (DDIM, CFG) with that file."""
    from PIL import Image
    from safetensors import safe_open

    model = {**TINY, "remat_policy": "none"}
    raw = {"job": "extension", "config": {"name": "sdxl_tiny", "process": [{
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"),
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "save": {"dtype": "float16", "save_every": 250},
        "datasets": [{"folder_path": _dataset(tmp_path / "data"), "caption_ext": "txt",
                      "cache_latents_to_disk": False, "resolution": [64]}],
        "train": {"batch_size": 1, "steps": 2, "noise_scheduler": "ddpm", "min_snr_gamma": 5.0,
                  "optimizer": "adamw8bit", "lr": 1e-4, "ema_config": {"use_ema": True, "ema_decay": 0.99},
                  "dtype": "float32", "seed": 42},
        "model": model}]}}
    from ai_toolkit_tpu_torch.jobs import get_job

    job = get_job(raw, device="cpu")
    (result,) = job.run()
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    ema = job.processes[0].state.ema
    with safe_open(result["save_path"], framework="numpy") as f:
        flat = {k: f.get_tensor(k) for k in f.keys()}
    names = sorted(job.processes[0].lora)
    assert len(names) == result["lora_modules"] == 48
    assert sorted(flat) == sorted(f"lora_unet_{n.replace('.', '_')}.{s}" for n in names
                                  for s in ("alpha", "lora_down.weight", "lora_up.weight"))
    for n in names:
        key = f"lora_unet_{n.replace('.', '_')}"
        np.testing.assert_array_equal(flat[key + ".lora_up.weight"],
                                      ema[f"{n}.b"].detach().numpy().T.astype(np.float16))
        assert float(flat[key + ".alpha"]) == pytest.approx(4.0 * float(ema[f"{n}.scale"]), rel=1e-3)

    gen = {"job": "generate", "config": {"name": "sdxl_gen", "process": [{
        "type": "generate", "training_folder": str(tmp_path), "model": model,
        "lora_path": result["save_path"],
        "sample": {"sampler": "ddim", "width": 64, "height": 64, "guidance_scale": 7.0, "sample_steps": 2,
                   "seed": 42, "prompts": ["a watercolor fox", "a dew drop"]}}]}}
    (out,) = run_job(gen, device="cpu")
    assert len(out["images"]) == 2 and all(r["latents_finite"] for r in out["timings"])
    for path in out["images"]:
        assert np.asarray(Image.open(path)).shape == (64, 64, 3)


def test_schedule_must_fit_the_model(tmp_path):
    """A DDPM scheduler for a flow-matching DiT, and flow matching for SDXL,
    raise before any model is built."""
    from ai_toolkit_tpu_torch.jobs import get_job

    for arch, scheduler in (("flux", "ddpm"), ("sdxl", "flowmatch")):
        raw = {"job": "extension", "config": {"name": "x", "process": [{
            "type": "sd_trainer", "training_folder": str(tmp_path), "network": {"type": "lora"},
            "datasets": [{"folder_path": str(tmp_path), "cache_latents_to_disk": False}],
            "train": {"noise_scheduler": scheduler},
            "model": {"name_or_path": "", "arch": arch, "model_kwargs": {"size": "tiny"}}}]}}
        with pytest.raises(NotImplementedError, match="noise_scheduler"):
            get_job(raw, device="cpu").run()


def test_unported_sdxl_branches_raise(tmp_path):
    for model in ({**TINY, "arch": "sd1"}, {**TINY, "arch": "sdxl_refiner"},
                  {**TINY, "refiner_name_or_path": "/nowhere/refiner"}, {**TINY, "model_kwargs": {"size": "xl"}}):
        with pytest.raises(NotImplementedError):
            SDXLModel(ModelConfig.from_dict(model), device="cpu")
    unet = tunet.UNet2DCondition(tunet.UNetConfig.tiny())
    with pytest.raises(NotImplementedError):
        unet(torch.zeros((1, 8, 8, 4)), torch.tensor([5]), torch.zeros((1, 3, 64)), ip_context=torch.zeros((1, 4, 64)))
    with pytest.raises(NotImplementedError):
        tlora.build_lora(tunet.UNet2DCondition(tunet.UNetConfig.tiny()), tlora.LoRASpec(conv_rank=4),
                         torch.Generator())
