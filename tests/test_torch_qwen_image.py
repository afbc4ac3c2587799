"""Qwen-Image on the port against the JAX package on the CPU at tiny f32 sizes:
Qwen2.5's decoder layer with its q/k/v biases under the eos mask, the 7B
config, ``encode_prompt``, ``predict`` for ``qwen_image`` and
``qwen_image_edit`` (a padded text mask, the control segment on frame index
1), the loader on a tiny diffusers directory (the three JAX faults it shows
pinned as ``[jax_fault]`` / ``[port]`` pairs: the text encoder never read,
``txt_norm`` dropped, ``vector_in`` on its init; the Wan VAE read by the
port), one LoRA train step's loss and gradients through JAX
``train/step.make_train_step``, the comfy LoRA file's keys against the JAX
job's (and the JAX fault in their names), ``generate_flux`` with and
without a ``ctrl_img`` against JAX's with its noise, the two shipped files
as tiny jobs and the refusals.

Weights come from the JAX init (1-D leaves moved off their init values) and
reach the port through ``io/from_jax.py``; inputs are made with numpy.
Tolerance: f32 on both sides, ``rtol`` 1e-5 and an ``atol`` of 1e-4 of the
largest reference value (of a gradient: over every trained tensor), the
``time_in`` archs' tolerance (``tests/test_torch_sd3.py``); the generated
images within one uint8 step."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.torch import save_file
from test_torch_sd3 import _close, _jax_job_keys, _perturbed, lora_step_matches_jax

from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.generation import generate_flux as jgenerate_flux
from ai_toolkit_tpu.io.qwen_import import load_qwen_checkpoint
from ai_toolkit_tpu.models.qwen_model import QwenImageModel as JQwenImageModel
from ai_toolkit_tpu.models.text_encoders import llm as jllm
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.generation import generate_flux
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.sd3_layout import qwen_layout, reference_state
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.models.flux_dit import FluxDiT
from ai_toolkit_tpu_torch.models.qwen_model import QwenImageModel
from ai_toolkit_tpu_torch.models.text_encoders import llm as tllm
from ai_toolkit_tpu_torch.models.wan_vae import WanVAE, WanVAEConfig
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from test_torch_lumina2 import filled
from test_torch_flux_family import fast_jit, jit_decode
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen_image", "qwen_image_edit")
SHIPPED = {"qwen_image": "train_lora_qwen_image_tpu", "qwen_image_edit": "train_lora_qwen_image_edit_tpu"}


def _cfg(arch, path=""):
    return {"name_or_path": path, "arch": arch, "model_kwargs": {"size": "tiny"}}


def _models(arch, path=""):
    return (JQwenImageModel(JModelConfig.from_dict(_cfg(arch, path))),
            QwenImageModel(ModelConfig.from_dict(_cfg(arch, path)), device="cpu"))


@pytest.fixture(scope="module")
def jvars():
    """The JAX variables of the tiny model (the same for both archs), 1-D
    leaves of the DiT and the text tower moved off their init."""
    jm, _ = _models("qwen_image")
    v = filled(jax.eval_shape(jm.init_variables, jax.random.key(1)), 1)  # traced, not compiled
    v["dit"], v["te"] = _perturbed(v["dit"], 1), _perturbed(v["te"], 2)
    return v


def _port_variables(tm, jv):
    variables = tm.init_variables(torch.Generator().manual_seed(0))
    tm.load_state_dicts(variables, from_jax.qwen_model_state(jv))
    return variables


PROMPTS = ["a photo of a red fox in the snow", "macro"]  # the second pads 14 of 16 tokens


def _conds(jm, tm, jv, variables, b=2, hh=8, ww=8, seed=3):
    rng = np.random.default_rng(seed)
    c = tm.dit_config.in_channels // 4
    inp = {"x": rng.standard_normal((b, hh, ww, c), dtype=np.float32), "t": np.asarray([0.3, 0.85], np.float32)}
    jc = dict(jm.encode_prompt(jv, PROMPTS))
    with torch.inference_mode():
        tc = tm.encode_prompt(variables, PROMPTS)
    jc["pe"], tc["pe"] = jm.rope_table(hh, ww, 16), tm.rope_table(hh, ww, 16)
    if tm.is_edit:
        ctrl = rng.standard_normal((b, hh, ww, c), dtype=np.float32)
        jc["control_latents"], tc["control_latents"] = jnp.asarray(ctrl), torch.from_numpy(ctrl)
    return inp, jc, tc


def test_qwen25_config_matches_jax():
    ours, ref = tllm.LLMConfig.qwen25_7b(), jllm.LLMConfig.qwen25_7b()
    assert {f.name: getattr(ours, f.name) for f in dataclasses.fields(ours) if f.name != "dtype"} == \
           {f.name: getattr(ref, f.name) for f in dataclasses.fields(ours) if f.name != "dtype"}
    assert ours.qkv_bias and (ours.n_heads, ours.n_kv_heads, ours.d_ff) == (28, 4, 18944)


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_dit_config_matches_jax(size):
    """Every field the two DiT configs share is equal (60 joint blocks of
    24 x 128 heads, no single blocks, no guidance embed), and the port
    checkpoints every block with the ``full`` policy, JAX's ``remat_policy``
    for this DiT: only the block inputs are kept."""
    cfg = {"name_or_path": "", "arch": "qwen_image", "model_kwargs": {"size": size}}
    ours = QwenImageModel(ModelConfig.from_dict(cfg), device="meta").dit_config
    ref = JQwenImageModel(JModelConfig.from_dict(cfg)).dit_config
    shared = [f.name for f in dataclasses.fields(ours) if f.name not in ("dtype", "checkpoint_policy")]
    assert {f: getattr(ours, f) for f in shared} == {f: getattr(ref, f) for f in shared}
    assert ours.checkpoint_policy == ref.remat_policy == "full"
    if size == "full":
        assert (ours.depth_double, ours.depth_single, ours.num_heads, ours.head_dim) == (60, 0, 24, 128)


@pytest.mark.parametrize("masked", [False, True])
def test_qwen25_layers_with_biases_match_jax(masked):
    """``LLMEncoder`` with Qwen2's q/k/v biases (``LLMConfig.tiny(qkv_bias=True)``:
    JAX's tiny config has none) against JAX's, with and without the eos mask
    of ``encode_prompt`` (the padded rows keep the valid keys)."""
    cfg = dict(qkv_bias=True, rms_eps=1e-6, rope_theta=1_000_000.0)
    ids = np.random.default_rng(5).integers(3, 1000, (2, 12)).astype(np.int32)
    ids[1, 4:] = 2  # eos then padding
    is_eos = ids == 2
    mask = (np.cumsum(is_eos, axis=1) - is_eos <= 0).astype(np.int32)
    jmod = jllm.LLMEncoder(jllm.LLMConfig.tiny(**cfg))
    params = _perturbed(seeded_init(jmod.init, jax.random.key(3), jnp.asarray(ids))["params"], 4)
    assert np.abs(params["layer_0"]["q"]["bias"]).max() > 0
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    mod = tllm.LLMEncoder(tllm.LLMConfig.tiny(**cfg))
    mod.load_state_dict(from_jax.llm_state_dict(params))
    assert mod.layers[0].self_attn.q_proj.bias is not None and mod.layers[0].self_attn.o_proj.bias is None
    with torch.inference_mode():
        out = mod(torch.from_numpy(ids).long(), torch.from_numpy(mask) if masked else None)
    _close(out.numpy(), ref)


def test_encode_prompt_matches_jax(jvars):
    """The text tower's states over 16 tokens, the eos mask (every token up to
    the first eos) and the zero pooled vector."""
    jm, tm = _models("qwen_image")
    variables = _port_variables(tm, jvars)
    ref = jm.encode_prompt(jvars, PROMPTS)
    with torch.inference_mode():
        out = tm.encode_prompt(variables, PROMPTS)
    np.testing.assert_array_equal(out["txt_mask"].numpy(), np.asarray(ref["txt_mask"]))
    assert out["txt_mask"][1].sum() == 2 and not out["y"].any() and out["y"].shape == (2, 64)
    _close(out["txt"].numpy(), ref["txt"])


@pytest.mark.parametrize("arch", ARCHS)
def test_predict_matches_jax(jvars, arch):
    """``predict`` under the padded text mask; the edit arch with the control
    latents joined along the sequence (the rope table's second frame) and
    the output cut back to the image tokens."""
    jm, tm = _models(arch)
    variables = _port_variables(tm, jvars)
    inp, jc, tc = _conds(jm, tm, jvars, variables)
    assert tc["pe"].shape[1] == 16 + 16 * (2 if tm.is_edit else 1)
    ref = jax.jit(jm.predict)(jvars, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jc)
    with torch.inference_mode():
        out = tm.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), tc)
    assert out.shape == inp["x"].shape
    _close(out.numpy(), ref, arch)
    with pytest.raises(ValueError, match="control latents"):
        bad = dict(tc)
        if tm.is_edit:
            bad.pop("control_latents")
        else:
            bad["control_latents"] = torch.zeros(inp["x"].shape)
        tm.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), bad)


def test_lora_step_matches_jax(jvars, monkeypatch):
    """qwen_image_edit, ``timestep_type: flux_shift`` (the shipped files'):
    the loss and every LoRA gradient under the padded mask and the control
    segment, against the JAX step with the port's draws; the last block's
    text-stream projections get zero gradients on both sides."""
    jm, tm = _models("qwen_image_edit")
    variables = _port_variables(tm, jvars)
    inp, jc, tc = _conds(jm, tm, jvars, variables)
    _, zero = lora_step_matches_jax(jm, tm, jvars, variables, inp, jc, tc, "flux_shift", monkeypatch)
    # the last block's text stream reaches no output (the DiT returns the image tokens)
    assert zero == ["double_blocks.1.txt_attn.proj", "double_blocks.1.txt_mlp.0", "double_blocks.1.txt_mlp.2"]


def _write_dir(root, tm, state, te_state):
    """A tiny diffusers Qwen-Image directory: ``transformer/`` in the
    diffusers names with a ``txt_norm``, and ``text_encoder/``."""
    for sub in ("transformer", "text_encoder"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    flat = reference_state(state, qwen_layout(tm.dit_config))
    flat["txt_norm.weight"] = torch.full((tm.dit_config.context_dim,), 0.5)
    save_file({k: v.contiguous() for k, v in flat.items()}, os.path.join(root, "transformer", "model.safetensors"))
    save_file({k: v.contiguous() for k, v in te_state.items()}, os.path.join(root, "text_encoder", "model.safetensors"))


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_loader_on_a_tiny_diffusers_dir(side, jvars, tmp_path, capsys):
    """The transformer's fused q/k/v, ``norm_out``'s swapped halves and the
    qk norms read bit for bit by both loaders. ``jax_fault``: JAX leaves the
    text encoder and ``vector_in`` on its init and drops ``txt_norm``
    (ROADMAP Queue 3). ``port``: the port mirrors all three, naming each."""
    jm, tm = _models("qwen_image", str(tmp_path))
    src = _port_variables(tm, jvars)
    state = {k: v + 0.25 for k, v in src["dit"].state_dict().items()}  # off the JAX init
    te_state = {k: v + 0.25 for k, v in src["te"].state_dict().items()}
    _write_dir(str(tmp_path), tm, state, te_state)
    if side == "port":
        loaded = tm.load_variables(torch.Generator().manual_seed(0))
        out = capsys.readouterr().out
        seeded = tm.init_variables(torch.Generator().manual_seed(0))
        for k, v in loaded["dit"].state_dict().items():
            want = seeded["dit"].state_dict()[k] if k.startswith("vector_in.") else state[k]
            assert torch.equal(v, want), k
        for k, v in loaded["te"].state_dict().items():
            assert torch.equal(v, seeded["te"].state_dict()[k]), k
        assert "vector_in has no source" in out and "['txt_norm.weight']" in out
        assert "text_encoder is not read" in out
        return
    jm.init_variables = lambda rng: jax.tree.map(np.copy, jvars)
    jv = load_qwen_checkpoint(str(tmp_path), jm)
    assert "1 unmatched keys (e.g. ['txt_norm.weight'])" in capsys.readouterr().out
    got = from_jax.flux_dit_state_dict(jax.tree.map(np.asarray, jv["dit"]))
    init = from_jax.flux_dit_state_dict(jvars["dit"])
    for k, v in got.items():
        assert torch.equal(v, init[k] if k.startswith("vector_in.") else state[k]), k
    for a, b in zip(jax.tree.leaves(jv["te"]), jax.tree.leaves(jvars["te"])):
        np.testing.assert_array_equal(a, b)


def test_loader_reads_the_wan_vae(tmp_path, capsys):
    """The Wan VAE (``vae/`` and its ``config.json``, here at the tiny Wan
    widths) through the port's Wan loader: every tensor as written."""
    _, tm = _models("qwen_image", str(tmp_path))
    tm.vae_config = WanVAEConfig.tiny()
    c = tm.vae_config
    src = init_parameters(WanVAE(c), torch.Generator().manual_seed(6))
    dit = init_parameters(FluxDiT(tm.dit_config), torch.Generator().manual_seed(7))
    _write_dir(str(tmp_path), tm, dit.state_dict(), {})
    os.makedirs(tmp_path / "vae", exist_ok=True)
    with open(tmp_path / "vae" / "config.json", "w") as f:
        json.dump({"base_dim": c.base_dim, "z_dim": c.z_dim, "dim_mult": list(c.dim_mult),
                   "num_res_blocks": c.num_res_blocks, "attn_scales": list(c.attn_scales),
                   "temperal_downsample": list(c.temperal_downsample), "latents_mean": list(c.latents_mean),
                   "latents_std": list(c.latents_std)}, f)
    save_file({k: v.contiguous() for k, v in src.state_dict().items()}, str(tmp_path / "vae" / "model.safetensors"))
    loaded = tm.load_variables(torch.Generator().manual_seed(0))
    assert isinstance(loaded["vae"], WanVAE) and "loaded qwen_image vae" in capsys.readouterr().out
    for k, v in src.state_dict().items():
        assert torch.equal(loaded["vae"].state_dict()[k], v), k
    assert tm.latent_shape(64, 32) == (64 // c.spatial_downscale, 32 // c.spatial_downscale, c.z_dim)


def test_wan_vae_on_one_frame_matches_jax():
    """Qwen-Image's VAE is Wan 2.1's at T = 1: a narrow Wan 2.1 VAE (both
    temporal downsamples, where a stride-2 conv over one frame yields none)
    encodes two images and decodes their latents as JAX ``WanVAE`` does,
    within 1e-4 of max|ref|, through ``QwenImageModel``'s image functions."""
    from ai_toolkit_tpu.models import wan_vae as jwan_vae

    jcfg = dataclasses.replace(jwan_vae.WanVAEConfig(), dtype=jnp.float32, base_dim=8)
    jmod = jwan_vae.WanVAE(jcfg)
    params = jax.tree.map(np.asarray, fast_jit(jmod.init, jax.random.key(2), jnp.zeros((1, 1, 16, 16, 3)))["params"])
    _, tm = _models("qwen_image")
    tm.vae_config = dataclasses.replace(WanVAEConfig.wan21(), dtype=torch.float32, base_dim=8)
    vae = WanVAE(tm.vae_config)
    vae.load_state_dict(from_jax.wan_vae_state_dict(params))
    imgs = np.random.default_rng(8).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)

    def run(p, x):  # one program: the latents and their decode
        lat = jmod.apply(p, x, method=jwan_vae.WanVAE.encode)
        return lat, jmod.apply(p, lat, method=jwan_vae.WanVAE.decode)

    ref_lat, ref_img = (np.asarray(r)[:, 0] for r in fast_jit(run, {"params": params}, imgs[:, None]))
    with torch.inference_mode():
        lat = tm.encode_images({"vae": vae}, torch.from_numpy(imgs)).numpy()
        img = tm.decode_latents({"vae": vae}, torch.from_numpy(ref_lat)).numpy()
    assert lat.shape == (2, 2, 2, 16) and img.shape == imgs.shape
    for got, ref in ((lat, ref_lat), (img, ref_img)):
        _close(got, ref)


def _data(root, controls):
    imgs, ctrl = os.path.join(root, "imgs"), os.path.join(root, "control")
    for d in (imgs, ctrl):
        os.makedirs(d, exist_ok=True)
    for i, (w, h) in enumerate(((96, 64), (64, 96), (96, 96))):
        rng = np.random.default_rng(i)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(os.path.join(imgs, f"im_{i}.png"))
        with open(os.path.join(imgs, f"im_{i}.txt"), "w") as f:
            f.write(f"photo of thing {i}")
        if controls:
            Image.fromarray(rng.integers(0, 255, (h + 8, w + 16, 3), dtype=np.uint8)).save(
                os.path.join(ctrl, f"im_{i}.png"))
    return imgs, ctrl


def _shipped(arch, root, steps=2):
    """The shipped file for ``arch`` as written but for its paths, its steps
    and, for the CPU, ``size: tiny`` with its resolutions cut to 32 / 64 / 96
    (divisible by 32) and its samples to 64."""
    raw = get_config(os.path.join(ROOT, "configs", "examples", f"{SHIPPED[arch]}.yaml"))
    proc = raw["config"]["process"][0]
    imgs, ctrl = _data(root, arch == "qwen_image_edit")
    proc["training_folder"] = os.path.join(root, "out")
    ds = proc["datasets"][0]
    ds.update(folder_path=imgs, resolution=[32, 64, 96])
    if "control_path" in ds:
        ds["control_path"] = ctrl
    proc["train"]["steps"] = steps
    proc["model"].update(name_or_path="", model_kwargs={"size": "tiny"})
    proc["sample"].update(width=64, height=64)
    return raw


@pytest.mark.parametrize("arch", ARCHS)
def test_shipped_file_runs_and_saves_the_jax_keys(tmp_path, arch, monkeypatch):
    """Each file (quantize: true, adamw8bit, EMA, flux_shift, bf16,
    checkpointing, the disk cache, three resolutions, a first and a final
    sample at 20 steps) runs to its end with finite losses, every item in the
    disk cache, both samples and a comfy LoRA file with the JAX job's keys;
    each edit batch's control latents are the VAE encode of its control
    images and the rope table counts the control tokens."""
    from safetensors import safe_open

    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    seen, real = [], SDTrainProcess._prepare_batch

    def record(self, model, variables, raw, text_cache):
        batch = real(self, model, variables, raw, text_cache)
        seen.append((model, variables, raw, batch))
        return batch

    monkeypatch.setattr(SDTrainProcess, "_prepare_batch", record)
    (result,) = run_job(_shipped(arch, str(tmp_path)), device="cpu")
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["latent_cache"]["items"] == 9 and result["latent_cache"]["encoded"] == 9
    assert [(s["step"], s["index"]) for s in result["samples"]] == [(0, 0), (2, 0)]
    jm = JQwenImageModel(JModelConfig.from_dict(_cfg(arch)))
    with safe_open(result["save_path"], framework="numpy") as f:
        saved = {k: f.get_tensor(k).shape for k in f.keys()}
    assert saved == _jax_job_keys(jm, jax.eval_shape(jm.init_variables, jax.random.key(0))["dit"], 16, "comfy")
    for model, variables, raw, batch in seen:
        ctrl = batch["cond"].get("control_latents")
        assert (ctrl is not None) == model.is_edit
        n_img = batch["image_seq_len"]
        assert batch["cond"]["pe"].shape[1] == 16 + n_img * (2 if model.is_edit else 1)
        if ctrl is not None:
            with torch.no_grad():
                enc = model.encode_images(variables, torch.from_numpy(raw["control_pixels"]))
            np.testing.assert_array_equal(ctrl.float().numpy(), enc.float().numpy())


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_comfy_key_names(side):
    """``jax_fault``: the JAX job's comfy file names the BFL modules of its
    DiT under ``diffusion_model.`` (``double_blocks.0.img_attn.qkv``, q/k/v
    fused), where the reference's ComfyUI convention (JAX
    ``qwen_model.py``'s docstring: ``transformer.`` -> ``diffusion_model.``
    over the diffusers names) writes ``transformer_blocks.0.attn.to_q``
    (ROADMAP Queue 3). ``port``: the port writes the JAX job's names."""
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.io.lora_file import flatten_lora

    jm, tm = _models("qwen_image")
    ref = _jax_job_keys(jm, jax.eval_shape(jm.init_variables, jax.random.key(0))["dit"], 4, "comfy")
    if side == "jax_fault":
        assert "diffusion_model.double_blocks.0.img_attn.qkv.lora_A.weight" in ref
        assert not any("transformer_blocks" in k or ".to_q." in k for k in ref)
        return
    lora = build_lora(FluxDiT(tm.dit_config, device="meta"), LoRASpec(rank=4, alpha=4.0,
                                                                       target_patterns=tm.lora_targets()), None)
    tree = {n: {"a": torch.zeros(m.a.shape), "b": torch.zeros(m.b.shape), "scale": torch.tensor(1.0)}
            for n, m in lora.items()}
    assert {k: v.shape for k, v in flatten_lora(tree, fmt=tm.lora_key_layout()).items()} == ref


@pytest.mark.parametrize("ctrl", [False, True])
def test_generate_flux_matches_jax(jvars, tmp_path, ctrl):
    """qwen_image_edit, 2 steps at 32 x 32, with JAX's noise: the control
    latents the encoded ``ctrl_img`` (resized to the sample) or zeros, and
    no CFG pass at ``guidance_scale`` 4 (as in JAX). The images agree within
    one uint8 step; the control changes the image."""
    jm, tm = _models("qwen_image_edit")
    variables = _port_variables(tm, jvars)
    path = None
    if ctrl:
        path = str(tmp_path / "ctrl.png")
        Image.fromarray(np.random.default_rng(9).integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(path)
    kw = dict(prompt="a photo of a fox", width=32, height=32, sample_steps=2, guidance_scale=4.0, seed=42,
              ctrl_img=path)
    ref = jgenerate_flux(jit_decode(jm), jvars, JGenerateImageConfig(**kw))
    h, w, c = tm.latent_shape(32, 32)
    noise = np.asarray(jax.random.normal(jax.random.key(42), (1, h, w, c), jnp.float32))
    out = generate_flux(tm, variables, GenerateImageConfig(**kw), noise=noise)
    assert out.shape == (32, 32, 3)
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    if ctrl:
        blank = generate_flux(tm, variables, GenerateImageConfig(**{**kw, "ctrl_img": None}), noise=noise)
        assert not np.array_equal(out, blank)


@pytest.mark.parametrize("what,match", [
    ("qwen_image_edit_plus", "later slice"), ("mageflow", "later slice"), ("mageflow_edit", "later slice"),
    ("model_kwargs", "model_kwargs"), ("control_path on qwen_image", "takes no control latents"),
    ("edit without a control", "no item of this"),
])
def test_what_stays_refused(tmp_path, what, match):
    raw = _shipped("qwen_image_edit" if what.startswith("edit") else "qwen_image", str(tmp_path))
    proc = raw["config"]["process"][0]
    proc["sample"]["sample_every"] = 0
    proc["train"]["disable_sampling"] = True
    if what in ("qwen_image_edit_plus", "mageflow", "mageflow_edit"):
        proc["model"]["arch"] = what
    elif what == "model_kwargs":
        proc["model"]["model_kwargs"]["vae_size"] = "tiny"  # a mageflow knob
    elif what == "control_path on qwen_image":
        proc["datasets"][0]["control_path"] = proc["datasets"][0]["folder_path"]
    else:
        proc["datasets"][0]["control_path"] = str(tmp_path / "empty")
        os.makedirs(tmp_path / "empty")
    with pytest.raises((NotImplementedError, ValueError), match=match) as err:
        run_job(raw, device="cpu")
    if "later slice" in match:
        assert "Queue 1 item 6" in str(err.value)
