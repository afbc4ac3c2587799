"""OmniGen2 on the port against the JAX package on the CPU at tiny f32 sizes:
the configs (the full-size transformer config from ``from_hf``, the
Qwen2.5-VL-3B text tower) and the JAX fault of a full-size build without a
transformer config, ``predict`` with 0, 1 and 2 reference images (the
reference embedder, the per-image index embedding, the reference refiner,
the shifted rope ids), one LoRA train step with a reference and the
reference refiner's LoRA through JAX ``train/step.make_train_step``, the
loader on a tiny diffusers directory (``mllm/`` with the Qwen2.5-VL
prefixes), the comfy LoRA file's keys at both sizes, the quantized base's
modules, ``generate_flux`` (one pass a step, no references: JAX's
choices), the shipped file through ``python -m ai_toolkit_tpu_torch.run``
at ``size: tiny`` and a job with ``control_path`` (the references), and
the refusals.

Trees, inputs and tolerances as in ``tests/test_torch_lumina2.py``: f32,
``rtol`` 1e-5 and an ``atol`` of 1e-4 of the largest reference value (of a
gradient: over every trained tensor)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open
from safetensors.torch import save_file
from test_torch_lumina2 import OPT, cfg, jax_variables, port_variables, shipped_file
from test_torch_sd3 import _close, _jax_job_keys, lora_step_matches_jax

from ai_toolkit_tpu.adapters import quantize as jquantize
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io.dit_importers import load_omnigen2_checkpoint
from ai_toolkit_tpu.models import omnigen2_dit as jdit
from ai_toolkit_tpu.models.omnigen2_model import OmniGen2Model as JOmniGen2Model
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.generation import generate_flux
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.lora_file import flatten_lora, load_lora_file
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.models import omnigen2_dit as tdit
from ai_toolkit_tpu_torch.models.omnigen2_model import CHAT_TEMPLATE, OmniGen2Model
from ai_toolkit_tpu_torch.models.text_encoders import llm as tllm
from ai_toolkit_tpu_torch.run import main as run_main
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
# OmniGen2Config's defaults under the diffusers transformer/config.json names from_hf reads
HF_CONFIG = {"hidden_size": 2520, "num_layers": 32, "num_refiner_layers": 2, "num_attention_heads": 21,
             "num_kv_heads": 7, "text_feat_dim": 2048, "multiple_of": 256, "ffn_dim_multiplier": None,
             "axes_dim_rope": [40, 40, 40], "norm_eps": 1e-5, "timestep_scale": 1.0, "in_channels": 16,
             "patch_size": 2}


def models(path="", **kw):
    c = cfg("omnigen2", path=path, **kw)
    return JOmniGen2Model(JModelConfig.from_dict(c)), OmniGen2Model(ModelConfig.from_dict(c), device="cpu")


@pytest.fixture(scope="module")
def omni():
    jm, tm = models()
    jv = jax_variables(jm, seed=2)
    return jm, tm, jv


PROMPTS = ["a red fox", "macro"]


def _conds(jm, tm, jv, variables, n_ref, seed=4):
    """The text conditioning and ``n_ref`` reference latents (4-D for one,
    5-D for several) at 4 x 6, beside an 8 x 8 image."""
    jc = dict(jm.encode_prompt(jv, PROMPTS))
    with torch.inference_mode():
        tc = tm.encode_prompt(variables, PROMPTS)
    if n_ref:
        ctrl = np.random.default_rng(seed).standard_normal((2, n_ref, 4, 6, 4), dtype=np.float32)
        ctrl = ctrl[:, 0] if n_ref == 1 else ctrl
        jc["control_latents"], tc["control_latents"] = jnp.asarray(ctrl), torch.from_numpy(ctrl)
    return jc, tc


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((2, 8, 8, 4), dtype=np.float32), "t": np.asarray([0.3, 0.85], np.float32)}


def test_configs_match_jax():
    """Tiny, and full from the released config under its diffusers names
    (the ffn round-up to 10,240, 21 x 120 heads), and Qwen2.5-VL-3B's text
    tower, field by field."""
    for kw in ({}, {"size": "full", "transformer_config": HF_CONFIG}):
        c = {"name_or_path": "", "arch": "omnigen2", "model_kwargs": kw or {"size": "tiny"}}
        ours = OmniGen2Model(ModelConfig.from_dict(c), device="meta")
        ref = JOmniGen2Model(JModelConfig.from_dict(c))
        shared = [f.name for f in dataclasses.fields(ours.dit_config) if f.name != "dtype"]
        assert {f: getattr(ours.dit_config, f) for f in shared} == {f: getattr(ref.dit_config, f) for f in shared}
        lshared = [f.name for f in dataclasses.fields(ours.llm_config) if f.name != "dtype"]
        assert {f: getattr(ours.llm_config, f) for f in lshared} == {f: getattr(ref.llm_config, f) for f in lshared}
    assert ours.dit_config == tdit.OmniGen2Config(dtype=torch.bfloat16)
    assert (ours.dit_config.ffn_hidden, ours.dit_config.head_dim) == (10240, 120)
    assert ours.llm_config == tllm.LLMConfig.qwen25_3b() and ours.tokenizer.eos_id == 151_643


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_full_size_needs_a_transformer_config(side, tmp_path):
    """``jax_fault``: a full-size OmniGen2 with no ``transformer/config.json``
    and no ``model_kwargs.transformer_config`` fails with ``KeyError:
    'hidden_size'`` (ROADMAP Queue 3). ``port``: it raises too, naming the
    file it looked for; the file alone builds the model, and
    ``transformer_config`` overrides it."""
    c = {"name_or_path": "", "arch": "omnigen2", "model_kwargs": {"size": "full"}}
    if side == "jax_fault":
        with pytest.raises(KeyError, match="hidden_size"):
            JOmniGen2Model(JModelConfig.from_dict(c))
        return
    with pytest.raises(KeyError, match="transformer/config.json"):
        OmniGen2Model(ModelConfig.from_dict(c), device="meta")
    os.makedirs(tmp_path / "transformer")
    with open(tmp_path / "transformer" / "config.json", "w") as f:
        json.dump(HF_CONFIG, f)
    c["name_or_path"] = str(tmp_path)
    assert OmniGen2Model(ModelConfig.from_dict(c), device="meta").dit_config.dim == 2520
    c["model_kwargs"]["transformer_config"] = {"num_layers": 3}
    assert OmniGen2Model(ModelConfig.from_dict(c), device="meta").dit_config.n_layers == 3


@pytest.mark.parametrize("n_ref", [0, 1, 2])
def test_predict_matches_jax(omni, n_ref):
    """``encode_prompt`` (the chat template, eos 2 at tiny) and ``predict``
    with ``n_ref`` references: JAX's rope ids (reference j at cap_len +
    j * max(rh, rw), the image after them), the references refined as their
    own rows, the output the image tokens negated."""
    jm, tm, jv = omni
    variables = port_variables(tm, jv)
    jc, tc = _conds(jm, tm, jv, variables, n_ref)
    assert tm.prompt_text("x") == CHAT_TEMPLATE.format("x") and tm.tokenizer.eos_id == 2
    _close(tc["txt"].numpy(), jc["txt"])
    inp = _inputs()
    ref = jax.jit(jm.predict)(jv, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jc)
    with torch.inference_mode():
        out = tm.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), tc)
    _close(out.numpy(), ref, f"{n_ref} references")
    if n_ref == 2:  # the references reach the output
        with torch.inference_mode():
            alone = tm.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                               {k: v for k, v in tc.items() if k != "control_latents"})
        assert not torch.allclose(out, alone)


def test_lora_step_matches_jax(omni, monkeypatch):
    """One reference, ``use_image_refiner`` (the reference refiner's LoRA
    too), ``timestep_type: flux_shift``: the loss and every LoRA gradient
    against the JAX step with the port's draws, under adamw (``OPT``)."""
    _, _, jv = omni
    jm, tm = models(use_image_refiner=True)
    variables = port_variables(tm, jv)
    jc, tc = _conds(jm, tm, jv, variables, 1)
    names, zero = lora_step_matches_jax(jm, tm, jv, variables, _inputs(), jc, tc, "flux_shift", monkeypatch,
                                        optimizer=OPT, targets=tm.lora_targets(), module_of=from_jax._nextdit_module)
    assert not zero and "ref_image_refiner.0.feed_forward.linear_2" in names


def _write_dir(root, variables):
    """A tiny diffusers OmniGen2 directory: ``transformer/`` with its
    ``config.json``, ``vae/``, and ``mllm/`` in Qwen2.5-VL's layout
    (``model.language_model.``, a vision tower and an LM head)."""
    written = {}
    for sub, name in (("transformer", "dit"), ("vae", "vae"), ("mllm", "te")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        written[name] = state = {k: (v.float() + 0.25).contiguous() for k, v in variables[name].state_dict().items()}
        if name == "te":
            state = {"model.language_model." + k: v for k, v in state.items()}
            state.update({"model.visual.patch_embed.proj.weight": torch.ones(4, 3),
                          "lm_head.weight": torch.ones(8, 24)})
        save_file(state, os.path.join(root, sub, "model.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump(HF_CONFIG, f)
    return written


def test_loader_on_a_tiny_diffusers_dir(omni, tmp_path, capsys):
    """Both loaders read the transformer (the reference embedder, the index
    embedding and the reference refiner too), the VAE and the Qwen2.5-VL
    text tower bit for bit; the port names the vision tower and the LM
    head it does not read, and a missing ``vae/`` keeps its seeded init."""
    _, _, jv = omni
    variables = port_variables(OmniGen2Model(ModelConfig.from_dict(cfg("omnigen2")), device="cpu"), jv)
    written = _write_dir(str(tmp_path), variables)
    jm, tm = models(str(tmp_path))
    loaded = tm.load_variables(torch.Generator().manual_seed(0))
    out = capsys.readouterr().out
    assert "2 not read" in out and "lm_head.weight" in out
    for name, state in written.items():
        for k, v in loaded[name].state_dict().items():
            assert torch.equal(v, state[k]), (name, k)
    jm.init_variables = lambda rng: jax.tree.map(np.copy, jv)
    got = load_omnigen2_checkpoint(str(tmp_path), jm)
    assert "unmatched" not in capsys.readouterr().out
    for name, conv in (("dit", from_jax.nextdit_state_dict), ("vae", from_jax.vae_state_dict),
                       ("te", from_jax.llm_state_dict)):
        for k, v in conv(got[name]).items():
            assert torch.equal(v, written[name][k]), (name, k)
    os.rename(tmp_path / "vae", tmp_path / "vae_gone")
    again = tm.load_variables(torch.Generator().manual_seed(0))
    assert "'vae' keeps its seeded init" in capsys.readouterr().out
    seeded = tm.init_variables(torch.Generator().manual_seed(0))["vae"].state_dict()
    assert all(torch.equal(v, seeded[k]) for k, v in again["vae"].state_dict().items())


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_comfy_lora_keys_match_the_jax_job(omni, size):
    """The comfy file (``diffusion_model.``) carries the JAX job's module
    paths at both sizes (``layers.block.ffn_w2.31`` scanned, ``layer_1``
    unrolled); with ``use_image_refiner`` the reference refiner's too
    (``ref_refiner_0.norm1_lin``); they read back to the port's modules."""
    kw = {"use_image_refiner": True}
    if size == "full":
        kw["transformer_config"] = HF_CONFIG
    c = {"name_or_path": "", "arch": "omnigen2", "model_kwargs": {"size": size, **kw}}
    jm, tm = JOmniGen2Model(JModelConfig.from_dict(c)), OmniGen2Model(ModelConfig.from_dict(c), device="meta")
    tree = omni[2]["dit"]
    if size == "full":
        jc = jm.dit_config
        ca, ia, ra = jdit.omnigen2_pos_angles(jc, 2, 2, jnp.full((1,), 4), 4, ref_hw=(2, 2), n_ref=1)
        ppc = 4 * jc.in_channels
        tree = jax.eval_shape(jm.dit.init, jax.random.key(0), jnp.zeros((1, 4, ppc)),
                              jnp.zeros((1, 4, jc.cap_feat_dim)), jnp.zeros((1,)), jnp.ones((1, 4), bool), ia, ca,
                              jnp.zeros((1, 1, 4, ppc)), ra)["params"]
    ref = _jax_job_keys(jm, tree, 4, "comfy")
    lora = build_lora(tdit.OmniGen2DiT(tm.dit_config, device="meta"),
                      LoRASpec(rank=4, alpha=4.0, target_patterns=tm.lora_targets()), None)
    factors = {n: {"a": torch.zeros(m.a.shape), "b": torch.zeros(m.b.shape), "scale": torch.tensor(1.0)}
               for n, m in lora.items()}
    flat = flatten_lora(factors, fmt=tm.lora_key_layout(), key_map=tm.lora_key)
    assert {k: v.shape for k, v in flat.items()} == ref
    assert "diffusion_model.ref_refiner_0.norm1_lin.lora_A.weight" in ref
    assert ("diffusion_model.layers.block.ffn_w2.31.lora_B.weight" if size == "full"
            else "diffusion_model.layer_1.ffn_w2.lora_B.weight") in ref
    assert {tm.lora_module_name(k.split(".", 1)[1].rsplit(".", 2)[0]) for k in flat} == set(lora)


def test_quantized_modules_match_jax(omni, monkeypatch):
    """The weights a quantized base (the shipped file's qfloat8) holds
    quantized, over the tiny DiT with the size floor lifted: JAX
    ``DEFAULT_EXCLUDE`` on its paths and the port's list on the diffusers
    names pick the same modules (the modulations, ``time_in`` and the final
    layer stay; ``x_embedder``, ``ref_embedder`` and ``cap_proj`` go)."""
    jm, tm, jv = omni
    # the selection alone: a stand-in for the fp8 kernel (JAX's runs eagerly, op by op)
    monkeypatch.setattr(jquantize, "get_quantize_kernel", lambda qtype: lambda v: (v, v[:1]))
    _, quant = jquantize.quantize_params(jv["dit"], min_size=0, qtype="qfloat8")
    theirs = set()

    def walk(node, path):
        for k, v in node.items():
            if k == "qvalue":
                theirs.add(path)
            elif isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)

    walk(quant, "")
    ours = quantize_params(tdit.OmniGen2DiT(tm.dit_config), exclude_patterns=tm.quantize_exclude, min_size=0,
                           qtype="qfloat8")
    assert sorted(ours) == sorted(from_jax._nextdit_module(p) for p in theirs)
    assert {"x_embedder", "ref_image_patch_embedder", "time_caption_embed.caption_embedder.1"} <= set(ours)
    assert not any("norm" in n or "timestep" in n for n in ours)


def test_generate_flux_samples_as_jax(omni, monkeypatch):
    """2 steps at 32 x 32, ``guidance_scale`` 4: one ``predict`` a step
    (no CFG pass, as JAX ``generate_flux`` gives omnigen2 none) and no
    references; a ``ctrl_img`` raises (JAX ignores it)."""
    _, tm, jv = omni
    variables = port_variables(tm, jv)
    calls, real = [], tm.predict

    def predict(v, x, t, cond):
        calls.append((x.shape[0], cond.get("control_latents")))
        return real(v, x, t, cond)

    monkeypatch.setattr(tm, "predict", predict)
    kw = dict(prompt="a photo of a fox", width=32, height=32, sample_steps=2, guidance_scale=4.0, seed=42)
    out = generate_flux(tm, variables, GenerateImageConfig(**kw))
    assert out.shape == (32, 32, 3) and calls == [(1, None), (1, None)]
    with pytest.raises(NotImplementedError, match="without references"):
        generate_flux(tm, variables, GenerateImageConfig(**kw, ctrl_img="x.png"))


def test_shipped_file_runs_through_run_py(omni, tmp_path, capsys):
    """``python -m ai_toolkit_tpu_torch.run`` on the shipped omnigen2 file
    (qfloat8 base, nothing quantized at the tiny widths) at ``size: tiny``,
    one step: the disk cache, both samples, and a comfy LoRA file with the
    JAX job's keys that reads back to the port's modules."""
    path, out_dir, name = shipped_file(str(tmp_path), "train_lora_omnigen2_tpu.yaml", "omnigen2")
    assert run_main([path, "--device", "cpu"]) == 0
    assert "step 1/1" in capsys.readouterr().out
    assert len(os.listdir(os.path.join(out_dir, "latent_cache"))) == 9
    assert len(os.listdir(os.path.join(out_dir, "samples"))) == 2
    jm, tree = omni[0], omni[2]["dit"]
    with safe_open(os.path.join(out_dir, f"{name}.safetensors"), framework="numpy") as f:
        keys = {k: f.get_tensor(k).shape for k in f.keys()}
    assert keys == _jax_job_keys(jm, tree, 16, "comfy")
    saved, _ = load_lora_file(os.path.join(out_dir, f"{name}.safetensors"),
                              module_name=OmniGen2Model.lora_module_name)
    assert len(saved) == len(keys) // 2


def test_control_path_feeds_the_references(tmp_path, monkeypatch):
    """With ``datasets[].control_path`` every batch carries the VAE encode of
    its control image as one reference, and the DiT runs its reference
    stream; without one (the shipped file) no batch carries any."""
    from ai_toolkit_tpu_torch.config import get_config
    from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess

    path, _, _ = shipped_file(str(tmp_path), "train_lora_omnigen2_tpu.yaml", "omnigen2")
    raw = get_config(path)
    proc = raw["config"]["process"][0]
    ctrl = tmp_path / "ctrl"
    os.makedirs(ctrl)
    for f in os.listdir(proc["datasets"][0]["folder_path"]):
        if f.endswith(".png"):
            Image.fromarray(np.random.default_rng(len(f)).integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(ctrl / f)
    proc["datasets"][0]["control_path"] = str(ctrl)
    proc["sample"]["sample_every"] = 0
    proc["train"].update(disable_sampling=True, steps=2)
    seen, real = [], SDTrainProcess._prepare_batch

    def record(self, model, variables, raw_batch, text_cache):
        batch = real(self, model, variables, raw_batch, text_cache)
        ctrl_lat = batch["cond"].get("control_latents")
        with torch.no_grad():
            enc = model.encode_images(variables, torch.from_numpy(raw_batch["control_pixels"]))
        seen.append(ctrl_lat is not None and torch.equal(ctrl_lat, enc))
        return batch

    monkeypatch.setattr(SDTrainProcess, "_prepare_batch", record)
    (result,) = run_job(raw, device="cpu")
    assert seen == [True, True] and all(np.isfinite(result["losses"]))


@pytest.mark.parametrize("what,match", [("inpaint_path", "inpaint_path"), ("control_path on lumina2", "lumina2"),
                                        ("model_kwargs", "model_kwargs")])
def test_what_stays_refused(tmp_path, what, match):
    path, _, _ = shipped_file(str(tmp_path), "train_lora_omnigen2_tpu.yaml", "omnigen2")
    from ai_toolkit_tpu_torch.config import get_config

    raw = get_config(path)
    proc = raw["config"]["process"][0]
    ds = proc["datasets"][0]
    if what == "inpaint_path":
        ds["inpaint_path"] = ds["folder_path"]
    elif what == "model_kwargs":
        proc["model"]["model_kwargs"]["control"] = True
    else:
        proc["model"]["arch"] = "lumina2"
        ds["control_path"] = ds["folder_path"]
    with pytest.raises((NotImplementedError, ValueError), match=match):
        run_job(raw, device="cpu")
