"""Lumina-Image-2.0 on the port against the JAX package on the CPU at tiny f32
sizes: the Gemma2 text tower (its config, the four norms, the tanh GELU,
the scaled embeddings and the softcapped attention under the eos mask), the
Gemma ``1 + w`` norm scale bit for bit on a bf16 checkpoint, the NextDiT
forward from a JAX
tree scanned and unrolled (uneven caption lengths, the patch-major packing,
``1 - t`` and the negated output), one LoRA train step's loss and gradients
through JAX ``train/step.make_train_step``, the loader on a tiny diffusers
directory (and the JAX fault in its text-encoder rules at ``tiny``), the
LoRA file's keys at both sizes against the JAX job's, and the shipped file
run at ``size: tiny`` through
``python -m ai_toolkit_tpu_torch.run``.

JAX trees come from ``jax.eval_shape`` filled with seeded numpy values (a
jitted init costs seconds a component), norm scales away from 1, and reach
the port through ``io/from_jax.py``. Tolerance: f32 on both sides,
``rtol`` 1e-5 and an ``atol`` of 1e-4 of the largest reference value (of a
gradient: over every trained tensor), as in ``tests/test_torch_sd3.py``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import save_file
from test_torch_sd3 import _close, _jax_job_keys, lora_step_matches_jax

from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io.dit_importers import load_lumina2_checkpoint
from ai_toolkit_tpu.io.sd_import import llm_rules
from ai_toolkit_tpu.io.torch_import import load_safetensors_dir, torch_to_tree
from ai_toolkit_tpu.models import lumina2_dit as jdit
from ai_toolkit_tpu.models.lumina2_model import Lumina2Model as JLumina2Model
from ai_toolkit_tpu.models.omnigen2_model import OmniGen2Model as JOmniGen2Model
from ai_toolkit_tpu.models.text_encoders import llm as jllm
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.lora_file import flatten_lora, load_lora_file
from ai_toolkit_tpu_torch.io.safetensors_dir import SafetensorsIndex, load_module
from ai_toolkit_tpu_torch.models import lumina2_dit as tdit
from ai_toolkit_tpu_torch.models.lumina2_model import Lumina2Model
from ai_toolkit_tpu_torch.models.text_encoders import llm as tllm
from ai_toolkit_tpu_torch.run import main as run_main
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Gemma2's flags on the tiny widths; the softcap at 0.5 bites on the tiny logits
GEMMA = dict(post_norms=True, gemma_gelu=True, scale_embeddings=True, rms_eps=1e-6, query_scale=16.0 ** -0.5)
# the LoRA step's optimizer: the gradients are held before it, and JAX compiles adamw8bit's
# step in twice the time; the shipped files' adamw8bit runs in the shipped-file tests
OPT = "adamw"


def filled(shapes, seed):
    """A JAX parameter tree of ``shapes`` (``jax.eval_shape``) with seeded
    values: kernels normal / sqrt(fan_in), scales 1 + 0.3 normal, token
    embeddings 0.02 normal, biases and the rest (OmniGen2's index embedding)
    0.1 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        elif name.endswith("['scale']"):
            v = 1.0 + 0.3 * rng.standard_normal(s.shape)
        elif "token_embedding" in name:
            v = 0.02 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def cfg(arch, size="tiny", path="", **kw):
    return {"name_or_path": path, "arch": arch, "model_kwargs": {"size": size, **kw}}


def jax_variables(jm, seed=1):
    """The JAX model's variables: eval_shape of its init, filled."""
    return filled(jax.eval_shape(jm.init_variables, jax.random.key(0)), seed)


def port_variables(tm, jv):
    variables = tm.init_variables(torch.Generator().manual_seed(0))
    tm.load_state_dicts(variables, from_jax.nextdit_model_state(jv))
    return variables


@pytest.fixture(scope="module")
def lumina():
    jm = JLumina2Model(JModelConfig.from_dict(cfg("lumina2")))
    tm = Lumina2Model(ModelConfig.from_dict(cfg("lumina2")), device="cpu")
    jv = jax_variables(jm)
    return jm, tm, jv, port_variables(tm, jv)


PROMPTS = ["a photo of a red fox in the snow", "macro"]  # the second keeps 2 of 16 tokens


def inputs(tm, b=2, hh=8, ww=12, seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, hh, ww, tm.dit_config.in_channels), dtype=np.float32),
            "t": np.asarray([0.3, 0.85], np.float32)[:b]}


def conds(jm, tm, jv, variables, prompts=PROMPTS):
    jc = dict(jm.encode_prompt(jv, prompts))
    with torch.inference_mode():
        tc = tm.encode_prompt(variables, prompts)
    return jc, tc


# ---- the Gemma2 text tower ----

def test_gemma2_config_matches_jax():
    ours, ref = tllm.LLMConfig.gemma2_2b(), jllm.LLMConfig.gemma2_2b()
    shared = [f.name for f in dataclasses.fields(ours) if f.name != "dtype"]
    assert {f: getattr(ours, f) for f in shared} == {f: getattr(ref, f) for f in shared}
    assert (ours.d_model, ours.n_layers, ours.n_heads, ours.n_kv_heads, ours.head_dim, ours.d_ff) == \
        (2304, 26, 8, 4, 256, 9216)
    assert ours.attn_softcap == 50.0 and ours.query_scale == 256.0 ** -0.5
    with pytest.raises(NotImplementedError, match="other LLM families"):
        tllm.LLMEncoder(tllm.LLMConfig.tiny(qk_head_norm=True), device="meta")


@pytest.mark.parametrize("cap", [50.0, 0.5])
def test_gemma2_encoder_matches_jax(cap):
    """A tiny Gemma2 tower (post norms, tanh GELU, scaled embeddings, the
    softcap, the query scale) under the eos mask of ``encode_prompt`` (the
    padded rows keep their valid keys), every norm's ``1 + w`` away from 1."""
    c = dict(GEMMA, attn_softcap=cap)
    ids = np.random.default_rng(5).integers(3, 1000, (2, 12)).astype(np.int32)
    ids[1, 4:] = 1  # eos then padding
    is_eos = ids == 1
    mask = (np.cumsum(is_eos, axis=1) - is_eos <= 0).astype(np.int32)
    jmod = jllm.LLMEncoder(jllm.LLMConfig.tiny(**c))
    params = filled(jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(ids))["params"], 4)
    assert "post_mlp_norm" in params["layer_0"]
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    mod = tllm.LLMEncoder(tllm.LLMConfig.tiny(**c))
    mod.load_state_dict(from_jax.llm_state_dict(params, gemma=True))
    layer = mod.layers[0]
    assert isinstance(layer.pre_feedforward_layernorm, tllm.GemmaRMSNorm)
    # the stored w is the JAX scale less 1: 1 + w gives it back within half an ulp of 1
    np.testing.assert_allclose(layer.post_attention_layernorm.scale.detach().numpy(),
                               params["layer_0"]["post_attn_norm"]["scale"], rtol=0, atol=6e-8)
    with torch.inference_mode():
        out = mod(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(out.numpy(), ref, f"softcap {cap}")


def test_gemma_scale_on_a_bf16_checkpoint(tmp_path):
    """A transformers Gemma2 state (``model.`` prefix) in bf16, read by the
    port and by JAX's ``load_safetensors_dir`` and ``llm_rules(gemma=True)``
    (``plus_one``: numpy adds 1.0 to the bf16 values in f32): the port's
    scale ``1 + w`` equals JAX's bit for bit, norm by norm, the
    post-attention norm where JAX puts it."""
    mod = tllm.LLMEncoder(tllm.LLMConfig.tiny(**GEMMA, attn_softcap=50.0))
    g = torch.Generator().manual_seed(6)
    state = {f"model.{k}": (torch.randn(v.shape, generator=g) * (0.3 if v.dim() == 1 else 0.05)).to(torch.bfloat16)
             for k, v in mod.state_dict().items()}
    save_file(state, str(tmp_path / "model.safetensors"))
    with SafetensorsIndex(str(tmp_path), ("model.",)) as index:
        load_module(mod, index, "gemma2")
    flat = load_safetensors_dir(str(tmp_path))
    assert flat["model.norm.weight"].dtype.name == "bfloat16"
    tree, unmatched = torch_to_tree(flat, llm_rules(gemma=True))
    assert not unmatched
    pairs = {"input_layernorm": "input_norm", "post_attention_layernorm": "post_attn_norm",
             "pre_feedforward_layernorm": "pre_mlp_norm", "post_feedforward_layernorm": "post_mlp_norm"}
    n = 0
    for i, layer in enumerate(mod.layers):
        for ours, theirs in pairs.items():
            scale = getattr(layer, ours).scale.detach().numpy()
            want = np.asarray(tree[f"layer_{i}"][theirs]["scale"])
            assert scale.dtype == want.dtype == np.float32 and np.array_equal(scale.view(np.uint32),
                                                                              want.view(np.uint32)), (i, ours)
            n += 1
    assert np.array_equal(mod.norm.scale.detach().numpy(), tree["final_norm"]["scale"]) and n == 8
    assert not np.array_equal(mod.norm.scale.detach().numpy(), (state["model.norm.weight"] + 1).float().numpy())


# ---- the NextDiT ----

def test_dit_configs_match_jax():
    for size in ("tiny", "full"):
        ours = Lumina2Model(ModelConfig.from_dict(cfg("lumina2", size)), device="meta").dit_config
        ref = JLumina2Model(JModelConfig.from_dict(cfg("lumina2", size))).dit_config
        shared = [f.name for f in dataclasses.fields(ours) if f.name != "dtype"]
        assert {f: getattr(ours, f) for f in shared} == {f: getattr(ref, f) for f in shared}
    assert (ours.head_dim, ours.ffn_hidden, ours.adaln_dim) == (96, 6144, 1024)


def test_scanned_dit_forward_matches_jax():
    """The DiT from a scanned JAX tree (``scan_blocks``: the joint stack
    split per layer; the unrolled tree is ``predict``'s below) over captions
    of 9 and 3 valid tokens of 12 and a 12 x 8 image grid, against JAX's
    apply with the same angle tables."""
    jcfg = jdit.Lumina2Config.tiny(scan_blocks=True, n_layers=3)
    jmod = jdit.Lumina2DiT(jcfg)
    b, hp, wp, t_max = 2, 6, 4, 12
    lens = np.asarray([9, 3])
    mask = np.arange(t_max)[None] < lens[:, None]
    ta, ia = jdit.lumina2_pos_angles(jcfg, hp, wp, jnp.asarray(lens), t_max)
    rng = np.random.default_rng(7)
    img = rng.standard_normal((b, hp * wp, 16), dtype=np.float32)
    cap = rng.standard_normal((b, t_max, 24), dtype=np.float32)
    t = np.asarray([0.2, 0.7], np.float32)
    args = (jnp.asarray(img), jnp.asarray(cap), jnp.asarray(t), jnp.asarray(mask), ia, ta)
    params = filled(jax.eval_shape(jmod.init, jax.random.key(0), *args)["params"], 8)
    assert params["layers"]["block"]["ffn_w1"]["kernel"].shape[0] == 3
    ref = jax.jit(jmod.apply)({"params": params}, *args)
    mod = tdit.Lumina2DiT(tdit.Lumina2Config.tiny(n_layers=3))
    mod.load_state_dict(from_jax.nextdit_state_dict(params))
    ta2, ia2 = tdit.lumina2_pos_angles(mod.cfg, hp, wp, torch.from_numpy(lens), t_max)
    np.testing.assert_allclose(ia2.numpy(), np.asarray(ia), rtol=1e-6)
    with torch.inference_mode():
        out = mod(torch.from_numpy(img), torch.from_numpy(cap), torch.from_numpy(t), torch.from_numpy(mask), ia2, ta2)
    _close(out.numpy(), ref)


def test_predict_and_encode_prompt_match_jax(lumina):
    """``encode_prompt`` (the eos mask, eos id 1) and ``predict`` (packed
    patch-major, ``1 - t`` in, the output negated) on the tiny model."""
    jm, tm, jv, variables = lumina
    jc, tc = conds(jm, tm, jv, variables)
    np.testing.assert_array_equal(tc["txt_mask"].numpy(), np.asarray(jc["txt_mask"]))
    assert tc["txt_mask"][1].sum() == 2 and tm.tokenizer.eos_id == 1
    _close(tc["txt"].numpy(), jc["txt"])
    inp = inputs(tm)
    ref = jax.jit(jm.predict)(jv, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jc)
    with torch.inference_mode():
        out = tm.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), tc)
    assert out.shape == inp["x"].shape
    _close(out.numpy(), ref)


def test_lora_step_matches_jax(lumina, monkeypatch):
    """``timestep_type: flux_shift`` (the shipped file's): the loss and every
    LoRA gradient (the joint layers and both refiners) against the JAX step
    with the port's draws, under adamw (``OPT``)."""
    jm, tm, jv, _ = lumina
    variables = port_variables(tm, jv)  # the LoRA stays on this DiT
    jc, tc = conds(jm, tm, jv, variables)
    names, zero = lora_step_matches_jax(jm, tm, jv, variables, inputs(tm), jc, tc, "flux_shift", monkeypatch,
                                        optimizer=OPT, targets=tm.lora_targets(),
                                        module_of=from_jax._nextdit_module)
    assert not zero and any(n.startswith("context_refiner.0.") for n in names)
    assert "noise_refiner.0.norm1.linear" in names and "layers.1.feed_forward.linear_3" in names


# ---- the loader ----

def _write_dir(root, variables, bump=0.25):
    """A tiny diffusers Lumina2 directory from the port's modules, each
    tensor moved off its value by ``bump``; returns what was written."""
    written = {}
    for sub, name in (("transformer", "dit"), ("vae", "vae"), ("text_encoder", "te")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        state = {k: (v.float() + bump).contiguous() for k, v in variables[name].state_dict().items()}
        save_file({("model." if name == "te" else "") + k: v for k, v in state.items()},
                  os.path.join(root, sub, "model.safetensors"))
        written[name] = state
    return written


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_loader_on_a_tiny_diffusers_dir(side, lumina, tmp_path, capsys):
    """The transformer and the FLUX-layout VAE read bit for bit by both
    loaders. ``port``: the text encoder too, strictly, in its own names.
    ``jax_fault``: at ``size: tiny`` the text tower is the Llama one, and the
    JAX loader reads ``text_encoder/`` with the Gemma2 rules: every norm gets
    1 added and ``post_attention_layernorm`` (this tower's pre-MLP norm) goes
    nowhere, so the pre-MLP norm keeps its init (ROADMAP Queue 3)."""
    _, _, jv, variables = lumina
    written = _write_dir(str(tmp_path), variables)
    if side == "port":
        tm = Lumina2Model(ModelConfig.from_dict(cfg("lumina2", path=str(tmp_path))), device="cpu")
        loaded = tm.load_variables(torch.Generator().manual_seed(0))
        out = capsys.readouterr().out
        assert all(f"loaded lumina2 {n}" in out for n in ("dit", "vae", "te"))
        for name, state in written.items():
            for k, v in loaded[name].state_dict().items():
                assert torch.equal(v, state[k]), (name, k)
        single = Lumina2Model(ModelConfig.from_dict(cfg("lumina2", path=str(tmp_path / "transformer" /
                                                                            "model.safetensors"))), device="cpu")
        one = single.load_variables(torch.Generator().manual_seed(0))
        assert "one transformer file" in capsys.readouterr().out
        assert torch.equal(one["dit"].x_embedder.weight, written["dit"]["x_embedder.weight"])
        return
    jm = JLumina2Model(JModelConfig.from_dict(cfg("lumina2", path=str(tmp_path))))
    jm.init_variables = lambda rng: jax.tree.map(np.copy, jv)
    got = load_lumina2_checkpoint(str(tmp_path), jm)
    assert "unmatched" not in capsys.readouterr().out
    for k, v in from_jax.nextdit_state_dict(got["dit"]).items():
        assert torch.equal(v, written["dit"][k]), k
    for k, v in from_jax.vae_state_dict(got["vae"]).items():
        assert torch.equal(v, written["vae"][k]), k
    te = got["te"]["layer_0"]
    w = written["te"]
    np.testing.assert_array_equal(te["input_norm"]["scale"], w["layers.0.input_layernorm.weight"].numpy() + 1.0)
    np.testing.assert_array_equal(te["pre_mlp_norm"]["scale"], jv["te"]["layer_0"]["pre_mlp_norm"]["scale"])
    np.testing.assert_array_equal(te["q"]["kernel"], w["layers.0.self_attn.q_proj.weight"].numpy().T)


# ---- LoRA files ----

@pytest.mark.parametrize("size", ["tiny", "full"])
def test_lora_keys_match_the_jax_job(lumina, size):
    """The PEFT file's keys and shapes equal the JAX job's: its module paths,
    the joint layers unrolled at ``tiny`` (``layer_1.ffn_w1``) and per layer
    of the scanned stack at full size (``layers.block.attn.to_k.25``), the
    refiners unrolled (``context_refiner_0.attn.to_out``,
    ``noise_refiner_1.norm1_lin``); they read back to the port's modules."""
    jm = JLumina2Model(JModelConfig.from_dict(cfg("lumina2", size)))
    tm = Lumina2Model(ModelConfig.from_dict(cfg("lumina2", size)), device="meta")
    tree = lumina[2]["dit"]
    if size == "full":
        c = jm.dit_config
        ta, ia = jdit.lumina2_pos_angles(c, 2, 2, jnp.full((1,), 4), 4)
        tree = jax.eval_shape(jm.dit.init, jax.random.key(0), jnp.zeros((1, 4, 4 * c.in_channels)),
                              jnp.zeros((1, 4, c.cap_feat_dim)), jnp.zeros((1,)), jnp.ones((1, 4), bool), ia,
                              ta)["params"]
    ref = _jax_job_keys(jm, tree, 4)
    lora = build_lora(tdit.Lumina2DiT(tm.dit_config, device="meta"),
                      LoRASpec(rank=4, alpha=4.0, target_patterns=tm.lora_targets()), None)
    factors = {n: {"a": torch.zeros(m.a.shape), "b": torch.zeros(m.b.shape), "scale": torch.tensor(1.0)}
               for n, m in lora.items()}
    flat = flatten_lora(factors, fmt="peft", key_map=tm.lora_key)
    assert {k: v.shape for k, v in flat.items()} == ref
    if size == "full":
        assert len(ref) == 2 * (26 * 8 + 2 * 8 + 2 * 7)
        assert "transformer.layers.block.attn.to_k.25.lora_A.weight" in ref
        assert "transformer.noise_refiner_1.norm1_lin.lora_B.weight" in ref
    else:
        assert "transformer.layer_1.ffn_w1.lora_A.weight" in ref
    assert {tm.lora_module_name(k.split(".", 1)[1].rsplit(".", 2)[0]) for k in flat} == set(lora)


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_lora_key_names(lumina, side):
    """``jax_fault``: the JAX job's key map (``flux_lora_key_map``) matches
    none of the NextDiT's modules, so its file carries the JAX module paths
    (``layer_0.ffn_w1``, ``noise_refiner_0.norm1_lin``,
    ``context_refiner_0.attn.to_out``), where diffusers and ComfyUI name
    ``layers.0.feed_forward.linear_1``, ``norm1.linear`` and
    ``attn.to_out.0`` (ROADMAP Queue 3). ``port``: the port's modules carry
    the diffusers names, and its file writes the JAX job's paths."""
    jm, tm, jv, _ = lumina
    ref = set(_jax_job_keys(jm, jv["dit"], 4))
    if side == "jax_fault":
        assert {"transformer.layer_0.ffn_w1.lora_A.weight", "transformer.noise_refiner_0.norm1_lin.lora_A.weight",
                "transformer.context_refiner_0.attn.to_out.lora_A.weight"} <= ref
        assert not any(w in k for k in ref for w in ("feed_forward", "norm1.linear", "to_out.0", "layers.0."))
        return
    names = {"layers.0.feed_forward.linear_1": "layer_0.ffn_w1", "noise_refiner.0.norm1.linear": "noise_refiner_0.norm1_lin",
             "context_refiner.0.attn.to_out.0": "context_refiner_0.attn.to_out"}
    modules = dict(tm._dit(None).named_modules())
    for port, jax_path in names.items():
        assert port in modules and tm.lora_key(port) == jax_path and tm.lora_module_name(jax_path) == port
        assert f"transformer.{jax_path}.lora_B.weight" in ref


def test_jax_samples_without_cfg():
    """``jax_fault`` (ROADMAP Queue 3, "No CFG"): JAX ``generate_flux`` builds
    a negative pass only for an x0-prediction arch, the zero-text CFG and
    ``use_flux_cfg``, and neither NextDiT arch is one, so the shipped files'
    ``guidance_scale: 4`` reaches a ``guidance`` neither DiT reads; the port
    samples them the same way (``tests/test_torch_omnigen2.py``: one pass a
    step)."""
    for cls, arch in ((JLumina2Model, "lumina2"), (JOmniGen2Model, "omnigen2")):
        jm = cls(JModelConfig.from_dict(cfg(arch)))
        assert not getattr(jm, "x0_prediction", False) and getattr(jm, "cfg_uncond", None) is None
        assert not jm.config.use_flux_cfg and not getattr(jm.dit_config, "guidance_embed", False)


# ---- the shipped file ----

def shipped_file(root, example, arch, steps=1, **model_kwargs):
    """The shipped file as written but for its paths, its steps and, for the
    CPU, ``size: tiny`` with its resolutions cut to 32 / 48 / 64 and its
    samples to 64 x 64 at 2 steps; written to ``root/job.yaml``."""
    from PIL import Image

    raw = get_config(os.path.join(ROOT, "configs", "examples", example))
    proc = raw["config"]["process"][0]
    imgs = os.path.join(root, "imgs")
    os.makedirs(imgs, exist_ok=True)
    for i, (w, h) in enumerate(((64, 48), (48, 64), (64, 64))):
        rng = np.random.default_rng(i)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(os.path.join(imgs, f"im_{i}.png"))
        with open(os.path.join(imgs, f"im_{i}.txt"), "w") as f:
            f.write(f"photo of thing {i}")
    proc["training_folder"] = os.path.join(root, "out")
    proc["datasets"][0].update(folder_path=imgs, resolution=[32, 48, 64])
    proc["train"]["steps"] = steps
    proc["model"].update(name_or_path="", model_kwargs={"size": "tiny", **model_kwargs})
    proc["sample"].update(width=64, height=64, sample_steps=2)
    path = os.path.join(root, "job.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, os.path.join(root, "out", raw["config"]["name"]), raw["config"]["name"]


def test_shipped_file_runs_through_run_py(lumina, tmp_path, capsys):
    """``python -m ai_toolkit_tpu_torch.run`` on the shipped lumina2 file at
    ``size: tiny``, one step: a finite loss, every item in the disk cache,
    the first and final samples, and a PEFT LoRA file with the JAX job's
    keys that reads back to the port's modules."""
    path, out_dir, name = shipped_file(str(tmp_path), "train_lora_lumina2_tpu.yaml", "lumina2")
    assert run_main([path, "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert "step 1/1" in log and "nan" not in log.split("step 1/1")[1].split("\n")[0]
    assert len(os.listdir(os.path.join(out_dir, "latent_cache"))) == 9
    assert len(os.listdir(os.path.join(out_dir, "samples"))) == 2
    jm, tree = lumina[0], lumina[2]["dit"]
    saved, _ = load_lora_file(os.path.join(out_dir, f"{name}.safetensors"),
                              module_name=Lumina2Model.lora_module_name)
    from safetensors import safe_open

    with safe_open(os.path.join(out_dir, f"{name}.safetensors"), framework="numpy") as f:
        keys = {k: f.get_tensor(k).shape for k in f.keys()}
    assert keys == _jax_job_keys(jm, tree, 16)
    assert len(saved) == len(keys) // 2 and "layers.0.attn.to_out.0" in saved
