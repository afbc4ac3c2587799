"""The port's hidream slice against the JAX package on the CPU at tiny f32
sizes: the CLIP ``gelu`` (OpenCLIP-G), the Llama encoder, weight-only
quantization, the HiDream model's predict (dense and grouped MoE dispatch),
its LoRA targets, generate and one LoRA train step, and the train job with a
quantized base. Weights come from the JAX package's own init and go through
``io/from_jax``; inputs and noise are made with numpy and handed to both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.adapters import quantize as jquant
from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.generation import generate_flux as jax_generate_flux
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.models.hidream_model import HiDreamModel as JHiDreamModel
from ai_toolkit_tpu.models.text_encoders import clip as jclip
from ai_toolkit_tpu.models.text_encoders import llm as jllm
from ai_toolkit_tpu.ops.rope import image_position_ids
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.adapters import quantize as tquant
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.generation import generate_flux
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.models.hidream_model import HiDreamModel, hidream_dit_config
from ai_toolkit_tpu_torch.models.text_encoders import clip as tclip
from ai_toolkit_tpu_torch.models.text_encoders import llm as tllm
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss

torch.set_num_threads(1)
TINY = {"name_or_path": "", "arch": "hidream", "model_kwargs": {"size": "tiny"}}


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():  # the JAX grouped dispatch's Pallas kernels
        yield


def _jax_model(dispatch="dense"):
    model = JHiDreamModel(JModelConfig.from_dict(dict(TINY)))
    if dispatch != "dense":  # the JAX tiny size is always dense; its FluxConfig takes either
        model.dit_config = dataclasses.replace(model.dit_config, moe_dispatch=dispatch)
        model.dit = jdit.FluxDiT(model.dit_config)
    return model


@pytest.fixture(scope="module")
def jax_vars():
    # jitted: one compile instead of one per initializer
    return jax.tree.map(np.asarray, jax.jit(_jax_model().init_variables)(jax.random.key(0)))


def _port(jax_vars, dispatch="dense"):
    cfg = dict(TINY, model_kwargs={"size": "tiny", "moe_dispatch": dispatch})
    model = HiDreamModel(ModelConfig.from_dict(cfg), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.hidream_model_state(jax_vars))
    return model, variables


# ---- text encoders ----

def test_clip_gelu_is_the_tanh_approximation(monkeypatch):
    """OpenCLIP-G's ``gelu`` is jax.nn.gelu's tanh approximation; the exact erf
    the port used before differs from the JAX layer by far more than the f32
    tolerance (1e-5) at this size."""
    jcfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(), hidden_act="gelu")
    ids = np.random.default_rng(0).integers(0, 999, (2, 12)).astype(np.int32)
    ids[:, 9] = jcfg.eos_token_id
    params = jax.tree.map(np.asarray, jclip.CLIPTextModel(jcfg).init(jax.random.key(1), jnp.asarray(ids))["params"])
    ref = jclip.CLIPTextModel(jcfg).apply({"params": params}, jnp.asarray(ids))

    def port_out():
        cfg = dataclasses.replace(tclip.CLIPTextConfig.tiny(), hidden_act="gelu")
        mod = tclip.CLIPTextModel(cfg)
        mod.load_state_dict(from_jax.clip_state_dict(params))
        with torch.inference_mode():
            return mod(torch.from_numpy(ids).long())

    out = port_out()
    for key in ("last_hidden_state", "pooled_output"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)
    monkeypatch.setattr(tclip, "_act", lambda name: torch.nn.functional.gelu)  # the erf form
    erf = port_out()["last_hidden_state"].numpy()
    assert np.abs(erf - np.asarray(ref["last_hidden_state"])).max() > 1e-4  # 7.6e-4 at this seed


def test_open_clip_g_config_matches_jax():
    ours, ref = tclip.CLIPTextConfig.open_clip_g(), jclip.CLIPTextConfig.open_clip_g()
    for f in dataclasses.fields(ref):
        if f.name != "dtype":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("masked", [False, True])
def test_llm_encoder_matches_jax(masked):
    """Llama tiny (GQA 4/2, causal, optional padding mask) in f32: summation order only."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1000, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    jmod = jllm.LLMEncoder(jllm.LLMConfig.tiny())
    params = jmod.init(jax.random.key(3), jnp.asarray(ids))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    mod = tllm.LLMEncoder(tllm.LLMConfig.tiny())
    mod.load_state_dict(from_jax.llm_state_dict(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        out = mod(torch.from_numpy(ids).long(), torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flag", [{"qkv_bias": True}, {"post_norms": True}, {"attn_softcap": 50.0},
                                  {"rope_interleaved": True}, {"collect_layers": (0,)}])
def test_llm_other_families_raise(flag):
    with pytest.raises(NotImplementedError, match="slice G"):
        tllm.LLMEncoder(tllm.LLMConfig.tiny(**flag))


def test_llama31_8b_config_matches_jax():
    ours, ref = tllm.LLMConfig.llama31_8b(), jllm.LLMConfig.llama31_8b()
    for f in dataclasses.fields(ours):
        if f.name != "dtype":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name


# ---- quantization ----

def _jax_quant_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if "qvalue" in v:
            out[p] = v
        else:
            out.update(_jax_quant_paths(v, p))
    return out


@pytest.mark.parametrize("qtype", ["qfloat8", "qint8"])
@pytest.mark.parametrize("min_size", [2**16, 2**10])
def test_quantize_params_matches_jax(jax_vars, qtype, min_size):
    """The same weights are selected (at 2**16 only the tiny expert banks; at
    2**10 the Linears too, minus the excluded modulations, embedders and final
    layer) and their values and scales are equal bit for bit."""
    _, jquant_tree = jquant.quantize_params(jax_vars["dit"], min_size=min_size, qtype=qtype)
    ref = {from_jax._flux_module(p): v for p, v in _jax_quant_paths(jquant_tree).items()}
    _, variables = _port(jax_vars)
    names = tquant.quantize_params(variables["dit"], min_size=min_size, qtype=qtype)
    assert sorted(names) == sorted(ref) and names
    assert any(".experts." in n for n in names)
    if min_size < 2**16:
        assert "double_blocks.0.img_attn.qkv" in names
        assert not any(s in n for n in names for s in ("_mod.", "modulation.", "final_", "_in."))
    mods = dict(variables["dit"].named_modules())
    for name in names:
        q, s = mods[name].qvalue, mods[name].qscale
        if q.dim() == 2:  # a Linear keeps the torch layout [out, in]
            q, s = q.t(), s.t()
        raw_t, raw_np = (torch.uint8, np.uint8) if qtype == "qfloat8" else (torch.int8, np.int8)
        np.testing.assert_array_equal(q.contiguous().view(raw_t).numpy(),
                                      np.asarray(ref[name]["qvalue"]).view(raw_np), err_msg=name)
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref[name]["qscale"]), err_msg=name)


def test_quantized_predict_matches_jax(jax_vars):
    """predict on a qfloat8 base (min_size 2**10: banks and Linears) against the
    JAX model with the same ``quant`` collection: the dequantization next to
    the product is the JAX one."""
    rest, quant = jquant.quantize_params(jax_vars["dit"], min_size=2**10, qtype="qfloat8")
    jmodel = _jax_model()
    model, variables = _port(jax_vars)
    tquant.quantize_params(variables["dit"], min_size=2**10, qtype="qfloat8")
    inp = _inputs(model)
    ref = jax.jit(jmodel.predict)({"dit": rest, "quant": quant}, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
                                  _jcond(jmodel, inp))
    with torch.inference_mode():
        out = model.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                            _tcond(model, inp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_unported_qtypes_raise():
    with pytest.raises(NotImplementedError, match="slice G"):
        tquant.get_quantize_kernel("uint4")
    with pytest.raises(ValueError):
        tquant.get_quantize_kernel("qint3")


# ---- the model ----

def _inputs(model, b=2, hh=8, ww=8, seed=11):
    rng = np.random.default_rng(seed)
    cfg = model.dit_config
    n_txt = 2 * model.max_txt_len
    return {
        "x": rng.standard_normal((b, hh, ww, cfg.in_channels // 4), dtype=np.float32),
        "noise": rng.standard_normal((b, hh, ww, cfg.in_channels // 4), dtype=np.float32),
        "t": np.asarray([0.3, 0.85], np.float32)[:b],
        "txt": rng.standard_normal((b, n_txt, cfg.context_dim), dtype=np.float32),
        "y": rng.standard_normal((b, cfg.vec_dim), dtype=np.float32),
        "hw": (hh, ww),
    }


def _jcond(jmodel, inp):
    return {"txt": jnp.asarray(inp["txt"]), "y": jnp.asarray(inp["y"]),
            "pe": jmodel.rope_table(*inp["hw"], inp["txt"].shape[1])}


def _tcond(model, inp):
    return {"txt": torch.from_numpy(inp["txt"]), "y": torch.from_numpy(inp["y"]),
            "pe": model.rope_table(*inp["hw"], inp["txt"].shape[1])}


@pytest.mark.parametrize("dispatch", ["dense", "grouped"])
def test_predict_matches_jax(jax_vars, dispatch):
    """Patch-major packing, across-head QK norms, the txt SwiGLU and the MoE
    FFN of both blocks; f32 through two blocks: summation order only."""
    jmodel = _jax_model(dispatch)
    model, variables = _port(jax_vars, dispatch)
    inp = _inputs(model)
    ref = jax.jit(jmodel.predict)({"dit": jax_vars["dit"]}, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
                                  _jcond(jmodel, inp))
    with torch.inference_mode():
        out = model.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                            _tcond(model, inp))
    assert out.shape == inp["x"].shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_encode_prompt_matches_jax(jax_vars):
    jmodel = _jax_model()
    model, variables = _port(jax_vars)
    prompts = ["a watercolor fox", "macro photo of a dew drop on a leaf"]
    ref = jmodel.encode_prompt(jax_vars, prompts)
    with torch.inference_mode():
        out = model.encode_prompt(variables, prompts)
    assert out["txt"].shape == (2, 2 * model.max_txt_len, model.dit_config.context_dim)
    for key in ("txt", "y"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-5, rtol=1e-5)


def test_lora_targets_and_count_match_jax(jax_vars):
    """Attention qkv/proj only: the same modules and parameter count as the
    JAX builder at the tiny size; at full size 128 modules, 15,728,640 factor
    elements at rank 16 (built on the meta device: no memory)."""
    jmodel = _jax_model()
    model, variables = _port(jax_vars)
    jtree = jlora.build_lora(jax_vars["dit"], jlora.LoRASpec(rank=4, alpha=4.0,
                                                             target_patterns=jmodel.lora_targets()),
                             jax.random.key(0))
    ported = tlora.build_lora(variables["dit"], tlora.LoRASpec(rank=4, alpha=4.0,
                                                               target_patterns=model.lora_targets()),
                              torch.Generator().manual_seed(0))
    assert sorted(from_jax.flux_lora_tree(jax.tree.map(np.asarray, jtree))) == sorted(ported)
    assert len(ported) == 6 and tlora.count_lora_params(ported) == jlora.count_lora_params(jtree)

    full = tdit.FluxDiT(hidream_dit_config(), device="meta")
    big = tlora.build_lora(full, tlora.LoRASpec(rank=16, alpha=16.0, target_patterns=model.lora_targets(),
                                                init_std=0.0), torch.Generator())
    assert len(big) == 128
    assert sum(m.a.numel() + m.b.numel() for m in big.values()) == 15_728_640


def test_generate_matches_jax(jax_vars):
    """uint8 images within 1 (f32 both sides; rounding to uint8 can flip on
    summation-order differences); no guidance embed, no CFG pass."""
    model, variables = _port(jax_vars)
    gen = GenerateImageConfig(prompt="a watercolor fox in a misty forest", width=32, height=32,
                              seed=7, guidance_scale=4.0, sample_steps=2, sampler="flowmatch")
    jgen = JGenerateImageConfig(prompt=gen.prompt, width=32, height=32, seed=7, guidance_scale=4.0,
                                sample_steps=2, sampler="flowmatch")
    ref = np.asarray(jax_generate_flux(_jax_model(), jax_vars, jgen))
    h, w, c = model.latent_shape(32, 32)
    noise = np.asarray(jax.random.normal(jax.random.key(7), (1, h, w, c), jnp.float32))
    ours = generate_flux(model, variables, gen, noise=noise)
    assert ours.shape == ref.shape == (32, 32, 3)
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    assert len(np.unique(ours)) > 8


@pytest.mark.parametrize("dispatch", ["dense", "grouped"])
def test_train_step_loss_and_lora_grads_match_jax(jax_vars, dispatch):
    """One step's loss and every LoRA a/b/scale gradient against
    jax.value_and_grad of the JAX predict with the lora collection; b is
    non-zero, else the gradient of a is zero. In grouped mode the gradient
    reaches the first block's LoRA through the MoE dx of both blocks."""
    jmodel = _jax_model(dispatch)
    model, variables = _port(jax_vars, dispatch)
    lora = tlora.build_lora(variables["dit"], tlora.LoRASpec(rank=4, alpha=4.0,
                                                             target_patterns=model.lora_targets()),
                            torch.Generator().manual_seed(3))
    gb = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    jtree = jlora.build_lora(jax_vars["dit"], jlora.LoRASpec(rank=4, alpha=4.0,
                                                             target_patterns=jmodel.lora_targets()),
                             jax.random.key(0))
    paths = {}

    def fill(node, prefix=""):
        for k, v in node.items():
            p = f"{prefix}/{k}" if prefix else k
            if "a" in v:
                name = from_jax._flux_module(p)
                paths[name] = p
                node[k] = {leaf: jnp.asarray(getattr(lora[name], leaf).detach().numpy())
                           for leaf in ("a", "b", "scale")}
            else:
                fill(v, p)

    jtree = jax.tree.map(lambda x: x, jtree)
    fill(jtree)
    assert sorted(paths) == sorted(lora)
    inp = _inputs(model)
    x0, noise, t = (jnp.asarray(inp[k]) for k in ("x", "noise", "t"))
    sched, jcond = JSchedule(), _jcond(jmodel, inp)

    def jloss(lora_tree):
        pred = jmodel.predict({"dit": jax_vars["dit"], "lora": lora_tree},
                              sched.add_noise(x0, noise, t), t, jcond)
        return jcompute_loss(pred, sched.target(x0, noise, t))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jtree)
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": _tcond(model, inp)}
    loss, _ = train_loss(lambda noisy, tt, cond: model.predict(variables, noisy, tt, cond),
                         FlowMatchSchedule(), TrainStepConfig(), batch,
                         torch.from_numpy(inp["noise"]), torch.from_numpy(inp["t"]))
    names = [(name, leaf) for name in lora for leaf in ("a", "b", "scale")]
    grads = torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for (name, leaf), g in zip(names, grads):
        node = ref_grads
        for part in paths[name].split("/"):
            node = node[part]
        ref = np.asarray(node[leaf])
        assert np.abs(ref).max() > 0, f"{name}.{leaf}: zero reference gradient"
        # f32 through two blocks and the loss: summation order only
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=f"{name}.{leaf}")


# ---- the jobs ----

def _dataset(folder, n=2, size=32):
    from PIL import Image

    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(folder / f"im_{i}.png")
        (folder / f"im_{i}.txt").write_text(f"photo of thing {i}")
    return str(folder)


def _train_job(tmp_path, model, steps=2):
    return {"job": "extension", "config": {"name": "hidream_tiny", "process": [{
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"),
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "save": {"dtype": "float16", "save_every": 250},
        "datasets": [{"folder_path": _dataset(tmp_path / "data"), "caption_ext": "txt",
                      "cache_latents_to_disk": False, "resolution": [32]}],
        "train": {"batch_size": 1, "steps": steps, "gradient_checkpointing": True,
                  "noise_scheduler": "flowmatch", "timestep_type": "flux_shift",
                  "optimizer": "adamw8bit", "lr": 1e-4, "ema_config": {"use_ema": True},
                  "dtype": "float32", "seed": 42},
        "model": model}]}}


def test_train_job_on_a_quantized_base(tmp_path):
    """The LoRA job with ``quantize: true`` (qfloat8) and the grouped dispatch
    runs on the CPU: finite losses, a LoRA of the 6 attention projections."""
    from ai_toolkit_tpu_torch.io.lora_file import load_lora_file

    model = {**TINY, "model_kwargs": {"size": "tiny", "moe_dispatch": "grouped"},
             "quantize": True, "qtype": "qfloat8"}
    (result,) = run_job(_train_job(tmp_path, model), device="cpu")
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["lora_modules"] == 6
    tree, _ = load_lora_file(result["save_path"])
    assert sorted(tree) == sorted(n for n in tree if n.endswith((".qkv", ".proj")))


def test_unported_hidream_branches_raise(tmp_path):
    for i, model in enumerate(({**TINY, "quantize": True, "qtype": "uint4"}, {**TINY, "quantize_te": True},
                               {**TINY, "arch": "hidream_e1"}, {**TINY, "model_kwargs": {"size": "dev"}})):
        with pytest.raises(NotImplementedError):
            run_job(_train_job(tmp_path / str(i), model), device="cpu")
