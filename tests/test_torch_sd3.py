"""SD3 / SD3.5 on the port's FluxDiT against the JAX package on the CPU at tiny
f32 sizes: the configs the three archs build at every size, each SD3 flag of
``FluxDiT`` alone (QK norm off and on, a dual-attention block, the
context_pre_only final block, the learned position table; a scanned JAX
tree), ``SD3Model.encode_prompt`` and ``predict``, the loader on a tiny
diffusers directory written from the JAX tree by JAX ``sd3_flat`` (and on
one transformer file whose position table is centre-cropped), one LoRA
train step's loss and gradients through JAX ``train/step.make_train_step``
with the port's draws injected, and the LoRA file's keys against the JAX
job's, unrolled and scanned (the dual and final blocks included).

Weights come from the JAX init (norm scales moved away from 1, so a misplaced
scale shows) and reach the port through ``io/from_jax.py``; inputs are made
with numpy. Tolerance: f32 on both sides, ``rtol`` 1e-5 and an ``atol`` of
1e-4 of the largest reference value (of a gradient: over every trained
tensor): the 256-wide timestep embedding takes ``exp`` of its frequencies,
where XLA's and PyTorch's CPU ``exp`` differ by one ulp at some entries, and
t·1000 moves a sinusoid by up to 1.2e-4 (the flux family's finding)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_np
from safetensors.torch import save_file

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.sd3_import import load_sd3_checkpoint, sd3_flat
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.models.sd3_model import SD3Model as JSD3Model
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io.lora_file import flatten_lora, unflatten_lora
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.models.sd3_model import SD3Model, sd3_lora_key, sd3_module_name
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("sd3", "sd35", "sd35_large")
DUAL = dict(dual_attention_layers=1, depth_double=3, qk_norm=True)  # dual, double, final at tiny width


def _close(ours, ref, what="", scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=1e-4 * scale, err_msg=what)


def _cfg(arch="sd35", size="tiny", path=""):
    return {"name_or_path": path, "arch": arch, "model_kwargs": {"size": size}}


def _perturbed(tree, seed=0):
    """Norm scales and biases (1-D leaves) moved off their init values."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
                        if np.ndim(a) == 1 else np.asarray(a), tree)


def _models(arch="sd35", path="", **dit_over):
    """The JAX and the port model at ``size: tiny``, both DiT configs
    replaced by ``dit_over``."""
    jm = JSD3Model(JModelConfig.from_dict(_cfg(arch, path=path)))
    tm = SD3Model(ModelConfig.from_dict(_cfg(arch, path=path)), device="cpu")
    if dit_over:
        jm.dit_config = dataclasses.replace(jm.dit_config, **dit_over)
        jm.dit = jdit.FluxDiT(jm.dit_config)
        tm.dit_config = dataclasses.replace(tm.dit_config, **dit_over)
    return jm, tm


def _jax_variables(jm, seed=1):
    from test_torch_lumina2 import filled  # (that file imports this one)

    v = filled(jax.eval_shape(jm.init_variables, jax.random.key(seed)), seed)  # traced, not compiled
    v["dit"] = _perturbed(v["dit"], seed)
    return v


@pytest.fixture(scope="module")
def sd35_vars():
    """The JAX variables of sd3.5 tiny with the dual block (one init for the
    module's tests)."""
    jm, _ = _models("sd35", **DUAL)
    return _jax_variables(jm)


def _port_variables(tm, jvars):
    variables = tm.init_variables(torch.Generator().manual_seed(0))
    tm.load_state_dicts(variables, from_jax.sd3_model_state(jvars))
    return variables


def _inputs(cfg, b=2, hh=8, ww=8, n_txt=7, seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((b, hh, ww, cfg.in_channels // 4), dtype=np.float32),
            "t": np.asarray([0.3, 0.85], np.float32)[:b],
            "txt": rng.standard_normal((b, n_txt, cfg.context_dim), dtype=np.float32),
            "y": rng.standard_normal((b, cfg.vec_dim), dtype=np.float32), "hw": (hh, ww, n_txt)}


def _conds(jm, tm, inp):
    hh, ww, n_txt = inp["hw"]
    j = {"txt": jnp.asarray(inp["txt"]), "y": jnp.asarray(inp["y"]), "pe": jm.rope_table(hh, ww, n_txt)}
    t = {"txt": torch.from_numpy(inp["txt"]), "y": torch.from_numpy(inp["y"]), "pe": tm.rope_table(hh, ww, n_txt)}
    return j, t


@pytest.mark.parametrize("size", ["tiny", "medium", "35", "large"])
@pytest.mark.parametrize("arch", ARCHS)
def test_archs_build_the_jax_configs(arch, size):
    """Every field the two DiT configs share is equal (sd3: no QK norm;
    sd3.5-medium: 13 dual blocks and the 384 table; sd3.5-large: 38 x 64 heads,
    the 192 table), and so are the VAE's (16 channels, 1.5305 / 0.0609, no
    quant convs), the encoders' widths and the T5 length."""
    ours = SD3Model(ModelConfig.from_dict(_cfg(arch, size)), device="meta")
    ref = JSD3Model(JModelConfig.from_dict(_cfg(arch, size)))
    for a, b in ((ours.dit_config, ref.dit_config), (ours.vae_config, ref.vae_config),
                 (ours.clip_config, ref.clip_config), (ours.clip2_config, ref.clip2_config)):
        # checkpoint_policy is the port's own FluxConfig field (JAX's is remat_policy)
        shared = [f.name for f in dataclasses.fields(a) if f.name not in ("dtype", "checkpoint_policy")]
        assert {f: getattr(a, f) for f in shared} == {f: getattr(b, f) for f in shared}
    assert ours.t5_config.d_model == ref.t5_config.d_model and ours.max_txt_len == ref.max_txt_len
    cfg = ours.dit_config
    if size != "tiny":
        large = arch == "sd35_large" or size == "large"
        assert (cfg.num_heads, cfg.head_dim, cfg.depth_double) == ((38, 64, 38) if large else (24, 64, 24))
        assert cfg.final_context_pre_only and cfg.depth_single == 0 and cfg.vec_dim == 2048


FLAGS = {
    "qk_norm_off": ({}, {}),
    "qk_norm_on": ({"qk_norm": True}, {}),
    "dual_attention": (DUAL, {}),
    "no_final_block_no_table": ({"final_context_pre_only": False, "pos_embed_max_size": 0}, {}),
    "dual_scanned": ({**DUAL, "dual_attention_layers": 2, "depth_double": 5}, {"scan_blocks": True}),
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_dit_flags_match_jax(flag):
    """``FluxDiT``'s forward with each SD3 flag alone on the sd3 tiny base
    (no QK norm, the final block, the 32 x 32 table at the centre-cropped
    rows of an 8 x 8 latent), against the JAX DiT; the scanned case maps a
    JAX tree with ``dual_blocks`` / ``double_blocks`` stacks."""
    over, jax_only = FLAGS[flag]
    jm, tm = _models("sd3", **over)
    jcfg = dataclasses.replace(jm.dit_config, **jax_only)
    inp = _inputs(tm.dit_config)
    img = np.asarray(jdit.pack_latents(jnp.asarray(inp["x"])))
    jc, tc = _conds(jm, tm, inp)
    pos = np.asarray(jm._pos_ids(8, 8)) if jcfg.pos_embed_max_size else None
    jd = jdit.FluxDiT(jcfg)
    args = (img, jc["txt"], inp["t"], jc["y"], jc["pe"])
    tree = _perturbed(seeded_init(jd.init, jax.random.key(2), *args)["params"], 2)
    assert ("dual_blocks" in tree) == (flag == "dual_scanned")
    ref = jax.jit(lambda p, *a: jd.apply({"params": p}, *a, pos_ids=pos))(tree, *args)
    dit = tdit.FluxDiT(tm.dit_config)
    dit.load_state_dict(from_jax.flux_dit_state_dict(tree))
    with torch.inference_mode():
        out = dit(torch.from_numpy(img), tc["txt"], torch.from_numpy(inp["t"]), tc["y"], tc["pe"],
                  pos_ids=None if pos is None else torch.from_numpy(pos))
    _close(out.numpy(), ref, flag)
    names = [n for n, _ in dit.named_modules()]
    assert ("dual_blocks.0.img2_attn.qkv" in names) == ("dual" in flag)
    assert ("final_block.txt_mod" in names) == tm.dit_config.final_context_pre_only
    assert ("double_blocks.0.img_attn.norm.query_norm" in names) == tm.dit_config.qk_norm


def test_predict_and_encode_prompt_match_jax(sd35_vars):
    """``SD3Model`` at sd3.5 tiny with the dual block: encode_prompt (CLIP-L and
    OpenCLIP-G penultimate states cut to the context width, then T5; the
    pooled outputs cut to vec_dim) and predict (patch-major packing, the
    identity rope, the position table's rows) on the JAX variables."""
    jm, tm = _models("sd35", **DUAL)
    jvars = sd35_vars
    variables = _port_variables(tm, jvars)
    prompts = ["a photo of a red fox", "macro photo"]
    jcond = jm.encode_prompt(jvars, prompts)
    with torch.inference_mode():
        cond = tm.encode_prompt(variables, prompts)
    assert cond["txt"].shape == (2, 77 + 16, 64) and cond["y"].shape == (2, 64)
    _close(cond["txt"].numpy(), jcond["txt"], "txt")
    _close(cond["y"].numpy(), jcond["y"], "y")
    inp = _inputs(tm.dit_config, n_txt=93)
    inp["txt"] = jcond_txt = np.asarray(jcond["txt"])
    jc, tc = _conds(jm, tm, inp)
    ref = jax.jit(jm.predict)(jvars, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jc)
    with torch.inference_mode():
        out = tm.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), tc)
    assert out.shape == inp["x"].shape and jcond_txt.shape[1] == 93
    _close(out.numpy(), ref, "predict")


def _write_diffusers(root, tm, jvars, variables, transformer):
    """``transformer`` (a flat diffusers dict) under ``transformer/``, and the
    port's VAE, CLIP-L, OpenCLIP-G and T5 states under their HF subdirs."""
    os.makedirs(os.path.join(root, "transformer"), exist_ok=True)
    save_np({k: np.ascontiguousarray(v) for k, v in transformer.items()},
            os.path.join(root, "transformer", "diffusion_pytorch_model.safetensors"))
    for sub, name in (("vae", "vae"), ("text_encoder", "clip"), ("text_encoder_2", "clip2"),
                      ("text_encoder_3", "t5")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        sd = {k: v.contiguous() for k, v in variables[name].state_dict().items()}
        if name == "t5":
            sd.pop("encoder.embed_tokens.weight")  # tied to shared.weight, as transformers writes T5
        save_file(sd, os.path.join(root, sub, "model.safetensors"))


@pytest.mark.parametrize("layout", ["dir", "file_cropped"])
def test_loader_reads_the_jax_export(layout, tmp_path, capsys, sd35_vars):
    """JAX ``sd3_flat`` of a tiny sd3.5 tree with a dual, a double and the
    final block (fused q/k/v split, the conv patch embed, ``norm_out`` in
    diffusers' (scale, shift) order), written as a diffusers directory with
    the companions, or as one transformer file whose table is 34 x 34: the
    port's strict loader gives the JAX tree's tensors bit for bit (the table
    centre-cropped to 32 x 32, as JAX crops it), and so does JAX
    ``load_sd3_checkpoint``. A single file leaves the companions seeded."""
    root = str(tmp_path / "sd35")
    jm, tm = _models("sd35", **DUAL)
    jvars = sd35_vars
    variables = _port_variables(tm, jvars)
    flat = sd3_flat(jvars["dit"], jm.dit_config)
    assert "transformer_blocks.0.attn2.to_q.weight" in flat and "transformer_blocks.2.attn.to_add_out.weight" not in flat
    if layout == "dir":
        _write_diffusers(root, tm, jvars, variables, flat)
    else:
        tab = np.asarray(jvars["dit"]["pos_embed"]).reshape(32, 32, -1)
        big = np.random.default_rng(4).standard_normal((34, 34, tab.shape[-1])).astype(np.float32)
        big[1:33, 1:33] = tab
        flat["pos_embed.pos_embed"] = big.reshape(1, 34 * 34, -1)
        root = str(tmp_path / "sd35.safetensors")
        save_np({k: np.ascontiguousarray(v) for k, v in flat.items()}, root)
    jm2, tm2 = _models("sd35", path=root, **DUAL)
    jm2.init_variables = lambda rng: jax.tree.map(np.copy, jvars)
    jtree = load_sd3_checkpoint(root, jm2)["dit"]
    loaded = tm2.load_variables(torch.Generator().manual_seed(0))
    out = capsys.readouterr().out
    ref = from_jax.flux_dit_state_dict(jvars["dit"])
    got = loaded["dit"].state_dict()
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    for k, v in from_jax.flux_dit_state_dict(jax.tree.map(np.asarray, jtree)).items():
        assert torch.equal(v, ref[k]), k
    if layout == "dir":
        for name in ("vae", "clip", "clip2", "t5"):
            for k, v in variables[name].state_dict().items():
                assert torch.equal(loaded[name].state_dict()[k], v), (name, k)
    else:
        assert "centre-cropped to 32x32" in out and "keep their seeded init" in out


def _lora_pair(dit, tree, jm, rank=4, alpha=8.0, targets=None, module_of=None):
    """A LoRA on the port's DiT (b non-zero) and the same factors as the JAX
    ``lora`` collection; {port name: JAX path}. ``targets``: the port's
    target patterns (flux's by default); ``module_of``: JAX module path ->
    port module name (flux's by default)."""
    targets = tdit.flux_lora_targets() if targets is None else targets
    module_of = from_jax._flux_module if module_of is None else module_of
    lora = tlora.build_lora(dit, tlora.LoRASpec(rank=rank, alpha=alpha, target_patterns=targets),
                            torch.Generator().manual_seed(3))
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
    jtree = jax.eval_shape(lambda: jlora.build_lora(
        tree, jlora.LoRASpec(rank=rank, alpha=alpha, target_patterns=jm.lora_targets()), jax.random.key(0)))
    jtree = jax.tree.map(lambda x: x, jtree)
    paths = {}

    def fill(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if "a" in v:
                name = module_of(path)
                paths[name] = path
                node[k] = {leaf: np.array(getattr(lora[name], leaf).detach().numpy()) for leaf in ("a", "b", "scale")}
            else:
                fill(v, path)

    fill(jtree)
    assert sorted(paths) == sorted(lora)
    return lora, jtree, paths


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def lora_step_matches_jax(jm, tm, jvars, variables, inp, jc, tc, timestep_type, monkeypatch, optimizer="adamw8bit",
                          **pair):
    """One LoRA step (``optimizer``, adamw8bit by default; clipping at 1) of the port's
    ``make_train_step`` against JAX ``train/step.make_train_step`` with the
    port's draws (t, then the noise) injected: the loss, the grad norm and
    every LoRA a / b / scale gradient (captured where each step hands them to
    its optimizer); ``pair``: :func:`_lora_pair`'s ``targets`` and
    ``module_of``. Returns the port's LoRA names and those whose reference
    gradient is zero (their output reaches no loss: the last double block's
    text stream when no final block follows)."""
    lora, jtree, paths = _lora_pair(variables["dit"], jvars["dit"], jm, **pair)
    seq = inp["x"].shape[1] * inp["x"].shape[2] // 4
    names = [f"{n}.{leaf}" for n in lora for leaf in ("a", "b", "scale")]
    trainable = {k: getattr(lora[k.rsplit(".", 1)[0]], k.rsplit(".", 1)[1]) for k in names}
    state = TrainState(trainable, get_optimizer(optimizer, list(trainable.values()), 1e-3, max_grad_norm=1.0))
    grads_seen = {}
    real_step = state.optimizer.step
    state.optimizer.step = lambda grads: grads_seen.update(zip(names, (g.clone() for g in grads))) or real_step(grads)
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": tc, "image_seq_len": seq, "loss_multiplier": torch.ones(2)}
    metrics = make_train_step(lambda x, t, c: tm.predict(variables, x, t, c), FlowMatchSchedule(),
                              TrainStepConfig(timestep_type=timestep_type))(state, [batch], torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)  # the draws the port's step made, in its order
    t = FlowMatchSchedule().sample_timesteps(g, 2, timestep_type, seq, 1.0)
    noise = torch.randn(inp["x"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jstate = JTrainState.create(jvars, {"lora": jtree}, jget_optimizer(optimizer, 1e-3, max_grad_norm=1.0))
    jtrain = jstep.make_train_step(jm.predict, Injected(), jstep.TrainStepConfig(timestep_type=timestep_type))
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        seen = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: seen.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, b, jax.random.key(0), image_seq_len=seq)
        return m, seen[0]

    jbatch = {"latents": jnp.asarray(inp["x"]), "cond": jc, "loss_multiplier": jnp.ones(2)}
    jmetrics, jgrads = jax.jit(run)(jstate, jbatch)
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]), rtol=1e-5)
    ref = {k: np.asarray(_leaf(jgrads["lora"], paths[k.rsplit(".", 1)[0]])[k.rsplit(".", 1)[1]]) for k in names}
    gmax = max(float(np.abs(v).max()) for v in ref.values())
    for k in names:
        _close(grads_seen[k].numpy(), ref[k], k, scale=gmax)
    return list(lora), sorted({k.rsplit(".", 1)[0] for k in names if not np.abs(ref[k]).max() > 0})


def test_lora_step_matches_jax(monkeypatch, sd35_vars):
    """sd3.5 tiny with the dual block, ``timestep_type: shift`` (the sd35_large
    file's): loss and gradients, the LoRA on the dual block's img2 attention
    and on the final block's txt_mod and text q/k/v too."""
    jm, tm = _models("sd35", **DUAL)
    jvars = sd35_vars
    variables = _port_variables(tm, jvars)
    inp = _inputs(tm.dit_config)
    jc, tc = _conds(jm, tm, inp)
    names, zero = lora_step_matches_jax(jm, tm, jvars, variables, inp, jc, tc, "shift", monkeypatch)
    assert not zero, zero
    assert {"dual_blocks.0.img2_attn.qkv", "final_block.txt_mod", "final_block.txt_attn.qkv"} <= set(names)
    assert "final_block.txt_attn.proj" not in names


def _jax_job_keys(jm, tree, rank, fmt="peft"):
    """The keys and shapes of the LoRA file the JAX job writes for ``tree``
    (JAX ``build_lora``, the job's key map)."""
    shapes = jax.eval_shape(lambda: jlora.build_lora(
        tree, jlora.LoRASpec(rank=rank, alpha=float(rank), target_patterns=jm.lora_targets()), jax.random.key(0)))
    jtree = jax.tree.map(lambda s: np.ones(s.shape, s.dtype), shapes)
    flat = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jm, jtree), fmt=fmt)
    return {k: v.shape for k, v in flat.items()}


def test_scanned_lora_keys_match_the_jax_job():
    """At every size but tiny the JAX tree is scanned: the file names the
    double blocks by their BFL names per layer, and the dual and final blocks
    by their JAX paths (``dual_blocks.block.img2_qkv.1``,
    ``final_block.txt_mod``). The port's ``lora_key`` writes those keys, and
    ``lora_module_name`` reads them back to its modules."""
    over = {**DUAL, "dual_attention_layers": 2, "depth_double": 5}
    jm, tm = _models("sd35", **over)
    jcfg = dataclasses.replace(jm.dit_config, scan_blocks=True)
    jm.dit = jdit.FluxDiT(jcfg)
    tree = jax.eval_shape(jm.init_variables, jax.random.key(0))["dit"]
    assert "dual_blocks" in tree and "double_blocks" in tree
    ref = _jax_job_keys(jm, tree, 4)
    dit = tdit.FluxDiT(tm.dit_config, device="meta")
    lora = tlora.build_lora(dit, tlora.LoRASpec(rank=4, alpha=4.0, target_patterns=tm.lora_targets()), None)
    tree = {n: {"a": torch.zeros(m.a.shape), "b": torch.zeros(m.b.shape), "scale": torch.tensor(1.0)}
            for n, m in lora.items()}
    flat = flatten_lora(tree, key_map=lambda n: sd3_lora_key(n, scanned=True))
    assert {k: v.shape for k, v in flat.items()} == ref
    assert "transformer.dual_blocks.block.img2_qkv.1.lora_A.weight" in ref
    assert "transformer.final_block.txt_mod.lora_B.weight" in ref
    assert sorted(unflatten_lora(flat, module_name=sd3_module_name)) == sorted(lora)
    for name in lora:
        assert sd3_module_name(sd3_lora_key(name, scanned=False)) == name


def _shipped(root, steps=2):
    """configs/examples/train_lora_sd35_large_tpu.yaml as written but for its
    paths, its steps and, for the CPU, ``size: tiny`` with its resolutions
    and sample size cut to 32 / 48 / 64."""
    from PIL import Image

    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_lora_sd35_large_tpu.yaml"))
    proc = raw["config"]["process"][0]
    imgs = os.path.join(root, "imgs")
    os.makedirs(imgs, exist_ok=True)
    for i, (w, h) in enumerate(((64, 48), (48, 64), (64, 64))):
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(imgs, f"im_{i}.png"))
        with open(os.path.join(imgs, f"im_{i}.txt"), "w") as f:
            f.write(f"photo of thing {i}")
    proc["training_folder"] = os.path.join(root, "out")
    proc["datasets"][0].update(folder_path=imgs, resolution=[32, 48, 64])
    proc["train"]["steps"] = steps
    proc["model"].update(name_or_path="", model_kwargs={"size": "tiny"})
    proc["sample"].update(width=64, height=64)
    return raw


def test_shipped_file_runs_and_saves_the_jax_keys(tmp_path):
    """The sd35_large file (quantize: true, adamw8bit, EMA, ``shift``, bf16,
    checkpointing, the disk cache, three resolutions, a first and a final
    sample at 20 steps) runs to its end with finite losses, every item in the
    disk cache, both samples and a LoRA file with the JAX job's keys."""
    from safetensors import safe_open

    (result,) = run_job(_shipped(str(tmp_path)), device="cpu")
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["latent_cache"]["items"] == 9 and result["latent_cache"]["encoded"] == 9
    assert [(s["step"], s["index"]) for s in result["samples"]] == [(0, 0), (2, 0)]
    jm = JSD3Model(JModelConfig.from_dict(_cfg("sd35_large")))
    with safe_open(result["save_path"], framework="numpy") as f:
        saved = {k: f.get_tensor(k).shape for k in f.keys()}
    assert saved == _jax_job_keys(jm, jax.eval_shape(jm.init_variables, jax.random.key(0))["dit"], 16)
    assert "transformer.final_block.txt_qkv.lora_A.weight" in saved


@pytest.mark.parametrize("what,match", [
    ("size", "sd3 size 'xl'"), ("model_kwargs", "model_kwargs"), ("control_path", "takes no control latents"),
])
def test_what_stays_refused(tmp_path, what, match):
    raw = _shipped(str(tmp_path))
    proc = raw["config"]["process"][0]
    if what == "size":
        proc["model"]["model_kwargs"] = {"size": "xl"}
    elif what == "model_kwargs":
        proc["model"]["model_kwargs"]["control"] = True
    else:
        proc["datasets"][0]["control_path"] = proc["datasets"][0]["folder_path"]
    with pytest.raises(NotImplementedError, match=match):
        run_job(raw, device="cpu")


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_sd35_archs_lose_sd3s_static_shift(side):
    """``jax_fault``: JAX ``get_schedule`` gives arch ``sd3`` the static shift
    3 of SD3's scheduler config, but ``sd35`` and ``sd35_large`` fall through
    to the default schedule, whose samples shift their sigmas by the flux
    rule over the image's token count (ROADMAP Queue 3). ``port``: the port's
    factory builds the same schedules."""
    from ai_toolkit_tpu.samplers.factory import get_schedule as jget_schedule
    from ai_toolkit_tpu_torch.samplers.factory import get_schedule

    for arch in ARCHS:
        ref = jget_schedule("flowmatch", arch)
        if side == "jax_fault":
            assert (ref.shift, ref.use_dynamic_shifting) == (3.0, arch != "sd3")
        else:
            ours = get_schedule("flowmatch", arch)
            assert {f.name: getattr(ours, f.name) for f in dataclasses.fields(ours)} == \
                   {f.name: getattr(ref, f.name) for f in dataclasses.fields(ours)}
