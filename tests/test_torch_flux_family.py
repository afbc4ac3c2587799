"""The flux family on the port's FluxDiT against the JAX package on the CPU at
tiny f32 sizes: the configs the six archs build (chroma's Approximator,
flex2's 196-input and kontext's 128-input ``img_in``), ``FluxModel.predict``
per arch (the control latents concatenated to the image tokens), chroma's
Approximator and its 344 rows at flux-dev's depth (captured from the JAX
forward), one train step per arch through JAX ``train/step.py`` (loss,
gradients and the adamw8bit update), the qfloat8 base's choice of weights,
the chroma loader on a seeded BFL file with ``distilled_guidance_layer.*``,
and the two JAX faults (``[jax_fault]``: what the JAX loader leaves on its
init; ``[port]``: the port refuses the file, naming the fault). Weights come
from the port's seeded init and reach JAX through the JAX package's own
importer rules; inputs and noise are made with numpy, or drawn by the port
and handed to JAX.

Tolerance: f32 on both sides, ``rtol`` 1e-5 and an ``atol`` relative to
the largest reference value (of a gradient: over every trained tensor, as
a LoRA ``scale``'s gradient is a sum that mostly cancels): 1e-5 of it for chroma (summation order alone;
an elementwise ``atol`` of 1e-6 fails on that at values near 4), 1e-4 for
the archs with ``time_in`` / ``guidance_in``, whose 256-wide timestep
embedding takes ``exp`` of its frequencies, where XLA's and PyTorch's CPU
``exp`` differ by one ulp at some entries; times t·1000 (4,000 rad at
guidance 4) that moves a sinusoid by up to 1.2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.adapters import quantize as jquant
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io.flux_import import chroma_approximator_rules, flux_dit_rules, load_flux_checkpoint
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.models.flux_model import FluxModel as JFluxModel
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.adapters import quantize as tquant
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.models.flux_model import FluxModel
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step
from torch_jax_opt import full_jax_opt, jax_opt0  # noqa: F401

torch.set_num_threads(1)
ARCHS = ("chroma", "flex1", "flex2", "flux_kontext")
ONE_EACH = dict(depth_double=1, depth_single=1)  # one block of each kind keeps the JAX compiles small
RULES = chroma_approximator_rules() + flux_dit_rules(scan_blocks=False)


def _close(ours, ref, what="", arch="chroma", scale=None):
    """``scale``: the largest value of the whole reference (a gradient's, over
    every trained tensor), else of ``ref``."""
    ref = np.asarray(ref)
    rel = 1e-5 if arch == "chroma" else 1e-4
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=rel * scale, err_msg=what)


def _cfg(arch, size="tiny", path=""):
    return {"name_or_path": path, "arch": arch, "model_kwargs": {"size": size}}


def _seeded_dit(cfg, seed=0):
    dit = init_parameters(tdit.FluxDiT(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():  # norm scales away from 1, so a misplaced scale shows
        for k, p in dit.named_parameters():
            if p.dim() == 1 and "bias" not in k:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(k))))
    return dit.eval().requires_grad_(False)


def _jax_tree(dit, rules=RULES):
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in dit.state_dict().items() if ".lora." not in k}, rules)
    assert not unmatched, unmatched[:5]
    return tree


class Pair:
    """One arch on both sides at ``depths`` (one block of each kind by
    default): the port's model and seeded DiT, the JAX model and the DiT's
    tree (``rules``: the JAX importer rules of its layout)."""

    def __init__(self, arch, depths=ONE_EACH, rules=RULES, seed=None, **jax_over):
        self.arch = arch
        self.model = FluxModel(ModelConfig.from_dict(_cfg(arch)), device="cpu")
        self.model.dit_config = dataclasses.replace(self.model.dit_config, **depths)
        self.dit = _seeded_dit(self.model.dit_config, seed=len(arch) if seed is None else seed)
        self.jmodel = JFluxModel(JModelConfig.from_dict(_cfg(arch)))
        self.jmodel.dit_config = dataclasses.replace(self.jmodel.dit_config, **depths, **jax_over)
        self.jmodel.dit = jdit.FluxDiT(self.jmodel.dit_config)
        self.tree = _jax_tree(self.dit, rules)

    def inputs(self, b=2, hh=8, ww=8, n_txt=5, seed=3):
        cfg, rng = self.model.dit_config, np.random.default_rng(seed)
        c = (cfg.out_channels or cfg.in_channels) // 4
        out = {"x": rng.standard_normal((b, hh, ww, c), dtype=np.float32),
               "noise": rng.standard_normal((b, hh, ww, c), dtype=np.float32),
               "t": np.asarray([0.3, 0.85], np.float32)[:b],
               "txt": rng.standard_normal((b, n_txt, cfg.context_dim), dtype=np.float32),
               "y": rng.standard_normal((b, cfg.vec_dim), dtype=np.float32),
               "g": np.asarray([1.0, 4.0], np.float32)[:b], "hw": (hh, ww, n_txt)}
        if cfg.control_channels:
            out["ctrl"] = rng.standard_normal((b, hh, ww, cfg.control_channels // 4), dtype=np.float32)
        return out

    def conds(self, inp):
        hh, ww, n_txt = inp["hw"]
        j = {"txt": jnp.asarray(inp["txt"]), "y": jnp.asarray(inp["y"]), "guidance": jnp.asarray(inp["g"]),
             "pe": self.jmodel.rope_table(hh, ww, n_txt)}
        t = {"txt": torch.from_numpy(inp["txt"]), "y": torch.from_numpy(inp["y"]),
             "guidance": torch.from_numpy(inp["g"]), "pe": self.model.rope_table(hh, ww, n_txt)}
        if "ctrl" in inp:
            j["control_latents"], t["control_latents"] = jnp.asarray(inp["ctrl"]), torch.from_numpy(inp["ctrl"])
        return j, t


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, arch):
    if arch not in pairs:
        pairs[arch] = Pair(arch)
    return pairs[arch]


@pytest.mark.parametrize("size", ["tiny", "dev"])
@pytest.mark.parametrize("arch", ["flux", "flux_schnell", *ARCHS])
def test_archs_build_the_jax_configs(arch, size):
    """Every field the two FluxConfigs share is equal: chroma's Approximator
    (5120 x 5; 64 x 2 at tiny) without the guidance embed, flex2's 196 / 64 /
    132 channels, kontext's 128 / 64 / 64, and flex1 / flex2 at FLUX.1-dev's
    19 double blocks (the JAX fault, pinned in test_flex_double_blocks)."""
    ours = FluxModel(ModelConfig.from_dict(_cfg(arch, size)), device="meta").dit_config
    ref = JFluxModel(JModelConfig.from_dict(_cfg(arch, size))).dit_config
    # checkpoint_policy is the port's own field (JAX's is remat_policy): flux keeps dots_flash
    shared = [f.name for f in dataclasses.fields(ours) if f.name not in ("dtype", "checkpoint_policy")]
    assert {f: getattr(ours, f) for f in shared} == {f: getattr(ref, f) for f in shared}
    assert ours.checkpoint_policy == "dots_flash"
    if size == "dev":
        expect = {"chroma": (64, None, 0, 5120), "flex2": (196, 64, 132, 5120), "flux_kontext": (128, 64, 64, 5120)}
        got = (ours.in_channels, ours.out_channels, ours.control_channels, ours.approximator_hidden)
        assert got == expect.get(arch, (64, None, 0, 5120))
        assert ours.chroma_mod == (arch == "chroma") and ours.depth_double == 19


@pytest.mark.parametrize("arch", ARCHS)
def test_predict_matches_jax(pairs, arch):
    """``FluxModel.predict``: chroma through the Approximator (guidance 1 and
    4), flex1 as flux-dev, flex2 and kontext with the packed control latents
    concatenated to the image tokens' channels."""
    p = _pair(pairs, arch)
    inp = p.inputs()
    jc, tc = p.conds(inp)
    ref = jax.jit(p.jmodel.predict)({"dit": p.tree}, jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jc)
    with torch.inference_mode():
        out = p.model.predict({"dit": p.dit}, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), tc)
    assert out.shape == inp["x"].shape
    _close(out.numpy(), ref, arch, arch)
    if "ctrl" in inp:  # a control arch needs its latents
        with pytest.raises(ValueError, match="control latents"):
            p.model.predict({"dit": p.dit}, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]),
                            {k: v for k, v in tc.items() if k != "control_latents"})


@pytest.mark.usefixtures("full_jax_opt")
def test_chroma_approximator_rows_match_jax():
    """At flux-dev's depth (19 double + 38 single blocks, tiny width) the
    Approximator yields 344 modulation rows; they equal the JAX forward's
    ``distilled_guidance`` output (captured), and so does the forward. The
    JAX tree is the scanned one. Without guidance the rows are those of g = 0."""
    p = Pair("chroma", dict(depth_double=19, depth_single=38),
             chroma_approximator_rules() + flux_dit_rules(scan_blocks=True), seed=5, scan_blocks=True)
    cfg, dit, jcfg, tree = p.model.dit_config, p.dit, p.jmodel.dit_config, p.tree
    assert tdit.chroma_mod_count(cfg) == 344 and "double_blocks" in tree  # the scanned JAX layout
    inp = p.inputs(hh=4, ww=4)
    jc, tc = p.conds(inp)
    img = np.asarray(jdit.pack_latents_cmajor(jnp.asarray(inp["x"])))

    def jfwd(params, *args):
        return jdit.FluxDiT(jcfg).apply({"params": params}, *args, mutable=["intermediates"],
                                        capture_intermediates=lambda m, _: isinstance(m, jdit.Approximator))

    ref, inter = jax.jit(jfwd)(tree, img, jc["txt"], jnp.asarray(inp["t"]), jc["y"], jc["pe"], jc["guidance"])
    (rows,) = inter["intermediates"]["distilled_guidance"]["__call__"]
    with torch.inference_mode():
        t, g = torch.from_numpy(inp["t"]), torch.from_numpy(inp["g"])
        mods = dit.chroma_mods(t, g)
        out = dit(torch.from_numpy(img), tc["txt"], t, tc["y"], tc["pe"], g)
        no_g = dit.chroma_mods(t, None)
        zero_g = dit.chroma_mods(t, torch.zeros(2))
    assert rows.shape == (2, 344, cfg.hidden_size)
    sing, dimg, dtxt, fin = mods
    assert (sing.shape, dimg.shape, dtxt.shape, fin.shape) == ((2, 38, 3, 64), (2, 19, 2, 3, 64),
                                                              (2, 19, 2, 3, 64), (2, 2, 64))
    ours = torch.cat([sing.flatten(1, 2), dimg.flatten(1, 3), dtxt.flatten(1, 3), fin], dim=1)
    _close(ours.numpy(), rows, "approximator rows")
    _close(out.numpy(), ref, "forward")
    assert all(torch.equal(a, b) for a, b in zip(no_g, zero_g))
    assert not torch.equal(no_g[0], mods[0])


def _lora_pair(p, rank=4, alpha=8.0):
    """A LoRA on the port's DiT (b non-zero, else a's gradient is zero) and
    the same factors as the JAX ``lora`` collection; {port name: JAX path}."""
    lora = tlora.build_lora(p.dit, tlora.LoRASpec(rank=rank, alpha=alpha, target_patterns=p.model.lora_targets()),
                            torch.Generator().manual_seed(3))
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(4))
    jtree = jax.eval_shape(lambda: jlora.build_lora(
        p.tree, jlora.LoRASpec(rank=rank, alpha=alpha, target_patterns=p.jmodel.lora_targets()), jax.random.key(0)))
    paths = {}

    def fill(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if "a" in v:
                name = from_jax._flux_module(path)
                paths[name] = path
                node[k] = {leaf: np.array(getattr(lora[name], leaf).detach().numpy()) for leaf in ("a", "b", "scale")}
            else:
                fill(v, path)

    jtree = jax.tree.map(lambda x: x, jtree)
    fill(jtree)
    assert sorted(paths) == sorted(lora)
    return lora, jtree, paths


# XLA's backend optimization level 0: a reference's CPU compile in about half
# the time; the comparisons and their tolerances are unchanged
OPT0 = {"xla_backend_optimization_level": 0}


def fast_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`OPT0`."""
    return jax.jit(fn, compiler_options=OPT0)(*args)


def jit_decode(jmodel):
    """``jmodel`` with its ``decode_latents`` (and ``decode_audio``) compiled
    with :data:`OPT0`: the JAX generation functions call them eagerly, which
    flax runs op by op. The same computation; returns ``jmodel``."""
    for name in ("decode_latents", "decode_audio"):
        real = getattr(jmodel, name, None)
        if real is not None:
            setattr(jmodel, name, lambda variables, latents, real=real: fast_jit(real, variables, latents))
    return jmodel


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(pairs, arch, monkeypatch, request):
    """One LoRA step (flux_shift, adamw8bit, clipping at 1) of the port's
    ``make_train_step`` against JAX ``train/step.make_train_step`` with the
    port's draws (t, then the noise, from its generator) injected: the loss,
    every LoRA a / b / scale gradient (captured where the JAX step hands them
    to ``apply_gradients``) and the update: adam's first step is about
    g / (|g| + eps), so the update is held to 1e-3 of the learning rate
    where |g| > 1e-5 (at least 90 % of the elements), and the 8-bit moments
    to 99.9 % equal codes (a gradient within 1e-5 of JAX's may round to
    another code now and then). Chroma's 1e-5 tolerance holds the JAX step
    at XLA's default level (``full_jax_opt``)."""
    if arch == "chroma":
        request.getfixturevalue("full_jax_opt")
    p = _pair(pairs, arch)
    lora, jtree, paths = _lora_pair(p)
    lr, seq = 1e-3, 16
    inp = p.inputs()
    jc, tc = p.conds(inp)
    names = [f"{n}.{leaf}" for n in lora for leaf in ("a", "b", "scale")]
    trainable = {k: getattr(lora[k.rsplit(".", 1)[0]], k.rsplit(".", 1)[1]) for k in names}
    before = {k: v.detach().clone() for k, v in trainable.items()}
    state = TrainState(trainable, get_optimizer("adamw8bit", list(trainable.values()), lr, max_grad_norm=1.0))
    cfg = TrainStepConfig(timestep_type="flux_shift")
    grads_seen = {}
    real_step = state.optimizer.step

    def keep_grads(grads):
        grads_seen.update(zip(names, (g.clone() for g in grads)))
        return real_step(grads)

    state.optimizer.step = keep_grads
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": tc, "image_seq_len": seq,
             "loss_multiplier": torch.ones(2)}
    metrics = make_train_step(lambda x, t, c: p.model.predict({"dit": p.dit}, x, t, c), FlowMatchSchedule(),
                              cfg)(state, [batch], torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)  # the draws the port's step made, in its order
    t = FlowMatchSchedule().sample_timesteps(g, 2, "flux_shift", seq, 1.0)
    noise = torch.randn(inp["x"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jstate = JTrainState.create({"dit": p.tree}, {"lora": jtree}, jget_optimizer("adamw8bit", lr, max_grad_norm=1.0))
    jtrain = jstep.make_train_step(p.jmodel.predict, Injected(), jstep.TrainStepConfig(timestep_type="flux_shift"))
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        seen = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: seen.append(gr)
                            or real_apply(self, gr, **kw))
        new, m = jtrain(st, b, jax.random.key(0), image_seq_len=seq)
        return new, m, seen[0]

    jbatch = {"latents": jnp.asarray(inp["x"]), "cond": jc, "loss_multiplier": jnp.ones(2)}
    jnew, jmetrics, jgrads = jax.jit(run)(jstate, jbatch)
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]), rtol=1e-5)
    adam = jnew.opt_state[1][0]
    codes = same = held = total = 0
    ref_grads = {k: np.asarray(_leaf(jgrads["lora"], paths[k.rsplit(".", 1)[0]])[k.rsplit(".", 1)[1]]) for k in names}
    gmax = max(float(np.abs(g).max()) for g in ref_grads.values())
    for i, k in enumerate(names):
        name, leaf = k.rsplit(".", 1)
        ref_g = ref_grads[k]
        assert np.abs(ref_g).max() > 0, f"{k}: zero reference gradient"
        _close(grads_seen[k].numpy(), ref_g, k, arch, scale=gmax)
        for ours, ref in ((state.optimizer.mu[i], adam.mu), (state.optimizer.nu[i], adam.nu)):
            eq = (ours[0].numpy() == np.asarray(_leaf(ref["lora"], paths[name])[leaf].q))[:ref_g.size]
            codes, same = codes + eq.size, same + int(eq.sum())
        # adam's first step is g / (|g| + eps) in f32 (the 8-bit codes are for the next step): where
        # |g| nears eps a gradient within 1e-5 of JAX's moves it, so the update is held where |g| > 1e-5
        sel = np.abs(ref_g) > 1e-5
        ref_new = np.asarray(_leaf(jnew.trainable["lora"], paths[name])[leaf])
        np.testing.assert_allclose((trainable[k].detach() - before[k]).numpy()[sel],
                                   (ref_new - before[k].numpy())[sel], atol=1e-3 * lr, err_msg=k)
        held += int(sel.sum())
        total += sel.size
    assert same >= 0.999 * codes, f"{codes - same} of {codes} 8-bit moment codes differ"
    assert held >= 0.9 * total, f"the update was held at {held} of {total} elements"


@pytest.mark.parametrize("arch", ["chroma", "flex2"])
def test_quantize_selects_the_jax_weights(pairs, arch):
    """qfloat8 at min_size 2**10: the same weights as JAX ``quantize_params``
    on the same tree (chroma: the Approximator's Linears too; flex2: its
    wide img_in; never a modulation or the final layer), bit for bit."""
    p = _pair(pairs, arch)
    _, jq = jquant.quantize_params(p.tree, min_size=2**10, qtype="qfloat8")
    ref = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if "qvalue" in v:
                ref[from_jax._flux_module(path)] = v
            else:
                walk(v, path)

    walk(jq)
    dit = _seeded_dit(p.model.dit_config, seed=len(arch))
    names = tquant.quantize_params(dit, min_size=2**10, qtype="qfloat8")
    assert sorted(names) == sorted(ref) and names
    assert ("distilled_guidance_layer.in_proj" in names) == (arch == "chroma") and "img_in" in names
    mods = dict(dit.named_modules())
    for name in names:
        np.testing.assert_array_equal(mods[name].qvalue.t().contiguous().view(torch.uint8).numpy(),
                                      np.asarray(ref[name]["qvalue"]).view(np.uint8), err_msg=name)
        np.testing.assert_array_equal(mods[name].qscale.t().numpy(), np.asarray(ref[name]["qscale"]), err_msg=name)


def _bfl_file(root, dit, drop=(), replace=None):
    """The DiT as one BFL file at the top of ``root`` (``model.diffusion_model.``
    keys, as single files ship), less the keys starting with ``drop``."""
    import os

    os.makedirs(root, exist_ok=True)
    sd = {k: v.contiguous() for k, v in dit.state_dict().items() if not k.startswith(tuple(drop))}
    sd.update(replace or {})
    save_file({f"model.diffusion_model.{k}": v for k, v in sd.items()}, os.path.join(root, "dit.safetensors"))


def _jax_load(arch, root, tree):
    """JAX ``load_flux_checkpoint`` with its model's init replaced by ``tree``
    (the DiT alone: the file holds nothing else)."""
    jm = JFluxModel(JModelConfig.from_dict(_cfg(arch, path=root)))
    jm.init_variables = lambda rng: {"dit": jax.tree.map(np.copy, tree)}
    return load_flux_checkpoint(root, jm)["dit"]


def test_chroma_checkpoint_loads_alike(tmp_path, capsys):
    """A seeded tiny chroma DiT written as a BFL single file with
    ``distilled_guidance_layer.*``: JAX's loader (its chroma rules) and the
    port's strict one read the same tensors, bit for bit."""
    src = _seeded_dit(FluxModel(ModelConfig.from_dict(_cfg("chroma")), device="meta").dit_config, seed=11)
    init = _jax_tree(_seeded_dit(src.cfg, seed=12))
    root = str(tmp_path / "chroma")
    _bfl_file(root, src)
    jtree = _jax_load("chroma", root, init)
    assert "0 shape mismatches" in capsys.readouterr().out
    model = FluxModel(ModelConfig.from_dict(_cfg("chroma", path=root)), device="cpu")
    loaded = model.load_variables(torch.Generator().manual_seed(0))["dit"].state_dict()
    assert any(k.startswith("distilled_guidance_layer.norms.") for k in loaded)
    ref = from_jax.flux_dit_state_dict(jax.tree.map(np.asarray, jtree))
    assert sorted(ref) == sorted(loaded)
    for k, v in src.state_dict().items():
        assert torch.equal(loaded[k], v) and torch.equal(ref[k], v), k


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_kontext_img_in_of_the_published_file(side, tmp_path, capsys):
    """FLUX.1-Kontext-dev's img_in takes 64 inputs (the control image joins
    the token stream); JAX builds flux_kontext as a channel concat (128).
    ``jax_fault``: JAX's non-strict merge skips that img_in and keeps its
    init. ``port``: the strict loader raises, naming the fault."""
    cfg = FluxModel(ModelConfig.from_dict(_cfg("flux_kontext")), device="meta").dit_config
    src = _seeded_dit(cfg, seed=13)
    narrow = torch.randn(cfg.hidden_size, cfg.in_channels // 2, generator=torch.Generator().manual_seed(1))
    root = str(tmp_path / "kontext")
    _bfl_file(root, src, replace={"img_in.weight": narrow})
    if side == "port":
        with pytest.raises(ValueError, match="Queue 3") as err:
            FluxModel(ModelConfig.from_dict(_cfg("flux_kontext", path=root)), device="cpu").load_variables(
                torch.Generator().manual_seed(0))
        assert "takes 16 inputs" in str(err.value) and "channel concat" in str(err.value)
        return
    init = _jax_tree(_seeded_dit(cfg, seed=14))
    jtree = _jax_load("flux_kontext", root, init)
    assert "1 shape mismatches skipped" in capsys.readouterr().out
    np.testing.assert_array_equal(jtree["img_in"]["kernel"], init["img_in"]["kernel"])
    np.testing.assert_array_equal(jtree["txt_in"]["kernel"], src.txt_in.weight.numpy().T)


@pytest.mark.parametrize("arch", ["flex1", "flex2"])
@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_flex_double_blocks(arch, side, tmp_path):
    """Flex.1-alpha and Flex.2-preview hold 8 double blocks; JAX builds both
    at FLUX.1-dev's 19. At tiny size (2 double blocks) a file with one:
    ``jax_fault``: JAX loads it and leaves double block 1 on its init;
    ``port``: the strict loader raises, naming the fault."""
    cfg = FluxModel(ModelConfig.from_dict(_cfg(arch)), device="meta").dit_config
    src = _seeded_dit(cfg, seed=15)
    root = str(tmp_path / arch)
    _bfl_file(root, src, drop=("double_blocks.1.",))
    if side == "port":
        with pytest.raises(KeyError, match="Queue 3") as err:
            FluxModel(ModelConfig.from_dict(_cfg(arch, path=root)), device="cpu").load_variables(
                torch.Generator().manual_seed(0))
        assert "holds 1 double blocks" in str(err.value)
        return
    init = _jax_tree(_seeded_dit(cfg, seed=16))
    jtree = _jax_load(arch, root, init)
    np.testing.assert_array_equal(jtree["double_1"]["img_qkv"]["kernel"], init["double_1"]["img_qkv"]["kernel"])
    np.testing.assert_array_equal(jtree["double_0"]["img_qkv"]["kernel"],
                                  src.double_blocks[0].img_attn.qkv.weight.numpy().T)
