"""The port's full fine-tune against the JAX package on the CPU at tiny sizes:
the parameter filter (JAX ``_filter_param_tree``), one training step's loss,
gradients, AdamW / AdamW8bit update and EMA in f32, the same update in bf16
bit for bit, and the ``sd_trainer`` job with ``network: {type: full}`` and its
save against the JAX full fine-tune's flat file. The grouped MoE's Pallas
kernels (their bank gradient ``_dw_kernel`` among them) run in TPU interpret
mode. Inputs, noise and timesteps are made with numpy and handed to both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.io.flux_import import flux_dit_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.jobs.train_process import _filter_param_tree, _flatten_params
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.models.hidream_model import HiDreamModel as JHiDreamModel
from ai_toolkit_tpu.ops.rope import image_position_ids
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.jobs.train_process import filter_param_names, select_trainable
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.models.flux_model import FluxModel
from ai_toolkit_tpu_torch.models.hidream_model import HiDreamModel
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss

torch.set_num_threads(1)
HIDREAM = {"name_or_path": "", "arch": "hidream", "model_kwargs": {"size": "tiny"}}
FLUX = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}
# the main path's filter: the expert banks of the first double and single block
BANKS = ["double_blocks.0.img_mlp.experts", "single_blocks.0.mlp.experts"]


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _jax_hidream(dispatch):
    model = JHiDreamModel(JModelConfig.from_dict(dict(HIDREAM)))
    if dispatch != "dense":  # the JAX tiny size is always dense; its FluxConfig takes either
        model.dit_config = dataclasses.replace(model.dit_config, moe_dispatch=dispatch)
        model.dit = jdit.FluxDiT(model.dit_config)
    return model


@pytest.fixture(scope="module")
def hidream_tree():
    """The tiny hidream DiT params from the JAX package's own (jitted) init."""
    return jax.tree.map(np.asarray, jax.jit(_jax_hidream("dense").init_variables)(jax.random.key(0))["dit"])


def _port_hidream(tree, dispatch):
    model = HiDreamModel(ModelConfig.from_dict(dict(HIDREAM, model_kwargs={"size": "tiny",
                                                                           "moe_dispatch": dispatch})),
                         device="cpu")
    dit = tdit.FluxDiT(model.dit_config)
    dit.load_state_dict(from_jax.flux_dit_state_dict(tree))
    return model, {"dit": dit.requires_grad_(False)}


def _flux():
    """The tiny flux DiT (1 + 1 blocks) of the port and its JAX params."""
    cfg = dataclasses.replace(tdit.FluxConfig.tiny(), depth_double=1, depth_single=1)
    dit = init_parameters(tdit.FluxDiT(cfg), torch.Generator().manual_seed(2)).requires_grad_(False)
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in dit.state_dict().items()},
                                    flux_dit_rules(scan_blocks=False))
    assert not unmatched
    model = FluxModel(ModelConfig.from_dict(dict(FLUX)), device="cpu")
    return model, {"dit": dit}, tree


def _port_names(tree):
    """Port parameter name -> JAX leaf path of every leaf of a JAX DiT tree."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                nested = leaf = {}
                for part in p.split("/")[:-1]:
                    leaf = leaf.setdefault(part, {})
                leaf[p.split("/")[-1]] = v
                (name,) = from_jax.flux_dit_state_dict(nested)
                out[name] = p

    walk(tree, "")
    return out


# ---- (a) the filter ----

@pytest.mark.parametrize("arch,inc,exc,n", [
    ("hidream", ["experts"], None, 6),
    ("hidream", ["qkv", "img_mlp"], ["txt", "w2"], 9),
    ("hidream", None, ["_mod", "shared", "experts.w3"], None),
    ("flux", ["qkv", "img_mlp"], ["txt"], 6),
    ("flux", None, ["_mod", "linear2"], None),
])
def test_filter_selects_the_same_leaves_as_jax(hidream_tree, arch, inc, exc, n):
    """The port's filter over its parameter names selects the leaves that JAX
    ``_filter_param_tree`` keeps of the same model's tree, mapped through
    ``io/from_jax`` (patterns that name the same leaves in both layouts)."""
    tree = hidream_tree if arch == "hidream" else _flux()[2]
    names = list(_port_names(tree))
    ref = sorted(from_jax.flux_dit_state_dict(_filter_param_tree(tree, inc, exc)))
    ours = sorted(filter_param_names(names, inc, exc))
    assert ours == ref and ours
    if n is not None:
        assert len(ours) == n
    else:  # an ignore list alone keeps everything else
        assert 0 < len(ours) < len(names)


def test_filter_maps_reference_block_names_and_sets_requires_grad(hidream_tree):
    """``transformer.transformer_blocks.0`` (the reference's diffusers names)
    selects ``double_blocks.0``; select_trainable marks exactly its result."""
    _, variables = _port_hidream(hidream_tree, "dense")
    dit = variables["dit"]
    names = [n for n, _ in dit.named_parameters()]
    assert (filter_param_names(names, ["transformer.transformer_blocks.0.img_mlp.experts"], None)
            == [f"double_blocks.0.img_mlp.experts.{w}.weight" for w in ("w1", "w3", "w2")])
    trainable = select_trainable(dit, BANKS, None)
    assert sorted(trainable) == sorted(f"{b}.{w}.weight" for b in BANKS for w in ("w1", "w3", "w2"))
    assert [n for n, p in dit.named_parameters() if p.requires_grad] == list(trainable)


# ---- (b) one full fine-tune step in f32 ----

def _inputs(cfg, n_txt, b=2, hh=8, ww=8, seed=11):
    rng = np.random.default_rng(seed)
    c = cfg.in_channels // 4
    return {
        "x0": rng.standard_normal((b, hh, ww, c), dtype=np.float32),
        "noise": rng.standard_normal((b, hh, ww, c), dtype=np.float32),
        "t": np.asarray([0.3, 0.85], np.float32)[:b],
        "txt": rng.standard_normal((b, n_txt, cfg.context_dim), dtype=np.float32),
        "y": rng.standard_normal((b, cfg.vec_dim), dtype=np.float32),
        "ids": image_position_ids(hh // 2, ww // 2, text_len=n_txt),
    }


def _merge(base, sub):
    return {k: _merge(base[k], sub[k]) if isinstance(v, dict) and k in sub else sub.get(k, v)
            for k, v in base.items()}


def _step_setup(case, hidream_tree):
    """(jax loss of the trainable subtree, the subtree, port model, port
    variables, inputs, include, exclude) of one case."""
    if case == "flux":  # unfiltered: every parameter of the DiT trains
        model, variables, tree = _flux()
        inc = exc = None
        cfg = variables["dit"].cfg
        jcfg = dataclasses.replace(jdit.FluxConfig.tiny(), depth_double=1, depth_single=1)
        inp = _inputs(cfg, n_txt=5)

        def jpredict(params, noisy, t, pe):
            out = jdit.FluxDiT(jcfg).apply({"params": params}, jdit.pack_latents_cmajor(noisy),
                                           jnp.asarray(inp["txt"]), t, jnp.asarray(inp["y"]), pe,
                                           jnp.ones((2,)))
            return jdit.unpack_latents_cmajor(out, noisy.shape[1], noisy.shape[2])
    else:
        dispatch = case.split("-")[1]
        model, variables = _port_hidream(hidream_tree, dispatch)
        tree, inc, exc = hidream_tree, ["experts", "qkv"], ["txt"]
        jmodel = _jax_hidream(dispatch)
        cfg = model.dit_config
        inp = _inputs(cfg, n_txt=2 * model.max_txt_len)

        def jpredict(params, noisy, t, pe):
            return jmodel.predict({"dit": params}, noisy, t, {"txt": jnp.asarray(inp["txt"]),
                                                              "y": jnp.asarray(inp["y"]), "pe": pe})
    sub = _filter_param_tree(tree, inc, exc) if inc or exc else tree
    pe = jnp.asarray(np.asarray(multi_axis_rope(torch.from_numpy(inp["ids"])[None], list(cfg.axes_dim),
                                                cfg.theta)))
    sched = JSchedule()
    x0, noise, t = (jnp.asarray(inp[k]) for k in ("x0", "noise", "t"))

    def jloss(trainable):
        pred = jpredict(_merge(tree, trainable), sched.add_noise(x0, noise, t), t, pe)
        return jcompute_loss(pred, sched.target(x0, noise, t))[0]

    return jloss, sub, model, variables, inp, inc, exc


@pytest.mark.parametrize("case", ["hidream-dense", "hidream-grouped", "flux"])
def test_full_finetune_step_matches_jax(hidream_tree, case):
    """The loss and the gradient of every trained tensor against
    jax.value_and_grad over the filtered subtree (hidream: the expert banks
    and the image / single qkv, the bank gradients through the grouped
    kernels' dw in grouped mode; flux: every parameter), then the trained
    tensors and the EMA after one adamw and one adamw8bit step fed those
    gradients. f32 both sides: summation order only; loss rtol 1e-5,
    gradients atol 1e-5 x max(1, max|ref|), parameters and EMA atol 1e-6."""
    jloss, sub, model, variables, inp, inc, exc = _step_setup(case, hidream_tree)
    ref_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(sub)
    jgrads = jax.tree.map(np.asarray, jgrads)
    ref_grads = from_jax.flux_dit_state_dict(jgrads)

    trainable = select_trainable(variables["dit"], inc, exc)
    assert sorted(trainable) == sorted(ref_grads)
    cfg = variables["dit"].cfg
    pe = multi_axis_rope(torch.from_numpy(inp["ids"])[None], list(cfg.axes_dim), cfg.theta)
    batch = {"latents": torch.from_numpy(inp["x0"]), "cond": {
        "txt": torch.from_numpy(inp["txt"]), "y": torch.from_numpy(inp["y"]), "pe": pe,
        "guidance": torch.ones(2)}}
    loss, _ = train_loss(lambda noisy, tt, cond: model.predict(variables, noisy, tt, cond),
                         FlowMatchSchedule(), TrainStepConfig(), batch,
                         torch.from_numpy(inp["noise"]), torch.from_numpy(inp["t"]))
    grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        assert np.abs(ref).max() > 0, f"{name}: zero reference gradient"
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()), err_msg=name)

    for opt in ("adamw", "adamw8bit"):
        jstate = JTrainState.create({}, {"dit": sub}, jget_optimizer(opt, 1e-3, max_grad_norm=1.0),
                                    use_ema=True)
        jstate = jax.jit(lambda st, g: st.apply_gradients(g, ema_decay=0.9))(jstate, {"dit": jgrads})
        params = {k: p.detach().clone() for k, p in trainable.items()}
        state = TrainState(params, get_optimizer(opt, list(params.values()), 1e-3, max_grad_norm=1.0),
                           use_ema=True)
        state.apply_gradients([ref_grads[k] for k in params], ema_decay=0.9)
        for ours, ref in ((state.trainable, jstate.trainable["dit"]), (state.ema, jstate.ema["dit"])):
            ref = from_jax.flux_dit_state_dict(jax.tree.map(np.asarray, ref))
            for k, v in ours.items():
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-6, err_msg=f"{opt} {k}")
        assert any(not torch.equal(state.trainable[k], trainable[k]) for k in params)


# ---- (c) the bf16 update ----

@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_bf16_update_and_ema_match_jax(hidream_tree, opt):
    """The expert banks in bf16 and bf16 gradients through two optimizer steps
    (one with the global norm above the clip, one below) and the EMA against
    the JAX state. This pins the rounding JAX does in bf16: every operation
    rounds, Python scalars are rounded to bf16 first (the EMA decay 0.99 is
    0.98828125), adamw keeps its moments in bf16, adamw8bit adds its f32
    update to the parameter and rounds once, XLA fuses f32 products into sums
    and divides by the constant 127 as a product with its reciprocal. adamw:
    the parameters, the EMA and the bf16 moments equal bit for bit.
    adamw8bit: the int8 moments and their f32 scales equal bit for bit; the
    parameters and the EMA are within one bf16 ULP, equal but for about one
    element in 10^5 where XLA's f32 update and PyTorch's differ in the last
    f32 bit before the rounding to bf16 (2 of 131,072 here)."""
    names = _port_names(hidream_tree)
    sd = from_jax.flux_dit_state_dict(_filter_param_tree(hidream_tree, ["experts"], None))
    init = {n: sd[n].to(torch.bfloat16) for n in names if ".experts." in n}
    jstate = JTrainState.create({}, {n: jnp.asarray(t.float().numpy(), jnp.bfloat16) for n, t in init.items()},
                                jget_optimizer(opt, 1e-3, max_grad_norm=1.0), use_ema=True)
    params = {n: t.clone() for n, t in init.items()}
    state = TrainState(params, get_optimizer(opt, list(params.values()), 1e-3, max_grad_norm=1.0),
                       use_ema=True)
    apply = jax.jit(lambda st, g: st.apply_gradients(g, ema_decay=0.99))
    rng = np.random.default_rng(5)
    for scale in (0.3, 1e-3):  # global norm above / below 1
        grads = {n: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32) * scale).bfloat16()
                 for n, t in init.items()}
        jstate = apply(jstate, {n: jnp.asarray(g.float().numpy(), jnp.bfloat16) for n, g in grads.items()})
        state.apply_gradients([grads[n] for n in params], ema_decay=0.99)

    def ulps(ours, ref):  # bf16 values of one sign: the distance of their bit patterns
        ref = torch.from_numpy(np.asarray(ref).view(np.int16).astype(np.int32))
        return (ours.view(torch.int16).to(torch.int32) - ref).abs()

    adam = jstate.opt_state[1][0]
    off = 0
    for i, n in enumerate(params):
        assert params[n].dtype == state.ema[n].dtype == torch.bfloat16
        assert not torch.equal(params[n], init[n])
        for ours, ref in ((params[n], jstate.trainable[n]), (state.ema[n], jstate.ema[n])):
            d = ulps(ours, ref)
            assert int(d.max()) <= (0 if opt == "adamw" else 1), n
            off += int((d > 0).sum())
        if opt == "adamw":
            assert str(adam.mu[n].dtype) == "bfloat16" and state.optimizer.mu[i].dtype == torch.bfloat16
            for ours, ref in ((state.optimizer.mu[i], adam.mu[n]), (state.optimizer.nu[i], adam.nu[n])):
                assert not ulps(ours, ref).any(), n
        else:
            for (q, s), ref in ((state.optimizer.mu[i], adam.mu[n]), (state.optimizer.nu[i], adam.nu[n])):
                np.testing.assert_array_equal(q.numpy(), np.asarray(ref.q), err_msg=n)
                np.testing.assert_array_equal(s.numpy(), np.asarray(ref.scale), err_msg=n)
    assert off <= 1e-4 * 2 * sum(p.numel() for p in params.values())


# ---- (d) the job and its save ----

def _dataset(folder, n=2, size=32):
    from PIL import Image

    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(folder / f"im_{i}.png")
        (folder / f"im_{i}.txt").write_text(f"photo of thing {i}")
    return str(folder)


def _job(tmp_path, model, network=None, steps=3):
    proc = {
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"),
        "save": {"dtype": "float16", "save_every": 1, "max_step_saves_to_keep": 1},
        "datasets": [{"folder_path": _dataset(tmp_path / "data"), "caption_ext": "txt",
                      "cache_latents_to_disk": False, "resolution": [32]}],
        "train": {"batch_size": 1, "steps": steps, "gradient_checkpointing": True,
                  "noise_scheduler": "flowmatch", "timestep_type": "flux_shift",
                  "optimizer": "adamw8bit", "lr": 1e-3, "ema_config": {"use_ema": True},
                  "dtype": "float32", "seed": 42},
        "model": model}
    if network is not None:
        proc["network"] = network
    return {"job": "extension", "config": {"name": "ft_tiny", "process": [proc]}}


def test_full_finetune_job_trains_the_banks_and_saves_what_jax_saves(tmp_path, hidream_tree, capsys):
    """hidream tiny, grouped dispatch, ``network: {type: full}`` filtered to
    the banks of the first double and single block: 3 steps, a save at every
    step (no rotation) and a final one. The saved tensors are the trained
    ones (not the EMA) in their own dtype, every other DiT tensor is unchanged
    from the seeded init, and the file equals the JAX full fine-tune's flat
    file (``_flatten_params`` of the same trained tree) after conversion
    through ``from_jax``: the same keys, dtypes, values and metadata."""
    from safetensors import safe_open
    from safetensors.numpy import save_file

    model = {**HIDREAM, "model_kwargs": {"size": "tiny", "moe_dispatch": "grouped"},
             "only_if_contains": BANKS}
    job = get_job(_job(tmp_path, model, {"type": "full"}), device="cpu")
    (result,) = job.run()
    proc = job.processes[0]
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
    n_params = sum(p.numel() for p in proc.state.trainable.values())
    assert result["trainable_params"] == n_params and result["lora_modules"] == 0
    assert f"full fine-tune (filtered to {n_params:,} params)" in capsys.readouterr().out

    root = tmp_path / "out" / "ft_tiny"
    assert sorted(p.name for p in root.iterdir()) == [
        "ft_tiny.safetensors", "ft_tiny_000000001.safetensors", "ft_tiny_000000002.safetensors"]
    trained = proc.state.trainable
    fresh = HiDreamModel(ModelConfig.from_dict(model), device="cpu").init_variables(
        torch.Generator().manual_seed(42))["dit"].state_dict()
    for name, p in proc.variables["dit"].named_parameters():
        if name in trained:
            assert not torch.equal(p, fresh[name]), name
        else:
            assert torch.equal(p, fresh[name]), name
    assert all(not torch.equal(proc.state.ema[k], v) for k, v in trained.items())

    with safe_open(result["save_path"], framework="pt") as f:
        ours, meta = {k: f.get_tensor(k) for k in f.keys()}, f.metadata()
    assert sorted(ours) == sorted(trained) and len(ours) == 6
    for k, v in ours.items():
        assert v.dtype == trained[k].dtype == torch.float32 and torch.equal(v, trained[k].detach()), k

    # the JAX save of the same trained tree
    paths = _port_names(hidream_tree)
    jtree: dict = {}
    for name, t in trained.items():
        *mods, leaf = paths[name].split("/")
        node = jtree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t.detach().numpy()  # expert banks keep one layout in both packages
    jpath = str(tmp_path / "jax_ft.safetensors")
    save_file(_flatten_params(jtree), jpath, metadata={"step": "3", "software": "ai_toolkit_tpu"})
    with safe_open(jpath, framework="numpy") as f:
        ref, ref_meta = from_jax.flux_dit_flat_state_dict({k: f.get_tensor(k) for k in f.keys()}), f.metadata()
    assert sorted(ref) == sorted(ours) and meta == ref_meta
    for k in ref:
        assert ref[k].dtype == ours[k].dtype and torch.equal(ref[k], ours[k]), k
    # a bf16 run's file holds ml_dtypes bfloat16 arrays: they convert to bf16 tensors
    import ml_dtypes

    flat = _flatten_params(jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), jtree))
    for k, v in from_jax.flux_dit_flat_state_dict(flat).items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, ours[k].bfloat16()), k


def test_full_finetune_on_a_quantized_base_raises(tmp_path):
    """In JAX the quantized weights leave the trainable tree; the port
    refuses the combination and names the slice that brings it."""
    model = {**HIDREAM, "quantize": True, "qtype": "qfloat8", "only_if_contains": BANKS}
    with pytest.raises(NotImplementedError, match="slice G"):
        run_job(_job(tmp_path, model, {"type": "full"}), device="cpu")
