"""The control-LoRA adapter of the port against the JAX package on the CPU,
in f32 at tiny sizes:

- the ``ctrl`` overlay on one ``Linear`` (forward and every gradient) against
  the JAX ``Linear`` reading its ``ctrl`` collection, alone, with a LoRA
  (which sees the base features only), with the expansion's bias and on an
  int8 base;
- the channel math and the init's statistics; ``assemble_inpaint_control``
  bit for bit from equal numpy generators; the whole control conditioning of
  a batch (the dropout draw, one control, several controls and the zero
  slots past them, the inpainting layout) against JAX ``_prepare_batch`` on
  the same raw batches, bit for bit;
- the save layout, ``load_control_lora_expansion`` and ``upgrade_expansion``
  against JAX's;
- one train step of a LoRA beside the expansion on the tiny flux DiT against
  JAX ``train/step.make_train_step`` (loss, the expansion's and every LoRA
  gradient);
- the tiny job end to end (both control layouts): the LoRA's keys are the
  JAX job's with ``img_in`` skipped, the expansion rides in the file, moves,
  is read back on a rerun, and samples take the ``ctrl_img``;
- the ``textual_inversion_trainer`` alias, and what stays refused.

Tolerance: f32, ``rtol`` 1e-6 on one Linear; through the DiT ``rtol`` 1e-5
on the loss and an ``atol`` of 1e-4 of the largest gradient (flux's
``time_in``, as in the flux-family tests)."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open
from test_torch_flux_family import Pair, fast_jit
from test_torch_train_job import _job, _train_proc
from torch_jax_opt import jax_opt0  # noqa: F401

from ai_toolkit_tpu.adapters import control_lora as jcl
from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.config.modules import ProcessConfig as JProcessConfig
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.sd_import import vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models.flux_model import FluxModel as JFluxModel
from ai_toolkit_tpu.ops import layers as jlayers
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import control_lora as tcl
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
from ai_toolkit_tpu_torch.config import get_config
from ai_toolkit_tpu_torch.io.from_jax import flux_jax_path
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess
from ai_toolkit_tpu_torch.ops.layers import Ctrl, Linear, LoRA
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLUX = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}


# ---- the ctrl overlay on one Linear ----

@pytest.mark.parametrize("case", ["alone", "lora", "bias", "int8"])
def test_ctrl_linear_matches_jax(case):
    """``y = x_base W + (x_base a) b s + x_extra w (+ b_ctrl) + bias`` and its
    gradients for the input, the expansion and the LoRA, against JAX."""
    rng = np.random.default_rng(0)
    cin, extra, cout = 8, 4, 6
    kernel = rng.normal(0, 0.3, (cin, cout)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    w = rng.normal(0, 0.3, (extra, cout)).astype(np.float32)
    x = rng.standard_normal((2, 5, cin + extra)).astype(np.float32)
    variables = {"params": {"kernel": kernel, "bias": bias}, "ctrl": {"w": w}}
    lin = Linear(cin, cout)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T))
        lin.bias.copy_(torch.from_numpy(bias))
    lin.requires_grad_(False)
    ctrl_b = None
    if case == "bias":
        ctrl_b = rng.normal(0, 0.1, cout).astype(np.float32)
        variables["ctrl"]["b"] = ctrl_b
    lin.ctrl = Ctrl(torch.from_numpy(w), None if ctrl_b is None else torch.from_numpy(ctrl_b))
    if case == "lora":
        a, b = (rng.normal(0, 0.3, s).astype(np.float32) for s in ((cin, 3), (3, cout)))
        variables["lora"] = {"a": a, "b": b, "scale": np.float32(0.7)}
        lin.lora = LoRA(cin, 3, cout, 0.7)
        with torch.no_grad():
            lin.lora.a.copy_(torch.from_numpy(a))
            lin.lora.b.copy_(torch.from_numpy(b))
    if case == "int8":
        q = rng.integers(-127, 128, (cin, cout)).astype(np.int8)
        s = rng.uniform(0.001, 0.01, (1, cout)).astype(np.float32)
        del variables["params"]["kernel"]
        variables["quant"] = {"qvalue": q, "qscale": s}
        lin._set_quantized(torch.from_numpy(q.T.copy()), torch.from_numpy(s.T.copy()))
    jlin = jlayers.Linear(cout, dtype=jnp.float32, param_dtype=jnp.float32)
    trained = ("ctrl", "lora")

    def f(tv, xx):
        y = jlin.apply({**variables, **tv}, xx)
        return jnp.sum(y * jnp.cos(y)), y

    tv = {k: variables[k] for k in trained if k in variables}
    (_, ref), (gtv, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(tv, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    params = {"ctrl.w": lin.ctrl.w}
    if case == "bias":
        params["ctrl.b"] = lin.ctrl.b
    if case == "lora":
        params.update({"lora.a": lin.lora.a, "lora.b": lin.lora.b, "lora.scale": lin.lora.scale})
    grads = torch.autograd.grad(torch.sum(y * torch.cos(y)), [xt, *params.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), rtol=1e-6, atol=1e-6)
    for (k, _), g in zip(params.items(), grads[1:]):
        coll, leaf = k.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(gtv[coll][leaf]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_ctrl_refuses_another_overlay_on_its_linear():
    lin = Linear(4, 3)
    lin.ctrl = Ctrl(torch.zeros(2, 3))
    lin.ara = LoRA(4, 1, 3, 1.0)
    with pytest.raises(NotImplementedError, match="ctrl"):
        lin(torch.zeros(1, 6))


# ---- channels, init, host-side assembly ----

def test_channel_math_and_init_statistics():
    for nc, inpaint in ((1, False), (2, False), (3, False), (1, True)):
        want = jcl.control_lora_extra_channels(64, nc, inpaint)
        assert tcl.control_lora_extra_channels(64, nc, inpaint) == want == (68 if inpaint else 64 * nc)
        w = tcl.init_control_lora(3072, 64, torch.Generator().manual_seed(1), nc, inpaint)
        assert w.shape == (want, 3072) and w.dtype == torch.float32
        assert abs(float(w.mean())) < 2e-4 and abs(float(w.std()) - 0.01) < 2e-4  # N(0, 1) * 0.01
    for fn, rng in ((tcl.init_control_lora, torch.Generator()), (jcl.init_control_lora, jax.random.key(0))):
        with pytest.raises(ValueError, match="has_inpainting_input"):
            fn(32, 64, rng, num_control_images=2, has_inpainting_input=True)


@pytest.mark.parametrize("keep,dropout,invert", [(True, 0.0, 0.0), (False, 0.0, 0.0), (True, 0.5, 0.5),
                                                 (False, 0.3, 0.7)])
def test_assemble_inpaint_control_matches_jax(keep, dropout, invert):
    """Six calls in a row on one generator each side: every tensor equal bit
    for bit, and the generators end in the same state."""
    data = np.random.default_rng(5)
    rt, rj = np.random.default_rng(4321), np.random.default_rng(4321)
    for _ in range(6):
        lat = data.standard_normal((2, 8, 12, 4), dtype=np.float32)
        px = data.uniform(0, 1, (2, 16, 24, 1)).astype(np.float32) if keep else None
        out = tcl.assemble_inpaint_control(lat, px, rt, dropout, invert)
        want = jcl.assemble_inpaint_control(lat, px, rj, dropout, invert)
        assert out.shape == (2, 8, 12, 5) and out.dtype == np.float32
        np.testing.assert_array_equal(out, want)
    assert rt.bit_generator.state == rj.bit_generator.state


def _encode(px: np.ndarray) -> np.ndarray:
    """A stand-in VAE: 8x average pooling to 4 channels (numpy, deterministic)."""
    b, h, w, _ = px.shape
    pooled = px.reshape(b, h // 8, 8, w // 8, 8, 3).mean(axis=(2, 4))
    return np.concatenate([pooled, pooled[..., :1] * 2.0], axis=-1).astype(np.float32)


def _raws(n_ctrl):
    """Three batches of two 16x16 images: with ``n_ctrl`` control slots (none:
    no control image), the second item with one control fewer."""
    data = np.random.default_rng(9)
    out = []
    for _ in range(3):
        raw = {"latents": data.standard_normal((2, 2, 2, 4), dtype=np.float32), "captions": ["a", "b"],
               "loss_multiplier": np.ones(2, np.float32), "bucket": (16, 16),
               "inpaint_keep": data.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)}
        if n_ctrl:
            multi = data.uniform(-1, 1, (2, n_ctrl, 16, 16, 3)).astype(np.float32)
            multi[1, n_ctrl - 1] = 0.0  # the loader's blank for the slot the item lacks
            raw["control_pixels"] = multi[:, 0]
            if n_ctrl > 1:
                raw["control_pixels_multi"] = multi
        out.append(raw)
    return out


@pytest.mark.parametrize("num_control,n_ctrl,inpaint", [(1, 1, False), (2, 1, False), (2, 2, False),
                                                        (3, 2, False), (2, 0, False), (1, 0, True)])
def test_batch_control_matches_the_jax_job(tmp_path, num_control, n_ctrl, inpaint):
    """The control latents of three batches in a row at ``control_image_dropout``
    0.4 (and ``invert_inpaint_mask_chance`` 0.5): the port's job against JAX
    ``_prepare_batch`` with the same stand-in encoder, bit for bit, and both
    jobs' ``default_rng(4321)`` end in the same state."""
    mode = {"inpaint": inpaint, "num_control": num_control, "control_image_dropout": 0.4,
            "invert_inpaint_mask_chance": 0.5}
    proc = _train_proc(tmp_path)
    proc["adapter"] = {"type": "control_lora", "num_control_images": num_control, "has_inpainting_input": inpaint}
    jp = JSDTrainProcess("job", JProcessConfig.from_dict(proc))
    jp.control_lora_mode, jp._encode_control = mode, _encode
    jmodel = types.SimpleNamespace(is_flow_matching=True, rope_table=lambda h, w, n: jnp.zeros((1,)))
    text = types.SimpleNamespace(get=lambda caps: {"txt": np.zeros((len(caps), 3, 4), np.float32)})
    (tp,) = get_job(_job("job", proc), device="cpu").processes
    tp.control_lora_mode = mode
    tmodel = types.SimpleNamespace(encode_images=lambda v, px: torch.from_numpy(_encode(px.numpy())))
    for raw in _raws(n_ctrl):
        want = np.asarray(jp._prepare_batch(jmodel, raw, text, None)["cond"]["control_latents"])
        got = tp._control_lora_latents(tmodel, {}, raw)
        assert got.shape == (2, 2, 2, 5 if inpaint else 4 * num_control)
        np.testing.assert_array_equal(got, want)
    assert tp._cl_rng.bit_generator.state == jp._cl_rng.bit_generator.state


# ---- the save layout ----

def test_save_load_and_upgrade_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((68, 24)).astype(np.float32)
    ours = tcl.control_lora_extra_flat(torch.from_numpy(w))
    ref = jcl.control_lora_extra_flat({"img_in": {"w": w}})
    assert sorted(ours) == sorted(ref) == [tcl.X_EMBEDDER_KEY]
    assert ours[tcl.X_EMBEDDER_KEY].flags["C_CONTIGUOUS"] and ours[tcl.X_EMBEDDER_KEY].shape == (24, 68)
    np.testing.assert_array_equal(ours[tcl.X_EMBEDDER_KEY], ref[tcl.X_EMBEDDER_KEY])
    from safetensors.numpy import save_file

    path = str(tmp_path / "cl.safetensors")
    save_file({**ours, "transformer.x_embedder.bias": np.ones(24, np.float32)}, path)
    got, want = tcl.load_control_lora_expansion(path), jcl.load_control_lora_expansion(path)["img_in"]
    assert sorted(got) == sorted(want) == ["b", "w"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    save_file({"x": np.zeros(1, np.float32)}, str(tmp_path / "plain.safetensors"))
    assert tcl.load_control_lora_expansion(str(tmp_path / "plain.safetensors")) is None
    assert jcl.load_control_lora_expansion(str(tmp_path / "plain.safetensors")) is None
    for width in (64, 68, 128, 200, 16):
        np.testing.assert_array_equal(tcl.upgrade_expansion(w, width), jcl.upgrade_expansion(w, width))


# ---- one step through the DiT ----

def test_control_lora_step_matches_jax(monkeypatch):
    """A LoRA (``img_in`` skipped) beside the expansion on the tiny flux DiT
    cut to one double block, one flux_shift adamw step with the port's t and
    noise injected into JAX: the loss, the expansion's and every LoRA
    gradient."""
    p = Pair("flux", depths=dict(depth_double=1, depth_single=0), seed=12)
    cfg = p.model.dit_config
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((2 * cfg.in_channels, cfg.hidden_size)) * 0.05).astype(np.float32)
    p.dit.img_in.ctrl = Ctrl(torch.from_numpy(w))
    p.model.dit_config = cfg = type(cfg)(**{**cfg.__dict__, "control_channels": w.shape[0]})
    lora = build_lora(p.dit, LoRASpec(rank=2, alpha=2.0, ignore_if_contains=["img_in"],
                                      target_patterns=p.model.lora_targets()), torch.Generator().manual_seed(4))
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(5))
    assert "img_in" not in lora
    jspec = jlora.LoRASpec(rank=2, alpha=2.0, ignore_if_contains=["img_in"],
                           target_patterns=JFluxModel.lora_targets(p.jmodel))
    jpaths = sorted("/".join(x) for x in jlora.lora_paths(jlora.build_lora(p.tree, jspec, jax.random.key(0))))
    assert jpaths == sorted(flux_jax_path(n).replace(".", "/") for n in lora)
    jtree: dict = {}
    for name, m in lora.items():
        node = jtree
        for part in flux_jax_path(name).split("."):
            node = node.setdefault(part, {})
        node.update({k: np.array(getattr(m, k).detach().numpy()) for k in ("a", "b", "scale")})
    trainable = {f"{n}.{k}": getattr(m, k) for n, m in lora.items() for k in ("a", "b", "scale")}
    trainable["ctrl.w"] = p.dit.img_in.ctrl.w
    inp = p.inputs()
    hh, ww, _ = inp["hw"]
    jc, tc = p.conds(inp)
    ctrl = rng.standard_normal((2, hh, ww, w.shape[0] // 4)).astype(np.float32)
    jc["control_latents"], tc["control_latents"] = jnp.asarray(ctrl), torch.from_numpy(ctrl)
    names = list(trainable)
    state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
    seen = {}
    real = state.optimizer.step
    state.optimizer.step = lambda grads: seen.update(zip(names, (g.clone() for g in grads))) or real(grads)
    seq = (hh // 2) * (ww // 2)
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": tc, "image_seq_len": seq, "loss_multiplier": torch.ones(2)}
    metrics = make_train_step(lambda x, t, c: p.model.predict({"dit": p.dit}, x, t, c), FlowMatchSchedule(),
                              TrainStepConfig(timestep_type="flux_shift"))(state, [batch],
                                                                          torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    t = FlowMatchSchedule().sample_timesteps(g, 2, "flux_shift", seq, 1.0)
    noise = torch.randn(inp["x"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, r, b, *args, **kwargs):
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jstate = JTrainState.create({"dit": p.tree}, {"lora": jtree, "ctrl": {"img_in": {"w": w}}},
                                jget_optimizer("adamw", 1e-3))
    jtrain = jstep.make_train_step(p.jmodel.predict, Injected(), jstep.TrainStepConfig(timestep_type="flux_shift"))
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        got = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: got.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, b, jax.random.key(0), image_seq_len=seq)
        return m, got[0]

    jm, jg = fast_jit(run, jstate, {"latents": jnp.asarray(inp["x"]), "cond": jc, "loss_multiplier": jnp.ones(2)})
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    ref = {"ctrl.w": np.asarray(jg["ctrl"]["img_in"]["w"])}
    for name in lora:
        node = jg["lora"]
        for part in flux_jax_path(name).split("."):
            node = node[part]
        ref.update({f"{name}.{k}": np.asarray(node[k]) for k in ("a", "b", "scale")})
    gmax = max(float(np.abs(v).max()) for v in ref.values())
    assert float(np.abs(ref["ctrl.w"]).max()) > 0
    for k, v in ref.items():
        np.testing.assert_allclose(seen[k].numpy(), v, rtol=1e-5, atol=1e-4 * gmax, err_msg=k)


# ---- the job ----

def _png(path, size, seed, mode="RGB"):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (size, size, 4 if mode == "RGBA" else 3), dtype=np.uint8)
    Image.fromarray(arr, mode).save(path)
    return str(path)


def _cl_proc(tmp_path, inpaint, steps=3):
    proc = _train_proc(tmp_path)
    imgs = proc["datasets"][0]["folder_path"]
    side = tmp_path / ("inpaint" if inpaint else "ctrl")
    side.mkdir(exist_ok=True)
    for i, f in enumerate(sorted(f for f in os.listdir(imgs) if not f.endswith(".txt"))):
        _png(side / f, 64, 30 + i, "RGBA" if inpaint else "RGB")
    proc["datasets"][0]["inpaint_path" if inpaint else "control_path"] = str(side)
    proc["adapter"] = {"type": "control_lora", "lora_config": proc.pop("network"),
                       "num_control_images": 1 if inpaint else 2, "has_inpainting_input": inpaint,
                       "control_image_dropout": 0.2}
    proc["train"]["steps"] = steps
    proc["save"]["save_every"] = 100  # the final save alone: a rerun goes on from it
    proc["sample"] = {"sample_every": 0, "width": 32, "height": 32, "sample_steps": 2,
                      "prompts": [{"prompt": "sks", "ctrl_img": _png(tmp_path / "c.png", 32, 3, "RGBA")}]}
    return proc


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = {}
    for inpaint in (False, True):
        tmp = tmp_path_factory.mktemp("inpaint" if inpaint else "ctrl")
        job = get_job(_job("cl", _cl_proc(tmp, inpaint)), device="cpu")
        (res,) = job.run()
        out[inpaint] = (job.processes[0], res, tmp)
    return out


@pytest.mark.parametrize("inpaint", [False, True])
def test_job_trains_saves_resumes_and_samples(jobs, inpaint):
    """The tiny job (3 steps, EMA, a control folder or an RGBA inpaint folder):
    the expansion and the LoRA move, the file holds the LoRA under the JAX
    job's keys (no ``img_in`` entry) and ``transformer.x_embedder.weight``
    ``[hidden, extra_in]``, the EMA copy in f32; samples run with the control;
    a rerun to 4 steps reads the save back."""
    proc, res, tmp = jobs[inpaint]
    extra = 16 + 4 if inpaint else 2 * 16
    hidden = proc.model.dit_config.hidden_size
    w = proc.state.trainable["ctrl.w"]
    assert w.shape == (extra, hidden) and proc.model.dit_config.control_channels == extra
    fresh = tcl.init_control_lora(hidden, 16, torch.Generator().manual_seed(3 + 41), 1 if inpaint else 2, inpaint)
    assert not torch.equal(w.detach(), fresh)  # trained away from its seeded init
    assert all(float(p.detach().abs().max()) > 0 for k, p in proc.state.trainable.items() if k.endswith(".b"))
    assert not any("img_in" in n for n in proc.lora)
    with safe_open(res["save_path"], "np") as f:
        flat = {k: f.get_tensor(k) for k in f.keys()}
    xe = flat.pop(tcl.X_EMBEDDER_KEY)
    assert xe.shape == (hidden, extra) and xe.dtype == np.float32
    np.testing.assert_array_equal(xe, proc.state.ema["ctrl.w"].numpy().T)
    jmodel = JFluxModel(JModelConfig.from_dict(TINY_FLUX))
    jtree: dict = {}
    for name in proc.lora:
        node = jtree
        for part in flux_jax_path(name).split("."):
            node = node.setdefault(part, {})
        node.update({k: np.zeros(tuple(proc.state.ema[f"{name}.{k}"].shape), np.float32) for k in ("a", "b", "scale")})
    ref = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jmodel, jtree), fmt="peft")
    assert sorted(flat) == sorted(ref)
    assert [(s["step"], s["index"]) for s in res["samples"]] == [(0, 0), (3, 0)]
    for s in res["samples"]:
        assert np.asarray(Image.open(s["path"])).shape == (32, 32, 3)
    again = _cl_proc(tmp, inpaint, steps=4)
    again["train"]["disable_sampling"] = True
    read = proc._expansion_from_file(res["save_path"], {"ctrl.w": tuple(w.shape)})
    np.testing.assert_array_equal(read["ctrl.w"].numpy(), xe.T)
    (res2,) = get_job(_job("cl", again), device="cpu").run()
    assert res2["start_step"] == 3 and len(res2["losses"]) == 1


def test_sampling_control_latents_of_the_inpainting_base(jobs):
    """``sampling_control_latents`` of the inpainting job's model against JAX's
    on the same VAE: an RGBA ``ctrl_img`` gives its latents where its alpha
    keeps them and ``1 - alpha``; an RGB one gives zeros and ones."""
    proc, _, tmp = jobs[True]
    jmodel = JFluxModel(JModelConfig.from_dict(TINY_FLUX))
    jmodel.control_lora_inpaint = True
    jmodel.encode_images = lambda v, px: fast_jit(JFluxModel.encode_images.__get__(jmodel), v, px)
    vae = proc.variables["vae"]
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in vae.state_dict().items()}, vae_rules())
    assert not unmatched
    for path, mode in ((_png(tmp / "s.png", 24, 1, "RGBA"), "RGBA"), (_png(tmp / "t.png", 24, 2), "RGB")):
        out = proc.model.sampling_control_latents(proc.variables, 6, 6, path, 12, 12)
        ref = np.asarray(jmodel.sampling_control_latents({"vae": tree}, 6, 6, path, 12, 12))
        assert out.shape == ref.shape == (1, 6, 6, 5)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        assert (out[..., 4] == 1).all() == (mode == "RGB")


# ---- the alias and the refusals ----

def test_textual_inversion_trainer_builds_the_trainer():
    """JAX ``dispatch.py:28`` maps ``textual_inversion_trainer`` to the trainer:
    the shipped textual-inversion file under that type builds the same
    process as under ``sd_trainer``, at ``tiny``."""
    procs = {}
    for ptype in ("sd_trainer", "textual_inversion_trainer"):
        raw = get_config(os.path.join(ROOT, "configs", "examples", "train_textual_inversion_sd15.yaml"))
        proc = raw["config"]["process"][0]
        proc["type"] = ptype
        proc["model"].update(name_or_path="", model_kwargs={"size": "tiny"})
        (procs[ptype],) = get_job(raw, device="cpu").processes
    a, b = procs["sd_trainer"], procs["textual_inversion_trainer"]
    assert type(a) is type(b) is SDTrainProcess and a.textual_inversion and b.textual_inversion
    assert a.cfg.embedding == b.cfg.embedding and a.cfg.train == b.cfg.train and a.cfg.model == b.cfg.model
    b._refuse_unported()


@pytest.mark.parametrize("over,err,match", [
    ({"adapter": {"type": "control_lora"}, "network": None}, ValueError, "requires network"),
    ({"adapter": {"type": "control_lora", "lora_config": {"type": "lokr", "linear": 4}}, "network": None},
     NotImplementedError, "beside network 'lokr'.*item 6e"),
    ({"adapter": {"type": "control_lora", "scale": 1.0}}, NotImplementedError, r"adapter keys \['scale'\]"),
    ({"adapter": {"type": "control_lora", "num_control_images": 2, "has_inpainting_input": True}}, ValueError,
     "has_inpainting_input"),
    ({"adapter": {"type": "control_lora"}, "model": {"arch": "chroma"}}, NotImplementedError, "item 6e"),
    ({"adapter": {"type": "ip_adapter"}, "model": {"arch": "chroma"}}, NotImplementedError, "item 6e"),
    ({"adapter": {"type": "t2i"}}, NotImplementedError, "item 6e"),
    ({"adapter": {"type": "ilora"}}, NotImplementedError, "item 6e"),
])
def test_what_stays_refused(tmp_path, over, err, match):
    """No network beside the adapter (JAX's ValueError), a network other than
    LoRA, an adapter key JAX does not read for the type, the inpainting input
    with several controls, another flux arch, IP-Adapter on an arch it is not
    ported to, t2i on flux (a UNet adapter), and the other item-6e adapters."""
    proc = _train_proc(tmp_path)
    for key, val in over.items():
        if val is None:
            proc.pop(key)
        elif isinstance(proc.get(key), dict):
            proc[key] = {**proc[key], **val}
        else:
            proc[key] = val
    (jp,) = get_job(_job("refused", proc), device="cpu").processes
    with pytest.raises(err, match=match):
        jp._refuse_unported()
