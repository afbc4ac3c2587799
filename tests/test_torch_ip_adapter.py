"""IP-Adapter in the port against the JAX package on the CPU, in f32 at tiny
sizes: ``ImageProjModel`` and the perceiver ``Resampler``, the UNet's
decoupled cross-attention through ``predict_train`` with ``ip_embeds`` on
SD 1.x and SDXL (the ``Resampler``'s 16 tokens), flux ``predict`` with
``ip_embeds`` through one double and one single block, one IP step on the
tiny SD and on tiny flux against JAX ``train/step.make_train_step`` (the
port's draws injected), and the refusals. The tiny jobs, their files and
the JAX-fault pairs that read them: ``test_torch_ip_adapter_jobs.py``; the
other JAX-fault pairs: ``test_torch_ip_adapter_faults.py`` (each file holds
11 tests or fewer: xdist deals the files largest first, so these run beside
the suite's long tail).

Weights: the JAX trees are seeded values at the JAX inits' shapes
(``torch_jax_opt.seeded_init``) or the port's seeded init through the JAX
importer rules, carried into the port by ``io/from_jax``
(``ip_proj_state_dict``, ``unet_ip_state``, ``flux_ip_state``).

Tolerance: ``rtol`` 1e-5 and an ``atol`` of 1e-5 of the largest reference
value for the projections and the UNet; 1e-4 through the flux DiT (its
``time_in``, as in the flux-family tests); a step's loss at ``rtol`` 1e-5
and each gradient at 1e-4 of the largest gradient of the adapter."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open
from test_torch_flux_family import ONE_EACH, Pair, fast_jit
from test_torch_sd15 import port_init_as_jax

from ai_toolkit_tpu.adapters import ip_adapter as jip
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.models.sd_model import SDModel as JSDModel
from ai_toolkit_tpu.models.sd_model import SDXLModel as JSDXLModel
from ai_toolkit_tpu.samplers.ddpm import DDPMSchedule as JDDPMSchedule
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JFlowSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import ip_adapter as tip
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.models.sd_model import SDModel, SDXLModel
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train import step as tstep
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)


def _close(ours, ref, what="", rel=1e-5, scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=rel * scale, err_msg=what)


def _np(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def jax_proj(plus: bool, embed: int, cross: int, n_tokens: int, seed: int = 0):
    """(JAX module, its params as seeded values, the port module carrying them)."""
    if plus:
        jm = jip.Resampler(cross_dim=cross, n_tokens=n_tokens, dim=32, depth=2, heads=2)
        params = _np(seeded_init(jm.init, jax.random.key(seed), jnp.zeros((1, 5, embed)))["params"])
        ours = tip.Resampler(embed, cross, n_tokens, 32, 2, 2)
    else:
        jm = jip.ImageProjModel(cross_dim=cross, n_tokens=n_tokens)
        params = _np(seeded_init(jm.init, jax.random.key(seed), jnp.zeros((1, embed)))["params"])
        ours = tip.ImageProjModel(embed, cross, n_tokens)
    ours.load_state_dict(from_jax.ip_proj_state_dict(params))
    return jm, params, ours


@pytest.mark.parametrize("plus", [False, True])
def test_projections_match_jax(plus):
    """``ImageProjModel`` over pooled embeddings, the ``Resampler`` (2 layers,
    2 heads of 16) over patch tokens: 1e-5 of max|ref|."""
    jm, params, ours = jax_proj(plus, 24, 40, 4)
    x = np.random.default_rng(1).standard_normal((2, 7, 24) if plus else (2, 24)).astype(np.float32)
    ref = fast_jit(lambda p, v: jm.apply({"params": p}, v), params, jnp.asarray(x))
    with torch.no_grad():
        out = ours(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 4, 40)
    _close(out.numpy(), ref)


# ---- the UNet ----

def sd_pair(arch: str):
    """(JAX model, its UNet tree, port model, variables) at the tiny size, the
    same weights on both sides (the port's seeded init through the JAX
    importer rules)."""
    cfg = {"name_or_path": "", "arch": arch, "model_kwargs": {"size": "tiny"}}
    model = (SDXLModel if arch == "sdxl" else SDModel)(ModelConfig.from_dict(cfg), device="cpu")
    jmodel = (JSDXLModel if arch == "sdxl" else JSDModel)(JModelConfig.from_dict(cfg))
    tree = port_init_as_jax(arch)["unet"]
    unet = model._constructors()["unet"]()
    unet.load_state_dict(from_jax.unet_state_dict(tree))
    return jmodel, tree, model, {"unet": unet.requires_grad_(False)}


def unet_ip(jmodel, tree, unet, scale=0.7, seed=4):
    """The JAX ``ip`` collection of ``tree`` (``build_ip_collection``, V moved
    off attn2's so K and V differ) and the port's sites carrying it."""
    ip = _np(jip.build_ip_collection(tree, jmodel.unet_config.cross_attention_dim, scale=scale))
    rng = np.random.default_rng(seed)
    for leaf in jax.tree_util.tree_leaves(ip, is_leaf=lambda n: isinstance(n, dict) and "ip_v" in n):
        leaf["ip_v"] = leaf["ip_v"] + rng.normal(0, 0.05, leaf["ip_v"].shape).astype(np.float32)
    ours = tip.build_ip_collection(unet)
    state = from_jax.unet_ip_state(ip, len(jmodel.unet_config.block_out_channels))
    assert sorted(state) == sorted(ours)
    for name, m in ours.items():
        m.load_state_dict(state[name])
    return ip, ours


def _sd_inputs(jmodel, model, arch, b=2, seed=5):
    rng = np.random.default_rng(seed)
    cfg = jmodel.unet_config
    inp = {"x": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
           "t": np.asarray([37, 811], np.int64)[:b],
           "context": rng.standard_normal((b, 9, cfg.cross_attention_dim), dtype=np.float32)}
    jc, tc = {"context": jnp.asarray(inp["context"])}, {"context": torch.from_numpy(inp["context"])}
    if arch == "sdxl":
        pooled = rng.standard_normal((b, 64), dtype=np.float32)
        jc["added_cond"] = jmodel.added_cond(jnp.asarray(pooled), 64, 64)
        tc["added_cond"] = model.added_cond(torch.from_numpy(pooled), 64, 64)
    return inp, jc, tc


@pytest.mark.parametrize("arch", ["sd1", "sdxl"])
def test_predict_train_with_ip_embeds_matches_jax(arch, monkeypatch):
    """``predict_train`` with ``ip_embeds``: the projection's tokens (sd1: the
    base ``ImageProjModel``, 4 tokens; sdxl: the ``Resampler``, 16, with the
    added condition) feed every ``attn2`` site's decoupled K/V; 1e-5 of
    max|ref|; the image moves the prediction. (Head_dim 64 and the flash
    kernel's plain version over the image tokens: the flux tests and, on
    the card, ``chip_smoke.py``.)"""
    jmodel, tree, model, variables = sd_pair(arch)
    plus = arch == "sdxl"
    cross = jmodel.unet_config.cross_attention_dim
    jproj, params, proj = jax_proj(plus, 24, cross, 16 if plus else 4)
    ip, _ = unet_ip(jmodel, tree, variables["unet"])
    jmodel.ip_proj = jproj
    inp, jc, tc = _sd_inputs(jmodel, model, arch)
    emb = np.random.default_rng(6).standard_normal((2, 7, 24) if plus else (2, 24)).astype(np.float32)
    t = jnp.asarray(inp["t"], jnp.int32)
    ref = fast_jit(lambda v, x, c: jmodel.predict_train(v, x, t, c),
                   {"unet": tree, "ip": ip, "ip_proj": params}, jnp.asarray(inp["x"]),
                   {**jc, "ip_embeds": jnp.asarray(emb)})
    with torch.no_grad():
        out = model.predict_train({**variables, "ip_proj": proj}, torch.from_numpy(inp["x"]),
                                  torch.from_numpy(inp["t"]), {**tc, "ip_embeds": torch.from_numpy(emb)})
        plain = model.predict(variables, torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]), tc)
    _close(out.numpy(), ref)
    assert float((out - plain).abs().max()) > 1e-3 * float(plain.abs().max())


def test_flux_predict_with_ip_embeds_matches_jax():
    """flux ``predict`` with ``ip_embeds``: the Resampler's tokens at the
    hidden width feed the ``random``-init K/V of the double and the single
    block; 1e-4 of max|ref| (the DiT's ``time_in``)."""
    p = Pair("flux", depths=ONE_EACH, seed=12)
    hid = p.model.dit_config.hidden_size
    jproj, params, proj = jax_proj(True, 24, hid, 6)
    ip = _np(jip.build_flux_ip_collection(p.tree, hid, jax.random.key(3), init="random", scale=0.8))
    ours = tip.build_flux_ip_collection(p.dit, hid, init="random")
    state = from_jax.flux_ip_state(ip)
    assert sorted(state) == sorted(ours) == ["double_blocks.0", "single_blocks.0"]
    for name, m in ours.items():
        m.load_state_dict(state[name])
    p.jmodel.ip_proj = jproj
    inp = p.inputs()
    jc, tc = p.conds(inp)
    emb = np.random.default_rng(7).standard_normal((2, 5, 24)).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    try:
        with torch.no_grad():
            out = p.model.predict({"dit": p.dit, "ip_proj": proj}, torch.from_numpy(inp["x"]), torch.from_numpy(t),
                                  {**tc, "ip_embeds": torch.from_numpy(emb)})
    finally:
        tip.detach_ip(p.dit)
    ref = fast_jit(p.jmodel.predict, {"dit": p.tree, "ip": ip, "ip_proj": params}, jnp.asarray(inp["x"]),
                   jnp.asarray(t), {**jc, "ip_embeds": jnp.asarray(emb)})
    _close(out.numpy(), ref, rel=1e-4)


# ---- one step ----

def one_step(monkeypatch, predict, trainable, batch, jpredict, jfrozen, jtrainable, jbatch, schedule, jschedule,
             to_port, **cfg):
    """One adamw step of the port's ``make_train_step`` and of JAX's over the
    same draws: the port's t and noise are recorded and handed to JAX
    (``sample_timesteps`` and ``jax.random.normal``). ``to_port(jax grads)``
    gives ``{trainable name: array in the port layout}``. Returns ((loss,
    grads), (JAX loss, JAX grads))."""
    names = list(trainable)
    state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
    seen, drawn = {}, {}
    real = state.optimizer.step
    state.optimizer.step = lambda grads: seen.update(zip(names, (g.clone() for g in grads))) or real(grads)
    real_loss = tstep.train_loss

    def recorded(fn, sched, c, b, noise, t, *a, **k):
        drawn.update(noise=noise.numpy().copy(), t=t.numpy().copy())
        return real_loss(fn, sched, c, b, noise, t, *a, **k)

    monkeypatch.setattr(tstep, "train_loss", recorded)
    metrics = tstep.make_train_step(predict, schedule, tstep.TrainStepConfig(**cfg))(
        state, [batch], torch.Generator().manual_seed(7))
    monkeypatch.setattr(tstep, "train_loss", real_loss)
    t_draw = jnp.asarray(drawn["t"], jnp.int32 if drawn["t"].dtype.kind == "i" else jnp.float32)

    class Injected(type(jschedule)):
        def sample_timesteps(self, r, b, *args, **kwargs):
            return t_draw

    inj = Injected.__new__(Injected)
    inj.__dict__.update(jschedule.__dict__)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(drawn["noise"],
                                                                                                 dtype))
    jstate = JTrainState.create(jfrozen, jtrainable, jget_optimizer("adamw", 1e-3))
    jtrain = jstep.make_train_step(jpredict, inj, jstep.TrainStepConfig(**cfg))
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        got = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: got.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, b, jax.random.key(0), image_seq_len=batch.get("image_seq_len"))
        return m, got[0]

    jm, jg = fast_jit(run, jstate, jbatch)
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    return (float(metrics["loss"]), {k: v.numpy() for k, v in seen.items()}), (float(jm["loss"]), to_port(jg))


def check_step(got, want):
    (loss, grads), (jloss, jgrads) = got, want
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    gmax = max(float(np.abs(v).max()) for v in jgrads.values())
    assert sorted(grads) == sorted(jgrads)
    for k, v in jgrads.items():
        assert grads[k].shape == v.shape, k
        _close(grads[k], v, k, rel=1e-4, scale=gmax)


def _proj_grads(g: dict, prefix: str = "ip_proj.") -> dict:
    return {prefix + k: v.numpy() for k, v in from_jax.ip_proj_state_dict(_np(g)).items()}


@pytest.mark.parametrize("arch", ["sd1", "flux"])
def test_ip_step_matches_jax(arch, monkeypatch):
    """One IP-Adapter step (sd1: DDPM epsilon, the base projection; flux:
    flux_shift, the Resampler and the random K/V): loss and every gradient
    of the projection and of each site's ip_k / ip_v / scale."""
    rng = np.random.default_rng(9)
    if arch == "sd1":
        jmodel, tree, model, variables = sd_pair(arch)
        jproj, params, proj = jax_proj(False, 24, jmodel.unet_config.cross_attention_dim, 4)
        ip, ours = unet_ip(jmodel, tree, variables["unet"])
        inp, jc, tc = _sd_inputs(jmodel, model, arch)
        x, frozen, schedule, jschedule, seq = inp["x"], {"unet": tree}, DDPMSchedule(), JDDPMSchedule(), None
        emb = rng.standard_normal((2, 24)).astype(np.float32)
        n = len(jmodel.unet_config.block_out_channels)

        def ip_grads(g):
            return {f"ip.{b}.{leaf}": v.numpy() for b, leaves in from_jax.unet_ip_state(_np(g), n).items()
                    for leaf, v in leaves.items()}
        cfg = {}
    else:
        p = Pair("flux", depths=ONE_EACH, seed=12)
        jmodel, model, hid = p.jmodel, p.model, p.model.dit_config.hidden_size
        jproj, params, proj = jax_proj(True, 24, hid, 6)
        ip = _np(jip.build_flux_ip_collection(p.tree, hid, jax.random.key(3), init="random", scale=0.8))
        ours = tip.build_flux_ip_collection(p.dit, hid, init="random")
        for name, st in from_jax.flux_ip_state(ip).items():
            ours[name].load_state_dict(st)
        inp = p.inputs()
        jc, tc = p.conds(inp)
        x, frozen, schedule, jschedule = inp["x"], {"dit": p.tree}, FlowMatchSchedule(), JFlowSchedule()
        seq, variables = 16, {"dit": p.dit}
        emb = rng.standard_normal((2, 5, 24)).astype(np.float32)

        def ip_grads(g):
            return {f"ip.{b}.{leaf}": v.numpy() for b, leaves in from_jax.flux_ip_state(_np(g)).items()
                    for leaf, v in leaves.items()}
        cfg = {"timestep_type": "flux_shift"}
    jmodel.ip_proj = jproj
    trainable = {f"ip_proj.{k}": v for k, v in proj.named_parameters()}
    trainable.update({f"ip.{b}.{leaf}": v for b, m in ours.items() for leaf, v in m.named_parameters()})
    predict = getattr(model, "predict_train", model.predict)
    jpredict = getattr(jmodel, "predict_train", jmodel.predict)
    batch = {"latents": torch.from_numpy(x), "cond": {**tc, "ip_embeds": torch.from_numpy(emb)},
             "loss_multiplier": torch.ones(2)}
    if seq:
        batch["image_seq_len"] = seq
    try:
        got, want = one_step(
            monkeypatch, lambda xx, tt, c: predict({**variables, "ip_proj": proj}, xx, tt, c), trainable, batch,
            jpredict, frozen, {"ip": ip, "ip_proj": params},
            {"latents": jnp.asarray(x), "cond": {**jc, "ip_embeds": jnp.asarray(emb)}, "loss_multiplier": jnp.ones(2)},
            schedule, jschedule, lambda g: {**_proj_grads(g["ip_proj"]), **ip_grads(g["ip"])}, **cfg)
    finally:
        if arch == "flux":
            tip.detach_ip(p.dit)
    check_step(got, want)
    assert any(abs(float(v)) > 0 for k, v in want[1].items() if k.endswith(".scale"))


# ---- the jobs (their tests: test_torch_ip_adapter_jobs.py) ----

def tiny_ip_job(tmp_path, arch, atype, steps=1, **over):
    imgs = tmp_path / "imgs"
    imgs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
        (imgs / f"{i}.txt").write_text(f"photo {i}")
    proc = {"type": "sd_trainer", "training_folder": str(tmp_path / "out"),
            "adapter": {"type": atype} if atype else None,
            "datasets": [{"folder_path": str(imgs), "caption_ext": "txt", "resolution": [32]}],
            "train": {"steps": steps, "dtype": "float32", "disable_sampling": True,
                      "noise_scheduler": "flowmatch" if arch.startswith("flux") else "ddpm"},
            "model": {"name_or_path": "", "arch": arch, "model_kwargs": {"size": "tiny"}},
            "save": {"save_every": 1}}
    for k, v in over.items():
        proc[k] = {**proc[k], **v} if isinstance(proc.get(k), dict) else v
    return {"job": "extension", "config": {"name": "job", "process": [proc]}}


def run_job(raw):
    (proc,) = get_job(raw, device="cpu").processes
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = proc.run()
    return proc, res, buf.getvalue()


def _read(path):
    with safe_open(path, "np") as f:
        return {k: f.get_tensor(k) for k in f.keys()}, f.metadata()


@pytest.mark.parametrize("over,match", [
    ({"model": {"arch": "sd2"}}, "adapter 'ip_adapter' on arch 'sd2'"),
    ({"model": {"arch": "chroma"}}, "adapter 'ip_adapter' on arch 'chroma'"),
    ({"adapter": {"type": "ip_adapter", "image_encoder_path": "/x"}}, r"adapter keys \['image_encoder_path'\]"),
])
def test_ip_refusals(tmp_path, over, match):
    """IP on an arch the port does not run it on, and an adapter key JAX
    does not read, raise by name."""
    (proc,) = get_job(tiny_ip_job(tmp_path, "sd1", "ip_adapter", **over), device="cpu").processes
    with pytest.raises(NotImplementedError, match=match):
        proc._refuse_unported()

