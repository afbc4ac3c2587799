"""The slider and paired-image guidance slice of the port against the JAX
package on the CPU, in f32 at tiny sizes: the per-sample LoRA multiplier on
one ``Linear`` (JAX ``ops/layers`` with ``scale_lora``: f32 values, bf16 bit
for bit), the adapter-off forward, the multiplier under recomputation,
``concept_slider_loss``, the polarity step's loss and the five guided kinds
(loss and every LoRA gradient against JAX ``value_and_grad``, the draws
injected; the guided kinds in ``test_torch_slider_guided.py``), the
ultimate slider's loss, the flow slider's partial denoise
against JAX's ``fori_loop``, the slider job's sequence of targets,
multipliers and denoise counts against the JAX job's loop, the paired
dataset's ``unconditional_pixels`` against the JAX loader, and the slider
jobs end to end with the JAX job's LoRA keys. Flux is the tiny flux cut to
one double and one single block (the flux-family tests' cut: small JAX
compiles); ``test_torch_slider_sd1.py`` holds the objectives on sd1.
The JAX compiles of the objectives are most of each file's time.

Tolerance: f32, ``rtol`` 1e-5 and an ``atol`` of 1e-4 of the largest
reference value on flux (its ``time_in`` meets one-ulp ``exp`` differences
between XLA and PyTorch, as in the flux-family tests), 1e-5 on sd1; a
gradient against the largest gradient of the whole LoRA."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_flux_family import Pair, _leaf, _lora_pair

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import DatasetConfig as JDatasetConfig
from ai_toolkit_tpu.data.loader import build_dataloader as jbuild_dataloader
from ai_toolkit_tpu.jobs import slider_process as jslider_process
from ai_toolkit_tpu.ops import layers as jlayers
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import slider as jslider
from ai_toolkit_tpu.train.state import merge_variables as jmerge
from ai_toolkit_tpu.train.step import TrainStepConfig as JStepConfig
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config.modules import DatasetConfig
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.data.loader import build_dataloader
from ai_toolkit_tpu_torch.jobs import run_job
from ai_toolkit_tpu_torch.jobs import slider_process
from ai_toolkit_tpu_torch.models.flux_model import FluxModel
from ai_toolkit_tpu_torch.models.sd_model import SDModel
from ai_toolkit_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from ai_toolkit_tpu_torch.ops.layers import ADAPTER_OFF, Linear, LoRA, init_parameters, lora_multiplier
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train import slider as tslider
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
W = 0.8  # network_weight: not 1, so a dropped multiplier shows
KINDS = ("concept", "polarity") + tslider.GUIDED_KINDS


# ---- the multiplier on one Linear ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_multiplier_matches_jax_linear(dtype, per_sample):
    """``Linear`` + ``LoRA`` under ``lora_multiplier`` against the JAX
    ``Linear`` applying the ``scale_lora`` leaf (``scale * mult`` in f32, cast
    to the layer's dtype, a ``[B]`` one broadcast over the trailing dims). The
    inputs are small multiples of 1/4 and 1/8, so every product is exact in
    bf16 and the bf16 outputs can be held bit for bit: a multiplier applied
    after the cast (the weak-typing trap) rounds ``scale * mult`` otherwise."""
    rng = np.random.default_rng(0)
    b, n, fin, fout, r = 3, 5, 16, 12, 4
    x = rng.integers(-4, 5, (b, n, fin)).astype(np.float32) / 4
    kernel = rng.integers(-4, 5, (fin, fout)).astype(np.float32) / 8
    a = rng.integers(-1, 2, (fin, r)).astype(np.float32) / 4
    up = rng.integers(-1, 2, (r, fout)).astype(np.float32) / 4
    scale = np.float32(0.37)  # 0.37 * 0.7 rounds to another bf16 than bf16(0.37) * bf16(0.7)
    mult = np.asarray([0.7, -1.3, 0.45], np.float32) if per_sample else 0.7
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    leaf = jlora.scale_lora({"m": {"a": a, "b": up, "scale": jnp.asarray(scale)}}, mult)["m"]
    ref = jlayers.Linear(features=fout, use_bias=False, dtype=jdt, param_dtype=jnp.float32).apply(
        {"params": {"kernel": kernel}, "lora": leaf}, jnp.asarray(x))
    lin = Linear(fin, fout, bias=False, dtype=tdt)
    lin.lora = LoRA(fin, r, fout, float(scale))
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T))
        lin.lora.a.copy_(torch.from_numpy(a))
        lin.lora.b.copy_(torch.from_numpy(up))
    with lora_multiplier(torch.from_numpy(mult) if per_sample else mult):
        out = lin(torch.from_numpy(x))
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    else:
        ours = out.detach().view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(ours, np.asarray(ref).view(np.uint16))
        with torch.no_grad():  # the trap this pins: the multiplier applied after the cast rounds otherwise
            delta = (torch.from_numpy(x).to(tdt) @ lin.lora.a.to(tdt)) @ lin.lora.b.to(tdt)
            m = torch.as_tensor(mult, dtype=tdt).reshape(-1, 1, 1)
            wrong = torch.from_numpy(x).to(tdt) @ lin.weight.t() + delta * (lin.lora.scale.to(tdt) * m)
        assert not torch.equal(wrong, out)


def _tiny_flux(depths=(1, 1)):
    model = FluxModel(ModelConfig.from_dict({"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "tiny"}}),
                      device="cpu")
    model.dit_config = dataclasses.replace(model.dit_config, depth_double=depths[0], depth_single=depths[1])
    from ai_toolkit_tpu_torch.models.flux_dit import FluxDiT

    return model, init_parameters(FluxDiT(model.dit_config), torch.Generator().manual_seed(0)).requires_grad_(False)


def _tiny_unet(remat: bool):
    cfg = dataclasses.replace(UNetConfig.tiny(), remat=remat)
    return init_parameters(UNet2DCondition(cfg), torch.Generator().manual_seed(0)).requires_grad_(False)


def _attach(net, targets, seed=3):
    lora = tlora.build_lora(net, tlora.LoRASpec(rank=4, alpha=8.0, target_patterns=targets),
                            torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(seed + 1))
    return lora


def _flux_inputs(model, b=2, seed=3):
    g = torch.Generator().manual_seed(seed)
    cfg = model.dit_config
    x = torch.randn((b, 8, 8, cfg.in_channels // 4), generator=g)
    cond = {"txt": torch.randn((b, 5, cfg.context_dim), generator=g), "y": torch.randn((b, cfg.vec_dim), generator=g),
            "guidance": torch.full((b,), 3.5), "pe": model.rope_table(8, 8, 5)}
    return x, torch.tensor([0.3, 0.85])[:b], cond


def _unet_inputs(b=2, seed=3):
    g = torch.Generator().manual_seed(seed)
    cfg = UNetConfig.tiny()
    return (torch.randn((b, 8, 8, 4), generator=g), torch.tensor([37, 811])[:b],
            {"context": torch.randn((b, 7, cfg.cross_attention_dim), generator=g)})


@pytest.mark.parametrize("arch", ["flux", "sd1"])
def test_adapter_off_is_the_base_forward(arch):
    """Under ``ADAPTER_OFF`` the model with a trained LoRA (b non-zero) gives
    exactly the forward without it (JAX drops the ``lora`` collection); with
    the adapter on it differs."""
    if arch == "flux":
        model, net = _tiny_flux()
        x, t, cond = _flux_inputs(model)
        fwd = lambda: model.predict({"dit": net}, x, t, cond)  # noqa: E731
        targets = model.lora_targets()
    else:
        net = _tiny_unet(remat=False)
        x, t, cond = _unet_inputs()
        fwd = lambda: net(x, t, cond["context"])  # noqa: E731
        targets = SDModel.lora_targets(None)
    with torch.no_grad():
        base = fwd()
        _attach(net, targets)
        with lora_multiplier(ADAPTER_OFF):
            off = fwd()
        on = fwd()
    assert torch.equal(off, base)
    assert not torch.equal(on, base)


def _naive_checkpoint(fn, *args, **kwargs):
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


@pytest.mark.parametrize("arch,policy", [("flux", "dots_flash"), ("flux", "full"), ("sd1", None)])
def test_multiplier_under_recompute(arch, policy, monkeypatch):
    """The recompute trap: the forward runs under ``lora_multiplier`` (a
    ``[B]`` vector ``[+1, -1]``, then a scalar -0.7), the block has exited
    before the backward, and the checkpointed blocks (flux: both policies;
    the UNet's ``remat``) recompute in the backward. The LoRA gradients
    equal those without recomputation. With a plain
    ``torch.utils.checkpoint`` in place of ``lora_checkpoint`` the
    recomputation runs without the multiplier: at the scalar the gradients
    come out silently wrong."""
    if arch == "flux":
        model, net = _tiny_flux()
        net.cfg = dataclasses.replace(net.cfg, checkpoint_policy=policy)
        x, t, cond = _flux_inputs(model)
        lora = _attach(net, model.lora_targets())

        def forward(recompute):
            net.gradient_checkpointing = recompute
            return model.predict({"dit": net}, x, t, cond)
        module = "ai_toolkit_tpu_torch.models.flux_dit"
    else:
        net = _tiny_unet(remat=True)
        x, t, cond = _unet_inputs()
        lora = _attach(net, SDModel.lora_targets(None))
        cfgs = {True: net.cfg, False: dataclasses.replace(net.cfg, remat=False)}

        def forward(recompute):
            net.cfg = cfgs[recompute]
            return net(x, t, cond["context"])
        module = "ai_toolkit_tpu_torch.models.unet"
    params = [p for m in lora.values() for p in m.parameters()]

    def grads(recompute, mult):
        with lora_multiplier(mult):
            out = forward(recompute)
        return torch.autograd.grad(out.square().mean(), params)  # after the block has exited

    for mult in (torch.tensor([1.0, -1.0]), -0.7):
        ref = grads(False, mult)
        gmax = max(float(g.abs().max()) for g in ref)
        for ours, want in zip(grads(True, mult), ref):
            np.testing.assert_allclose(ours.numpy(), want.numpy(), rtol=1e-6, atol=1e-7 * gmax)
    monkeypatch.setattr(f"{module}.lora_checkpoint", _naive_checkpoint)
    wrong = grads(True, -0.7)
    assert any(not torch.allclose(w, r, rtol=1e-3, atol=1e-3 * gmax) for w, r in zip(wrong, ref))


# ---- the objectives against JAX, on any pair of models ----

def jax_loss_fn(train_step):
    """The ``loss_fn`` a JAX slider ``train_step`` closes over (its
    ``value_and_grad``'s function)."""
    cells = dict(zip(train_step.__code__.co_freevars, (c.cell_contents for c in train_step.__closure__)))
    return cells["grad_fn"].__wrapped__


@dataclasses.dataclass
class Side:
    """One arch on both sides, with the same LoRA: the port's predict with
    the LoRA attached and its modules; the JAX predict, frozen variables and
    ``lora`` tree ({port name: JAX path} in ``paths``); a pair batch and a
    concept input for each side; the schedules (the JAX one is patched to
    return ``t``); ``rel``: the atol over the largest reference value."""

    predict: object
    lora: dict
    jpredict: object
    mv: dict
    jtree: dict
    paths: dict
    schedule: object
    jschedule: object
    batch: dict
    jbatch: dict
    noise: np.ndarray
    t: np.ndarray
    concept: tuple  # (noisy, t, [cond neutral, target, negative]) per side: (port, jax)
    rel: float
    seq: int | None = None


def _grads_close(ours: dict, ref_tree: dict, side: Side, what: str) -> None:
    ref = {k: np.asarray(_leaf(ref_tree, side.paths[k.rsplit(".", 1)[0]])[k.rsplit(".", 1)[1]]) for k in ours}
    gmax = max(float(np.abs(g).max()) for g in ref.values())
    assert gmax > 0
    for k, g in ours.items():
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-5, atol=side.rel * gmax, err_msg=f"{what}: {k}")


def _port_value_and_grads(side: Side, fn):
    names = [f"{n}.{leaf}" for n in side.lora for leaf in ("a", "b", "scale")]
    params = [getattr(side.lora[k.rsplit(".", 1)[0]], k.rsplit(".", 1)[1]) for k in names]
    for p in params:
        p.requires_grad_(True)
    loss = fn()
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), dict(zip(names, grads))


def check_objective(side: Side, kind: str, monkeypatch) -> None:
    """``kind``'s loss and LoRA gradients on both sides: ``concept``
    (``concept_slider_loss`` at multiplier 0.6), ``polarity`` (the polarity
    step's loss) or a guided kind, at ``network_weight`` ``W``, t and the
    noise injected into the JAX step."""
    noise, t = side.noise, side.t
    if kind == "concept":
        (noisy, tt, conds), (jnoisy, jt, jconds) = side.concept
        loss, grads = _port_value_and_grads(side, lambda: tslider.concept_slider_loss(
            side.predict, noisy, tt, conds[1], conds[0], conds[2], 3.0, 0.6))
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda lora: jslider.concept_slider_loss(
            side.jpredict, side.mv, {"lora": lora}, jnoisy, jt, jconds[1], jconds[0], jconds[2], 3.0, 0.6)))(
            side.jtree)
    else:
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
        if kind == "polarity":
            step = jslider.make_polarity_train_step(side.jpredict, side.jschedule, JStepConfig(), network_weight=W)
            port = lambda: tslider.polarity_loss(side.predict, side.schedule, side.batch,  # noqa: E731
                                                 torch.from_numpy(noise), torch.from_numpy(t), W)
        else:
            step = jslider.make_guided_train_step(kind, side.jpredict, side.jschedule, JStepConfig(),
                                                  network_weight=W)
            port = lambda: tslider.guided_loss(kind, side.predict, side.schedule, side.batch,  # noqa: E731
                                               torch.from_numpy(noise), torch.from_numpy(t), W)
        loss_fn = jax_loss_fn(step)
        loss, grads = _port_value_and_grads(side, port)
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda lora: loss_fn(
            {"lora": lora}, side.mv, side.jbatch, jax.random.key(0), side.seq)[0]))(side.jtree)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5, err_msg=kind)
    _grads_close(grads, ref_grads, side, kind)


def _flux_side() -> Side:
    p = Pair("flux")
    lora, jtree, paths = _lora_pair(p)
    inp = p.inputs(b=2, seed=3)
    neg = p.inputs(b=2, seed=4)["x"]
    jc, tc = p.conds(inp)
    c1 = [p.conds(p.inputs(b=1, seed=s)) for s in (5, 6, 7)]
    noisy = p.inputs(b=1, seed=8)["x"]
    t = inp["t"]

    class Injected(JSchedule):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t)

    return Side(
        predict=lambda x, tt, c: p.model.predict({"dit": p.dit}, x, tt, c), lora=lora,
        jpredict=p.jmodel.predict, mv={"dit": p.tree}, jtree=jtree, paths=paths, schedule=FlowMatchSchedule(),
        jschedule=Injected(),
        batch={"latents": torch.from_numpy(inp["x"]), "unconditional_latents": torch.from_numpy(neg), "cond": tc},
        jbatch={"latents": jnp.asarray(inp["x"]), "unconditional_latents": jnp.asarray(neg), "cond": jc},
        noise=inp["noise"], t=t,
        concept=((torch.from_numpy(noisy), torch.tensor([0.45]), [c[1] for c in c1]),
                 (jnp.asarray(noisy), jnp.asarray([0.45]), [c[0] for c in c1])),
        rel=1e-4, seq=16)


@pytest.fixture(scope="module")
def flux_side():
    return _flux_side()


@pytest.mark.parametrize("kind", ["concept", "polarity"])
def test_flux_objectives_match_jax(flux_side, kind, monkeypatch):
    check_objective(flux_side, kind, monkeypatch)


class _Caught(Exception):
    """Raised where the JAX job hands its loss to ``value_and_grad``."""


def _jax_ultimate_total_loss(s: Side, tmp_path, monkeypatch):
    """The JAX ultimate slider job's own ``total_loss`` (the closure of
    ``UltimateSliderProcess.run``, caught where its step hands it to
    ``value_and_grad``) over ``s``'s flux model and LoRA: image weight 0.7,
    concept weight 1.3, strength 3, ``network_weight`` ``W``, the job's
    schedule ``s.jschedule`` (t injected)."""
    from ai_toolkit_tpu.jobs import ultimate_slider_process as jult

    caught = {}

    class Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        def value_and_grad(self, fn, **kwargs):
            caught["total_loss"] = fn
            raise _Caught

    class Model:
        is_flow_matching = True
        bucket_divisibility = 16

        def __init__(self, cfg):
            self.predict = s.jpredict

        def load_variables(self, rng):
            return s.mv

        def lora_targets(self):
            return []

        def latent_shape(self, h, w):
            return s.jbatch["latents"].shape[1:]

        def encode_prompt(self, variables, prompts):
            return s.jbatch["cond"]

    raw = {"latents": np.asarray(s.jbatch["latents"]), "captions": ["a", "b"],
           "unconditional_latents": np.asarray(s.jbatch["unconditional_latents"])}
    monkeypatch.setattr(jult, "jax", Jax())
    monkeypatch.setattr(jult, "get_model_class", lambda arch: Model)
    monkeypatch.setattr(jult, "get_schedule", lambda *args: s.jschedule)
    monkeypatch.setattr(jult, "build_lora", lambda *args: s.jtree)
    monkeypatch.setattr("ai_toolkit_tpu.data.loader.build_dataloader", lambda *args, **kwargs: iter([raw]))
    job = {"job": "extension", "config": {"name": "ult", "process": [{
        "type": "ultimate_slider", "training_folder": str(tmp_path), "network": {"type": "lora", "linear": 2},
        "slider": {"targets": [{"target_class": "", "positive": "a", "negative": "b"}], "img_loss_weight": 0.7,
                   "cfg_loss_weight": 1.3, "guidance_strength": 3.0, "network_weight": W},
        "train": {"steps": 1, "noise_scheduler": "flowmatch", "optimizer": "adamw", "lr": 1e-3},
        "datasets": [{"folder_path": str(tmp_path / "pos"), "unconditional_path": str(tmp_path / "neg")}],
        "model": {"name_or_path": "", "arch": "flux"}}]}}
    with pytest.raises(_Caught):
        jult.UltimateSliderProcess("ult", _jax_job_config(job)).run()
    return caught["total_loss"]


def test_ultimate_slider_loss_matches_jax(flux_side, tmp_path, monkeypatch):
    """``ultimate_slider_loss`` (image weight 0.7, concept weight 1.3, the
    concept at multiplier 0.6) against the JAX job's own ``total_loss``: its
    image part one MSE over the pair's joined ``2B`` batch at ``[+w] * B +
    [-w] * B`` (JAX ``img_pair_loss``), its concept part
    ``concept_slider_loss``; the total, both parts and every LoRA gradient
    of the total, the noise and t injected."""
    s = flux_side
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(s.noise, dtype))
    total_loss = _jax_ultimate_total_loss(s, tmp_path, monkeypatch)
    (noisy, tt, conds), (jnoisy, jt, jconds) = s.concept
    (ref_loss, ref_parts), ref_grads = jax.jit(jax.value_and_grad(lambda lora: total_loss(
        lora, s.jbatch, jnoisy, jt, jconds[0], jconds[1], jconds[2], 0.6, jax.random.key(0)), has_aux=True))(
        s.jtree)
    parts = []

    def port():
        total, l_img, l_cfg = tslider.ultimate_slider_loss(
            s.predict, s.schedule, s.batch, torch.from_numpy(s.noise), torch.from_numpy(s.t), W, noisy, tt,
            conds[1], conds[0], conds[2], 3.0, 0.6, 0.7, 1.3)
        parts.extend(float(x.detach()) for x in (l_img, l_cfg))
        return total

    loss, grads = _port_value_and_grads(s, port)
    for o, r, what in zip([loss, *parts], [ref_loss, *ref_parts], ("total", "img_loss", "cfg_loss")):
        np.testing.assert_allclose(o, float(r), rtol=1e-5, err_msg=what)
    _grads_close(grads, ref_grads, s, "ultimate")


def test_partial_denoise_matches_jax_fori_loop(flux_side):
    """``partial_denoise`` (5 of 8 Euler steps at multiplier -0.8 from a
    given noise) against the JAX job's ``partial_denoise``: a ``fori_loop``
    over ``inference_sigmas(8)`` with the ``scale_lora`` tree; the latent
    (1e-4 of max|ref|) and its t (to an ulp: the two sigma tables differ by
    one at some entries)."""
    s = flux_side
    max_dn, steps_to, mult = 8, 5, -0.8
    (x, _, conds), (jx, _, jconds) = s.concept
    sig_tab = jnp.asarray(JSchedule().inference_sigmas(max_dn))

    @jax.jit
    def jpd(lora, x, steps_to):
        lv = jmerge(s.mv, {"lora": jlora.scale_lora(lora, mult)})

        def body(i, x):
            s0 = sig_tab[i]
            v = s.jpredict(lv, x, jnp.full((1,), s0), jconds[0])
            return x + (sig_tab[i + 1] - s0) * v.astype(x.dtype)

        x = jax.lax.fori_loop(0, steps_to, body, x)
        return x, jnp.full((1,), sig_tab[steps_to])

    ref_x, ref_t = jpd(s.jtree, jx, steps_to)
    ours_x, ours_t = tslider.partial_denoise(s.predict, FlowMatchSchedule().inference_sigmas(max_dn), x, steps_to,
                                             conds[0], mult)
    ref_x = np.asarray(ref_x)
    np.testing.assert_allclose(ours_x.numpy(), ref_x, rtol=1e-5, atol=1e-4 * float(np.abs(ref_x).max()))
    # the two schedules' sigma tables differ by an ulp at some entries (torch's and XLA's linspace)
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), rtol=2e-7)


# ---- the slider job's sequence against the JAX job's loop ----

PROMPTS = {"": 0.0, "person": 1.0, "old": 2.0, "young": 3.0, "dog": 4.0, "big": 5.0, "small": 6.0}
TARGETS = [{"target_class": "person", "positive": "old", "negative": "young", "weight": 1.0},
           {"target_class": "dog", "positive": "big", "negative": "small", "weight": 0.5}]


def _slider_job(tmp_path, arch, steps=6, **slider):
    return {"job": "extension", "config": {"name": "seq", "process": [{
        "type": "slider", "training_folder": str(tmp_path / arch),
        "network": {"type": "lora", "linear": 2, "linear_alpha": 2},
        "slider": {"guidance_strength": 3.0, "resolutions": [[16, 16]], "targets": TARGETS, **slider},
        "train": {"steps": steps, "optimizer": "adamw", "lr": 1e-3,
                  "noise_scheduler": "flowmatch" if arch == "flux" else "ddpm"},
        "model": {"name_or_path": "", "arch": arch}}]}}


def _jax_stub(flow: bool, events: list):
    class Stub:
        is_flow_matching = flow

        def __init__(self, cfg):
            pass

        def load_variables(self, rng):
            return {"unet": {"lin": {"kernel": jnp.zeros((4, 4))}}}

        def lora_targets(self):
            return ["lin"]

        def lora_key_map(self, lora):
            return {}

        def latent_shape(self, h, w):
            return h // 8, w // 8, 4

        def encode_prompt(self, variables, prompts):
            return {"context": jnp.full((1, 1, 1), PROMPTS[prompts[0]])}

        def predict(self, variables, x, t, cond):
            jax.debug.callback(lambda: events.append(("predict",)), ordered=True)
            return jnp.zeros_like(x)

    def loss(predict_fn, variables, trainable, noisy, t, cond_target, cond_neutral, cond_negative,
             guidance_strength=3.0, multiplier=1.0):
        jax.debug.callback(lambda *v: events.append(("loss",) + tuple(float(x) for x in v)),
                           cond_target["context"][0, 0, 0], cond_neutral["context"][0, 0, 0],
                           cond_negative["context"][0, 0, 0], multiplier, ordered=True)
        return jnp.sum(trainable["lora"]["lin"]["a"]) * 0.0

    return Stub, loss


def _port_stub(flow: bool, events: list):
    base = FluxModel if flow else SDModel
    kept = []

    class Stub(base):
        lora_key = None

        def __init__(self, cfg, device):
            self.config, self.device = cfg, torch.device(device)

        def load_variables(self, generator, qtype=None):
            kept.append(torch.nn.Module())
            kept[-1].lin = Linear(4, 4)
            return {self.main_component: kept[-1]}

        def lora_targets(self):
            return ["lin"]

        def latent_shape(self, h, w):
            return h // 8, w // 8, 4

        def encode_prompt(self, variables, prompts):
            return {"context": torch.full((1, 1, 1), PROMPTS[prompts[0]])}

        def rope_table(self, *args):
            return torch.zeros(1)

        def predict(self, variables, x, t, cond):
            events.append(("predict",))
            return torch.zeros_like(x)

    def loss(predict_fn, noisy, t, cond_target, cond_neutral, cond_negative, guidance_strength, multiplier):
        events.append(("loss", float(cond_target["context"]), float(cond_neutral["context"]),
                       float(cond_negative["context"]), float(multiplier)))
        return sum(p.sum() for p in kept[-1].lin.lora.parameters()) * 0.0

    return Stub, loss


@pytest.mark.parametrize("arch", ["sd1", "flux"])
def test_slider_sequence_matches_jax_loop(arch, tmp_path, monkeypatch):
    """The slider job over 6 steps and 2 targets (weights 1 and 0.5) with
    stub models on both sides: each step's target (its conditions), its
    multiplier (+w, -w, ... trained at |w|), the swapped positive and
    negative conditions at -w, and on a flow model the partial denoise's
    predict calls (the count drawn from ``default_rng(0)`` in
    ``[1, max_denoising_steps - 1)``), in order, against the JAX job's loop."""
    flow = arch == "flux"
    jevents, tevents = [], []
    jstub, jloss = _jax_stub(flow, jevents)
    monkeypatch.setattr(jslider_process, "get_model_class", lambda arch: jstub)
    monkeypatch.setattr(jslider_process, "concept_slider_loss", jloss)
    tstub, tloss = _port_stub(flow, tevents)
    monkeypatch.setattr(slider_process, "get_model_class", lambda arch: tstub)
    monkeypatch.setattr(slider_process, "concept_slider_loss", tloss)
    extra = {"max_denoising_steps": 7} if flow else {}
    jslider_process.TrainSliderProcess("seq", _jax_job_config(_slider_job(tmp_path / "jax", arch, **extra))).run()
    jax.effects_barrier()
    (result,) = run_job(_slider_job(tmp_path / "port", arch, **extra), device="cpu")
    assert [e[0] for e in tevents].count("loss") == 6
    assert tevents == jevents
    mults = [p["multiplier"] for p in result["plan"]]
    assert mults == [1.0, -0.5, 1.0, -0.5, 1.0, -0.5] and [p["target"] for p in result["plan"]] == [0, 1] * 3
    if flow:
        assert [p["denoise_steps"] for p in result["plan"]] == list(np.random.default_rng(0).integers(1, 6, 6))


def _jax_job_config(raw):
    from ai_toolkit_tpu.config.modules import JobConfig as JJobConfig

    return JJobConfig.from_raw(raw).processes[0]


# ---- the paired dataset against the JAX loader ----

def _pair_folders(root, missing=()):
    rng = np.random.default_rng(0)
    pos, neg = os.path.join(root, "pos"), os.path.join(root, "neg")
    os.makedirs(pos, exist_ok=True)
    os.makedirs(neg, exist_ok=True)
    for i, (w, h) in enumerate(((64, 48), (48, 64), (64, 64), (80, 64))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(os.path.join(pos, f"im_{i}.png"))
        with open(os.path.join(pos, f"im_{i}.txt"), "w") as f:
            f.write(f"a smiling person {i}")
        if i not in missing:  # the negative: another size, so the bucket's resize and crop show
            Image.fromarray(rng.integers(0, 255, (h + 8, w + 16, 3), dtype=np.uint8)).save(
                os.path.join(neg, f"im_{i}.png"))
    return pos, neg


def test_paired_dataset_matches_jax_loader(tmp_path):
    """``unconditional_path`` pairs each image with the same file name in
    the negatives' folder: every batch's ``unconditional_pixels`` (cover
    resize and crop to the bucket, ``flip_x`` / ``flip_y``) bit for bit
    against the JAX loader's, and no ``unconditional_pixels`` in a batch
    where one image has no pair (im_3), on both sides."""
    pos, neg = _pair_folders(str(tmp_path), missing=(3,))
    d = {"folder_path": pos, "unconditional_path": neg, "caption_ext": "txt", "resolution": [32, 48],
         "flip_x": True, "flip_y": True}
    enc = lambda imgs: np.zeros((imgs.shape[0], 1), np.float32)  # noqa: E731
    ours = build_dataloader([DatasetConfig.from_dict(dict(d))], 2, 16, encode_fn=enc)
    ref = jbuild_dataloader([JDatasetConfig.from_dict(dict(d))], 2, 16, encode_fn=enc)
    seen = with_pair = 0
    for ds, jds in zip(ours.datasets, ref.datasets):
        for b, jb in zip(ds.build_batches(2, shuffle=False), jds.build_batches(2, shuffle=False)):
            mine, theirs = ours._load_batch(ds, b), ref._load_batch(jds, jb)
            assert ("unconditional_pixels" in mine) == ("unconditional_pixels" in theirs)
            seen += 1
            if "unconditional_pixels" in mine:
                with_pair += 1
                np.testing.assert_array_equal(mine["unconditional_pixels"], theirs["unconditional_pixels"])
                assert mine["unconditional_pixels"].shape == (2, b[0].bucket[1], b[0].bucket[0], 3)
    assert seen > with_pair > 0
