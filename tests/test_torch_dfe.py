"""The DFE slice of the port against the JAX package on the CPU, in f32 at
tiny sizes: the TIPSv2 DPT (forward and image gradient at sides that are no
multiple of 14, its loader on a seeded file in the reference's names, whole
and split over ``dpt`` / ``backbone``), flax's SAME patch grid at 512 px,
and one LoRA step through JAX ``train/step.make_train_step`` with each DFE
aux loss (loss, ``aux_loss`` and every LoRA gradient, the port's draws
injected into the JAX step): v1 / v2 at narrow widths here, v7 and v8 (the
prediction decoded by the tiny flux VAE inside the differentiated graph) in
``test_torch_dfe7.py``, so the two files' JAX compiles run on two workers.

Weights: the port's seeded flux DiT and VAE reach JAX through the JAX
importer rules; the TIPSv2 and DFE weights are seeded numpy arrays in the
reference's torch layout, read by each package's own loader or converter.

Tolerance: f32, ``rtol`` 1e-5 and an ``atol`` of 1e-5 of the largest
reference value for the TIPSv2 outputs, 1e-4 for the step (flux's
``time_in`` meets one-ulp ``exp`` differences between XLA and PyTorch, as in
the flux-family tests), a gradient against the largest gradient of the LoRA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from safetensors.numpy import save_file
from test_torch_flux_family import ONE_EACH, Pair, _leaf, _lora_pair, fast_jit

from ai_toolkit_tpu.io.sd_import import vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.models import dfe as jdfe
from ai_toolkit_tpu.models import tipsv2 as jtips
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters.lora import detach_lora
from ai_toolkit_tpu_torch.models import dfe as tdfe
from ai_toolkit_tpu_torch.models import tipsv2 as ttips
from ai_toolkit_tpu_torch.models.vae import AutoencoderKL
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)


def _close(ours, ref, what="", rel=1e-5, scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=rel * scale, err_msg=what)


def _seeded_flat(module: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """Seeded numpy values for every tensor of ``module`` in its (the
    reference's) names: weights ~ N(0, 0.3 / sqrt(fan_in)), norm scales and
    LayerScale near 1, other 1-D tensors near 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            fan = int(np.prod(shape[1:])) if "resize_layers" not in k else shape[0] * shape[2] * shape[3]
            out[k] = rng.normal(0, 1.0 / np.sqrt(max(fan, 1)), shape).astype(np.float32)
        elif "norm" in k and k.endswith("weight") or k.endswith("gamma"):
            out[k] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            out[k] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def tips(tmp_path_factory):
    """The tiny TIPSv2 DPT as a reference-layout file: (dir, flat, the port's module, JAX params)."""
    cfg = ttips.TIPSConfig.tiny()
    flat = _seeded_flat(ttips.TIPSv2DPT(cfg, device="meta"), 11)
    root = tmp_path_factory.mktemp("tipsv2")
    save_file(flat, str(root / "model.safetensors"))
    module = ttips.load_tipsv2_dpt(str(root), "cpu", cfg)
    return root, flat, module, jtips.tipsv2_tree(flat, jtips.TIPSConfig.tiny())


def test_tips_config_matches_jax():
    for name in ("b14_dpt", "tiny"):
        ours, ref = getattr(ttips.TIPSConfig, name)(), getattr(jtips.TIPSConfig, name)()
        assert {f.name: getattr(ours, f.name) for f in dataclasses.fields(ours)} == \
            {f.name: getattr(ref, f.name) for f in dataclasses.fields(ours)}


def test_patch_grid_at_512_is_flax_same():
    """flax ``nn.Conv`` pads SAME: 512 px (no multiple of 14) make 37 x 37
    patches, so 1 + 1 + 1369 tokens enter the ViT."""
    ref = jax.eval_shape(lambda x: fnn.Conv(8, (14, 14), strides=(14, 14)).init_with_output(
        jax.random.key(0), x)[0], jax.ShapeDtypeStruct((1, 512, 500, 3), jnp.float32))
    pe = ttips.PatchEmbed(dataclasses.replace(ttips.TIPSConfig.tiny(), embed_dim=8), device="meta")
    assert tuple(pe(torch.empty(1, 512, 500, 3, device="meta")).shape) == ref.shape == (1, 37, 36, 8)


def test_tips_forward_and_image_gradient_match_jax(tips):
    """The four outputs and the gradient of a weighted sum of them with
    respect to the image, at 64 x 76 px, no multiple of 14 (SAME padding,
    the interpolated position table, the fusion residuals' resize, the
    align-corners upsampling, the depth-bin expectation)."""
    _, _, module, params = tips
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 64, 76, 3)).astype(np.float32)
    jm = jtips.TIPSv2DPT(jtips.TIPSConfig.tiny())
    shapes = jax.eval_shape(lambda x: jm.apply({"params": params}, x), jnp.asarray(img))
    wts = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in shapes.items()}

    def jloss(x):
        out = jm.apply({"params": params}, x)
        return sum(jnp.sum(out[k] * wts[k]) for k in out), out

    (_, ref), jg = fast_jit(jax.value_and_grad(jloss, has_aux=True), jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    out = module(x)
    loss = sum((out[k] * torch.from_numpy(wts[k])).sum() for k in out)
    (g,) = torch.autograd.grad(loss, x)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        _close(out[k].detach().numpy(), ref[k], k)
    _close(g.numpy(), jg, "d loss / d image")
    assert np.abs(np.asarray(jg)).max() > 0


def test_tips_loader_reads_split_files(tips, tmp_path):
    """``dpt.safetensors`` + ``backbone.safetensors`` load as the merged
    file does; a directory without either raises, as JAX's does."""
    _, flat, module, _ = tips
    save_file({k: v for k, v in flat.items() if k.startswith("vision_encoder.")}, str(tmp_path / "backbone.safetensors"))
    save_file({k: v for k, v in flat.items() if not k.startswith("vision_encoder.")}, str(tmp_path / "dpt.safetensors"))
    split = ttips.load_tipsv2_dpt(str(tmp_path), "cpu", ttips.TIPSConfig.tiny())
    for (k, a), (_, b) in zip(module.state_dict().items(), split.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(FileNotFoundError, match="no tipsv2 safetensors"):
        ttips.load_tipsv2_dpt(str(tmp_path / "none"), "cpu")
    with pytest.raises(FileNotFoundError, match="no tipsv2 safetensors"):
        jtips.load_tipsv2_dpt(str(tmp_path / "none"))


# ---- one LoRA step with each aux loss ----

class Flux(Pair):
    """The tiny flux pair with its VAE on both sides."""

    def __init__(self):
        super().__init__("flux", depths=ONE_EACH, seed=5)
        vc = self.model.vae_config
        self.vae = init_parameters(AutoencoderKL(vc), torch.Generator().manual_seed(6)).eval().requires_grad_(False)
        self.jvae, unmatched = torch_to_tree({k: v.numpy() for k, v in self.vae.state_dict().items()},
                                             vae_rules(len(vc.channel_multipliers), vc.layers_per_block))
        assert not unmatched


@pytest.fixture(scope="module")
def flux():
    return Flux()


def _step_pair(p: Flux, aux, jaux, monkeypatch, hh=10, ww=12):
    """One LoRA step (flux_shift, adamw) of the port's ``make_train_step``
    and of JAX's with ``aux`` / ``jaux`` as the aux loss; the port's draws
    injected into JAX. Returns ((loss, aux_loss, {name: grad}), the same from
    JAX), the gradients keyed by the port's names."""
    lora, jtree, paths = _lora_pair(p)
    inp = p.inputs(hh=hh, ww=ww)
    jc, tc = p.conds(inp)
    names = [f"{n}.{leaf}" for n in lora for leaf in ("a", "b", "scale")]
    trainable = {k: getattr(lora[k.rsplit(".", 1)[0]], k.rsplit(".", 1)[1]) for k in names}
    state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
    seen = {}
    real = state.optimizer.step
    state.optimizer.step = lambda grads: seen.update(zip(names, (g.clone() for g in grads))) or real(grads)
    seq = (hh // 2) * (ww // 2)
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": tc, "image_seq_len": seq,
             "loss_multiplier": torch.ones(2)}
    cfg = TrainStepConfig(timestep_type="flux_shift")
    metrics = make_train_step(lambda x, t, c: p.model.predict({"dit": p.dit}, x, t, c), FlowMatchSchedule(), cfg,
                              aux_loss_fn=aux)(state, [batch], torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    t = FlowMatchSchedule().sample_timesteps(g, 2, "flux_shift", seq, 1.0)
    noise = torch.randn(inp["x"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, rng, b, *args, **kwargs):
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jstate = JTrainState.create({"dit": p.tree}, {"lora": jtree}, jget_optimizer("adamw", 1e-3))
    jtrain = jstep.make_train_step(p.jmodel.predict, Injected(), jstep.TrainStepConfig(timestep_type="flux_shift"),
                                   aux_loss_fn=jaux)
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        got = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: got.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, b, jax.random.key(0), image_seq_len=seq)
        return m, got[0]

    jm, jgrads = fast_jit(run, jstate, {"latents": jnp.asarray(inp["x"]), "cond": jc, "loss_multiplier": jnp.ones(2)})
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    detach_lora(p.dit)  # the fixture's DiT serves the next test
    ref = {k: np.asarray(_leaf(jgrads["lora"], paths[k.rsplit(".", 1)[0]])[k.rsplit(".", 1)[1]]) for k in names}
    return ((float(metrics["loss"]), float(metrics["aux_loss"]), {k: v.numpy() for k, v in seen.items()}),
            (float(jm["loss"]), float(jm["aux_loss"]), ref))


def _hold(ours, ref):
    (loss, aux, grads), (jloss, jaux, jgrads) = ours, ref
    assert jaux > 0 and np.isfinite(loss)
    np.testing.assert_allclose(aux, jaux, rtol=1e-4)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        _close(grads[k], g, k, rel=1e-4, scale=gmax)


def _narrow_dfe(version, in_ch, seed):
    """A v1 / v2 DFE at narrow widths on both sides, from one torch-layout flat
    dict (the JAX side through its own converter, ``_convert_dfe_flat``)."""
    if version == 1:
        ours, jm = tdfe.DFEv1(in_ch, 16, 16, 2, device="cpu"), jdfe.DFEv1(16, 16, 2)
        x = jnp.zeros((1, 8, 8, in_ch))
    else:
        ours, jm = tdfe.DFEv2(2 * in_ch, 8, device="cpu"), jdfe.DFEv2(8)
        x = jnp.zeros((1, 8, 8, 2 * in_ch))
    flat = _seeded_flat(ours, seed)
    ours.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()}, strict=True)
    init = jax.eval_shape(lambda: jm.init(jax.random.key(0), x)["params"])
    tree = jdfe._convert_dfe_flat(flat, version)
    assert jax.tree.structure(jax.tree.map(np.shape, tree)) == jax.tree.structure(jax.tree.map(np.shape, init))
    return ours.eval().requires_grad_(False), jm, tree


@pytest.mark.parametrize("version", [1, 2])
def test_dfe_latent_step_matches_jax(flux, version, monkeypatch):
    """v1 (features of the x0 step against the clean latents', weighted by
    1 - t) and v2 (the feature list of [pred, noise] against [noise -
    latents, noise]) in one LoRA step."""
    in_ch = flux.model.dit_config.in_channels // 4
    ours, jm, params = _narrow_dfe(version, in_ch, 20 + version)
    aux = tdfe.make_dfe_loss(ours, version, FlowMatchSchedule(), 0.7)
    jaux = jdfe.make_dfe_loss(jm, params, version, JSchedule(), 0.7)
    _hold(*_step_pair(flux, aux, jaux, monkeypatch, hh=8, ww=8))
