"""The vision adapters of the port against the JAX package on the CPU, in f32
at tiny sizes: the pixtral tower (its 2-D interleaved rope, the forward
through both packages' loaders on a seeded directory in the reference's
names), the Redux encoder and the pixtral resampler, the flux decoupled K/V
(``build_flux_ip_collection`` bit for bit; ``predict`` with ``ip_tokens``
through the double and single blocks), one step of each adapter job against
JAX ``train/step.make_train_step`` with the JAX job's wrapped predict (loss
and every adapter gradient), the adapter file of each tiny job against the
JAX job's ``_save`` of the same tensors, and the ``[jax_fault]`` /
``[port]`` pairs of ROADMAP Queue 3.

Tolerance: f32, ``rtol`` 1e-5 and an ``atol`` of 1e-5 of the largest
reference value for the modules, 1e-4 through the flux DiT (its ``time_in``,
as in the flux-family tests), a gradient against the largest gradient of
the adapter."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open
from safetensors.numpy import save_file
from test_torch_flux_family import ONE_EACH, Pair, _leaf, fast_jit

from ai_toolkit_tpu.adapters import custom_adapter as jca
from ai_toolkit_tpu.adapters import ip_adapter as jip
from ai_toolkit_tpu.adapters import quantize as jquant
from ai_toolkit_tpu.config.modules import ProcessConfig as JProcessConfig
from ai_toolkit_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models.text_encoders import pixtral_vision as jpix
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu.utils.timer import Timer as JTimer
from ai_toolkit_tpu_torch.adapters import custom_adapter as tca
from ai_toolkit_tpu_torch.adapters import ip_adapter as tip
from ai_toolkit_tpu_torch.adapters import quantize as tquant
from ai_toolkit_tpu_torch.config.loader import get_config
from ai_toolkit_tpu_torch.jobs import get_job
from ai_toolkit_tpu_torch.models.text_encoders import pixtral_vision as tpix
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(ours, ref, what="", rel=1e-5, scale=None):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-5, atol=rel * scale, err_msg=what)


def _seeded(module, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, 1 / np.sqrt(v.shape[-1]), tuple(v.shape)) if v.dim() > 1
                else 1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
            for k, v in module.state_dict().items()}


def _linear_tree(module):
    """A torch module's Linears as a flax tree ({name: {kernel [in, out], bias}}), copied."""
    tree = {}
    for k, v in module.state_dict().items():
        name, leaf = k.rsplit(".", 1)
        tree.setdefault(name, {})["kernel" if leaf == "weight" else leaf] = np.array(v.numpy().T if leaf == "weight"
                                                                                     else v.numpy())
    return tree


# ---- pixtral ----

def test_pixtral_rope_angles_match_jax():
    for cfg_t, cfg_j in ((tpix.PixtralVisionConfig(), jpix.PixtralVisionConfig()),
                         (tpix.PixtralVisionConfig.tiny(), jpix.PixtralVisionConfig.tiny())):
        np.testing.assert_array_equal(tpix.pixtral_rope_angles(cfg_t, 5, 7), jpix.pixtral_rope_angles(cfg_j, 5, 7))
    x = np.random.default_rng(0).standard_normal((2, 35, 4, 16)).astype(np.float32)
    ang = jpix.pixtral_rope_angles(jpix.PixtralVisionConfig.tiny(), 5, 7)
    _close(tpix.rope_interleaved(torch.from_numpy(x), torch.from_numpy(ang)).numpy(),
           jpix._rope_interleaved(jnp.asarray(x), jnp.asarray(ang)))


def test_pixtral_tower_through_both_loaders_matches_jax(tmp_path):
    """A seeded tiny tower in the reference's names (``config.json`` +
    ``model.safetensors``) read by both loaders, then a 64 x 48 image (a
    4 x 3 patch grid, so the rope's two axes differ)."""
    cfg = tpix.PixtralVisionConfig.tiny()
    save_file(_seeded(tpix.PixtralVisionEncoder(cfg, device="meta"), 3), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({"hidden_size": 64, "image_size": 64, "patch_size": 16,
                                                      "intermediate_size": 128, "num_hidden_layers": 2,
                                                      "num_attention_heads": 4}))
    ours = tpix.load_pixtral_encoder(str(tmp_path), "cpu")
    jm, jtree = jpix.load_pixtral_encoder(str(tmp_path))
    img = np.random.default_rng(1).standard_normal((2, 64, 48, 3)).astype(np.float32)
    ref = fast_jit(lambda x: jm.apply({"params": jtree}, x), jnp.asarray(img))
    with torch.no_grad():
        out = ours(torch.from_numpy(img))
    assert out.shape == ref.shape == (2, 12, 64)
    _close(out.numpy(), ref)


# ---- the adapter modules and the decoupled K/V ----

@pytest.mark.parametrize("kind", ["redux", "pixtral"])
def test_adapter_modules_match_jax(kind):
    ours = (tca.ReduxEncoder(24, 16) if kind == "redux" else tca.PixtralResampler(24, 32)).requires_grad_(False)
    ours.load_state_dict({k: torch.from_numpy(v) for k, v in _seeded(ours, 4).items()})
    jm = jca.ReduxEncoder(16) if kind == "redux" else jca.PixtralResampler(32)
    x = np.random.default_rng(2).standard_normal((2, 5, 24)).astype(np.float32)
    _close(ours(torch.from_numpy(x)).numpy(), jm.apply({"params": _linear_tree(ours)}, jnp.asarray(x)))


@pytest.fixture
def flux():
    return Pair("flux", depths=ONE_EACH, seed=12)


def _port_block(jax_name: str) -> str:
    """JAX ``double_3`` -> the port's ``double_blocks.3``."""
    kind, i = jax_name.split("_")
    return f"{kind}_blocks.{i}"


def _jax_ip_for(ip: dict[str, tip.IPKV]) -> dict:
    """The port's K/V as the JAX ``ip`` collection of the unrolled tree."""
    out = {}
    for name, m in ip.items():
        kind, i = name.split(".")[0], name.rsplit(".", 1)[1]
        out[f"{'double' if kind == 'double_blocks' else 'single'}_{i}"] = {
            "to_k": np.array(m.to_k.detach().numpy().T), "to_v": np.array(m.to_v.detach().numpy().T),
            "scale": np.array(m.scale.detach().numpy())}
    return out


@pytest.mark.parametrize("only_double", [True, False])
def test_flux_ip_collection_is_jax_bit_for_bit(flux, only_double):
    """``from_qkv``: the frozen K weight's first ``mid`` input columns x 0.01,
    to_v a copy, the scale; doubles only with ``flux_only_double``."""
    mid = flux.model.dit_config.hidden_size // 2
    ours = tip.build_flux_ip_collection(flux.dit, mid, only_double=only_double, scale=0.6)
    ref = jip.build_flux_ip_collection(flux.tree, mid, jax.random.key(0), init="from_qkv", only_double=only_double,
                                       scale=0.6)
    assert sorted(_port_block(k) for k in ref) == sorted(ours)
    for k, leaf in ref.items():
        m = ours[_port_block(k)]
        np.testing.assert_array_equal(m.to_k.detach().numpy().T, np.asarray(leaf["to_k"]))
        np.testing.assert_array_equal(m.to_v.detach().numpy().T, np.asarray(leaf["to_v"]))
        assert float(m.scale.detach()) == float(leaf["scale"])


def test_predict_with_ip_tokens_matches_jax(flux):
    """The rotated joint query of each double and single block also attends to
    the adapter's K/V; scale times that output joins before the out-projection."""
    cfg = flux.model.dit_config
    ip = tip.build_flux_ip_collection(flux.dit, 24, scale=0.8)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for m in ip.values():  # away from the K init, so to_k and to_v differ
            m.to_v.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(m.to_v.shape)).astype(np.float32)))
    inp = flux.inputs()
    jc, tc = flux.conds(inp)
    tokens = rng.standard_normal((2, 6, 24)).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    with torch.no_grad():
        ours = flux.model.predict({"dit": flux.dit}, torch.from_numpy(inp["x"]), torch.from_numpy(t),
                                  {**tc, "ip_tokens": torch.from_numpy(tokens)})
        plain = flux.model.predict({"dit": flux.dit}, torch.from_numpy(inp["x"]), torch.from_numpy(t), tc)
    ref = fast_jit(flux.jmodel.predict, {"dit": flux.tree, "ip": _jax_ip_for(ip)}, jnp.asarray(inp["x"]),
                   jnp.asarray(t), {**jc, "ip_tokens": jnp.asarray(tokens)})
    _close(ours.numpy(), ref, rel=1e-4)
    assert float((ours - plain).abs().max()) > 1e-3 * float(plain.abs().max())
    assert cfg.depth_double == cfg.depth_single == 1


# ---- one step of each adapter ----

def _adapter_step(p, kind, monkeypatch):
    """One adapter step (flux_shift, adamw) on seeded vision tokens: the port's
    ``make_train_step`` over ``apply_cond`` + ``predict``, and JAX's over the
    JAX job's wrapped predict (``runtime.apply``). Returns ((loss, {port
    name: grad}), (loss, {port name: JAX grad in the port's layout}))."""
    cfg = p.model.dit_config
    rng = np.random.default_rng(8)
    vdim = 20
    acfg = ({"type": "redux"} if kind == "redux" else
            {"type": "vision_direct", "image_encoder_arch": "pixtral", "flux_only_double": True})
    runtime = tca.init_custom_adapter(acfg, cfg.context_dim, vdim, torch.Generator().manual_seed(3), "cpu",
                                      dit_hidden=cfg.hidden_size if kind != "redux" else None)
    with torch.no_grad():
        for prm in runtime.module.parameters():  # non-zero biases
            prm.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(prm.shape)).astype(np.float32)))
    trainable = {f"adapter.{k}": v for k, v in runtime.module.named_parameters()}
    jtrain_tree = {"adapter": _linear_tree(runtime.module)}
    ip = {}
    if kind != "redux":
        ip = tip.build_flux_ip_collection(p.dit, cfg.hidden_size, only_double=True, scale=1.0)
        trainable.update({f"ip.{b}.{leaf}": v for b, m in ip.items() for leaf, v in m.named_parameters()})
        jtrain_tree["ip"] = _jax_ip_for(ip)
    _, jruntime = jca.init_custom_adapter(dict(acfg, _flux_family=True, _dit_hidden=cfg.hidden_size),
                                          cfg.context_dim, "txt", vdim, jax.random.key(0))
    inp = p.inputs(n_txt=5)
    hh, ww, n_txt = inp["hw"]
    n_vis = 7
    tokens = rng.standard_normal((2, n_vis, vdim)).astype(np.float32)
    extra = n_vis if kind == "redux" else 0
    jc, tc = p.conds(dict(inp, hw=(hh, ww, n_txt + extra)))
    jc["txt"], tc["txt"] = jnp.asarray(inp["txt"]), torch.from_numpy(inp["txt"])
    jc["vision_tokens"], tc["vision_tokens"] = jnp.asarray(tokens), torch.from_numpy(tokens)
    names = list(trainable)
    state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
    seen = {}
    real = state.optimizer.step
    state.optimizer.step = lambda grads: seen.update(zip(names, (g.clone() for g in grads))) or real(grads)
    seq = (hh // 2) * (ww // 2)
    batch = {"latents": torch.from_numpy(inp["x"]), "cond": tc, "image_seq_len": seq, "loss_multiplier": torch.ones(2)}
    try:
        metrics = make_train_step(lambda x, t, c: p.model.predict({"dit": p.dit}, x, t, runtime.apply_cond(c)),
                                  FlowMatchSchedule(), TrainStepConfig(timestep_type="flux_shift"))(
            state, [batch], torch.Generator().manual_seed(7))
    finally:
        tip.detach_ip(p.dit)
    g = torch.Generator().manual_seed(7)
    t = FlowMatchSchedule().sample_timesteps(g, 2, "flux_shift", seq, 1.0)
    noise = torch.randn(inp["x"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, r, b, *args, **kwargs):
            return jnp.asarray(t.numpy())

    def jpredict(vars_, noisy, tt, cond):  # the JAX job's wrapper (jobs/train_process.py:473-478)
        v2, c2 = jruntime.apply(vars_, cond)
        return p.jmodel.predict(v2, noisy, tt, c2)

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jstate = JTrainState.create({"dit": p.tree}, jtrain_tree, jget_optimizer("adamw", 1e-3))
    jtrain = jstep.make_train_step(jpredict, Injected(), jstep.TrainStepConfig(timestep_type="flux_shift"))
    real_apply = JTrainState.apply_gradients

    def run(st, b):
        got = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: got.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, b, jax.random.key(0), image_seq_len=seq)
        return m, got[0]

    jm, jg = fast_jit(run, jstate, {"latents": jnp.asarray(inp["x"]), "cond": jc, "loss_multiplier": jnp.ones(2)})
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    ref = {}
    for k in names:
        if k.startswith("adapter."):
            mod, leaf = k[len("adapter."):].rsplit(".", 1)
            v = np.asarray(jg["adapter"][mod]["kernel" if leaf == "weight" else leaf])
            ref[k] = v.T if leaf == "weight" else v
        else:
            _, blk, i, leaf = k.split(".")
            v = np.asarray(jg["ip"][f"{'double' if blk == 'double_blocks' else 'single'}_{i}"][leaf])
            ref[k] = v.T if v.ndim == 2 else v
    return (float(metrics["loss"]), {k: v.numpy() for k, v in seen.items()}), (float(jm["loss"]), ref)


@pytest.mark.parametrize("kind", ["redux", "vision_direct"])
def test_adapter_step_matches_jax(flux, kind, monkeypatch):
    (loss, grads), (jloss, jgrads) = _adapter_step(flux, kind, monkeypatch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    gmax = max(float(np.abs(v).max()) for v in jgrads.values())
    for k, v in jgrads.items():
        assert grads[k].shape == v.shape, k
        _close(grads[k], v, k, rel=1e-4, scale=gmax)
    if kind == "vision_direct":  # the ip scale trains (the JAX fault of train_scaler: false)
        assert any(abs(float(v)) > 0 for k, v in jgrads.items() if k.endswith(".scale"))


# ---- the jobs: the adapter file against the JAX job's save, and the JAX faults ----

def _tiny_job(tmp_path, name, **train):
    imgs = tmp_path / "imgs"
    imgs.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
        (imgs / f"{i}.txt").write_text(f"photo {i}")
    raw = get_config(os.path.join(ROOT, "configs", "examples", f"{name}.yaml"))
    proc = raw["config"]["process"][0]
    proc.update(training_folder=str(tmp_path / "out"))
    proc["model"].update(name_or_path="", model_kwargs={"size": "tiny"})
    proc["datasets"][0].update(folder_path=str(imgs), resolution=[32])
    proc["train"].update(steps=1, dtype="float32", disable_sampling=True, **train)
    return raw


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each adapter file at ``size: tiny``, one step: (the process, its result, its printed lines)."""
    import contextlib
    import io

    out = {}
    for kind, name in (("redux", "train_redux_adapter_flux_tpu"), ("vision_direct",
                                                                   "train_vision_direct_pixtral_flux_tpu")):
        raw = _tiny_job(tmp_path_factory.mktemp(kind), name)
        (proc,) = get_job(raw, device="cpu").processes
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = proc.run()
        out[kind] = (proc, res, buf.getvalue())
    return out


@pytest.mark.parametrize("kind", ["redux", "vision_direct"])
def test_adapter_file_is_the_jax_jobs(jobs, kind, tmp_path):
    """The port's final save against the JAX job's ``_save`` of the same
    tensors (the module from the EMA copy when EMA is on, the K/V under
    ``adapter_modules.{i}.to_k_adapter.weight``): the same keys, values,
    dtypes and ``adapter_type``."""
    proc, res, _ = jobs[kind]
    src = proc.state.ema if proc.state.ema is not None else proc.state.trainable
    mod = {k[len("adapter."):]: v.detach() for k, v in src.items() if k.startswith("adapter.")}
    tree = {}
    for k, v in mod.items():
        name, leaf = k.rsplit(".", 1)
        tree.setdefault(name, {})["kernel" if leaf == "weight" else leaf] = v.numpy().T if leaf == "weight" \
            else v.numpy()
    trainable = {"adapter": tree}
    if proc.ip:
        trainable["ip"] = _jax_ip_for(proc.ip)
    jp = JSDTrainProcess.__new__(JSDTrainProcess)
    jp.timer, jp.save_root, jp.job_name = JTimer("t"), str(tmp_path), "job"
    jp.ckpt = JCheckpointManager(str(tmp_path), "job", fmt="peft")
    jp.custom_adapter = types.SimpleNamespace(adapter_type=kind)
    jp._save(types.SimpleNamespace(trainable=trainable, ema=None), 1, final=True)
    with safe_open(jp.ckpt.final_path(), "np") as f:
        ref = {k: f.get_tensor(k) for k in f.keys()}
        ref_meta = f.metadata()
    with safe_open(res["save_path"], "np") as f:
        ours = {k: f.get_tensor(k) for k in f.keys()}
        meta = f.metadata()
    assert sorted(ours) == sorted(ref) and meta["adapter_type"] == ref_meta["adapter_type"] == kind
    assert any(k.startswith(f"{kind}.adapter_modules.") for k in ref) == (kind == "vision_direct")
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    loaded, atype = tca.load_custom_adapter(res["save_path"])  # the port reads the file back as JAX's load does
    assert atype == kind and sorted(loaded) == sorted(k[len(kind) + 1:] for k in ref)
    jtree, jtype = jca.load_custom_adapter(res["save_path"])
    assert jtype == kind
    for k, v in loaded.items():
        *path, leaf = k.split(".")
        if path[0] == "adapter_modules":  # JAX nests the K/V by index: adapter_modules/{i}/to_k_adapter
            node = jtree["adapter_modules"][path[1]][path[2]]
        else:
            node = _leaf(jtree, "/".join(path))
        want = np.asarray(node["kernel" if leaf == "weight" else leaf])
        np.testing.assert_array_equal(v.numpy(), want.T if leaf == "weight" and want.ndim == 2 else want, err_msg=k)


@pytest.fixture(scope="module")
def jax_trainables(tmp_path_factory):
    """JAX ``_build_trainable`` on each tiny adapter file (the Redux file with
    its ``image_encoder_path`` pointed at a directory that exists); the
    vision towers' inits give seeded values at their shapes (only the
    trainable tree's structure is read)."""
    from test_torch_checkpoint_load import compiled_init

    from ai_toolkit_tpu.models.text_encoders.clip_vision import CLIPVisionModel as JCLIPVisionModel

    out = {}
    for kind, name in (("redux", "train_redux_adapter_flux_tpu"), ("vision_direct",
                                                                   "train_vision_direct_pixtral_flux_tpu")):
        tmp = tmp_path_factory.mktemp(f"j{kind}")
        raw = _tiny_job(tmp, name)
        proc = raw["config"]["process"][0]
        if kind == "redux":
            proc["adapter"]["image_encoder_path"] = str(tmp)
        jp = JSDTrainProcess("job", JProcessConfig.from_dict(proc))
        p = Pair("flux", depths=ONE_EACH, seed=1)
        jp.cfg.model.model_kwargs = {"size": "tiny"}
        with compiled_init(JCLIPVisionModel), compiled_init(jpix.PixtralVisionEncoder):
            trainable, *_ = jp._build_trainable(p.jmodel, {"dit": p.tree}, jax.random.key(0))
        out[kind] = (jp, trainable, p)
    return out


def test_jax_fault_redux_drops_its_network(jax_trainables):
    """[jax_fault] The Redux file's ``network: lora`` is not trained: JAX
    ``_build_trainable`` returns from the adapter branch with the adapter alone."""
    jp, trainable, _ = jax_trainables["redux"]
    assert jp.cfg.network is not None and jp.cfg.network.type == "lora"
    assert set(trainable) == {"adapter"}


def test_port_mirrors_the_dropped_network(jobs):
    """[port] The port trains the adapter alone too, and says so."""
    proc, res, printed = jobs["redux"]
    assert proc.lora is None and all(k.startswith("adapter.") for k in proc.state.trainable)
    assert "network 'lora' beside adapter 'redux' is not trained" in printed


def test_jax_fault_redux_image_encoder_path_is_not_read(jax_trainables):
    """[jax_fault] ``image_encoder_path`` names a directory, yet the tower is
    a seeded CLIP ViT (a SigLIP checkpoint there is never opened)."""
    jp, _, _ = jax_trainables["redux"]
    assert os.path.isdir(jp.cfg.adapter["image_encoder_path"])
    assert type(jp.vision_tower).__name__ == "CLIPVisionModel"


def test_port_mirrors_the_unread_image_encoder_path(jobs):
    """[port] The port builds the seeded CLIP tower and prints the fault."""
    proc, _, printed = jobs["redux"]
    assert type(proc.vision_tower).__name__ == "CLIPVisionModel"
    assert "image_encoder_path '/path/to/siglip' is not read" in printed


def test_jax_fault_vision_direct_trains_the_ip_scale(jax_trainables):
    """[jax_fault] ``train_scaler: false`` is read by nothing: each block's
    ``scale`` is a trainable leaf of the ``ip`` collection."""
    jp, trainable, _ = jax_trainables["vision_direct"]
    assert jp.cfg.adapter.get("train_scaler") is False
    assert trainable["ip"] and all("scale" in leaf for leaf in trainable["ip"].values())


def test_port_mirrors_the_trained_ip_scale(jobs):
    proc, _, printed = jobs["vision_direct"]
    assert sum(k.endswith(".scale") for k in proc.state.trainable) == len(proc.ip) > 0
    assert "train_scaler: false is not read" in printed


def test_jax_fault_ip_collection_on_a_quantized_base(flux):
    """[jax_fault] On a quantized base (the shipped vision_direct file sets
    ``quantize: true``) JAX ``build_flux_ip_collection`` reads the K columns
    from ``params``, which quantization has emptied: a KeyError."""
    rest, _ = jquant.quantize_params(flux.tree, min_size=0, qtype="qfloat8")
    with pytest.raises(KeyError):
        jip.build_flux_ip_collection(rest, 16, jax.random.key(0), init="from_qkv", only_double=True)


def test_port_builds_the_ip_collection_from_the_dequantized_base(flux):
    """[port] The port reads the dequantized K weight."""
    tquant.quantize_params(flux.dit, min_size=0, qtype="qfloat8")
    ip = tip.build_flux_ip_collection(flux.dit, 16, only_double=True)
    blk = flux.dit.double_blocks[0]
    want = blk.img_attn.qkv.dequantized()[flux.model.dit_config.hidden_size:][:flux.model.dit_config.hidden_size]
    torch.testing.assert_close(ip["double_blocks.0"].to_k, want[:, :16].float() * 0.01, rtol=0, atol=0)


@pytest.mark.parametrize("atype", ["te_augmenter", "ip_adapter"])
def test_unported_adapter_types_raise(atype):
    """A custom adapter type the port has not raises, naming ROADMAP item 6e,
    and so does IP-Adapter on a flux-family arch it is not ported to (it
    runs on flux / flux_schnell and the UNets); ``clip_image_augmentations``
    raises naming item 6h (``clip_image_path`` itself is read)."""
    raw = get_config(os.path.join(ROOT, "configs", "examples", "train_redux_adapter_flux_tpu.yaml"))
    proc_cfg = raw["config"]["process"][0]
    proc_cfg["adapter"] = {"type": atype}
    if atype == "ip_adapter":
        proc_cfg["model"]["arch"] = "chroma"
    (proc,) = get_job(raw, device="cpu").processes
    with pytest.raises(NotImplementedError, match="item 6e"):
        proc._refuse_unported()
    proc_cfg["adapter"] = {"type": "redux"}
    proc_cfg["model"]["arch"] = "flux"
    proc_cfg["datasets"][0]["clip_image_path"] = "/x"
    (proc,) = get_job(raw, device="cpu").processes
    proc._refuse_unported()
    from ai_toolkit_tpu_torch.config.modules import DatasetConfig
    from ai_toolkit_tpu_torch.data.dataset import FolderDataset

    with pytest.raises(NotImplementedError, match="clip_image_augmentations.*item 6h"):
        FolderDataset(DatasetConfig(folder_path=ROOT, clip_image_augmentations=[{"type": "flip"}]), 16)
