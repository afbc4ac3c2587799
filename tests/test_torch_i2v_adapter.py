"""The i2v adapter of the port against the JAX package on the CPU, in f32 at
the tiny Wan 2.1 size (the module tests at one block):

- the grafted parameters by name and shape against JAX ``new_leaves`` of the
  tiny i2v DiT over the t2v one, the image K/V kernels' 1e-3 scale (JAX
  ``scale_added_kv``), the frame embedder's width and init;
- ``assemble_first_frame_control`` bit for bit from the same stand-in
  encoder; Wan ``predict`` with the first-frame control latents through the
  frame embedder, the image tokens through the graft;
- one train step of a LoRA beside the graft and the frame embedder against
  JAX ``train/step.make_train_step`` (loss, every grafted, expansion and LoRA
  gradient);
- the save layout and its read-back against JAX ``i2v_extra_flat`` /
  ``load_i2v_from_flat``;
- the tiny job end to end (the base frozen, the graft and the frame embedder
  moved, the file's keys the JAX job's), and the ``[jax_fault]`` / ``[port]``
  pairs of ROADMAP Queue 3: JAX's resume restarts the graft (the port's
  resumes exactly), JAX's samples fail with a start frame (the port refuses
  the pair), JAX's samples drop the graft (the port's take the ``ctrl_img``
  through it), and JAX's loader gives an i2v job's image batches no pixels
  (the port's trains on them).

Tolerance: f32, predict within 1e-5 of max|ref|, the step's loss ``rtol``
1e-5 and each gradient within 1e-5 of the largest gradient."""

import ast
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors import safe_open
from test_torch_flux_family import fast_jit
from test_torch_lumina2 import filled
from test_torch_wan import TINY, _write_clip
from torch_jax_opt import jax_opt0  # noqa: F401

from ai_toolkit_tpu.adapters import control_lora as jcl
from ai_toolkit_tpu.adapters import i2v as ji2v
from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.config.modules import ProcessConfig as JProcessConfig
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models import wan_dit as jwan_dit
from ai_toolkit_tpu.models.wan_model import WanModel as JWanModel
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JSchedule
from ai_toolkit_tpu.train import step as jstep
from ai_toolkit_tpu.train.optimizers import get_optimizer as jget_optimizer
from ai_toolkit_tpu.train.state import TrainState as JTrainState
from ai_toolkit_tpu_torch.adapters import i2v as ti2v
from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
from ai_toolkit_tpu_torch.config.modules import ModelConfig
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.jobs.train_process import EXPANSION_IGNORE, I2V_START_FRAME_SAMPLE, SDTrainProcess
from ai_toolkit_tpu_torch.models import wan_dit as twan_dit
from ai_toolkit_tpu_torch.models.wan_model import WanModel
from ai_toolkit_tpu_torch.ops.layers import Ctrl
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = 2  # the tiny Wan VAE's temporal downscale


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


@pytest.fixture(scope="module")
def pair():
    """The tiny Wan 2.1 t2v model on both sides and the i2v leaves: JAX's DiT
    trees (t2v, and i2v with the graft's seeded values), the port's t2v DiT
    loaded from the t2v tree and grafted, its graft set to JAX's values."""
    jm = JWanModel(JModelConfig.from_dict(dict(TINY)))
    jm.dit_config = dataclasses.replace(jm.dit_config, i2v=True, num_layers=1)  # one block keeps the compiles small
    jm.dit = jwan_dit.WanDiT(jm.dit_config)
    cfg = jm.dit_config
    n = 2 * 2 * 2
    args = (jnp.zeros((1, n, cfg.in_channels * 4)), jnp.zeros((1, 8, cfg.text_dim)), jnp.zeros((1,)),
            jnp.zeros((1, n, cfg.head_dim // 2, 2, 2)))
    i2v_shapes = jax.eval_shape(lambda k: jm.dit.init(k, *args, jnp.zeros((1, 4, cfg.img_cond_dim)))["params"],
                                jax.random.key(0))
    t2v_shapes = jax.eval_shape(lambda k: jwan_dit.WanDiT(dataclasses.replace(cfg, i2v=False)).init(k, *args)["params"],
                                jax.random.key(0))
    full = filled(i2v_shapes, 11)
    overlay = ji2v.new_leaves(full, t2v_shapes)
    t2v = {k: v for k, v in full.items() if k in t2v_shapes}
    t2v = {k: ({kk: vv for kk, vv in v.items() if kk in t2v_shapes[k]} if k.startswith("block_") else v)
           for k, v in t2v.items()}
    model = WanModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    model.dit_config = dataclasses.replace(model.dit_config, num_layers=1)
    dit = twan_dit.WanDiT(model.dit_config)
    dit.load_state_dict(from_jax.wan_dit_state_dict(t2v))
    dit.requires_grad_(False)
    grafted = ti2v.graft_i2v(dit, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in grafted.items():
            v = np.asarray(_paths(overlay)[ti2v.jax_leaf_path(name)])
            p.copy_(torch.from_numpy(v.T.copy() if p.dim() == 2 else v))
    model.dit_config = dit.cfg
    return types.SimpleNamespace(jm=jm, t2v=t2v, overlay=overlay, i2v_shapes=i2v_shapes, t2v_shapes=t2v_shapes,
                                 model=model, dit=dit, grafted=grafted)


# ---- the graft ----

def test_grafted_leaves_are_jax_new_leaves(pair, monkeypatch):
    """The graft's parameters are JAX ``new_leaves`` by name and shape, f32
    and trainable; the image K/V kernels are the init times 1e-3, which is
    what JAX ``scale_added_kv`` scales; the base's own stay frozen."""
    want = {path: s.shape for path, s in _paths(ji2v.new_leaves(pair.i2v_shapes, pair.t2v_shapes)).items()}
    got = {ti2v.jax_leaf_path(n): tuple(p.shape[::-1]) for n, p in pair.grafted.items()}
    assert got == want and len(got) == 5 + 8
    assert all(p.dtype == torch.float32 and p.requires_grad for p in pair.grafted.values())
    assert not any(p.requires_grad for n, p in pair.dit.named_parameters() if n not in pair.grafted)
    scaled = {path for path, v in _paths(ji2v.scale_added_kv(jax.tree.map(np.ones_like, pair.overlay))).items()
              if float(np.asarray(v).max()) != 1.0}
    t2v = twan_dit.WanDiT(pair.model.dit_config.__class__(**{**pair.model.dit_config.__dict__, "i2v": False}))
    a = ti2v.graft_i2v(t2v, torch.Generator().manual_seed(2))
    monkeypatch.setattr(ti2v, "I2V_ADD_KV_SCALE", 1.0)
    t2v_b = twan_dit.WanDiT(pair.model.dit_config.__class__(**{**pair.model.dit_config.__dict__, "i2v": False}))
    b = ti2v.graft_i2v(t2v_b, torch.Generator().manual_seed(2))
    ratio = {ti2v.jax_leaf_path(n) for n in a if not torch.equal(a[n], b[n])}
    assert ratio == scaled == {("block_0", m, "kernel") for m in ("cross_k_img", "cross_v_img")}
    for n in a:
        if ti2v.jax_leaf_path(n) in scaled:
            torch.testing.assert_close(a[n], (b[n] * 1e-3).float(), rtol=0, atol=0)


def test_frame_embedder_width_and_init():
    """``(td + C) * pt * ph * pw`` inputs (80 for Wan 2.1's 4 + 16 channels),
    ``w`` N(0, 1) / sqrt(extra_in) as JAX's, ``b`` zeros."""
    for dim, c, td, want in ((1536, 16, 4, 80), (64, 4, TD, 24)):
        ctrl = ti2v.init_frame_embedder_ctrl(dim, c, (1, 2, 2), torch.Generator().manual_seed(0), mask_channels=td)
        ref = jax.eval_shape(lambda k: ji2v.init_frame_embedder_ctrl(dim, c, (1, 2, 2), k, mask_channels=td),
                             jax.random.key(0))
        assert ctrl.w.shape == ref["patch_embedding"]["w"].shape == (want, dim)
        assert ctrl.b.shape == ref["patch_embedding"]["b"].shape
        assert ctrl.b.shape == (dim,) and not ctrl.b.any()
        assert abs(float(ctrl.w.std()) * np.sqrt(want) - 1.0) < 0.05


def _encode(video: np.ndarray) -> np.ndarray:
    """A stand-in VAE: ``TD``x temporal and 8x spatial average pooling, 4 channels."""
    b, f, h, w, _ = video.shape
    first = video[:, :1].mean(axis=1, keepdims=True)
    rest = video[:, 1:].reshape(b, (f - 1) // TD, TD, h, w, 3).mean(axis=2)
    v = np.concatenate([first, rest], axis=1)
    v = v.reshape(b, v.shape[1], h // 8, 8, w // 8, 8, 3).mean(axis=(3, 5))
    return np.concatenate([v, v[..., :1] * 2.0], axis=-1).astype(np.float32)


def test_first_frame_control_matches_jax():
    ff = np.random.default_rng(2).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    for t_lat in (1, 3):
        out = ti2v.assemble_first_frame_control(ff, t_lat, _encode, temporal_downscale=TD)
        ref = ji2v.assemble_first_frame_control(ff, t_lat, _encode, temporal_downscale=TD)
        assert out.shape == (2, t_lat, 2, 3, TD + 4)
        np.testing.assert_array_equal(out, ref)
        assert (out[:, 0, ..., :TD] == 1).all() and not out[:, 1:, ..., :TD].any()


def _frame_ctrl(pair, seed=4):
    rng = np.random.default_rng(seed)
    c = pair.model.dit_config
    w = (rng.standard_normal((4 * (TD + c.in_channels), c.dim)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(c.dim) * 0.1).astype(np.float32)
    return w, b


def _inputs(pair, seed=6):
    """Latents 3 x 4 x 6 (18 tokens), 5 text tokens, 7 image tokens, the
    first-frame control latents, noise."""
    rng = np.random.default_rng(seed)
    c = pair.model.dit_config
    x0 = rng.standard_normal((2, 3, 4, 6, c.in_channels), dtype=np.float32)
    return {"x0": x0, "noise": rng.standard_normal(x0.shape, dtype=np.float32),
            "txt": rng.standard_normal((2, 5, c.text_dim), dtype=np.float32),
            "img": rng.standard_normal((2, 7, c.img_cond_dim), dtype=np.float32),
            "ctrl": rng.standard_normal((2, 3, 4, 6, TD + c.in_channels), dtype=np.float32),
            "t": np.asarray([0.3, 0.8], np.float32)}


def _conds(pair, inp):
    pe = pair.model.rope_table(3, 4, 6)
    j = {"txt": jnp.asarray(inp["txt"]), "pe": jnp.asarray(pe.numpy()), "img_cond": jnp.asarray(inp["img"]),
         "control_latents": jnp.asarray(inp["ctrl"])}
    t = {"txt": torch.from_numpy(inp["txt"]), "pe": pe, "img_cond": torch.from_numpy(inp["img"]),
         "control_latents": torch.from_numpy(inp["ctrl"])}
    return j, t


def test_predict_with_control_latents_matches_jax(pair):
    """The control latents patchified on their own and concatenated to the
    tokens' features, through the frame embedder on ``patch_embedding``; the
    image tokens through the grafted image MLP and K/V."""
    w, b = _frame_ctrl(pair)
    pair.dit.patch_embedding.ctrl = Ctrl(torch.from_numpy(w), torch.from_numpy(b))
    try:
        inp = _inputs(pair)
        jc, tc = _conds(pair, inp)
        ref = np.asarray(jax.jit(pair.jm.predict)({"dit": _merged(pair),
                                                   "ctrl": {"patch_embedding": {"w": w, "b": b}}},
                                                  jnp.asarray(inp["x0"]), jnp.asarray(inp["t"]), jc))
        with torch.no_grad():
            out = pair.model.predict({"dit": pair.dit}, torch.from_numpy(inp["x0"]), torch.from_numpy(inp["t"]),
                                     tc).numpy()
            plain = pair.model.predict({"dit": pair.dit}, torch.from_numpy(inp["x0"]), torch.from_numpy(inp["t"]),
                                       {**tc, "control_latents": torch.zeros_like(tc["control_latents"])}).numpy()
    finally:
        pair.dit.patch_embedding.ctrl = None
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert np.abs(out - plain).max() > 1e-2 * np.abs(ref).max()


def _merged(pair):
    """The t2v tree with the overlay deep-merged (JAX ``merge_variables``)."""
    out = dict(pair.t2v)
    for k, v in pair.overlay.items():
        out[k] = {**out[k], **v} if k in out else v
    return out


# ---- one step ----

def test_i2v_step_matches_jax(pair, monkeypatch):
    """A LoRA beside the graft and the frame embedder (the LoRA skipping the
    grafted and expanded Linears), one shift adamw step with the port's t and
    noise injected into JAX: the loss and every gradient."""
    w, b = _frame_ctrl(pair, seed=9)
    dit = pair.dit
    dit.patch_embedding.ctrl = Ctrl(torch.from_numpy(w), torch.from_numpy(b))
    spec = LoRASpec(rank=2, alpha=2.0, ignore_if_contains=EXPANSION_IGNORE["i2v"],
                    target_patterns=twan_dit.wan_lora_targets())
    lora = build_lora(dit, spec, torch.Generator().manual_seed(4))
    try:
        with torch.no_grad():
            for m in lora.values():
                m.b.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(5))
        jspec = jlora.LoRASpec(rank=2, alpha=2.0, target_patterns=jwan_dit.wan_lora_targets(),
                               ignore_if_contains=["patch_embedding", "cross_k_img", "cross_v_img", "img_emb"])
        jpaths = {"/".join(x) for x in jlora.lora_paths(jlora.build_lora(_merged(pair), jspec, jax.random.key(0)))}
        assert len(lora) == 10 and jpaths == {twan_dit.wan_lora_key(n, False).replace(".", "/") for n in lora}
        jtree: dict = {}
        for name, m in lora.items():
            blk, leaf = twan_dit.wan_lora_key(name, scanned=False).split(".")
            jtree.setdefault(blk, {})[leaf] = {k: np.array(getattr(m, k).detach().numpy()) for k in ("a", "b", "scale")}
        trainable = {f"{n}.{k}": getattr(m, k) for n, m in lora.items() for k in ("a", "b", "scale")}
        trainable.update({f"i2v.{n}": p for n, p in pair.grafted.items()})
        trainable.update({"ctrl.w": dit.patch_embedding.ctrl.w, "ctrl.b": dit.patch_embedding.ctrl.b})
        before = {k: v.detach().clone() for k, v in trainable.items()}
        inp = _inputs(pair, seed=7)
        jc, tc = _conds(pair, inp)
        names = list(trainable)
        state = TrainState(trainable, get_optimizer("adamw", list(trainable.values()), 1e-3))
        seen = {}
        real = state.optimizer.step
        state.optimizer.step = lambda grads: seen.update(zip(names, (g.clone() for g in grads))) or real(grads)
        seq = 3 * 2 * 3
        batch = {"latents": torch.from_numpy(inp["x0"]), "cond": tc, "image_seq_len": seq,
                 "loss_multiplier": torch.ones(2)}
        metrics = make_train_step(lambda x, t, c: pair.model.predict({"dit": dit}, x, t, c), FlowMatchSchedule(),
                                  TrainStepConfig(timestep_type="shift"))(state, [batch],
                                                                          torch.Generator().manual_seed(7))
    finally:
        for m in lora:
            dict(dit.named_modules())[m].lora = None
        dit.patch_embedding.ctrl = None
        with torch.no_grad():
            for k, v in before.items():
                if k.startswith("i2v."):
                    pair.grafted[k[4:]].copy_(v)
    g = torch.Generator().manual_seed(7)
    t = FlowMatchSchedule().sample_timesteps(g, 2, "shift", seq, 1.0)
    noise = torch.randn(inp["x0"].shape, generator=g).numpy()

    class Injected(JSchedule):
        def sample_timesteps(self, r, bsz, *args, **kwargs):
            return jnp.asarray(t.numpy())

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    jstate = JTrainState.create({"dit": pair.t2v}, {"lora": jtree, "dit": pair.overlay,
                                                    "ctrl": {"patch_embedding": {"w": w, "b": b}}},
                                jget_optimizer("adamw", 1e-3))
    jtrain = jstep.make_train_step(pair.jm.predict, Injected(), jstep.TrainStepConfig(timestep_type="shift"))
    real_apply = JTrainState.apply_gradients

    def run(st, bt):
        got = []
        monkeypatch.setattr(JTrainState, "apply_gradients", lambda self, gr, **kw: got.append(gr)
                            or real_apply(self, gr, **kw))
        _, m = jtrain(st, bt, jax.random.key(0), image_seq_len=seq)
        return m, got[0]

    jm, jg = fast_jit(run, jstate, {"latents": jnp.asarray(inp["x0"]), "cond": jc, "loss_multiplier": jnp.ones(2)})
    monkeypatch.setattr(JTrainState, "apply_gradients", real_apply)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    ref = {"ctrl.w": np.asarray(jg["ctrl"]["patch_embedding"]["w"]),
           "ctrl.b": np.asarray(jg["ctrl"]["patch_embedding"]["b"])}
    gov = _paths(jg["dit"])
    for n, p in pair.grafted.items():
        v = np.asarray(gov[ti2v.jax_leaf_path(n)])
        ref[f"i2v.{n}"] = v.T if v.ndim == 2 else v
    for name in lora:
        blk, leaf = twan_dit.wan_lora_key(name, scanned=False).split(".")
        ref.update({f"{name}.{k}": np.asarray(jg["lora"][blk][leaf][k]) for k in ("a", "b", "scale")})
    gmax = max(float(np.abs(v).max()) for v in ref.values())
    for k in ("ctrl.w", "i2v.condition_embedder.image_embedder.ff.net.2.weight", "i2v.blocks.0.attn2.add_v_proj.weight"):
        assert float(np.abs(ref[k]).max()) > 1e-3 * gmax, k
    for k, v in ref.items():
        np.testing.assert_allclose(seen[k].numpy(), v, rtol=1e-5, atol=1e-5 * gmax, err_msg=k)


# ---- the save layout ----

def test_extra_flat_and_read_back_match_jax(pair):
    """The graft and the frame embedder in the reference's keys, f32, equal to
    JAX ``i2v_extra_flat`` of the same values; both readers give them back."""
    w, b = _frame_ctrl(pair)
    ours = ti2v.i2v_extra_flat(pair.grafted, torch.from_numpy(w), torch.from_numpy(b))
    ref = ji2v.i2v_extra_flat(jax.tree.map(np.asarray, pair.overlay), {"patch_embedding": {"w": w, "b": b}})
    assert sorted(ours) == sorted(ref) and len(ref) == 6 + 8 + 2
    for k in ref:
        assert ours[k].dtype == np.float32 and ours[k].flags["C_CONTIGUOUS"], k
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert ours["frame_embedder.patch_embedding.weight"].shape == (64, TD + 4, 1, 2, 2)
    grafted, ctrl = ti2v.load_i2v_from_flat(ours)
    jover, jctrl = ji2v.load_i2v_from_flat(ref, pair.overlay, {"patch_embedding": {}})
    jflat = _paths(jover)
    for n, v in grafted.items():
        want = np.asarray(jflat[ti2v.jax_leaf_path(n)])
        np.testing.assert_array_equal(v, want.T if want.ndim == 2 else want, err_msg=n)
        np.testing.assert_array_equal(v, pair.grafted[n].detach().numpy(), err_msg=n)
    np.testing.assert_array_equal(ctrl[0], np.asarray(jctrl["patch_embedding"]["w"]))
    np.testing.assert_array_equal(ctrl[0], w)
    np.testing.assert_array_equal(ctrl[1], b)


# ---- the job ----

def _clips(root):
    data = root / "clips"
    data.mkdir(exist_ok=True)
    for i in range(2):
        _write_clip(data / f"v_{i}.avi", 8, (32, 32), i)
        (data / f"v_{i}.txt").write_text(f"a video of thing {i}")
    return str(data)


def _i2v_job(root, steps=2, start=True, sample=False, out="out", data=None):
    ctrl = root / "ctrl.png"
    if not ctrl.exists():
        Image.fromarray(np.random.default_rng(3).integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(ctrl)
    proc = {"type": "sd_trainer", "training_folder": str(root / out),
            "adapter": {"type": "i2v", "i2v_do_start_frame": start,
                        "lora_config": {"type": "lora", "linear": 4, "linear_alpha": 4}},
            "save": {"dtype": "float16", "save_every": 2},
            "datasets": [{"folder_path": data or _clips(root), "caption_ext": "txt", "cache_latents_to_disk": False,
                          "do_i2v": True, "resolution": [32], "num_frames": 6}],
            "train": {"batch_size": 1, "steps": steps, "noise_scheduler": "flowmatch", "timestep_type": "shift",
                      "optimizer": "adamw", "lr": 1e-3, "ema_config": {"use_ema": True, "ema_decay": 0.9},
                      "dtype": "float32", "seed": 42, "disable_sampling": not sample},
            "sample": {"sample_every": 0, "width": 32, "height": 32, "sample_steps": 2, "num_frames": 5,
                       "seed": 5, "prompts": [{"prompt": "x", "ctrl_img": str(ctrl)}, "x"]},
            "model": dict(TINY)}
    return {"job": "extension", "config": {"name": "i2v", "process": [proc]}}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("i2v")
    j = get_job(_i2v_job(root, steps=3), device="cpu")
    (res,) = j.run()
    return j.processes[0], res, root


def test_job_trains_the_graft_and_saves_the_jax_layout(job):
    """The tiny job (3 steps over two clips, EMA, the start frame): the base
    stays frozen, the graft and the frame embedder move, and the file holds
    the LoRA under the JAX job's keys beside JAX ``i2v_extra_flat`` of the
    graft's EMA copy and the frame embedder as it trains."""
    proc, res, _ = job
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    dit = proc.variables["dit"]
    fresh = WanModel(ModelConfig.from_dict(dict(TINY)), device="cpu").init_variables(
        torch.Generator().manual_seed(42))["dit"].state_dict()
    for k, v in dit.state_dict().items():
        if k in fresh:
            assert torch.equal(v, fresh[k]), k
    regraft = ti2v.graft_i2v(twan_dit.WanDiT(WanModel(ModelConfig.from_dict(dict(TINY)), device="cpu").dit_config),
                             torch.Generator().manual_seed(42 + 42))
    moved = [k for k, p in proc.state.trainable.items() if k.startswith("i2v.")
             and not torch.equal(p.detach(), regraft[k[4:]])]
    assert len(moved) == len(regraft)
    assert not any(n.startswith(("patch_embedding",)) or "add_" in n for n in proc.lora) and len(proc.lora) == 20
    with safe_open(res["save_path"], "np") as f:
        flat = {k: f.get_tensor(k) for k in f.keys()}
    ema, raw = proc.state.ema, proc.state.trainable
    ref = ji2v.i2v_extra_flat(_jax_overlay({k[4:]: ema[k] for k in raw if k.startswith("i2v.")}),
                              {"patch_embedding": {"w": raw["ctrl.w"].detach().numpy(),
                                                   "b": raw["ctrl.b"].detach().numpy()}})
    jtree: dict = {}
    for name in proc.lora:
        blk, leaf = twan_dit.wan_lora_key(name, scanned=False).split(".")
        jtree.setdefault(blk, {})[leaf] = {k: ema[f"{name}.{k}"].numpy() for k in ("a", "b", "scale")}
    jmodel = JWanModel(JModelConfig.from_dict(dict(TINY)))
    ref.update(jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jmodel, jtree), fmt="peft"))
    assert sorted(flat) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


def _jax_overlay(grafted):
    """Port-named graft tensors as the JAX overlay tree (unrolled)."""
    tree: dict = {}
    for n, v in grafted.items():
        *parents, leaf = ti2v.jax_leaf_path(n)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        v = v.detach().numpy()
        node[leaf] = v.T if v.ndim == 2 else v
    return tree


def test_jax_fault_resume_restarts_the_graft(job):
    """[jax_fault] JAX's resume reads an expansion only under
    ``transformer.x_embedder.weight``, which an i2v file has not, and no module
    of the JAX package calls ``load_i2v_from_flat``: a resumed JAX i2v job
    trains its graft and frame embedder from their init."""
    _, res, _ = job
    assert jcl.load_control_lora_expansion(res["save_path"], "patch_embedding") is None
    callers = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ai_toolkit_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                if "load_i2v_from_flat" in text:
                    callers += [f for node in ast.walk(ast.parse(text)) if isinstance(node, ast.Call)
                                and getattr(node.func, "id", getattr(node.func, "attr", None)) == "load_i2v_from_flat"]
    assert callers == []


def test_port_resumes_the_graft_exactly(tmp_path, monkeypatch):
    """[port] The job to 3 steps against the same job cut after its step-2 save
    and run again: the resumed step gives the whole run's loss bit for bit."""
    data = _clips(tmp_path)
    (whole,) = run_job(_i2v_job(tmp_path, steps=3, out="whole", data=data), device="cpu")
    prepare, calls = SDTrainProcess._prepare_batch, []

    def cut_after_two(self, *args):
        calls.append(1)
        if len(calls) > 2:
            raise KeyboardInterrupt  # killed after the step-2 save
        return prepare(self, *args)

    with monkeypatch.context() as m:
        m.setattr(SDTrainProcess, "_prepare_batch", cut_after_two)
        with pytest.raises(KeyboardInterrupt):
            run_job(_i2v_job(tmp_path, steps=3, out="cut", data=data), device="cpu")
    (resumed,) = run_job(_i2v_job(tmp_path, steps=3, out="cut", data=data), device="cpu")
    assert resumed["start_step"] == 2 and resumed["losses"] == whole["losses"][2:]


def test_jax_fault_sample_with_a_start_frame_fails(pair):
    """[jax_fault] JAX's samples build no first-frame control latents, so the
    frame embedder slices the noisy tokens themselves: the predict of every
    sample fails."""
    w, b = _frame_ctrl(pair)
    inp = _inputs(pair)
    jc, _ = _conds(pair, inp)
    jc.pop("control_latents")
    with pytest.raises(Exception):
        jax.eval_shape(pair.jm.predict, {"dit": _merged(pair), "ctrl": {"patch_embedding": {"w": w, "b": b}}},
                       jnp.asarray(inp["x0"]), jnp.asarray(inp["t"]), jc)


def test_port_refuses_a_start_frame_with_sample_prompts(tmp_path):
    """[port] The pair raises before the job builds, naming the fault."""
    (proc,) = get_job(_i2v_job(tmp_path, sample=True), device="cpu").processes
    with pytest.raises(NotImplementedError) as e:
        proc._refuse_unported()
    assert str(e.value) == I2V_START_FRAME_SAMPLE and "Queue 3" in I2V_START_FRAME_SAMPLE


def test_jax_fault_sample_drops_the_graft(pair):
    """[jax_fault] JAX ``_sample`` hands ``generate`` the model's variables and
    the ``ctrl`` collection alone when a LoRA trains: the grafted leaves are
    not there, and a sample with a ``ctrl_img`` (image tokens) fails."""
    inp = _inputs(pair)
    jc, _ = _conds(pair, inp)
    jc.pop("control_latents")
    with pytest.raises(Exception):
        jax.eval_shape(pair.jm.predict, {"dit": pair.t2v}, jnp.asarray(inp["x0"]), jnp.asarray(inp["t"]), jc)
    jax.eval_shape(pair.jm.predict, {"dit": pair.t2v}, jnp.asarray(inp["x0"]), jnp.asarray(inp["t"]),
                   {k: v for k, v in jc.items() if k != "img_cond"})  # without image tokens it runs


def test_port_samples_through_the_graft(tmp_path):
    """[port] The job without the start frame samples both prompts; the
    ``ctrl_img`` one goes through the graft, so it differs from the plain one
    (same seed)."""
    (res,) = run_job(_i2v_job(tmp_path, steps=1, start=False, sample=True), device="cpu")
    first = [s for s in res["samples"] if s["step"] == 1]
    assert [s["index"] for s in first] == [0, 1]
    frames = [np.asarray(Image.open(s["path"]).convert("RGB")) for s in first]
    assert frames[0].shape == (32, 32, 3) and not np.array_equal(frames[0], frames[1])


def test_jax_fault_image_batches_carry_no_pixels(tmp_path):
    """[jax_fault] JAX's job asks its loader for pixels only for the ip and
    custom adapters and ``train_turbo``: an i2v job's image batch has none,
    and JAX ``_prepare_batch`` raises on it."""
    raw = _i2v_job(tmp_path)
    jp = JSDTrainProcess("job", JProcessConfig.from_dict(raw["config"]["process"][0]))
    assert not (jp.ip_mode or jp.custom_adapter is not None or jp.cfg.train.train_turbo)
    jp.i2v_mode = {"start_frame": False}
    batch = {"latents": np.zeros((1, 1, 2, 2, 4), np.float32), "captions": ["x"],
             "loss_multiplier": np.ones(1, np.float32), "bucket": (32, 32)}
    text = types.SimpleNamespace(get=lambda caps: {"txt": np.zeros((1, 3, 4), np.float32)})
    with pytest.raises(ValueError, match="first-frame pixels"):
        jp._prepare_batch(types.SimpleNamespace(is_flow_matching=True), batch, text, None)


def test_port_trains_on_image_batches(tmp_path):
    """[port] The i2v job on an image folder: each image is its batch's first
    frame (through the vision tower and, with the start frame, the frame
    embedder)."""
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
        (imgs / f"{i}.txt").write_text(f"photo {i}")
    raw = _i2v_job(tmp_path, steps=1, data=str(imgs))
    raw["config"]["process"][0]["datasets"][0].update(do_i2v=False, num_frames=1)
    (res,) = run_job(raw, device="cpu")
    assert np.isfinite(res["losses"][0])
