"""The port's Wan 2.1 text-to-video slice against the JAX package on the CPU
at tiny f32 sizes: UMT5's per-layer bias, the causal 3-D VAE (all four
resample modes and the mid attention), the DiT at head_dim 128 and a ragged
token count (so its attentions take the flash kernel's plain version), one
flow-matching LoRA step, ``load_video``, ``generate_video``, the train job's
PEFT save against the JAX job's layout and the generate job that loads it,
and the refusal of sequence parallelism. Weights come from the
JAX package's own init and go through ``io/from_jax``; inputs and noise are
made with numpy and handed to both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.config.modules import GenerateImageConfig as JGenerateImageConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.data.dataset import FileItem as JFileItem
from ai_toolkit_tpu.generation import generate_video as jax_generate_video
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.dit_importers import wan_dit_tree
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.io.video_vae_import import wan_vae_rules
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models import wan_dit as jwan_dit
from ai_toolkit_tpu.models import wan_vae as jwan_vae
from ai_toolkit_tpu.models.text_encoders import t5 as jt5
from ai_toolkit_tpu.models.wan_model import WanModel as JWanModel
from ai_toolkit_tpu.samplers import FlowMatchSchedule as JFlowMatchSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ModelConfig
from ai_toolkit_tpu_torch.data.dataset import FileItem, load_video
from ai_toolkit_tpu_torch.generation import generate_video
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.io import lora_file as tlora_file
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.models import wan_dit as twan_dit
from ai_toolkit_tpu_torch.models import wan_vae as twan_vae
from ai_toolkit_tpu_torch.models.text_encoders import t5 as tt5
from ai_toolkit_tpu_torch.models.wan_model import WanModel
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, train_loss
from test_torch_flux_family import OPT0, fast_jit, jit_decode
from test_torch_lumina2 import filled
from torch_jax_opt import jax_opt0, filled_fan_in, seeded_init  # noqa: F401

torch.set_num_threads(1)
TINY = {"name_or_path": "", "arch": "wan21", "model_kwargs": {"size": "tiny"}}
# the DiT at head_dim 128 (2 heads), so every attention takes the flash dispatch
DIT128 = dict(in_channels=4, dim=256, ffn_dim=128, num_heads=2, num_layers=2, text_dim=64, freq_dim=32, axes_dim=(44, 42, 42))
# a narrow VAE with Wan 2.1's structure: downsample2d, downsample3d x 2, upsample3d x 2, upsample2d
VAE_NARROW = dict(base_dim=8)


@pytest.fixture(scope="module")
def jax_tiny():
    model = JWanModel(JModelConfig.from_dict(dict(TINY)))
    return model, filled(jax.eval_shape(model.init_variables, jax.random.key(0)), 0)  # traced, not compiled


def _port_tiny(jax_vars):
    model = WanModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.wan_model_state(jax_vars))
    return model, variables


# ---- components ----

def test_umt5_per_layer_bias_matches_jax():
    """Every layer with its own relative-bias table (UMT5); f32, 1e-5."""
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), per_layer_bias=True)
    ids = np.random.default_rng(0).integers(0, 999, (2, 11)).astype(np.int32)
    jmod = jt5.T5Encoder(jcfg)
    params = jax.tree.map(np.asarray, seeded_init(jmod.init, jax.random.key(1), jnp.asarray(ids))["params"])
    assert "relative_attention_bias" in params["layer_1"]
    mod = tt5.T5Encoder(dataclasses.replace(tt5.T5Config.tiny(), per_layer_bias=True))
    mod.load_state_dict(from_jax.t5_state_dict(params))
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(ids))
    with torch.inference_mode():
        out = mod(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    tables = [b.layer[0].SelfAttention.relative_attention_bias.weight for b in mod.encoder.block]
    assert not torch.equal(tables[0], tables[1])


@pytest.fixture(scope="module")
def jax_vae():
    jcfg = dataclasses.replace(jwan_vae.WanVAEConfig(), dtype=jnp.float32, **VAE_NARROW)
    jmod = jwan_vae.WanVAE(jcfg)
    x = jnp.zeros((1, 5, 16, 16, 3))
    # seeded values at the init's shapes (traced, not compiled)
    return jmod, filled_fan_in(jax.eval_shape(jmod.init, jax.random.key(2), x)["params"], 2)


@pytest.mark.parametrize("frames", [5, 9])
def test_wan_vae_matches_jax(jax_vae, frames):
    """raw_moments, encode (posterior mode, normalized by Wan 2.1's latent
    statistics) and decode in f32 within 1e-4 of max|ref|, at 5 and 9 frames
    (2 and 3 latent frames); the encoder's downsample2d and two downsample3d,
    the decoder's two upsample3d and upsample2d and both mid attentions run."""
    jmod, params = jax_vae
    mod = twan_vae.WanVAE(dataclasses.replace(twan_vae.WanVAEConfig(), dtype=torch.float32, **VAE_NARROW))
    mod.load_state_dict(from_jax.wan_vae_state_dict(params))
    modes = [m.mode for m in mod.modules() if isinstance(m, twan_vae.WanResample)]
    assert modes == ["downsample2d", "downsample3d", "downsample3d", "upsample3d", "upsample3d", "upsample2d"]
    vid = np.random.default_rng(frames).uniform(-1, 1, (1, frames, 16, 16, 3)).astype(np.float32)

    def run(p, x):  # one program: the moments, the latents and their decode
        lat = jmod.apply(p, x, method=jwan_vae.WanVAE.encode)
        return (jmod.apply(p, x, method=jwan_vae.WanVAE.raw_moments), lat,
                jmod.apply(p, lat, method=jwan_vae.WanVAE.decode))

    ref_mom, ref_lat, ref_img = (np.asarray(r) for r in fast_jit(run, {"params": params}, vid))
    with torch.inference_mode():
        mom = mod.raw_moments(torch.from_numpy(vid)).numpy()
        lat = mod.encode(torch.from_numpy(vid)).numpy()
        img = mod.decode(torch.from_numpy(ref_lat)).numpy()
    assert lat.shape == (1, (frames - 1) // 4 + 1, 2, 2, 16) and img.shape == vid.shape
    for got, ref in ((mom, ref_mom), (lat, ref_lat), (img, ref_img)):
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_wan_vae_names_are_the_importer_keys(jax_vae):
    """JAX ``wan_vae_rules`` applied to the port's state dict (diffusers
    names) rebuild the JAX VAE tree: every key matched, the same values."""
    _, params = jax_vae
    mod = twan_vae.WanVAE(dataclasses.replace(twan_vae.WanVAEConfig(), dtype=torch.float32, **VAE_NARROW))
    mod.load_state_dict(from_jax.wan_vae_state_dict(params))
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in mod.state_dict().items()}, wan_vae_rules())
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]).reshape(ref[k].shape), ref[k], err_msg=k)


# ---- the DiT ----

def _jax_dit():
    cfg = jwan_dit.WanConfig(**DIT128, dtype=jnp.float32, param_dtype=jnp.float32, remat=False,
                             scan_blocks=False)
    return cfg, jwan_dit.WanDiT(cfg)


@pytest.fixture(scope="module")
def jax_dit():
    cfg, mod = _jax_dit()
    x, ctx = jnp.zeros((1, 8, cfg.in_channels * 4)), jnp.zeros((1, 7, cfg.text_dim))
    pe = jnp.zeros((1, 8, cfg.head_dim // 2, 2, 2))
    return jax.tree.map(np.asarray, seeded_init(mod.init, jax.random.key(3), x, ctx, jnp.zeros((1,)), pe)["params"])


def _dit_inputs(seed=4):
    """Latents 3 x 6 x 10 -> 45 tokens (ragged), 7 text tokens, t, noise."""
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 3, 6, 10, 4), dtype=np.float32)
    return {"x0": lat, "noise": rng.standard_normal(lat.shape, dtype=np.float32),
            "ctx": rng.standard_normal((1, 7, 64), dtype=np.float32), "t": np.asarray([0.63], np.float32)}


def _port_dit(params):
    dit = twan_dit.WanDiT(twan_dit.WanConfig(**DIT128, dtype=torch.float32, remat=False))
    dit.load_state_dict(from_jax.wan_dit_state_dict(params))
    return dit.requires_grad_(False)


def _pe(t, h, w):
    ids = twan_dit.wan_position_ids(t, h // 2, w // 2)
    np.testing.assert_array_equal(ids, np.asarray(jwan_dit.wan_position_ids(t, h // 2, w // 2)))
    return jwan_dit.multi_axis_rope(jnp.asarray(ids), [44, 42, 42])


def test_wan_dit_forward_matches_jax(jax_dit, monkeypatch):
    """Patchify, the DiT and unpatchify at head_dim 128 over 45 tokens; f32,
    1e-4 of max|ref|; each block's self- and cross-attention run the flash
    kernel's plain version."""
    cfg, jmod = _jax_dit()
    inp = _dit_inputs()
    pe = _pe(3, 6, 10)
    tokens = jwan_dit.wan_patchify(jnp.asarray(inp["x0"]), cfg.patch_size)
    ref = jax.jit(jmod.apply)({"params": jax_dit}, tokens, jnp.asarray(inp["ctx"]), jnp.asarray(inp["t"]), pe)
    ref = np.asarray(jwan_dit.wan_unpatchify(ref, 3, 6, 10, cfg.patch_size, 4))
    dit = _port_dit(jax_dit)
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", lambda *a: calls.append(a[1].shape) or real(*a))
    with torch.inference_mode():
        t_tok = twan_dit.wan_patchify(torch.from_numpy(inp["x0"]), (1, 2, 2))
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(tokens))
        out = dit(t_tok, torch.from_numpy(inp["ctx"]), torch.from_numpy(inp["t"]),
                  torch.from_numpy(np.asarray(pe)))
        out = twan_dit.wan_unpatchify(out, 3, 6, 10, (1, 2, 2), 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    assert [s[1] for s in calls] == [45, 7] * 2  # self over 45 keys, cross over the 7 text tokens


def test_wan_dit_names_are_the_importer_keys(jax_dit):
    """JAX ``wan_dit_tree`` (diffusers ``WanTransformer3DModel`` keys) applied
    to the port's state dict rebuilds the JAX tree, the patch Linear given as
    the checkpoint's Conv3d; and a scanned JAX tree converts to the same
    state dict as the unrolled one."""
    cfg, _ = _jax_dit()
    sd = {k: v.numpy() for k, v in _port_dit(jax_dit).state_dict().items()}
    w = sd.pop("patch_embedding.weight")  # [dim, (t, y, x, c)] -> Conv3d [dim, c, t, y, x]
    sd["patch_embedding.weight"] = w.reshape(w.shape[0], 1, 2, 2, 4).transpose(0, 4, 1, 2, 3)
    tree, still = wan_dit_tree(sd, cfg)
    assert not still, still[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(jax_dit)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k], err_msg=k)
    blocks = [jax_dit[f"block_{i}"] for i in range(2)]
    scanned = {k: v for k, v in jax_dit.items() if not k.startswith("block_")}
    scanned["blocks"] = {"block": jax.tree.map(lambda *xs: np.stack(xs), *blocks)}
    a, b = from_jax.wan_dit_state_dict(scanned), from_jax.wan_dit_state_dict(jax_dit)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def _lora_pair(dit, rank=4, seed=5):
    """The same LoRA on the port's DiT (b non-zero, else a's gradient is zero)
    and as a JAX ``lora`` tree at the JAX paths."""
    lora = tlora.build_lora(dit, tlora.LoRASpec(rank=rank, alpha=8.0, target_patterns=twan_dit.wan_lora_targets()),
                            torch.Generator().manual_seed(seed))
    gb = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in lora.values():
            m.b.normal_(0.0, 0.05, generator=gb)
    jtree: dict = {}
    for name, m in lora.items():
        block, leaf = twan_dit.wan_lora_key(name, scanned=False).split(".")
        jtree.setdefault(block, {})[leaf] = {k: jnp.asarray(getattr(m, k).detach().numpy())
                                             for k in ("a", "b", "scale")}
    return lora, jtree


def test_wan_lora_targets_and_step_match_jax(jax_dit):
    """JAX ``build_lora`` over ``wan_lora_targets`` picks the same 20 block
    Linears; one flow-matching step (x_t, v target, MSE) with the noise and t
    injected: the loss, and every a and b gradient within 1e-4 of its max."""
    from ai_toolkit_tpu.adapters import lora as jlora

    cfg, jmod = _jax_dit()
    dit = _port_dit(jax_dit)
    lora, jtree = _lora_pair(dit)
    jpaths = {"/".join(p) for p in jlora.lora_paths(jlora.build_lora(
        jax_dit, jlora.LoRASpec(rank=4, target_patterns=jwan_dit.wan_lora_targets()), jax.random.key(0)))}
    assert len(lora) == 20 and jpaths == {twan_dit.wan_lora_key(n, False).replace(".", "/") for n in lora}
    assert sorted(from_jax.wan_lora_tree(jax.tree.map(np.asarray, jtree))) == sorted(lora)
    inp = _dit_inputs(seed=6)
    pe = _pe(3, 6, 10)
    x0, noise, t = (jnp.asarray(inp[k]) for k in ("x0", "noise", "t"))
    sched = JFlowMatchSchedule()

    def jloss(tree):
        tok = jwan_dit.wan_patchify(sched.add_noise(x0, noise, t), cfg.patch_size)
        out = jmod.apply({"params": jax_dit, "lora": tree}, tok, jnp.asarray(inp["ctx"]), t, pe)
        pred = jwan_dit.wan_unpatchify(out, 3, 6, 10, cfg.patch_size, 4)
        return jcompute_loss(pred, sched.target(x0, noise, t))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jtree)
    tpe = torch.from_numpy(np.asarray(pe))

    def predict(noisy, tt, cond):
        out = dit(twan_dit.wan_patchify(noisy, (1, 2, 2)), cond["txt"], tt, cond["pe"])
        return twan_dit.wan_unpatchify(out, 3, 6, 10, (1, 2, 2), 4)

    batch = {"latents": torch.from_numpy(inp["x0"]), "cond": {"txt": torch.from_numpy(inp["ctx"]), "pe": tpe}}
    loss, _ = train_loss(predict, FlowMatchSchedule(), TrainStepConfig(), batch, torch.from_numpy(inp["noise"]),
                         torch.from_numpy(inp["t"]))
    names = [(n, leaf) for n in lora for leaf in ("a", "b")]
    grads = torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for (name, leaf), g in zip(names, grads):
        block, mod = twan_dit.wan_lora_key(name, scanned=False).split(".")
        ref = np.asarray(ref_grads[block][mod][leaf])
        assert np.abs(ref).max() > 0, f"{name}.{leaf}: zero reference gradient"
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0, err_msg=f"{name}.{leaf}")


def test_wan_lora_keys_match_jax_flatten_lora(jax_dit):
    """The PEFT keys and fp16 values of JAX ``flatten_lora`` with the job's key
    map, for an unrolled tree (``transformer.block_0.self_q``) and a scanned
    one (``transformer.blocks.block.self_q.0``); both load back."""
    dit = _port_dit(jax_dit)
    lora, jtree = _lora_pair(dit)
    tree = {n: {k: getattr(m, k).detach() for k in ("a", "b", "scale")} for n, m in lora.items()}
    jmodel = JWanModel(JModelConfig.from_dict(dict(TINY)))
    stacked = {"blocks": {"block": jax.tree.map(lambda *xs: jnp.stack(xs), jtree["block_0"], jtree["block_1"])}}
    for scanned, jt in ((False, jtree), (True, stacked)):
        ref = jlora_file.flatten_lora(jt, key_map=JSDTrainProcess._key_map(jmodel, jt), fmt="peft")
        ours = tlora_file.flatten_lora(tree, key_map=lambda n: twan_dit.wan_lora_key(n, scanned))
        assert sorted(ours) == sorted(ref) and len(ref) == 40
        for k in ref:
            assert ours[k].dtype == ref[k].dtype == np.float16
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        back = tlora_file.unflatten_lora(ours, module_name=twan_dit.wan_module_name)
        assert sorted(back) == sorted(tree)


# ---- data ----

def _write_clip(path, frames, size, seed):
    import cv2

    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 16, (w, h))
    assert wr.isOpened()
    for i in range(frames):
        img = 127.5 * (1 + np.sin((xx + 3 * i) / (4 + rng.uniform(0, 4)) + np.arange(3)[:, None, None]))
        wr.write(np.clip(img.transpose(1, 2, 0) + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8))
    wr.release()


class _OverstatedCapture:
    """``cv2.VideoCapture`` whose header claims ``extra`` frames more than the
    stream holds, as a container with a wrong frame count does."""

    def __init__(self, real, extra):
        self.real, self.extra = real, extra

    def get(self, prop):
        import cv2

        return self.real.get(prop) + (self.extra if prop == cv2.CAP_PROP_FRAME_COUNT else 0)

    def read(self):
        return self.real.read()

    def release(self):
        self.real.release()


@pytest.mark.parametrize("frames,want,size,flip,extra", [
    (7, 9, (32, 32), False, 0),  # fewer frames than asked: some sampled twice
    (20, 9, (48, 32), True, 0),  # uniform sampling, resize and crop, both flips
    (7, 9, (32, 32), False, 4),  # the header overstates the count: the last frame repeated
])
def test_load_video_matches_jax(tmp_path, monkeypatch, frames, want, size, flip, extra):
    """Both packages' ``load_video`` of one seeded MJPG clip, bit for bit."""
    import cv2

    path = tmp_path / "clip.avi"
    _write_clip(path, frames, size, frames)
    if extra:
        real = cv2.VideoCapture
        monkeypatch.setattr(cv2, "VideoCapture", lambda p: _OverstatedCapture(real(p), extra))
    kw = dict(path=str(path), caption="", bucket=(32, 32), flip=flip, flip_y=flip, num_frames=want)
    ours = load_video(FileItem(**kw, kind="video"))
    ref = JFileItem(**kw, kind="video").load_video()
    assert ours.shape == (want, 32, 32, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if extra:  # frames 0 1 2 4 5 6 of 0..10 decode; the last one fills the other three
        assert all(np.array_equal(ours[i], ours[5]) for i in (6, 7, 8))
        assert not np.array_equal(ours[4], ours[5])


def test_frame_snapper_and_latent_shape_match_jax(jax_tiny):
    jmodel, _ = jax_tiny
    model = WanModel(ModelConfig.from_dict(dict(TINY)), device="cpu")
    full = WanModel(ModelConfig.from_dict({**TINY, "model_kwargs": {"size": "1.3b"}}), device="cpu")
    jfull = JWanModel(JModelConfig.from_dict({**TINY, "model_kwargs": {"size": "1.3b"}}))
    for n in (1, 2, 4, 5, 8, 16, 33, 34, 80, 81):
        assert model.frame_count_snapper(n) == jmodel.frame_count_snapper(n)
        assert full.frame_count_snapper(n) == jfull.frame_count_snapper(n)
        assert model.latent_shape(32, 48, n) == jmodel.latent_shape(32, 48, n)
        assert full.latent_shape(480, 832, n) == jfull.latent_shape(480, 832, n)
    assert full.latent_shape(480, 832, 81) == (21, 60, 104, 16)  # 21 * 30 * 52 = 32,760 tokens
    assert full.latent_shape(480, 480, 33) == (9, 60, 60, 16)  # 9 * 30 * 30 = 8,100 tokens
    assert full.image_seq_len(480, 832) == jfull.image_seq_len(480, 832)
    for f in dataclasses.fields(jwan_dit.WanConfig):
        if hasattr(full.dit_config, f.name) and f.name not in ("dtype",):
            assert getattr(full.dit_config, f.name) == getattr(jfull.dit_config, f.name), f.name
    assert full.t5_config.per_layer_bias and full.max_txt_len == jfull.max_txt_len == 512


def test_full_size_parameters_match_jax():
    """The 1.3B DiT, the Wan 2.1 VAE and UMT5-XXL built on the meta device:
    every parameter lands on the device asked for, and each component has
    the JAX package's parameter count (its shapes from ``jax.eval_shape``, no
    weights made)."""
    full = WanModel(ModelConfig.from_dict({**TINY, "model_kwargs": {"size": "1.3b"}}), device="meta")
    jfull = JWanModel(JModelConfig.from_dict({**TINY, "model_kwargs": {"size": "1.3b"}}))
    shapes = jax.eval_shape(jfull.init_variables, jax.random.key(0))
    ours = {"dit": twan_dit.WanDiT(full.dit_config, device="meta"),
            "vae": twan_vae.WanVAE(full.vae_config, device="meta"),
            "t5": tt5.T5Encoder(full.t5_config, device="meta")}
    for name, mod in ours.items():
        assert all(p.device.type == "meta" for p in mod.parameters()), name
        # the T5 embedding is tied (shared, encoder.embed_tokens): counted once
        n = sum(p.numel() for p in mod.parameters())
        ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes[name]))
        assert n == ref, (name, n, ref)
    assert sum(p.numel() for p in ours["dit"].parameters()) == 1_418_996_800


# ---- generation and the jobs ----

def test_generate_video_matches_jax(jax_tiny):
    """Euler over 5-D latents, 3 steps, 6 frames asked (snapped to 5), with a
    LoRA on the blocks, the JAX noise injected: uint8 frames within 1."""
    jmodel, jvars = jax_tiny
    model, variables = _port_tiny(jvars)
    lora, jtree = _lora_pair(variables["dit"])
    tlora.detach_lora(variables["dit"])
    tree = {n: {k: getattr(m, k).detach().clone() for k in ("a", "b", "scale")} for n, m in lora.items()}
    kw = dict(prompt="a cat walking through tall grass", width=32, height=32, seed=7, sample_steps=3,
              num_frames=6)
    ref, _ = jax_generate_video(jit_decode(jmodel), jvars, JGenerateImageConfig(**kw), lora=jtree)
    shape = model.latent_shape(32, 32, 5)
    noise = np.asarray(jax.random.normal(jax.random.key(7), (1, *shape), jnp.float32))
    stats = {}
    ours = generate_video(model, variables, GenerateImageConfig(**kw), lora=tree, noise=noise, stats=stats)
    assert ours.shape == np.asarray(ref).shape == (5, 32, 32, 3) and ours.dtype == np.uint8
    assert np.abs(ours.astype(np.int16) - np.asarray(ref).astype(np.int16)).max() <= 1
    assert len(np.unique(ours)) > 8 and len(stats["step_ms"]) == 3 and stats["tokens"] == 3 * 8 * 8


def test_train_job_saves_jax_layout_and_generate_loads_it(tmp_path):
    """The tiny wan21 LoRA job over two seeded clips (num_frames 6, snapped to
    5), 2 steps: finite losses, a PEFT file with the keys and fp16 values of
    the JAX job's save of the same (EMA) LoRA tree; then the generate job with
    that file writes an animated webp of the snapped frame count."""
    from PIL import Image
    from safetensors import safe_open

    data = tmp_path / "clips"
    data.mkdir()
    for i in range(2):
        _write_clip(data / f"v_{i}.avi", 8, (32, 32), i)
        (data / f"v_{i}.txt").write_text(f"a video of thing {i}")
    raw = {"job": "extension", "config": {"name": "wan_tiny", "process": [{
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"),
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "save": {"dtype": "float16", "save_every": 250},
        "datasets": [{"folder_path": str(data), "caption_ext": "txt", "cache_latents_to_disk": False,
                      "resolution": [32], "num_frames": 6}],
        "train": {"batch_size": 1, "steps": 2, "noise_scheduler": "flowmatch", "timestep_type": "shift",
                  "optimizer": "adamw", "lr": 1e-4, "ema_config": {"use_ema": True, "ema_decay": 0.99},
                  "dtype": "float32", "seed": 42},
        "model": dict(TINY)}]}}
    job = get_job(raw, device="cpu")
    (result,) = job.run()
    proc = job.processes[0]
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert proc.cfg.datasets[0].num_frames == 5
    ema = proc.state.ema
    jtree: dict = {}
    for name in proc.lora:
        block, leaf = twan_dit.wan_lora_key(name, scanned=False).split(".")
        jtree.setdefault(block, {})[leaf] = {k: np.asarray(ema[f"{name}.{k}"].detach().numpy())
                                             for k in ("a", "b", "scale")}
    jmodel = JWanModel(JModelConfig.from_dict(dict(TINY)))
    ref = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jmodel, jtree), fmt="peft",
                                  dtype=np.float16)
    with safe_open(result["save_path"], framework="numpy") as f:
        flat = {k: f.get_tensor(k) for k in f.keys()}
    assert len(proc.lora) == result["lora_modules"] == 20 and sorted(flat) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)

    gen = {"job": "generate", "config": {"name": "wan_gen", "process": [{
        "type": "generate", "training_folder": str(tmp_path), "model": dict(TINY),
        "lora_path": result["save_path"],
        "sample": {"sampler": "flowmatch", "width": 32, "height": 32, "sample_steps": 2, "num_frames": 6,
                   "fps": 16, "seed": 42, "prompts": ["a video of thing 0"]}}]}}
    (out,) = run_job(gen, device="cpu")
    (path,) = out["images"]
    assert path.endswith(".webp") and out["timings"][0]["latents_finite"] and out["timings"][0]["frames"] == 5
    with Image.open(path) as im:
        assert im.n_frames == 5 and im.size == (32, 32)


@pytest.mark.parametrize("what", ["sp"])
def test_rest_of_slice_e_raises(tmp_path, what):
    """Sequence parallelism raises, naming slice E (the other archs of slice
    E are ported: tests/test_torch_wan22.py)."""
    raw = {"job": "extension", "config": {"name": "x", "process": [{
        "type": "sd_trainer", "training_folder": str(tmp_path), "network": {"type": "lora"},
        "datasets": [{"folder_path": str(tmp_path), "cache_latents_to_disk": False}],
        "mesh": {"axes": {what: 2}}, "model": dict(TINY)}]}}
    with pytest.raises(NotImplementedError, match="slice E"):
        get_job(raw, device="cpu").run()
