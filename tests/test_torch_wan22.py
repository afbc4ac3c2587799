"""The rest of the port's slice E against the JAX package on the CPU at tiny
f32 sizes: the CLIP vision tower, i2v image conditioning (the antialiased
resize), the i2v DiT (the image attention a second softmax added to the text
attention's), the Wan 2.2 residual VAE and its parameter-free parts, the
multistage pair's routing, its switched noise ranges and its one shared
LoRA, the quantized pair (each expert quantized from its own weights; the
JAX package's shared ``quant`` collection pinned as a fault), the importer
names, ``first_frame`` from the loader, the archs' sizes, and the tiny i2v
train and generate jobs. Weights come from the JAX package's own init and go
through ``io/from_jax``; inputs and noise are made with numpy and handed to
both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.adapters import lora as jlora
from ai_toolkit_tpu.adapters.quantize import quantize_params as jquantize_params
from ai_toolkit_tpu.config.modules import DatasetConfig as JDatasetConfig
from ai_toolkit_tpu.config.modules import ModelConfig as JModelConfig
from ai_toolkit_tpu.data.dataset import FolderDataset as JFolderDataset
from ai_toolkit_tpu.data.loader import DataLoader as JDataLoader
from ai_toolkit_tpu.io import lora_file as jlora_file
from ai_toolkit_tpu.io.dit_importers import wan_dit_tree
from ai_toolkit_tpu.io.sd_import import clip_vision_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree
from ai_toolkit_tpu.io.video_vae_import import wan_vae_rules
from ai_toolkit_tpu.jobs.train_process import SDTrainProcess as JSDTrainProcess
from ai_toolkit_tpu.models import wan_dit as jwan_dit
from ai_toolkit_tpu.models import wan_vae as jwan_vae
from ai_toolkit_tpu.models.text_encoders import clip_vision as jclip_vision
from ai_toolkit_tpu.models.wan_model import WanModel as JWanModel
from ai_toolkit_tpu.samplers import FlowMatchSchedule as JFlowMatchSchedule
from ai_toolkit_tpu.train.losses import compute_loss as jcompute_loss
from ai_toolkit_tpu_torch.adapters import lora as tlora
from ai_toolkit_tpu_torch.adapters.quantize import quantize_params
from ai_toolkit_tpu_torch.config.modules import DatasetConfig, ModelConfig
from ai_toolkit_tpu_torch.data.dataset import FolderDataset
from ai_toolkit_tpu_torch.data.loader import DataLoader
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.jobs import get_job, run_job
from ai_toolkit_tpu_torch.models import wan_dit as twan_dit
from ai_toolkit_tpu_torch.models import wan_vae as twan_vae
from ai_toolkit_tpu_torch.models.text_encoders import clip_vision as tclip_vision
from ai_toolkit_tpu_torch.models.wan_model import QUANTIZE_EXCLUDE, WanModel
from ai_toolkit_tpu_torch.ops.attention import reference_attention
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from ai_toolkit_tpu_torch.train.step import TrainStepConfig, make_train_step, stage_range, train_loss
from ai_toolkit_tpu_torch.train.state import TrainState
from ai_toolkit_tpu_torch.train.optimizers import get_optimizer
from test_torch_flux_family import OPT0

torch.set_num_threads(1)
PAIR = {"name_or_path": "", "arch": "wan22_14b_i2v", "model_kwargs": {"size": "tiny"}}
# the i2v DiT at head_dim 128 (2 heads): the text and image attentions take the flash dispatch
DIT128 = dict(in_channels=4, dim=256, ffn_dim=128, num_heads=2, num_layers=2, text_dim=64, freq_dim=32,
              axes_dim=(44, 42, 42), i2v=True, img_cond_dim=48)


# ---- the CLIP vision tower ----

@pytest.fixture(scope="module")
def jax_vit():
    jmod = jclip_vision.CLIPVisionModel(jclip_vision.CLIPVisionConfig.tiny())
    params = jax.jit(jmod.init, compiler_options=OPT0)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jmod, jax.tree.map(np.asarray, params)


def _port_vit(params):
    mod = tclip_vision.CLIPVisionModel(tclip_vision.CLIPVisionConfig.tiny())
    mod.load_state_dict(from_jax.clip_vision_state_dict(params))
    return mod


def test_vit_matches_jax(jax_vit):
    """pooled_output, last_hidden_state and penultimate_hidden_state of the
    tiny ViT (17 tokens, full self-attention); f32, 1e-5."""
    jmod, params = jax_vit
    px = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(jmod.apply)({"params": params}, px)
    with torch.inference_mode():
        out = _port_vit(params)(torch.from_numpy(px))
    assert out["last_hidden_state"].shape == (2, 17, 64) and out["pooled_output"].shape == (2, 64)
    for k in ("pooled_output", "last_hidden_state", "penultimate_hidden_state"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    assert not np.allclose(out["last_hidden_state"].numpy(), out["penultimate_hidden_state"].numpy())


def test_vit_names_are_the_importer_keys(jax_vit):
    """JAX ``clip_vision_rules`` (transformers ``CLIPVisionModelWithProjection``
    keys) applied to the port's state dict rebuild the JAX tree."""
    _, params = jax_vit
    sd = {k: v.numpy() for k, v in _port_vit(params).state_dict().items()}
    tree, unmatched = torch_to_tree(sd, clip_vision_rules())
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k], err_msg=k)


# ---- the i2v DiT ----

@pytest.fixture(scope="module")
def jax_i2v_dit():
    cfg = jwan_dit.WanConfig(**DIT128, dtype=jnp.float32, param_dtype=jnp.float32, remat=False, scan_blocks=False)
    mod = jwan_dit.WanDiT(cfg)
    args = (jnp.zeros((1, 8, 16)), jnp.zeros((1, 7, 64)), jnp.zeros((1,)), jnp.zeros((1, 8, 64, 2, 2)),
            jnp.zeros((1, 5, 48)))
    params = jax.tree.map(np.asarray, jax.jit(mod.init, compiler_options=OPT0)(jax.random.key(3), *args)["params"])
    # the image MLP's norms away from their identity init, so their names are checked by value
    rng = np.random.default_rng(9)
    for name in ("img_emb_norm1", "img_emb_norm2"):
        for leaf in ("scale", "bias"):
            params[name][leaf] = params[name][leaf] + rng.normal(0, 0.1, params[name][leaf].shape).astype(np.float32)
    return cfg, mod, params


def _port_i2v_dit(params):
    dit = twan_dit.WanDiT(twan_dit.WanConfig(**DIT128, dtype=torch.float32, remat=False))
    dit.load_state_dict(from_jax.wan_dit_state_dict(params))
    return dit.requires_grad_(False)


def _i2v_inputs():
    """3 x 3 x 5 patches (45 tokens, ragged), 7 text tokens, 9 image tokens."""
    rng = np.random.default_rng(4)
    ids = twan_dit.wan_position_ids(3, 3, 5)
    return {"x": rng.standard_normal((1, 45, 16), dtype=np.float32),
            "ctx": rng.standard_normal((1, 7, 64), dtype=np.float32), "t": np.asarray([0.63], np.float32),
            "pe": np.asarray(jwan_dit.multi_axis_rope(jnp.asarray(ids), [44, 42, 42])),
            "img": rng.standard_normal((1, 9, 48), dtype=np.float32)}


@pytest.mark.parametrize("with_image", [True, False])
def test_i2v_dit_forward_matches_jax(jax_i2v_dit, monkeypatch, with_image):
    """The i2v DiT at head_dim 128 over 45 tokens, with the image tokens (the
    image MLP and every block's image K/V) and without them (an i2v DiT
    called as t2v); f32, 1e-4 of max|ref|; the attentions run the flash
    kernel's plain version."""
    _, jmod, params = jax_i2v_dit
    inp = _i2v_inputs()
    img = inp["img"] if with_image else None
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, inp["x"], inp["ctx"], inp["t"], inp["pe"], img))
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", lambda *a: calls.append(a[1].shape[1]) or real(*a))
    with torch.inference_mode():
        out = _port_i2v_dit(params)(*(torch.from_numpy(inp[k]) for k in ("x", "ctx", "t", "pe")),
                                    None if img is None else torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    assert calls == ([45, 7, 9] if with_image else [45, 7]) * 2


def test_image_attention_is_a_second_softmax(jax_i2v_dit):
    """The i2v cross-attention is softmax(q k_txt) v_txt + softmax(q k_img)
    v_img (decoupled K/V): the port's block attention equals that sum, and one
    softmax over the concatenated text and image K/V is a different function."""
    _, _, params = jax_i2v_dit
    attn = _port_i2v_dit(params).blocks[0].attn2
    rng = np.random.default_rng(5)
    x, ctx, img = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   for s in ((1, 45, 256), (1, 7, 256), (1, 9, 256)))
    heads = attn.heads
    with torch.inference_mode():
        out = attn(x, ctx, context_img=img)
        q = attn.norm_q(attn.to_q(x)).unflatten(-1, heads)
        k, v = attn.norm_k(attn.to_k(ctx)).unflatten(-1, heads), attn.to_v(ctx).unflatten(-1, heads)
        ki, vi = attn.norm_added_k(attn.add_k_proj(img)).unflatten(-1, heads), attn.add_v_proj(img).unflatten(-1, heads)
        summed = attn.to_out[0]((reference_attention(q, k, v) + reference_attention(q, ki, vi)).flatten(2))
        concat = attn.to_out[0](reference_attention(q, torch.cat([k, ki], 1), torch.cat([v, vi], 1)).flatten(2))
    np.testing.assert_allclose(out.numpy(), summed.numpy(), atol=1e-5 * summed.abs().max().item(), rtol=0)
    assert (out - concat).abs().max().item() > 0.1 * summed.abs().max().item()


def test_i2v_dit_names_are_the_importer_keys(jax_i2v_dit):
    """JAX ``wan_dit_tree(..., i2v=True)`` (diffusers keys ``attn2.add_k_proj``,
    ``attn2.norm_added_k``, ``condition_embedder.image_embedder.*``) applied to
    the port's state dict rebuilds the JAX tree."""
    cfg, _, params = jax_i2v_dit
    sd = {k: v.numpy() for k, v in _port_i2v_dit(params).state_dict().items()}
    w = sd.pop("patch_embedding.weight")  # [dim, (t, y, x, c)] -> Conv3d [dim, c, t, y, x]
    sd["patch_embedding.weight"] = w.reshape(w.shape[0], 1, 2, 2, 4).transpose(0, 4, 1, 2, 3)
    assert "blocks.1.attn2.norm_added_k.weight" in sd and "condition_embedder.image_embedder.norm2.bias" in sd
    tree, still = wan_dit_tree(sd, cfg, i2v=True)
    assert not still, still[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k], err_msg=k)


# ---- the Wan 2.2 VAE ----

@pytest.fixture(scope="module")
def jax_vae22():
    jmod = jwan_vae.WanVAE(jwan_vae.WanVAEConfig.tiny22())
    params = jax.jit(jmod.init, compiler_options=OPT0)(jax.random.key(2), jnp.zeros((1, 5, 16, 16, 3)))["params"]
    return jmod, jax.tree.map(np.asarray, params)


def _port_vae22(params):
    mod = twan_vae.WanVAE(twan_vae.WanVAEConfig.tiny22())
    mod.load_state_dict(from_jax.wan_vae_state_dict(params))
    return mod


@pytest.mark.parametrize("frames", [5, 9])
def test_wan22_vae_matches_jax(jax_vae22, frames):
    """``tiny22`` (2x2 patchify, residual down blocks with AvgDown3D in time
    and space, residual up blocks with DupUp3D and full-width resample convs,
    ``decoder_base_dim``): raw moments, encode and decode at 5 and 9 frames;
    f32, 1e-4 of max|ref|."""
    jmod, params = jax_vae22
    vid = np.random.default_rng(frames).uniform(-1, 1, (1, frames, 32, 32, 3)).astype(np.float32)

    def run(method, x):
        return np.asarray(jax.jit(lambda p, x: jmod.apply(p, x, method=method))({"params": params}, x))

    ref_mom, ref_lat = run(jwan_vae.WanVAE.raw_moments, vid), run(jwan_vae.WanVAE.encode, vid)
    ref_img = run(jwan_vae.WanVAE.decode, ref_lat)
    mod = _port_vae22(params)
    with torch.inference_mode():
        mom = mod.raw_moments(torch.from_numpy(vid)).numpy()
        lat = mod.encode(torch.from_numpy(vid)).numpy()
        img = mod.decode(torch.from_numpy(ref_lat)).numpy()
    assert lat.shape == (1, (frames - 1) // 4 + 1, 4, 4, 4) and img.shape == vid.shape
    for got, ref in ((mom, ref_mom), (lat, ref_lat), (img, ref_img)):
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("part,args", [
    ("patchify", (2,)),
    ("avg_down", (16, 2, 2)),  # time and space: a front-padded odd frame count
    ("avg_down", (8, 1, 2)),
    ("avg_down", (8, 1, 1)),
    ("dup_up", (8, 2, 2)),  # the first frame dropped
    ("dup_up", (4, 1, 2)),
])
def test_wan22_vae_parts_match_jax(part, args):
    """``vae_patchify`` / ``vae_unpatchify`` (channel order ``(c r q)``),
    ``_avg_down3d`` (its mean in f32) and ``_dup_up3d`` alone, bit for bit
    (the mean within 1e-6) on a 5-frame, 8-channel input."""
    x = np.random.default_rng(7).standard_normal((1, 5, 4, 6, 8)).astype(np.float32)
    tx = torch.from_numpy(x)
    if part == "patchify":
        got = twan_vae.vae_patchify(tx, *args).numpy()
        np.testing.assert_array_equal(got, np.asarray(jwan_vae.vae_patchify(jnp.asarray(x), *args)))
        np.testing.assert_array_equal(twan_vae.vae_unpatchify(torch.from_numpy(got), *args).numpy(), x)
        return
    fn = {"avg_down": (twan_vae._avg_down3d, jwan_vae._avg_down3d),
          "dup_up": (twan_vae._dup_up3d, jwan_vae._dup_up3d)}[part]
    got, ref = fn[0](tx, *args).numpy(), np.asarray(fn[1](jnp.asarray(x), *args))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_wan22_vae_names_are_the_importer_keys(jax_vae22):
    """JAX ``wan_vae_rules`` (``encoder.down_blocks.{i}.resnets.{j}``,
    ``.downsampler``, ``decoder.up_blocks.{i}.upsampler``) applied to the
    port's 2.2 state dict rebuild the JAX tree."""
    _, params = jax_vae22
    sd = {k: v.numpy() for k, v in _port_vae22(params).state_dict().items()}
    assert "decoder.up_blocks.0.upsampler.time_conv.weight" in sd and "encoder.down_blocks.1.downsampler.resample.1.weight" in sd
    tree, unmatched = torch_to_tree(sd, wan_vae_rules())
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]).reshape(ref[k].shape), ref[k], err_msg=k)


# ---- the model: archs and sizes ----

@pytest.mark.parametrize("arch", ["wan21", "wan21_i2v", "wan22_5b", "wan22_14b", "wan22_14b_i2v"])
@pytest.mark.parametrize("size", [None, "tiny", "14b", "5b"])
def test_archs_and_sizes_match_jax(arch, size):
    """Every arch at every size builds the JAX class's DiT, VAE and vision
    configs, bucket divisibility, pair and boundary: ``size`` defaults to
    1.3b (a ``wan22_14b`` pair without ``model_kwargs.size`` is a 1.3B pair),
    ``wan22_5b`` is forced to 5b unless tiny."""
    raw = {"name_or_path": "", "arch": arch, "model_kwargs": {} if size is None else {"size": size}}
    ours, ref = WanModel(ModelConfig.from_dict(raw), device="meta"), JWanModel(JModelConfig.from_dict(raw))
    for mine, theirs in ((ours.dit_config, ref.dit_config), (ours.vae_config, ref.vae_config),
                         (ours.vision_config, ref.vision_config)):
        assert (mine is None) == (theirs is None)
        if mine is None:
            continue
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.dtype == (torch.float32 if theirs.dtype == jnp.float32 else torch.bfloat16)
    assert (ours.multistage, ours.stage_boundary, ours.bucket_divisibility, ours.max_txt_len) == \
           (ref.multistage, ref.stage_boundary, ref.bucket_divisibility, ref.max_txt_len)
    assert ours.experts == (("dit", "dit_low") if ref.multistage else ("dit",))
    if arch == "wan22_14b" and size is None:
        assert ours.dit_config.dim == 1536 and ours.dit_config.num_layers == 30


@pytest.mark.parametrize("what", ["dit14b_i2v", "dit5b", "vae22", "vit_h"])
def test_full_size_parameters_match_jax(what):
    """The 14B i2v DiT (one expert), the TI2V-5B DiT, the Wan 2.2 VAE and
    ViT-H built on the meta device have the JAX modules' parameter counts
    (their shapes from ``jax.eval_shape``, no weights made)."""
    if what.startswith("dit"):
        jcfg = (dataclasses.replace(jwan_dit.WanConfig.wan21_14b(), i2v=True) if what == "dit14b_i2v"
                else jwan_dit.WanConfig.wan22_5b())
        tcfg = (dataclasses.replace(twan_dit.WanConfig.wan21_14b(), i2v=True) if what == "dit14b_i2v"
                else twan_dit.WanConfig.wan22_5b())
        n, pd = 8, jcfg.in_channels * 4
        img = jnp.zeros((1, 4, jcfg.img_cond_dim)) if jcfg.i2v else None
        shapes = jax.eval_shape(jwan_dit.WanDiT(jcfg).init, jax.random.key(0), jnp.zeros((1, n, pd)),
                                jnp.zeros((1, 8, jcfg.text_dim)), jnp.zeros((1,)),
                                jnp.zeros((1, n, jcfg.head_dim // 2, 2, 2)), img)
        mod = twan_dit.WanDiT(tcfg, device="meta")
    elif what == "vae22":
        shapes = jax.eval_shape(jwan_vae.WanVAE(jwan_vae.WanVAEConfig.wan22_5b()).init, jax.random.key(0),
                                jnp.zeros((1, 5, 32, 32, 3)))
        mod = twan_vae.WanVAE(twan_vae.WanVAEConfig.wan22_5b(), device="meta")
    else:
        shapes = jax.eval_shape(jclip_vision.CLIPVisionModel(jclip_vision.CLIPVisionConfig.vit_h()).init,
                                jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
        mod = tclip_vision.CLIPVisionModel(tclip_vision.CLIPVisionConfig.vit_h(), device="meta")
    assert all(p.device.type == "meta" for p in mod.parameters())
    n_ours = sum(p.numel() for p in mod.parameters())
    assert n_ours == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    if what == "dit14b_i2v":
        assert n_ours > 16e9


# ---- the tiny multistage i2v pair ----

@pytest.fixture(scope="module")
def jax_pair():
    model = JWanModel(JModelConfig.from_dict(dict(PAIR)))
    variables = jax.tree.map(np.asarray, jax.jit(model.init_variables, compiler_options=OPT0)(jax.random.key(0)))
    assert {"dit", "dit_low", "clip_vision"} <= set(variables)
    return model, variables


@pytest.fixture(scope="module")
def jax_pair_fns(jax_pair):
    """JAX's ``predict``, and the loss and LoRA gradients of one flow-matching
    step through it, each jitted once for the module."""
    jmodel, jvars = jax_pair
    sched = JFlowMatchSchedule()

    def jloss(tree, x0, noise, t, cond):
        pred = jmodel.predict({**jvars, "lora": tree}, sched.add_noise(x0, noise, t), t, cond)
        return jcompute_loss(pred, sched.target(x0, noise, t))[0]

    return jax.jit(jmodel.predict), jax.jit(jax.value_and_grad(jloss))


def _port_pair(jvars):
    model = WanModel(ModelConfig.from_dict(dict(PAIR)), device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    model.load_state_dicts(variables, from_jax.wan_model_state(jvars))
    return model, variables


def _pair_inputs(seed=11):
    """Latents 2 x 4 x 4 (8 tokens), the tiny UMT5's 16 tokens, a first frame."""
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((1, 2, 4, 4, 4), dtype=np.float32),
            "noise": rng.standard_normal((1, 2, 4, 4, 4), dtype=np.float32),
            "txt": rng.standard_normal((1, 16, 64), dtype=np.float32),
            "frame": rng.uniform(-1, 1, (1, 48, 40, 3)).astype(np.float32)}


def test_encode_image_cond_matches_jax(jax_pair):
    """The first frame (48 x 40) resized to the tower's 32 x 32 and through
    the ViT: its penultimate hidden states within 1e-5 of JAX's. The resize
    must antialias as ``jax.image.resize`` does when it downsamples: plain
    bilinear is far off."""
    jmodel, jvars = jax_pair
    model, variables = _port_pair(jvars)
    frame = _pair_inputs()["frame"]
    ref = np.asarray(jmodel.encode_image_cond(jvars, jnp.asarray(frame)))
    with torch.inference_mode():
        got = model.encode_image_cond(variables, torch.from_numpy(frame)).numpy()
        plain = torch.nn.functional.interpolate(torch.from_numpy(frame).permute(0, 3, 1, 2), size=(32, 32),
                                                mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        no_aa = variables["clip_vision"](plain)["penultimate_hidden_state"].numpy()
    assert got.shape == (1, 17, 64)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert np.abs(no_aa - ref).max() > 1e-3


@pytest.mark.parametrize("t", [0.9, 0.1])
def test_multistage_routing_matches_jax(jax_pair, jax_pair_fns, t):
    """``predict`` at t = 0.9 runs the high-noise expert ``dit``, at 0.1 the
    low-noise ``dit_low`` (``mean(t) >= 0.875``), with the i2v image tokens:
    f32, 1e-4 of max|ref| against JAX's ``predict``; the other expert gives
    another output."""
    jmodel, jvars = jax_pair
    model, variables = _port_pair(jvars)
    inp = _pair_inputs()
    tt = np.asarray([t], np.float32)
    with torch.inference_mode():
        img = model.encode_image_cond(variables, torch.from_numpy(inp["frame"]))
        cond = {"txt": torch.from_numpy(inp["txt"]), "pe": model.rope_table(2, 4, 4), "img_cond": img}
        out = model.predict(variables, torch.from_numpy(inp["x0"]), torch.from_numpy(tt), cond).numpy()
        other = "dit_low" if model.last_expert == "dit" else "dit"
        swapped = {**variables, "dit": variables[other], "dit_low": variables[other]}
        out_other = model.predict(swapped, torch.from_numpy(inp["x0"]), torch.from_numpy(tt), cond).numpy()
    jcond = {"txt": jnp.asarray(inp["txt"]), "pe": jmodel.rope_table(2, 4, 4), "img_cond": jnp.asarray(img.numpy())}
    ref = np.asarray(jax_pair_fns[0](jvars, jnp.asarray(inp["x0"]), jnp.asarray(tt), jcond))
    assert model.last_expert == ("dit" if t >= 0.875 else "dit_low")
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    assert np.abs(out_other - ref).max() > 1e-2 * np.abs(ref).max()


def test_switch_every_t_ranges():
    """``switch_boundary_every: 2`` trains steps 0-4 on the high, high, low,
    low, high noise ranges: every sampled t of a step lies in it
    (``lo + t (hi - lo)``, JAX ``train_step``'s ``t_range``) and routes to
    that range's expert."""
    cfg = TrainStepConfig(timestep_type="shift", stage_boundary=0.875, switch_every=2)
    want = [(0.875, 1.0), (0.875, 1.0), (0.0, 0.875), (0.0, 0.875), (0.875, 1.0)]
    assert [stage_range(cfg, s) for s in range(5)] == want
    assert stage_range(TrainStepConfig(), 3) is None
    model = WanModel(ModelConfig.from_dict(dict(PAIR)), device="meta")
    w = torch.nn.Parameter(torch.ones(()))
    seen = []

    def predict(noisy, t, cond):
        seen.append((t.clone(), model.expert(t)))
        return noisy * w

    step = make_train_step(predict, FlowMatchSchedule(), cfg)
    state = TrainState({"w": w}, get_optimizer("adamw", [w], 1e-4, {}, None))
    batch = {"latents": torch.zeros((4, 2, 4, 4, 4)), "cond": {}, "loss_multiplier": torch.ones(4),
             "image_seq_len": 8}
    gen = torch.Generator().manual_seed(0)
    for s in range(5):
        step(state, [batch], gen)
        t, expert = seen[-1]
        lo, hi = want[s]
        assert state.step == s + 1 and bool(((t >= lo) & (t <= hi)).all()), (s, t)
        assert expert == ("dit" if lo > 0 else "dit_low")


def _shared_lora(model, variables, seed=5):
    lora = tlora.build_lora(variables["dit"], tlora.LoRASpec(rank=4, alpha=8.0, target_patterns=model.lora_targets()),
                            torch.Generator().manual_seed(seed))
    tlora.share_lora(variables["dit_low"], lora)
    gb = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in lora.values():  # b non-zero, else a's gradient is zero
            m.b.normal_(0.0, 0.05, generator=gb)
    jtree: dict = {}
    for name, m in lora.items():
        block, leaf = model.lora_key(name).split(".")
        jtree.setdefault(block, {})[leaf] = {k: jnp.asarray(getattr(m, k).detach().numpy()) for k in ("a", "b", "scale")}
    return lora, jtree


def test_pair_shares_one_lora_network(jax_pair):
    """One LoRA network on both experts: JAX ``build_lora`` over the wan
    targets picks the same 24 block Linears (the image K/V included), and
    every adapted Linear of ``dit_low`` holds the very module of ``dit``."""
    _, jvars = jax_pair
    model, variables = _port_pair(jvars)
    lora, _ = _shared_lora(model, variables)
    jpaths = {"/".join(p) for p in jlora.lora_paths(jlora.build_lora(
        jvars["dit"], jlora.LoRASpec(rank=4, target_patterns=jwan_dit.wan_lora_targets()), jax.random.key(0)))}
    assert len(lora) == 24 and jpaths == {model.lora_key(n).replace(".", "/") for n in lora}
    assert {"block_0/cross_k_img", "block_1/cross_v_img"} <= jpaths
    low = dict(variables["dit_low"].named_modules())
    assert all(low[name].lora is adapter for name, adapter in lora.items())
    assert tlora.count_lora_params(lora) == sum(p.numel() for m in lora.values() for p in m.parameters())


@pytest.mark.parametrize("t", [0.95, 0.3])
def test_lora_step_through_each_expert_matches_jax(jax_pair, jax_pair_fns, t):
    """One flow-matching LoRA step through the high (t = 0.95) and the low
    (t = 0.3) expert with the i2v image tokens, noise and t injected: the
    loss, and the a and b gradients of the one shared network within 1e-4 of
    their max, against JAX's ``predict`` with the ``lora`` collection."""
    jmodel, jvars = jax_pair
    model, variables = _port_pair(jvars)
    lora, jtree = _shared_lora(model, variables)
    inp = _pair_inputs(seed=12)
    tt = np.asarray([t], np.float32)
    with torch.inference_mode():
        img = model.encode_image_cond(variables, torch.from_numpy(inp["frame"])).numpy()
    jcond = {"txt": jnp.asarray(inp["txt"]), "pe": jmodel.rope_table(2, 4, 4), "img_cond": jnp.asarray(img)}
    ref_loss, ref_grads = jax_pair_fns[1](jtree, *(jnp.asarray(a) for a in (inp["x0"], inp["noise"], tt)), jcond)
    cond = {"txt": torch.from_numpy(inp["txt"]), "pe": model.rope_table(2, 4, 4), "img_cond": torch.from_numpy(img)}
    batch = {"latents": torch.from_numpy(inp["x0"]), "cond": cond}
    loss, _ = train_loss(lambda n, t_, c: model.predict(variables, n, t_, c), FlowMatchSchedule(), TrainStepConfig(),
                         batch, torch.from_numpy(inp["noise"]), torch.from_numpy(tt))
    assert model.last_expert == ("dit" if t >= 0.875 else "dit_low")
    names = [(n, leaf) for n in lora for leaf in ("a", "b")]
    grads = torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for (name, leaf), g in zip(names, grads):
        block, mod = model.lora_key(name).split(".")
        ref = np.asarray(ref_grads[block][mod][leaf])
        assert np.abs(ref).max() > 0, f"{name}.{leaf}: zero reference gradient"
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0, err_msg=f"{name}.{leaf}")


@pytest.fixture(scope="module")
def quantized_pair(jax_pair):
    """The JAX reference of a quantized low-noise expert (``quantize_params``
    on ``dit_low``'s own weights, ``min_size=1``, int8, applied to ``WanDiT``
    directly), the JAX job's quantized pair (only ``dit`` quantized, its one
    ``quant`` collection passed to both experts) and the port's pair, each
    expert quantized from its own weights, at t = 0.1."""
    jmodel, jvars = jax_pair
    inp = _pair_inputs(seed=13)
    tt = np.asarray([0.1], np.float32)
    model, variables = _port_pair(jvars)
    with torch.inference_mode():
        img = model.encode_image_cond(variables, torch.from_numpy(inp["frame"])).numpy()
    tokens = jwan_dit.wan_patchify(jnp.asarray(inp["x0"]), (1, 2, 2))
    pe = jmodel.rope_table(2, 4, 4)
    rest_low, quant_low = jquantize_params(jvars["dit_low"], min_size=1)
    apply = jax.jit(jmodel.dit.apply)
    ref = apply({"params": rest_low, "quant": quant_low}, tokens, inp["txt"], tt, pe, img)
    ref = np.asarray(jwan_dit.wan_unpatchify(ref, 2, 4, 4, (1, 2, 2), 4))
    unquantized = np.asarray(jwan_dit.wan_unpatchify(apply({"params": jvars["dit_low"]}, tokens, inp["txt"], tt, pe, img),
                                                     2, 4, 4, (1, 2, 2), 4))
    rest_high, quant_high = jquantize_params(jvars["dit"], min_size=1)
    jcond = {"txt": jnp.asarray(inp["txt"]), "pe": pe, "img_cond": jnp.asarray(img)}
    shared = np.asarray(jax.jit(jmodel.predict)({**jvars, "dit": rest_high, "quant": quant_high},
                                                jnp.asarray(inp["x0"]), jnp.asarray(tt), jcond))
    names = [quantize_params(variables[e], exclude_patterns=QUANTIZE_EXCLUDE, min_size=1, qtype="qint8")
             for e in model.experts]
    cond = {"txt": torch.from_numpy(inp["txt"]), "pe": model.rope_table(2, 4, 4), "img_cond": torch.from_numpy(img)}
    with torch.inference_mode():
        ours = model.predict(variables, torch.from_numpy(inp["x0"]), torch.from_numpy(tt), cond).numpy()
    jq = {k.rsplit("/", 1)[0] for k in from_jax._flatten(quant_low)}
    return {"ref": ref, "unquantized": unquantized, "shared": shared, "ours": ours, "expert": model.last_expert,
            "names": names, "jax_quantized": jq}


@pytest.mark.parametrize("side", ["port", "jax_fault"])
def test_quantized_pair_uses_each_experts_own_weights(quantized_pair, side):
    """port: the port's quantized low expert (its own int8 weights, the same
    selection as JAX's) matches the JAX reference within 1e-5 of max|ref|,
    far inside the int8 error itself. jax_fault: the JAX job quantizes only
    ``variables["dit"]`` and ``WanModel.predict`` passes that one ``quant``
    collection to both experts, so its low expert runs the high expert's
    kernels: it is more than 1.0 away from the reference (a fault of the
    reference package, which stays as it is)."""
    q = quantized_pair
    int8_err = np.abs(q["ref"] - q["unquantized"]).max()
    assert 0 < int8_err < 0.2
    if side == "port":
        assert q["expert"] == "dit_low" and q["names"][0] == q["names"][1]
        assert {n for n in q["names"][1]} == {from_jax._wan_module(p) for p in q["jax_quantized"]}
        np.testing.assert_allclose(q["ours"], q["ref"], atol=1e-5 * np.abs(q["ref"]).max(), rtol=0)
    else:
        assert np.abs(q["shared"] - q["ref"]).max() > 1.0


# ---- data ----

def _write_clip(path, frames, size, seed):
    import cv2

    w, h = size
    rng = np.random.default_rng(seed)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 16, (w, h))
    assert wr.isOpened()
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(frames):
        img = 127.5 * (1 + np.sin((xx + 3 * i) / (4 + rng.uniform(0, 4)) + np.arange(3)[:, None, None]))
        wr.write(np.clip(img.transpose(1, 2, 0) + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8))
    wr.release()


def _clips(folder, n=2):
    folder.mkdir()
    for i in range(n):
        _write_clip(folder / f"v_{i}.avi", 8, (48, 32), i)
        (folder / f"v_{i}.txt").write_text(f"a video of thing {i}")
    return folder


def test_loader_first_frame_matches_jax(tmp_path):
    """With ``do_i2v`` a video batch carries each clip's ``first_frame``
    ``[B, H, W, 3]``: the port's loader and the JAX loader give the same
    frames bit for bit (an image-free batch of latents otherwise)."""
    data = _clips(tmp_path / "clips")
    kw = dict(folder_path=str(data), caption_ext="txt", resolution=[32], num_frames=5, do_i2v=True,
              cache_latents_to_disk=False)
    ds, jds = FolderDataset(DatasetConfig(**kw), 16), JFolderDataset(JDatasetConfig(**kw), 16)
    batch = sorted(ds.items, key=lambda it: it.path)
    jbatch = sorted(jds.items, key=lambda it: it.path)
    assert [it.path for it in batch] == [it.path for it in jbatch]
    encode = lambda px: np.zeros((px.shape[0], 2, 4, 4, 4), np.float32)  # noqa: E731
    ours = DataLoader([ds], 2, encode_fn=encode)._load_batch(ds, batch)
    ref = JDataLoader([jds], 2, encode_fn=encode)._load_batch(jds, jbatch)
    assert ours["first_frame"].shape == (2, 32, 32, 3) and ours["first_frame"].dtype == np.float32
    np.testing.assert_array_equal(ours["first_frame"], np.asarray(ref["first_frame"]))
    ds_t2v = FolderDataset(DatasetConfig(**{**kw, "do_i2v": False}), 16)
    assert "first_frame" not in DataLoader([ds_t2v], 2, encode_fn=encode)._load_batch(ds_t2v, batch)


# ---- the jobs ----

def test_i2v_pair_train_job_saves_jax_layout_and_generate_loads_it(tmp_path, capsys):
    """The tiny ``wan22_14b_i2v`` LoRA job over two seeded clips with
    ``do_i2v`` and ``switch_boundary_every: 2``, 3 steps: finite losses, the
    experts high, high, low, a PEFT file with the keys and fp16 values of the
    JAX job's save of the same (EMA) LoRA tree; then the generate job with
    that file and a ``ctrl_img`` writes an animated webp, its steps routed by
    sigma to both experts."""
    from PIL import Image
    from safetensors import safe_open

    data = _clips(tmp_path / "clips")
    raw = {"job": "extension", "config": {"name": "pair_tiny", "process": [{
        "type": "sd_trainer", "training_folder": str(tmp_path / "out"),
        "network": {"type": "lora", "linear": 4, "linear_alpha": 4},
        "save": {"dtype": "float16", "save_every": 250},
        "datasets": [{"folder_path": str(data), "caption_ext": "txt", "cache_latents_to_disk": False,
                      "resolution": [32], "num_frames": 6, "do_i2v": True}],
        "train": {"batch_size": 1, "steps": 3, "noise_scheduler": "flowmatch", "timestep_type": "shift",
                  "optimizer": "adamw", "lr": 1e-4, "ema_config": {"use_ema": True, "ema_decay": 0.99},
                  "dtype": "float32", "seed": 42, "switch_boundary_every": 2},
        "logging": {"log_every": 1}, "model": dict(PAIR)}]}}
    job = get_job(raw, device="cpu")
    (result,) = job.run()
    proc = job.processes[0]
    log = capsys.readouterr().out
    assert [line.split("expert=")[1].split()[0] for line in log.splitlines() if "expert=" in line] == \
           ["dit", "dit", "dit_low"]
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))
    low = dict(proc.variables["dit_low"].named_modules())
    assert all(low[n].lora is m for n, m in proc.lora.items())
    ema = proc.state.ema
    jtree: dict = {}
    for name in proc.lora:
        block, leaf = proc.model.lora_key(name).split(".")
        jtree.setdefault(block, {})[leaf] = {k: np.asarray(ema[f"{name}.{k}"].detach().numpy())
                                             for k in ("a", "b", "scale")}
    jmodel = JWanModel(JModelConfig.from_dict(dict(PAIR)))
    ref = jlora_file.flatten_lora(jtree, key_map=JSDTrainProcess._key_map(jmodel, jtree), fmt="peft",
                                  dtype=np.float16)
    with safe_open(result["save_path"], framework="numpy") as f:
        flat = {k: f.get_tensor(k) for k in f.keys()}
    assert len(proc.lora) == 24 and sorted(flat) == sorted(ref)
    assert any("cross_k_img" in k for k in flat)
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)

    ctrl = tmp_path / "first.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(ctrl)
    gen = {"job": "generate", "config": {"name": "pair_gen", "process": [{
        "type": "generate", "training_folder": str(tmp_path), "model": dict(PAIR),
        "lora_path": result["save_path"],
        "sample": {"sampler": "flowmatch", "width": 32, "height": 32, "sample_steps": 4, "num_frames": 6,
                   "fps": 16, "seed": 42, "prompts": [{"prompt": "a video of thing 0", "ctrl_img": str(ctrl)}]}}]}}
    (out,) = run_job(gen, device="cpu")
    (path,) = out["images"]
    rec = out["timings"][0]
    assert path.endswith(".webp") and rec["latents_finite"] and rec["frames"] == 5
    assert rec["experts"][0] == "dit" and rec["experts"][-1] == "dit_low"
    with Image.open(path) as im:
        assert im.n_frames == 5 and im.size == (32, 32)
