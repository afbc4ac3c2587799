"""Port models (FluxDiT, CLIP, T5, VAE decoder) and io/from_jax against the JAX
package at tiny f32 sizes on the CPU. Weights come from the port's seeded init;
the JAX trees are built from them with the JAX package's own importer rules."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.io.flux_import import flux_dit_rules
from ai_toolkit_tpu.io.sd_import import clip_rules, t5_rules, vae_rules
from ai_toolkit_tpu.io.torch_import import torch_to_tree, tree_to_torch
from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.models import vae as jvae
from ai_toolkit_tpu.models.text_encoders import clip as jclip
from ai_toolkit_tpu.models.text_encoders import t5 as jt5
from ai_toolkit_tpu.ops.rope import image_position_ids, multi_axis_rope
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.models import vae as tvae
from ai_toolkit_tpu_torch.models.text_encoders import clip as tclip
from ai_toolkit_tpu_torch.models.text_encoders import t5 as tt5
from ai_toolkit_tpu_torch.ops.layers import init_parameters
from ai_toolkit_tpu_torch.ops.rope import multi_axis_rope as t_multi_axis_rope
from test_torch_flux_family import fast_jit
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
ATOL = 1e-4  # f32 forwards through several layers: summation order only

VAE_TINY = jvae.VAEConfig.tiny()
COMPONENTS = {
    # name: (port module factory, importer rules, from_jax converter)
    "dit": (lambda: tdit.FluxDiT(tdit.FluxConfig.tiny()), lambda: flux_dit_rules(scan_blocks=False),
            from_jax.flux_dit_state_dict),
    "dit_scanned": (lambda: tdit.FluxDiT(tdit.FluxConfig.tiny()),
                    lambda: flux_dit_rules(scan_blocks=True), from_jax.flux_dit_state_dict),
    "clip": (lambda: tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()), clip_rules,
             from_jax.clip_state_dict),
    "t5": (lambda: tt5.T5Encoder(tt5.T5Config.tiny()), t5_rules, from_jax.t5_state_dict),
    "vae": (lambda: tvae.AutoencoderKL(tvae.VAEConfig.tiny()),
            lambda: vae_rules(len(VAE_TINY.channel_multipliers), VAE_TINY.layers_per_block),
            from_jax.vae_state_dict),
}


def _build(name, seed=0):
    module = init_parameters(COMPONENTS[name][0](), torch.Generator().manual_seed(seed))
    # random (not unit) norm scales, so a misplaced scale cannot go unnoticed
    with torch.no_grad():
        for k, p in module.named_parameters():
            if p.dim() == 1 and "bias" not in k:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(len(k))))
    return module.eval()


def _jax_tree(module, rules):
    flat = {k: v.numpy() for k, v in module.state_dict().items()}
    tree, unmatched = torch_to_tree(flat, rules)
    assert not unmatched, unmatched[:8]
    return tree


@pytest.mark.parametrize("name", list(COMPONENTS))
def test_from_jax_matches_exporter_and_round_trips(name):
    module = _build(name)
    rules = COMPONENTS[name][1]()
    tree = _jax_tree(module, rules)
    if name == "dit_scanned":
        assert tree["double_blocks"]["block"]["img_qkv"]["kernel"].shape[0] == 2
    ours = {k: v.numpy() for k, v in COMPONENTS[name][2](tree).items()}
    theirs = tree_to_torch(tree, rules)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    original = {k: v.numpy() for k, v in module.state_dict().items()}
    assert sorted(ours) == sorted(original)
    for k in original:
        np.testing.assert_array_equal(ours[k], original[k], err_msg=k)


def test_flux_dit_forward_matches_jax():
    cfg_t = tdit.FluxConfig.tiny()
    module = _build("dit", seed=1)
    tree = _jax_tree(module, flux_dit_rules(scan_blocks=False))
    rng = np.random.default_rng(0)
    n_txt, hh, ww = 5, 4, 6
    img = rng.standard_normal((2, hh * ww, cfg_t.in_channels), dtype=np.float32)
    txt = rng.standard_normal((2, n_txt, cfg_t.context_dim), dtype=np.float32)
    t = np.asarray([0.25, 0.8], np.float32)
    y = rng.standard_normal((2, cfg_t.vec_dim), dtype=np.float32)
    g = np.asarray([1.0, 4.0], np.float32)
    ids = image_position_ids(hh, ww, text_len=n_txt)
    pe_j = multi_axis_rope(jnp.asarray(ids)[None], list(cfg_t.axes_dim), cfg_t.theta)
    ref = fast_jit(jdit.FluxDiT(jdit.FluxConfig.tiny()).apply,
                   {"params": tree}, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t), jnp.asarray(y),
                   pe_j, jnp.asarray(g))
    pe_t = t_multi_axis_rope(torch.from_numpy(ids)[None], list(cfg_t.axes_dim), cfg_t.theta)
    with torch.inference_mode():
        out = module(*(torch.from_numpy(a) for a in (img, txt, t, y)), pe_t, torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)

    # the scanned JAX layout converts to the same port weights
    cfg_s = dataclasses.replace(jdit.FluxConfig.tiny(), scan_blocks=True)
    tree_s = _jax_tree(module, flux_dit_rules(scan_blocks=True))
    ref_s = fast_jit(jdit.FluxDiT(cfg_s).apply,
                     {"params": tree_s}, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t), jnp.asarray(y),
                     pe_j, jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_s), atol=ATOL)

    # attn_masking: the key-padding mask takes the plain attention path
    mask = np.ones((2, n_txt), bool)
    mask[0, 3:] = False
    ref_m = fast_jit(jdit.FluxDiT(jdit.FluxConfig.tiny()).apply,
                     {"params": tree}, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(t), jnp.asarray(y),
                     pe_j, jnp.asarray(g), jnp.asarray(mask))
    with torch.inference_mode():
        out_m = module(*(torch.from_numpy(a) for a in (img, txt, t, y)), pe_t,
                       torch.from_numpy(g), torch.from_numpy(mask))
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), atol=ATOL)


def test_pack_latents_cmajor_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 6, 4, 3), dtype=np.float32)
    packed = tdit.pack_latents_cmajor(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdit.pack_latents_cmajor(jnp.asarray(x))))
    np.testing.assert_array_equal(tdit.unpack_latents_cmajor(packed, 6, 4).numpy(), x)


def test_clip_forward_matches_jax():
    module = _build("clip", seed=2)
    tree = _jax_tree(module, clip_rules())
    cfg = tclip.CLIPTextConfig.tiny()
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size - 1, (2, 77)).astype(np.int32)
    ids[0, 9:] = cfg.eos_token_id
    ids[1, 30:] = cfg.eos_token_id
    ref = fast_jit(jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny()).apply, {"params": tree}, jnp.asarray(ids))
    with torch.inference_mode():
        out = module(torch.from_numpy(ids).long())
    for key in ("pooled_output", "last_hidden_state"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


def test_t5_relative_position_bucket_matches_jax():
    """S = 512 reaches the log branch and the cap of the bucketing."""
    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    ref = jt5._relative_position_bucket(jnp.asarray(rel))
    ours = tt5.relative_position_bucket(torch.from_numpy(rel))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_t5_forward_matches_jax():
    module = _build("t5", seed=3)
    tree = _jax_tree(module, t5_rules())
    ids = np.random.default_rng(3).integers(2, 1000, (2, 40)).astype(np.int32)
    ids[0, 20:] = 1
    ref = fast_jit(jt5.T5Encoder(jt5.T5Config.tiny()).apply, {"params": tree}, jnp.asarray(ids))
    with torch.inference_mode():
        out = module(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_vae_decode_matches_jax():
    module = _build("vae", seed=4)
    tree = _jax_tree(module, vae_rules(len(VAE_TINY.channel_multipliers), VAE_TINY.layers_per_block))
    z = np.random.default_rng(4).standard_normal((1, 8, 6, VAE_TINY.latent_channels), dtype=np.float32)
    ref = fast_jit(lambda v, zz: jvae.AutoencoderKL(VAE_TINY).apply(v, zz, method=jvae.AutoencoderKL.decode),
                   {"params": tree}, jnp.asarray(z))
    with torch.inference_mode():
        out = module.decode(torch.from_numpy(z))
    assert out.shape == (1, 16, 12, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
