"""The port's LTX-2 audio chain against the JAX package on the CPU, in f32:
``log_mel`` against JAX ``log_mel_jax`` and the host
``log_mel_spectrogram`` (the symmetric Hann window, no centre padding, the
ragged last hop), the mel audio VAE (encode, decode, raw moments, the
causal rows), the latent packing, ``stack_stereo_mel`` and the vocoder with
its transposed convolutions. Weights come from the JAX package's own init
through ``io/from_jax``; inputs are made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.models import ltx_audio_vae as jmel
from ai_toolkit_tpu.models import ltx_vocoder as jvoc
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.models import ltx_audio_vae as tmel
from ai_toolkit_tpu_torch.models import ltx_vocoder as tvoc
from test_torch_flux_family import fast_jit
from torch_jax_opt import jax_opt0, seeded_init  # noqa: F401

torch.set_num_threads(1)
# a narrow mel VAE with LTX-2's structure: three levels, two downsamples, two res blocks a level
MEL = dict(base_channels=8, ch_mult=(1, 2, 4), num_res_blocks=2, latent_channels=4, mel_bins=16)


@pytest.mark.parametrize("samples", [4000, 4321])
def test_log_mel_matches_jax(samples):
    """[B, S, 2] -> [B, 1 + (S - 1024) // 160, 16, 2] at 16 kHz: JAX
    ``log_mel_jax`` and, per item, the host ``log_mel_spectrogram``; f32,
    1e-5 relative and 1e-5 of max|ref| (the mel values span about 1e2)."""
    wav = np.random.default_rng(samples).uniform(-1, 1, (2, samples, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda w: jmel.log_mel_jax(w, 16000, n_mels=16))(wav))
    out = tmel.log_mel(torch.from_numpy(wav), 16000, n_mels=16).numpy()
    assert out.shape == (2, 1 + (samples - 1024) // 160, 16, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    host = jmel.log_mel_spectrogram(wav[1], 16000, n_mels=16)
    np.testing.assert_allclose(out[1], host, rtol=1e-5, atol=1e-5 * np.abs(host).max())


def test_mel_filterbank_and_window_are_jax_s():
    """The filterbank is JAX's, bit for bit; the window is the symmetric Hann
    (``torch.hann_window``'s default, the periodic one, is not)."""
    np.testing.assert_array_equal(tmel.mel_filterbank(16000, 1024, 64), jmel._mel_filterbank(16000, 1024, 64))
    assert not np.allclose(np.hanning(1024), torch.hann_window(1024).numpy())


@pytest.fixture(scope="module")
def jax_mel_vae():
    cfg = jmel.LTXAudioVAEConfig(**MEL)
    mod = jmel.LTXAudioVAE(cfg)
    params = seeded_init(mod.init, jax.random.key(0), jnp.zeros((1, 8, 16, 2)))["params"]
    return mod, jax.tree.map(np.asarray, params)


def _port_mel_vae(params, **kw):
    mod = tmel.LTXAudioVAE(tmel.LTXAudioVAEConfig(**MEL, **kw))
    mod.load_state_dict(from_jax.ltx_audio_vae_state_dict(params))
    return mod


def test_mel_vae_matches_jax(jax_mel_vae):
    """raw moments, encode (the mean normalized by latent statistics) and
    decode of [1, 24, 16, 2] mels; f32, 1e-5 relative and 1e-5 of max|ref|.
    Latents are [1, 6, 4, 4]; decode gives 6 -> 11 -> 21 rows (each causal
    upsample drops its look-ahead row)."""
    jmod, params = jax_mel_vae
    stats = dict(latents_mean=(0.1, -0.2, 0.3, 0.0), latents_std=(1.5, 0.5, 2.0, 1.0))
    jmod = jmel.LTXAudioVAE(jmel.LTXAudioVAEConfig(**MEL, **stats))
    mel = np.random.default_rng(1).standard_normal((1, 24, 16, 2)).astype(np.float32)

    def run(p, x):  # one program: the moments, the latents and their decode
        lat = jmod.apply({"params": p}, x, method=jmel.LTXAudioVAE.encode)
        return (jmod.apply({"params": p}, x, method=jmel.LTXAudioVAE.raw_moments), lat,
                jmod.apply({"params": p}, lat, method=jmel.LTXAudioVAE.decode))

    ref_mom, ref_lat, ref_dec = (np.asarray(r) for r in fast_jit(run, params, mel))
    mod = _port_mel_vae(params, **stats)
    with torch.inference_mode():
        mom = mod.raw_moments(torch.from_numpy(mel)).numpy()
        lat = mod.encode(torch.from_numpy(mel)).numpy()
        dec = mod.decode(torch.from_numpy(ref_lat)).numpy()
    assert lat.shape == (1, 6, 4, 4) and dec.shape == (1, 21, 16, 2) == ref_dec.shape
    for got, ref in ((mom, ref_mom), (lat, ref_lat), (dec, ref_dec)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_mel_vae_is_causal_in_time(jax_mel_vae):
    """A change at mel row 20 leaves the latents of rows before it as they were."""
    _, params = jax_mel_vae
    mod = _port_mel_vae(params)
    mel = np.random.default_rng(2).standard_normal((1, 24, 16, 2)).astype(np.float32)
    later = mel.copy()
    later[:, 20:] += 1.0
    with torch.inference_mode():
        a, b = mod.encode(torch.from_numpy(mel)), mod.encode(torch.from_numpy(later))
    assert torch.equal(a[:, :5], b[:, :5]) and not torch.equal(a, b)


def test_mel_vae_names_are_the_importer_keys(jax_mel_vae):
    """JAX ``ltx_audio_vae_rules`` over the port's state dict rebuild the JAX tree."""
    from ai_toolkit_tpu.io.torch_import import torch_to_tree
    from ai_toolkit_tpu.io.video_vae_import import ltx_audio_vae_rules

    _, params = jax_mel_vae
    sd = {k: v.numpy() for k, v in _port_mel_vae(params).state_dict().items()}
    tree, unmatched = torch_to_tree(sd, ltx_audio_vae_rules())
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_pack_unpack_and_stereo_stack_match_jax():
    """Packing [B, T, 16, 8] latents into 128-wide tokens and back, and the
    vocoder's stereo stacking, bit for bit."""
    z = np.random.default_rng(3).standard_normal((2, 5, 16, 8)).astype(np.float32)
    tok = tmel.pack_audio_latents(torch.from_numpy(z))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jmel.pack_audio_latents(jnp.asarray(z))))
    np.testing.assert_array_equal(tmel.unpack_audio_latents(tok, 16).numpy(), z)
    mel = np.random.default_rng(4).standard_normal((2, 5, 64, 2)).astype(np.float32)
    np.testing.assert_array_equal(tvoc.stack_stereo_mel(torch.from_numpy(mel)).numpy(),
                                  np.asarray(jvoc.stack_stereo_mel(jnp.asarray(mel))))


@pytest.mark.parametrize("cfg_kw", [{}, dict(in_channels=8, hidden_channels=32, upsample_kernel_sizes=(16, 15, 4),
                                               upsample_factors=(6, 5, 2), resnet_kernel_sizes=(3, 7, 11),
                                               resnet_dilations=(1, 3, 5))],
                         ids=["tiny", "ltx2_kernels"])
def test_vocoder_matches_jax(cfg_kw):
    """The vocoder on [1, 7, in] mels: the tiny config and one with LTX-2's
    odd kernel 15 over stride 5 (the HiFi-GAN padding (k - s) // 2) and its
    three residual kernels; output length T x total upsample, in [-1, 1];
    f32, 1e-5 relative and 1e-5 of max|ref|."""
    jcfg = jvoc.VocoderConfig(**cfg_kw) if cfg_kw else jvoc.VocoderConfig.tiny()
    tcfg = tvoc.VocoderConfig(**cfg_kw) if cfg_kw else tvoc.VocoderConfig.tiny()
    jmod = jvoc.LTX2Vocoder(jcfg)
    mel = np.random.default_rng(5).standard_normal((1, 7, jcfg.in_channels)).astype(np.float32)
    params = jax.tree.map(np.asarray, seeded_init(jmod.init, jax.random.key(6), jnp.asarray(mel))["params"])
    params = jax.tree.map(lambda v: v + 0.01 if v.ndim == 1 else v, params)  # non-zero biases
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(mel)))
    mod = tvoc.LTX2Vocoder(tcfg)
    mod.load_state_dict(from_jax.vocoder_state_dict(params))
    with torch.inference_mode():
        out = mod(torch.from_numpy(mel)).numpy()
    assert out.shape == (1, 7 * tcfg.total_upsample, 2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_vocoder_names_are_the_importer_keys():
    """JAX ``vocoder_rules`` over the port's state dict rebuild the JAX tree
    (the transposed kernels ``[in, out, k]`` included)."""
    from ai_toolkit_tpu.io.torch_import import torch_to_tree

    jmod = jvoc.LTX2Vocoder(jvoc.VocoderConfig.tiny())
    params = jax.tree.map(np.asarray, seeded_init(jmod.init, jax.random.key(7), jnp.zeros((1, 4, 8)))["params"])
    mod = tvoc.LTX2Vocoder(tvoc.VocoderConfig.tiny())
    mod.load_state_dict(from_jax.vocoder_state_dict(params))
    tree, unmatched = torch_to_tree({k: v.numpy() for k, v in mod.state_dict().items()}, jvoc.vocoder_rules())
    assert not unmatched, unmatched[:5]
    ours, ref = from_jax._flatten(tree), from_jax._flatten(params)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
