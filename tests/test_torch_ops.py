"""Port ops (layers, rope, embeddings, flow-matching schedule) against the JAX
package on the same seeded numpy inputs, f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_toolkit_tpu.ops import embeddings as jemb
from ai_toolkit_tpu.ops import layers as jl
from ai_toolkit_tpu.ops import rope as jrope
from ai_toolkit_tpu.samplers.flowmatch import FlowMatchSchedule as JaxSchedule
from ai_toolkit_tpu_torch.ops import embeddings as temb
from ai_toolkit_tpu_torch.ops import layers as tl
from ai_toolkit_tpu_torch.ops import rope as trope
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule
from torch_jax_opt import jax_opt0  # noqa: F401

torch.set_num_threads(1)
F32 = dict(dtype=jnp.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_linear_layout():
    """torch weight [out, in] == JAX kernel [in, out] transposed (atol 1e-5:
    matmul summation order)."""
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 12), dtype=np.float32)
    w = rng.standard_normal((7, 12), dtype=np.float32)
    b = rng.standard_normal((7,), dtype=np.float32)
    lin = tl.Linear(12, 7, dtype=torch.float32)
    lin.load_state_dict({"weight": _t(w), "bias": _t(b)})
    ref = jl.Linear(7, **F32, param_dtype=jnp.float32).apply(
        {"params": {"kernel": w.T, "bias": b}}, jnp.asarray(x))
    np.testing.assert_allclose(lin(_t(x)).detach().numpy(), np.asarray(ref), atol=1e-5)


def test_conv_nhwc_layout():
    """OIHW weight, NHWC tensors at the boundary (atol 1e-5: conv summation order)."""
    rng = _rng(1)
    x = rng.standard_normal((2, 6, 5, 4), dtype=np.float32)
    w = rng.standard_normal((3, 3, 4, 8), dtype=np.float32)  # HWIO
    b = rng.standard_normal((8,), dtype=np.float32)
    conv = tl.Conv(4, 8, 3, dtype=torch.float32)
    conv.load_state_dict({"weight": _t(w.transpose(3, 2, 0, 1).copy()), "bias": _t(b)})
    ref = jl.Conv(8, (3, 3), **F32, param_dtype=jnp.float32).apply(
        {"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
    np.testing.assert_allclose(conv(_t(x)).detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kind", ["rms", "ln_plain", "ln_affine", "gn_16", "gn_64"])
def test_norms(kind):
    """f32 norms; atol 1e-5 (mean/var summation order)."""
    rng = _rng(2)
    c = 64 if kind == "gn_64" else 16
    x = rng.standard_normal((2, 4, 3, c), dtype=np.float32) * 3 + 1
    scale = rng.standard_normal((c,), dtype=np.float32)
    bias = rng.standard_normal((c,), dtype=np.float32)
    if kind == "rms":
        mod = tl.RMSNorm(c, weight_name="scale")
        mod.load_state_dict({"scale": _t(scale)})
        ref = jl.RMSNorm(**F32).apply({"params": {"scale": scale}}, jnp.asarray(x))
    elif kind == "ln_plain":
        mod = tl.LayerNorm(c, eps=1e-6, affine=False)
        ref = jl.LayerNorm(use_scale=False, use_bias=False, **F32).apply({}, jnp.asarray(x))
    elif kind == "ln_affine":
        mod = tl.LayerNorm(c, eps=1e-5)
        mod.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
        ref = jl.LayerNorm(eps=1e-5, **F32).apply(
            {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    else:  # C < 32 -> C groups of one channel (JAX g = min(32, C)); C = 64 -> 32 groups
        mod = tl.GroupNorm(c)
        mod.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
        ref = jl.GroupNorm(32, **F32).apply({"params": {"scale": scale, "bias": bias}},
                                            jnp.asarray(x))
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), np.asarray(ref), atol=1e-5)


def test_adaln_zero_and_modulate():
    """atol 1e-5 (matmul summation order)."""
    rng = _rng(3)
    cond = rng.standard_normal((2, 8), dtype=np.float32)
    w = rng.standard_normal((24, 8), dtype=np.float32)
    b = rng.standard_normal((24,), dtype=np.float32)
    x = rng.standard_normal((2, 5, 8), dtype=np.float32)
    ada = tl.AdaLayerNormZero(8, 3, dtype=torch.float32)
    ada.load_state_dict({"lin.weight": _t(w), "lin.bias": _t(b)})
    mods_t = ada(_t(cond))
    mods_j = jl.AdaLayerNormZero(8, 3, **F32, param_dtype=jnp.float32).apply(
        {"params": {"mod": {"kernel": w.T, "bias": b}}}, jnp.asarray(cond))
    for a, r in zip(mods_t, mods_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-5)
    out_t = tl.modulate(_t(x), mods_t[0], mods_t[1]).detach().numpy()
    out_j = jl.modulate(jnp.asarray(x), mods_j[0], mods_j[1])
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=1e-5)


def test_multi_axis_rope_and_apply():
    """Tables atol 1e-6 (f32 cos/sin), rotated q atol 1e-5."""
    ids = trope.image_position_ids(4, 5, text_len=3)
    np.testing.assert_array_equal(ids, jrope.image_position_ids(4, 5, text_len=3))
    axes = [4, 6, 6]
    tab_t = trope.multi_axis_rope(_t(ids)[None], axes)
    tab_j = jrope.multi_axis_rope(jnp.asarray(ids)[None], axes)
    np.testing.assert_allclose(tab_t.numpy(), np.asarray(tab_j), atol=1e-6)
    x = _rng(4).standard_normal((2, ids.shape[0], 3, 16), dtype=np.float32)
    np.testing.assert_allclose(trope.apply_rope(_t(x), tab_t).numpy(),
                               np.asarray(jrope.apply_rope(jnp.asarray(x), tab_j)), atol=1e-5)


def test_timestep_embedding_and_embedder():
    """atol 1e-4: the arguments reach t*1000 = 1000, where one f32 ulp is 6e-5,
    and XLA's f32 exp rounds 15 of the 128 frequencies one ulp away from
    torch's (torch's match the correctly rounded value in all but 3)."""
    t = np.asarray([0.0, 0.25, 0.8, 1.0], np.float32)
    for dim in (256, 17):
        np.testing.assert_allclose(temb.timestep_embedding(_t(t), dim).numpy(),
                                   np.asarray(jemb.timestep_embedding(jnp.asarray(t), dim)),
                                   atol=1e-4)
    rng = _rng(5)
    w1 = rng.standard_normal((32, 256), dtype=np.float32) * 0.05
    w2 = rng.standard_normal((32, 32), dtype=np.float32) * 0.1
    b1, b2 = (rng.standard_normal((32,), dtype=np.float32) for _ in range(2))
    emb = temb.TimestepEmbedder(32, dtype=torch.float32)
    emb.load_state_dict({"in_layer.weight": _t(w1), "in_layer.bias": _t(b1),
                         "out_layer.weight": _t(w2), "out_layer.bias": _t(b2)})
    ref = jemb.TimestepEmbedder(32, dtype=jnp.float32, param_dtype=jnp.float32).apply(
        {"params": {"in_layer": {"kernel": w1.T, "bias": b1},
                    "out_layer": {"kernel": w2.T, "bias": b2}}}, jnp.asarray(t))
    np.testing.assert_allclose(emb(_t(t)).detach().numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("steps,seq", [(4, 64), (8, 4096), (3, None)])
def test_inference_sigmas(steps, seq):
    """atol 1e-6 (f32 linspace / exp shift)."""
    s_t = FlowMatchSchedule().inference_sigmas(steps, image_seq_len=seq)
    s_j = JaxSchedule().inference_sigmas(steps, image_seq_len=seq)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


def test_euler_step():
    """atol 1e-6."""
    rng = _rng(6)
    x = rng.standard_normal((1, 4, 4, 3), dtype=np.float32)
    v = rng.standard_normal((1, 4, 4, 3), dtype=np.float32)
    sig = FlowMatchSchedule().inference_sigmas(4, image_seq_len=64)
    sig_j = JaxSchedule().inference_sigmas(4, image_seq_len=64)
    out_t = FlowMatchSchedule().euler_step(_t(x), _t(v), sig[1], sig[2])
    out_j = JaxSchedule().euler_step(jnp.asarray(x), jnp.asarray(v), sig_j[1], sig_j[2])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6)


def test_seeded_init_is_lecun_normal():
    """Kernels get flax lecun_normal scale (std sqrt(1/fan_in)), biases 0, norms 1."""
    lin = tl.init_parameters(tl.Linear(400, 300), torch.Generator().manual_seed(0))
    assert abs(lin.weight.std().item() - (1 / 400) ** 0.5) < 2e-3
    assert lin.weight.abs().max().item() <= 2 * (1 / 400) ** 0.5 / 0.87962566103423978
    assert lin.bias.abs().max().item() == 0.0
    norm = tl.init_parameters(tl.RMSNorm(8), torch.Generator().manual_seed(0))
    assert norm.weight.dtype == torch.float32 and bool((norm.weight == 1).all())
    a = tl.init_parameters(tl.Linear(4, 4), torch.Generator().manual_seed(1)).weight
    b = tl.init_parameters(tl.Linear(4, 4), torch.Generator().manual_seed(1)).weight
    assert torch.equal(a, b)
