"""Port flash-attention forward (ai_toolkit_tpu_torch/ops/kernels/flash_attention.py)
against the JAX Pallas forward, run in interpret mode as tests/test_flash_attention.py
runs it. The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ai_toolkit_tpu.ops.attention import _reference_attention
from ai_toolkit_tpu.ops.pallas import flash_attention as jfa
from ai_toolkit_tpu_torch.ops import attention as tattn
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)

OUT_ATOL = 2e-5  # f32 online softmax vs f32 einsum/softmax: summation order only
LSE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(b, s, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, t, h, d), dtype=np.float32),
            rng.standard_normal((b, t, h, d), dtype=np.float32))


@pytest.mark.parametrize("b,s,t,h,d", [
    (2, 256, 256, 4, 32),  # test_flash_forward_matches_reference
    (1, 128, 256, 2, 32),  # test_flash_forward_rect_kv
    (1, 256, 256, 2, 64),  # test_flash_d64_fwd_bwd_and_gate
])
def test_plain_matches_pallas_fwd(b, s, t, h, d):
    q, k, v = _qkv(b, s, t, h, d, seed=s + t + d)
    out_j, (_, _, _, _, lse_j) = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          None, 128, 128)
    out_t, lse_t = tfa.flash_attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                                 torch.from_numpy(v))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=OUT_ATOL)
    np.testing.assert_allclose(lse_t.reshape(b * h, s).numpy(), np.asarray(lse_j), atol=LSE_ATOL)


def test_plain_matches_pallas_any_odd_lengths():
    """250x190 goes through the pad + KV-mask streamed kernel in the JAX package."""
    q, k, v = _qkv(1, 250, 190, 2, 32, seed=12)
    out_j = jfa.flash_attention_any(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = _reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out_t, lse_t = tfa.flash_attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                                 torch.from_numpy(v))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=OUT_ATOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), atol=OUT_ATOL)
    assert lse_t.shape == (1, 2, 250)


def test_dispatch_cpu_uses_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 70, 50, 2, 64, seed=3))
    before = tfa.launches
    out = tattn.dot_product_attention(q, k, v)
    out_w, lse_w = tfa.flash_attention_fwd(q, k, v)
    ref = _reference_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    assert tfa.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)
    np.testing.assert_array_equal(out.numpy(), out_w.numpy())
    assert lse_w.shape == (1, 2, 70)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 32, seed=4))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, k, v)
    q64, k64, v64 = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 64, seed=4))
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q64.half(), k64.half(), v64.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q64, k64, v64.transpose(1, 3).contiguous().transpose(1, 3))


@pytest.mark.parametrize("kind", ["causal", "mask"])
def test_masked_and_causal_match_reference(kind):
    q, k, v = _qkv(2, 12, 12, 2, 64, seed=5)
    mask = None
    if kind == "mask":
        mask = np.random.default_rng(6).random((2, 1, 12, 12)) > 0.3
        mask[..., 0] = True  # every row keeps one key
    out_t = tattn.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask), is_causal=kind == "causal")
    ref = _reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=None if mask is None else jnp.asarray(mask),
                               is_causal=kind == "causal")
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref), atol=OUT_ATOL)

