"""CUDA-only checks of the port's hand-written kernels (skipped without a card).

This file imports no jax, so it runs on a GPU machine without the JAX
package's dependencies; the suite's conftest imports jax, so skip it there:

    python -m pytest --noconftest -p no:randomly -m gpu tests/test_torch_cuda.py
"""

import pytest
import torch

from ai_toolkit_tpu_torch.ops import attention
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
LSE_ATOL = 1e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _qkv(gen, b, s, t, h, d, dtype):
    return [torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype) for n in (s, t, t)]


@pytest.mark.parametrize("shape,dtype,atol", [
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),  # rect, ragged, D=64
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),  # smaller than one tile
    ((2, 129, 65, 3, 64), torch.bfloat16, 2e-2),  # one row / column past a tile
    ((1, 640, 640, 4, 128), torch.bfloat16, 2e-2),  # bf16 rounding of p and out
])
def test_kernel_matches_plain(gen, shape, dtype, atol):
    q, k, v = _qkv(gen, *shape, dtype)
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v)
    assert (out.float() - ref_out.float()).abs().max().item() <= atol
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL


def test_dispatch_launches_the_kernel_only_where_it_applies(gen):
    q, k, v = _qkv(gen, 1, 128, 128, 2, 64, torch.bfloat16)
    before = fa.launches
    attention.dot_product_attention(q, k, v)
    assert fa.launches == before + 1
    attention.dot_product_attention(q, k, v, is_causal=True)  # plain path
    q32, k32, v32 = _qkv(gen, 1, 128, 128, 2, 32, torch.bfloat16)
    attention.dot_product_attention(q32, k32, v32)  # head_dim 32: plain path
    assert fa.launches == before + 1


def test_wrapper_raises_instead_of_falling_back(gen):
    q, k, v = _qkv(gen, 1, 64, 64, 2, 64, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _qkv(gen, 1, 64, 64, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k.cpu(), v)
    out, _ = fa.flash_attention_fwd(q.requires_grad_(), k, v)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.float().sum().backward()
