"""Port flash-attention backward (ai_toolkit_tpu_torch/ops/kernels/flash_attention.py:
flash_attention_bwd_plain and the custom op's autograd) against jax.vjp of the JAX
Pallas flash attention, run in interpret mode as tests/test_flash_attention.py runs
it. The CUDA kernels themselves run only on the card (chip_smoke.py and
tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ai_toolkit_tpu.ops.pallas import flash_attention as jfa
from ai_toolkit_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(1)

# f32 on both sides; the Pallas kernels sum over 128-wide blocks, the plain
# version over the whole row: summation order only
ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(b, s, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d), (b, s, h, d))]


@pytest.mark.parametrize("b,s,t,h,d,kind", [
    (1, 128, 256, 1, 32, "flash"),  # rectangular, D=32 (test_flash_forward_rect_kv's shape)
    (1, 128, 128, 1, 64, "flash"),  # D=64
    (1, 250, 190, 2, 32, "any"),  # ragged: flash_attention_any pads and masks the KV tail
])
def test_bwd_matches_pallas_vjp(b, s, t, h, d, kind):
    q, k, v, g = _inputs(b, s, t, h, d, seed=s + t + d)
    fn = jfa.flash_attention_any if kind == "any" else (
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, None, 128, 128))
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tfa.flash_attention_fwd_plain(qt, kt, vt)
    plain = tfa.flash_attention_bwd_plain(qt, kt, vt, out, lse, gt)

    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    out_op, lse_op = tfa.flash_attention_op(*leaves, d ** -0.5)
    assert not lse_op.requires_grad
    out_op.backward(gt)

    for name, r, p, a in zip(("dq", "dk", "dv"), ref, plain, leaves):
        np.testing.assert_allclose(p.numpy(), r, atol=ATOL, err_msg=f"plain {name}")
        np.testing.assert_allclose(a.grad.numpy(), r, atol=ATOL, err_msg=f"autograd {name}")


def test_bwd_wrappers_on_cpu_use_plain_and_count_no_launch():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, 70, 50, 2, 64, seed=3))
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, g)
    delta = tfa.flash_attention_bwd_delta(out, g)
    assert delta.shape == (2, 2, 70)
    np.testing.assert_array_equal(
        dq.numpy(), tfa.flash_attention_bwd_dq(q, k, v, g, lse, delta, 64 ** -0.5).numpy())
    dk2, dv2 = tfa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, 64 ** -0.5)
    np.testing.assert_array_equal(dk.numpy(), dk2.numpy())
    np.testing.assert_array_equal(dv.numpy(), dv2.numpy())
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == before
    with pytest.raises(ValueError, match="tensors on"):
        tfa.flash_attention_bwd(q, k, v, out, lse, g.to("meta"))
