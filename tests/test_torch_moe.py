"""The port's grouped SwiGLU MoE (ops/kernels/moe_gmm.py, models/flux_dit.py
MoEFFN) against the JAX package on the CPU at tiny f32 sizes: the JAX Pallas
kernels run in TPU interpret mode (as tests/test_moe_gmm.py runs them), the
port's wrappers take their plain versions on CPU tensors. Inputs are made with
numpy and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ai_toolkit_tpu.models import flux_dit as jdit
from ai_toolkit_tpu.ops.pallas import moe_gmm as jmoe
from ai_toolkit_tpu_torch.io import from_jax
from ai_toolkit_tpu_torch.models import flux_dit as tdit
from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as tmoe

torch.set_num_threads(1)
# f32 on both sides: summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _banks(rng, e, d, h, scale=0.05):
    return [np.asarray(rng.normal(size=shape) * scale, np.float32)
            for shape in ((e, d, h), (e, d, h), (e, h, d))]


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("d,h,e,groups", [
    (64, 256, 3, [0, 0, 1, 2, 2, 2]),  # tests/test_moe_gmm.py's forward case
    (64, 128, 4, [1, 1, 3, 3]),  # experts 0 and 2 own no tile
])
def test_grouped_swiglu_forward_matches_jax(d, h, e, groups):
    bm = 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(len(groups) * bm, d)).astype(np.float32)
    w1, w3, w2 = _banks(rng, e, d, h)
    tg = np.asarray(groups, np.int32)
    ref = jmoe.grouped_swiglu(jnp.asarray(x), w1, w3, w2, jnp.asarray(tg), bm, 128)
    calls = tmoe.launches
    out = tmoe.grouped_swiglu(*_t(x, w1, w3, w2), torch.from_numpy(tg), bm)
    assert tmoe.launches == calls  # CPU tensors never count a kernel launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_grouped_swiglu_dx_matches_jax_vjp():
    """The x gradient through the custom op's autograd (the dx formula with
    h1/h3 recomputed) against jax.vjp of the Pallas grouped_swiglu."""
    d, h, e, bm = 64, 128, 2, 8
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4 * bm, d)).astype(np.float32)
    w1, w3, w2 = _banks(rng, e, d, h)
    tg = np.asarray([0, 1, 1, 1], np.int32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jmoe.grouped_swiglu(xx, w1, w3, w2, jnp.asarray(tg), bm, 128),
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(cot))
    (xt,) = _t(x, grad=True)
    y = tmoe.grouped_swiglu(xt, *_t(w1, w3, w2), torch.from_numpy(tg), bm)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    direct = tmoe.grouped_swiglu_dx(*_t(x, cot, w1, w3, w2), torch.from_numpy(tg), bm)
    np.testing.assert_array_equal(direct.numpy(), dx.numpy())


@pytest.mark.parametrize("groups", [[0, 1, 1, 2], [0, 0, 2, 2]], ids=["all-experts", "expert-1-empty"])
@pytest.mark.parametrize("bank", ["w1", "w3", "w2"])
def test_grouped_swiglu_bank_gradients_match_jax_vjp(bank, groups):
    """A bank's gradient through the custom op's autograd (the _dw_kernel
    formula, f32) and grouped_swiglu_dw_plain against jax.vjp of the Pallas
    grouped_swiglu (its _dw_kernel in interpret mode) on every expert that
    owns a tile. An expert that owns none gets zeros in the port; the Pallas
    kernel never writes its output block, which interpret mode leaves NaN (a
    fault of the reference, ROADMAP Queue 3)."""
    d, h, e, bm = 64, 128, 3, 8
    rng = np.random.default_rng(2)
    x = rng.normal(size=(len(groups) * bm, d)).astype(np.float32)
    banks = dict(zip(("w1", "w3", "w2"), _banks(rng, e, d, h)))
    tg = np.asarray(groups, np.int32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda w: jmoe.grouped_swiglu(jnp.asarray(x), *{**banks, bank: w}.values(),
                                                   jnp.asarray(tg), bm, 128), jnp.asarray(banks[bank]))
    (ref,) = vjp(jnp.asarray(cot))
    ref = np.asarray(ref)
    args = dict(zip(banks, _t(*banks.values())))
    args[bank].requires_grad_()
    y = tmoe.grouped_swiglu(torch.from_numpy(x), *args.values(), torch.from_numpy(tg), bm)
    calls = tmoe.dw_launches
    (dw,) = torch.autograd.grad(y, args[bank], torch.from_numpy(cot))
    assert tmoe.dw_launches == calls  # CPU tensors never count a kernel launch
    plain = dict(zip(banks, tmoe.grouped_swiglu_dw_plain(*_t(x, cot), *_t(*banks.values()),
                                                         torch.from_numpy(tg), bm)))[bank]
    owned = sorted(set(groups))
    for got in (dw, plain):
        np.testing.assert_allclose(got.numpy()[owned], ref[owned], atol=2e-5, rtol=2e-5)
        assert all(not got[g].any() for g in range(e) if g not in owned)
    assert all(np.isnan(ref[g]).all() for g in range(e) if g not in owned)


def _routing(rng, b, s, e, k, empty=None):
    logits = rng.normal(size=(b, s, e)).astype(np.float32)
    if empty is not None:
        logits[..., empty] = -30.0  # no token routes to this expert
    scores = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    topv, topi = jax.lax.top_k(jnp.asarray(scores), k)
    return np.array(topv), np.array(topi)


@pytest.mark.parametrize("block_m,empty", [(8, None), (tmoe.BLOCK_M, None), (8, 2)])
def test_moe_dispatch_swiglu_and_grads_match_jax(block_m, empty):
    """Forward and the x / topv gradients of the whole gather -> grouped SwiGLU
    -> combine; the port's tile size (8, or the kernels' 128) changes only the
    padding. ``empty``: one expert gets no token."""
    b, s, d, h, e, k = 2, 24, 64, 128, 4, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w1, w3, w2 = _banks(rng, e, d, h)
    topv, topi = _routing(rng, b, s, e, k, empty)
    if empty is not None:
        assert not (topi == empty).any()
    cot = rng.normal(size=x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda xx, tv: jmoe.moe_dispatch_swiglu(xx, tv, topi, w1, w3, w2, 8, 128),
                       jnp.asarray(x), jnp.asarray(topv))
    ref_dx, ref_dv = vjp(jnp.asarray(cot))
    xt, vt = _t(x, topv, grad=True)
    out = tmoe.moe_dispatch_swiglu(xt, vt, torch.from_numpy(topi), *_t(w1, w3, w2), block_m=block_m)
    dx, dv = torch.autograd.grad(out, (xt, vt), torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dv.numpy(), np.asarray(ref_dv), atol=2e-5, rtol=2e-5)


def test_moe_dispatch_needs_no_values_on_the_host():
    """The dispatch runs on meta tensors, which hold no values: no .item(), no
    data-dependent shape, so on the card it issues no host sync."""
    b, s, d, h, e, k = 1, 40, 64, 128, 4, 2
    meta = dict(device="meta")
    x = torch.empty((b, s, d), **meta)
    topv = torch.empty((b, s, k), **meta)
    topi = torch.empty((b, s, k), dtype=torch.long, **meta)
    banks = [torch.empty(shape, **meta) for shape in ((e, d, h), (e, d, h), (e, h, d))]
    out = tmoe.moe_dispatch_swiglu(x, topv, topi, *banks)
    assert out.shape == (b, s, d) and out.device.type == "meta"


def _moe_params(rng, d, h, e, sh):
    w1, w3, w2 = _banks(rng, e, d, h, 0.1)
    return {
        "gate": {"kernel": np.asarray(rng.normal(size=(d, e)) * 0.3, np.float32)},
        "experts": {"w1": {"kernel": w1}, "w3": {"kernel": w3}, "w2": {"kernel": w2}},
        "shared": {n: {"kernel": np.asarray(rng.normal(size=shape) * 0.1, np.float32)}
                   for n, shape in (("w1", (d, sh)), ("w3", (d, sh)), ("w2", (sh, d)))},
    }


@pytest.mark.parametrize("dispatch", ["dense", "grouped"])
def test_moeffn_matches_jax(dispatch):
    """MoEFFN on the same params as the JAX module (f32 gate, top-2 of the
    unnormalised softmax, half-width shared expert), and its input gradient."""
    b, s, d, h, e, k = 2, 16, 64, 128, 4, 2
    rng = np.random.default_rng(4)
    params = _moe_params(rng, d, h, e, h // 2)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jmod = jdit.MoEFFN(d, h, e, k, jnp.float32, jnp.float32, dispatch=dispatch)
    ref, vjp = jax.vjp(lambda xx: jmod.apply({"params": params}, xx), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(cot))

    mod = tdit.MoEFFN(d, h, e, k, torch.float32, dispatch=dispatch)
    sd = from_jax.flux_dit_state_dict({"double_0": {"img_mlp_moe": params}})
    mod.load_state_dict({key.removeprefix("double_blocks.0.img_mlp."): v for key, v in sd.items()})
    mod.requires_grad_(False)  # a frozen base, as in LoRA training: no bank gradient
    (xt,) = _t(x, grad=True)
    out = mod(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=2e-5, rtol=2e-5)
