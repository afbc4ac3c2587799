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
    out, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse, out.cpu())
    # the backward of the custom op launches both backward kernels, no fallback
    before = (fa.dq_launches, fa.dkv_launches)
    out, _ = fa.flash_attention_fwd(q.requires_grad_(), k, v)
    out.float().sum().backward()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)


# max|dX - ref| / max|ref| for dq, dk, dv against the f32 plain version: bf16
# rounds p and ds before the second products (f32 accumulation); f32 differs
# by summation order only
@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),  # rect, ragged, D=64
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),  # smaller than one tile
    ((2, 129, 65, 3, 64), torch.bfloat16, 2e-2),  # one row / column past a tile
    ((1, 640, 640, 4, 128), torch.bfloat16, 2e-2),
    ((1, 200, 200, 4, 128), "strided", 2e-2),  # q/k/v views of a fused projection
])
def test_bwd_kernels_match_plain(gen, shape, dtype, tol):
    b, s, t, h, d = shape
    if dtype == "strided":
        fused = torch.randn((b, s, 3 * h * d + 64), generator=gen, device="cuda").bfloat16()
        q, k, v = fused[..., : 3 * h * d].unflatten(-1, (3, h, d)).unbind(2)
        dtype = torch.bfloat16
    else:
        q, k, v = _qkv(gen, b, s, t, h, d, dtype)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v)
    before = (fa.dq_launches, fa.dkv_launches)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())
    for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
        assert x.dtype == dtype and x.shape == r.shape and bool(torch.isfinite(x).all()), name
        assert (x.float() - r).abs().max().item() <= tol * r.abs().max().item(), name


@pytest.mark.parametrize("shape", [(1, 333, 333, 4, 128), (2, 300, 190, 4, 64)])
def test_bwd_kernels_are_deterministic(gen, shape):
    """One owner per output tile and no atomics: dq, dk and dv are equal bits
    from run to run."""
    q, k, v = _qkv(gen, *shape, torch.bfloat16)
    g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    out, lse = fa.flash_attention_fwd(q, k, v)
    before = fa.dq_launches
    first = fa.flash_attention_bwd(q, k, v, out, lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), first, fa.flash_attention_bwd(q, k, v, out, lse, g)):
        assert torch.equal(a, b), name
    assert fa.dq_launches == before + 2


# The wgmma/TMA kernels (bf16 forward, dk/dv and dq) against their f32 plain
# versions: out within 2e-2 of max|ref| and never more than 2e-2 absolute (at
# T ~ 4500 a typical |out| of random inputs is ~0.02, so an absolute 2e-2 would
# not see a wrong P.V half), lse within 1e-3 absolute, dk/dv and dq within
# 2e-2 of max|ref| (p and ds rounded to bf16 before the second products).
# "qkv" and "linear1" take q, k, v as strided views of a fused projection (the
# main path's layouts), "unaligned" as views TMA cannot address (copied: the
# count of copies rises by 3 in the forward, 3 in dk/dv and 3 in dq).
# "negative" shifts q by +3.2 and k by -3.2, so the logits sit near -116 and
# lse near -106: a zero-filled K row past T would give dq's p = exp(-lse) =
# inf and a NaN, unless the kernel masks the tail (T = 190 is ragged).
@pytest.mark.parametrize("shape,layout", [
    ((1, 4481, 4481, 2, 128), "separate"),  # 1008^2: S = T not a multiple of 64 or 128
    ((2, 300, 190, 4, 64), "separate"),  # S != T, both ragged, D = 64
    ((2, 300, 190, 4, 128), "separate"),
    ((2, 190, 300, 4, 128), "separate"),  # S < T
    ((1, 16, 16, 2, 128), "separate"),  # smaller than one tile
    ((1, 16, 16, 2, 64), "separate"),
    ((2, 200, 200, 4, 128), "qkv"),
    ((1, 1100, 1100, 24, 128), "linear1"),
    ((2, 200, 200, 4, 64), "unaligned"),
    ((2, 300, 190, 4, 128), "negative"),
    # Wan 2.1 at 33 frames, 480^2: 8,100 tokens (63 * 128 + 36), 12 heads, and
    # the cross-attention to the 512 UMT5 tokens, with a ragged tail tile whose
    # lse sits near -106 in the negative case
    ((1, 8100, 8100, 12, 128), "separate"),
    ((1, 8100, 512, 12, 128), "separate"),
    ((1, 8100, 512, 12, 128), "negative"),
])
def test_wgmma_kernels_match_plain(gen, shape, layout):
    b, s, t, h, d = shape
    if layout == "separate":
        q, k, v = _qkv(gen, b, s, t, h, d, torch.bfloat16)
    elif layout == "negative":
        q, k, v = _qkv(gen, b, s, t, h, d, torch.float32)
        q, k, v = (q + 3.2).bfloat16(), (k - 3.2).bfloat16(), v.bfloat16()
    else:
        extra, start = {"qkv": (0, 0), "linear1": (4 * 3072, 0), "unaligned": (1, 1)}[layout]
        fused = torch.randn((b, s, 3 * h * d + extra), generator=gen, device="cuda").bfloat16()
        q, k, v = fused[..., start:start + 3 * h * d].unflatten(-1, (3, h, d)).unbind(2)
    copies = 3 if layout == "unaligned" else 0
    g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    before = (fa.launches, fa.dkv_launches, fa.tma_copies, fa.dq_launches)
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (fa.launches, fa.tma_copies) == (before[0] + 1, before[2] + copies)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert (out.float() - ref_out).abs().max().item() <= 2e-2 * min(1.0, ref_out.abs().max().item())
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    delta = fa.flash_attention_bwd_delta(out, g)
    scale = d ** -0.5
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.dkv_launches, fa.tma_copies) == (before[1] + 1, before[2] + 2 * copies)
    refs = fa.flash_attention_bwd_dkv_plain(q.float(), k.float(), v.float(), g.float(), lse, delta, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.tma_copies) == (before[3] + 1, before[2] + 3 * copies)
    refs = (*refs, fa.flash_attention_bwd_dq_plain(q.float(), k.float(), v.float(), g.float(), lse, delta, scale))
    for name, x, r in zip(("dk", "dv", "dq"), (dk, dv, dq), refs):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape and bool(torch.isfinite(x).all()), name
        assert (x.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item(), name


def test_checkpointed_dit_runs_each_kernel_once_per_block(gen):
    """Under the dots_flash policy the recompute keeps the flash forward's
    outputs: one forward, one dq and one dk/dv launch per block per step."""
    import dataclasses

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT, flux_lora_targets
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    cfg = dataclasses.replace(FluxConfig.tiny(), hidden_size=256, num_heads=2, head_dim=128,
                              axes_dim=(16, 56, 56), depth_double=2, depth_single=2,
                              dtype=torch.bfloat16)
    dit = init_parameters(FluxDiT(cfg, device="cuda"), gen)
    lora = build_lora(dit, LoRASpec(rank=4, alpha=4.0, target_patterns=flux_lora_targets()), gen)
    dit.gradient_checkpointing = True
    n_txt, hh, ww = 8, 4, 6
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None],
                         list(cfg.axes_dim), cfg.theta).cuda()
    args = [torch.randn((1, hh * ww, cfg.in_channels), generator=gen, device="cuda"),
            torch.randn((1, n_txt, cfg.context_dim), generator=gen, device="cuda"),
            torch.tensor([0.5], device="cuda"),
            torch.randn((1, cfg.vec_dim), generator=gen, device="cuda"), pe,
            torch.ones(1, device="cuda")]
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    loss = dit(*args).float().square().mean()
    grads = torch.autograd.grad(loss, [p for m in lora.values() for p in m.parameters()])
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (4, 4, 4)
    assert all(bool(torch.isfinite(x).all()) for x in grads)


# ---- the grouped SwiGLU MoE kernels (ops/kernels/moe_gmm.py) ----

def _moe_inputs(gen, n_tok, d, h, e, dtype, k=2, empty=None):
    """Expert-sorted rows of a real top-k routing of random activations."""
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    x = torch.randn((1, n_tok, d), generator=gen, device="cuda")
    logits = torch.randn((1, n_tok, e), generator=gen, device="cuda")
    if empty is not None:
        logits[..., empty] = -30.0
    topv, topi = torch.topk(torch.softmax(logits, -1), k)
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).to(dtype)
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    return x.to(dtype), topv, topi, banks, moe_gmm


# max|out - ref| / max|ref| against the f32 plain version: bf16 rounds the
# SwiGLU activation (forward) and dh1/dh3 (dx) between the two GEMMs; f32 is
# summation order only
@pytest.mark.parametrize("n_tok,d,h,e,dtype,tol,empty", [
    (100, 64, 128, 3, torch.float32, 1e-4, None),
    (300, 256, 512, 4, torch.bfloat16, 2e-2, None),
    (300, 256, 512, 4, torch.bfloat16, 2e-2, 1),  # expert 1 gets no token
    (257, 192, 320, 2, torch.bfloat16, 2e-2, None),  # d, h not multiples of 128
])
def test_moe_kernels_match_plain(gen, n_tok, d, h, e, dtype, tol, empty):
    x, topv, topi, (w1, w3, w2), moe = _moe_inputs(gen, n_tok, d, h, e, dtype, empty=empty)
    before = (moe.launches, moe.dx_launches)
    xt = x.detach().requires_grad_()
    out = moe.moe_dispatch_swiglu(xt, topv, topi, w1, w3, w2)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    (dx,) = torch.autograd.grad(out, xt, g)
    torch.cuda.synchronize()
    assert (moe.launches, moe.dx_launches) == (before[0] + 1, before[1] + 1)
    # the same rows through the kernels' wrappers and their plain versions
    xs = torch.randn((4 * moe.BLOCK_M, d), generator=gen, device="cuda").to(dtype)
    dys = torch.randn(xs.shape, generator=gen, device="cuda").to(dtype)
    tg = torch.tensor([0, 0, e - 1, e - 1], dtype=torch.int32, device="cuda")
    for kern, plain in (
        (moe.grouped_swiglu(xs, w1, w3, w2, tg), moe.grouped_swiglu_plain(xs.float(), w1, w3, w2, tg,
                                                                          moe.BLOCK_M)),
        (moe.grouped_swiglu_dx(xs, dys, w1, w3, w2, tg, moe.BLOCK_M),
         moe.grouped_swiglu_dx_plain(xs.float(), dys.float(), w1, w3, w2, tg, moe.BLOCK_M)),
    ):
        assert kern.dtype == dtype and bool(torch.isfinite(kern).all())
        assert (kern.float() - plain).abs().max().item() <= tol * plain.abs().max().item()
    assert bool(torch.isfinite(dx).all())


def test_moe_kernels_are_deterministic(gen):
    x, topv, topi, (w1, w3, w2), moe = _moe_inputs(gen, 500, 256, 512, 4, torch.bfloat16)
    runs = []
    for _ in range(2):
        xt = x.detach().requires_grad_()
        out = moe.moe_dispatch_swiglu(xt, topv, topi, w1, w3, w2)
        runs.append((out, *torch.autograd.grad(out, xt, torch.ones_like(out))))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_moe_wrapper_raises_instead_of_falling_back(gen):
    x, topv, topi, (w1, w3, w2), moe = _moe_inputs(gen, 64, 128, 256, 2, torch.bfloat16)
    xs = torch.zeros((moe.BLOCK_M, 128), device="cuda", dtype=torch.bfloat16)
    tg = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        moe.grouped_swiglu(xs.half(), w1.half(), w3.half(), w2.half(), tg)
    with pytest.raises(ValueError):
        moe.grouped_swiglu(torch.zeros((64, 128), device="cuda", dtype=torch.bfloat16), w1, w3, w2,
                           torch.zeros(1, dtype=torch.int32, device="cuda"), 64)
    with pytest.raises(ValueError):
        moe.grouped_swiglu(xs, w1.cpu(), w3, w2, tg)
    # the bank gradient: dw or raise, no fallback
    dy = torch.zeros_like(xs)
    with pytest.raises(TypeError):
        moe.grouped_swiglu_dw(xs.half(), dy.half(), w1.half(), w3.half(), w2.half(), tg, moe.BLOCK_M)
    with pytest.raises(ValueError):  # N not a multiple of 128
        moe.grouped_swiglu_dw(xs[:64], dy[:64], w1, w3, w2, tg, 64)
    with pytest.raises(ValueError):
        moe.grouped_swiglu_dw(xs, dy, w1, w3, w2.cpu(), tg, moe.BLOCK_M)
    before = moe.dw_launches
    w1g = w1.detach().requires_grad_()
    moe.moe_dispatch_swiglu(x, topv, topi, w1g, w3, w2).float().sum().backward()
    assert moe.dw_launches == before + 1 and w1g.grad is not None


def _routed(gen, moe, n_tok, d, e, dtype, empty=None):
    """Expert-sorted rows (and their tile_group) of a top-2 routing."""
    x = torch.randn((n_tok, d), generator=gen, device="cuda").to(dtype)
    logits = torch.randn((n_tok, e), generator=gen, device="cuda")
    if empty is not None:
        logits[:, empty] = -30.0
    xs, tg, _ = moe.dispatch_rows(x, torch.topk(logits, 2).indices, e)
    return xs, tg


# max|dW - ref| / max|ref| per bank against the f32 plain version: bf16 rounds
# dh1/dh3 and the activation between the passes and the gradients on output;
# f32 is summation order only
@pytest.mark.parametrize("n_tok,d,h,e,dtype,tol,empty", [
    (100, 64, 128, 3, torch.float32, 1e-4, None),  # d not a multiple of the 128-row output tile
    (300, 256, 512, 4, torch.bfloat16, 2e-2, None),
    (300, 256, 512, 4, torch.bfloat16, 2e-2, 1),  # expert 1 owns no tile: zeros
    (257, 192, 320, 2, torch.bfloat16, 2e-2, None),  # ragged output rows and 64-wide column tiles
    (19000, 64, 128, 4, torch.bfloat16, 2e-2, None),  # 300+ row tiles: the run scan takes two rounds
])
def test_dw_kernel_matches_plain(gen, n_tok, d, h, e, dtype, tol, empty):
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

    xs, tg = _routed(gen, moe, n_tok, d, e, dtype, empty)
    dy = torch.randn(xs.shape, generator=gen, device="cuda").to(dtype)
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).to(dtype)
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    before = moe.dw_launches
    dws = moe.grouped_swiglu_dw(xs, dy, *banks, tg, moe.BLOCK_M)
    torch.cuda.synchronize()
    assert moe.dw_launches == before + 1
    refs = moe.grouped_swiglu_dw_plain(xs.float(), dy.float(), *(b.float() for b in banks), tg, moe.BLOCK_M)
    for name, got, ref in zip(("dw1", "dw3", "dw2"), dws, refs):
        assert got.dtype == dtype and got.shape == ref.shape and bool(torch.isfinite(got).all()), name
        assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item(), name
        if empty is not None:
            assert not got[empty].any(), name
    # the custom op's backward: dx and dw from one first pass, as the plain versions give them
    xt, bt = xs.detach().requires_grad_(), [b.detach().requires_grad_() for b in banks]
    grads = torch.autograd.grad(moe.grouped_swiglu(xt, *bt, tg), [xt, *bt], dy)
    ref_dx = moe.grouped_swiglu_dx_plain(xs.float(), dy.float(), *(b.float() for b in banks), tg, moe.BLOCK_M)
    for got, ref in zip(grads, (ref_dx, *refs)):
        assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_dw_kernel_is_deterministic(gen):
    """One owner per gradient tile and no atomics: equal bits from run to run."""
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

    xs, tg = _routed(gen, moe, 700, 256, 4, torch.bfloat16)
    dy = torch.randn(xs.shape, generator=gen, device="cuda").bfloat16()
    banks = [(torch.randn(s, generator=gen, device="cuda") * 0.05).bfloat16()
             for s in ((4, 256, 512), (4, 256, 512), (4, 512, 256))]
    first = moe.grouped_swiglu_dw(xs, dy, *banks, tg, moe.BLOCK_M)
    for a, b in zip(first, moe.grouped_swiglu_dw(xs, dy, *banks, tg, moe.BLOCK_M)):
        assert torch.equal(a, b)


# The bf16 dx kernel (the wgmma/TMA passes of csrc/moe_gmm_sm90.cuh) at the
# hidream shapes: dx, and the hidden pass's dh = [dh1 | dh3] and act (DW_HIDDEN,
# which dw reads) against the f32 plain versions within 2e-2 of max|ref| (bf16
# rounds dh between the passes), the same bits from run to run.
@pytest.mark.parametrize("n_tok,empty", [
    (4096, None),  # double block: 4096 image tokens x top-2
    (4352, None),  # single block: 256 text + 4096 image tokens
    (1000, 3),  # ragged, expert 3 gets no token
])
def test_moe_dx_kernel_matches_plain_at_hidream_shapes(gen, n_tok, empty):
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

    d, h, e = 2560, 6912, 4
    xs, tg = _routed(gen, moe, n_tok, d, e, torch.bfloat16, empty)
    dy = torch.randn(xs.shape, generator=gen, device="cuda").bfloat16()
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).bfloat16()
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    before = moe.dx_launches
    dx = moe.grouped_swiglu_dx(xs, dy, *banks, tg, moe.BLOCK_M)
    dh, act = moe.grouped_swiglu_hidden(xs, dy, *banks, tg, moe.BLOCK_M)
    again = (moe.grouped_swiglu_dx(xs, dy, *banks, tg, moe.BLOCK_M),
             *moe.grouped_swiglu_hidden(xs, dy, *banks, tg, moe.BLOCK_M))
    torch.cuda.synchronize()
    assert moe.dx_launches == before + 2
    refs = (moe.grouped_swiglu_dx_plain(xs.float(), dy.float(), *banks, tg, moe.BLOCK_M),
            *(r.float() for r in moe.grouped_swiglu_hidden_plain(xs.float(), dy.float(), *banks, tg,
                                                                 moe.BLOCK_M)))
    for name, got, ref, rerun in zip(("dx", "dh", "act"), (dx, dh, act), refs, again):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape and bool(torch.isfinite(got).all()), name
        assert (got.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item(), name
        assert torch.equal(got, rerun), name


# The bf16 forward (moe_hidden_sm90<GATE_UP> and moe_out_sm90<DOWN> on
# csrc/moe_gmm_sm90.cuh) at the hidream shapes and where d or h is not a
# multiple of 128 (the 64-wide variants), against the f32 plain version within
# 2e-2 of max|ref| (bf16 rounds act between the passes), the same bits from
# run to run.
@pytest.mark.parametrize("n_tok,d,h,empty", [
    (4096, 2560, 6912, None),  # double block: 4096 image tokens x top-2
    (4352, 2560, 6912, None),  # single block: 256 text + 4096 image tokens
    (1000, 2560, 6912, 3),  # ragged, expert 3 gets no token
    (500, 2560, 6848, 1),  # h % 128 == 64: 64-wide GATE_UP tiles
    (300, 192, 320, None),  # d and h % 128 == 64: both passes 64 wide
])
def test_moe_fwd_kernel_matches_plain_at_hidream_shapes(gen, n_tok, d, h, empty):
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

    e = 4
    xs, tg = _routed(gen, moe, n_tok, d, e, torch.bfloat16, empty)
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).bfloat16()
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    before = moe.launches
    y = moe.grouped_swiglu(xs, *banks, tg)
    again = moe.grouped_swiglu(xs, *banks, tg)
    torch.cuda.synchronize()
    assert moe.launches == before + 2
    ref = moe.grouped_swiglu_plain(xs.float(), *banks, tg, moe.BLOCK_M)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert (y.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()
    assert torch.equal(y, again)


# The bf16 dw products (moe_dw_sm90: both operands MN-major, A through the
# transpose bit) after the shared hidden pass, against the f32 plain version
# within 2e-2 of max|ref| per bank; an expert with no token gets zeros; the
# same bits from run to run.
@pytest.mark.parametrize("n_tok,d,h,empty", [
    (4096, 2560, 6912, None),  # double block
    (1000, 2560, 6912, 3),  # ragged, expert 3 gets no token
    (300, 192, 320, 1),  # ragged output rows (d, h % 128 == 64), 64-wide tiles, expert 1 empty
])
def test_moe_dw_products_match_plain_at_hidream_shapes(gen, n_tok, d, h, empty):
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe

    e = 4
    xs, tg = _routed(gen, moe, n_tok, d, e, torch.bfloat16, empty)
    dy = torch.randn(xs.shape, generator=gen, device="cuda").bfloat16()
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).bfloat16()
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    before = moe.dw_launches
    dws = moe.grouped_swiglu_dw(xs, dy, *banks, tg, moe.BLOCK_M)
    again = moe.grouped_swiglu_dw(xs, dy, *banks, tg, moe.BLOCK_M)
    torch.cuda.synchronize()
    assert moe.dw_launches == before + 2
    refs = moe.grouped_swiglu_dw_plain(xs.float(), dy.float(), *(b.float() for b in banks), tg, moe.BLOCK_M)
    for name, got, ref, rerun in zip(("dw1", "dw3", "dw2"), dws, refs, again):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape and bool(torch.isfinite(got).all()), name
        assert (got.float() - ref).abs().max().item() <= 2e-2 * ref.abs().max().item(), name
        assert torch.equal(got, rerun), name
        if empty is not None:
            assert not got[empty].any(), name


def test_checkpointed_moe_layer_with_trainable_banks_launches_dw_once(gen):
    """A hidream-style DiT (grouped MoE, dots_flash checkpointing) whose first
    double block trains its expert banks: one dw launch in the backward, no
    MoE dx for that layer (its input needs no gradient), and the second
    layer's dx."""
    import dataclasses

    from ai_toolkit_tpu_torch.jobs.train_process import select_trainable
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm as moe
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    cfg = dataclasses.replace(FluxConfig.tiny(), hidden_size=256, num_heads=2, head_dim=128,
                              axes_dim=(16, 56, 56), depth_double=1, depth_single=1, guidance_embed=False,
                              moe_experts=4, qk_norm_across_heads=True, moe_dispatch="grouped",
                              dtype=torch.bfloat16)
    dit = init_parameters(FluxDiT(cfg, device="cuda"), gen)
    trainable = select_trainable(dit, ["double_blocks.0.img_mlp.experts"], None)
    dit.gradient_checkpointing = True
    n_txt, hh, ww = 8, 4, 6
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None],
                         list(cfg.axes_dim), cfg.theta).cuda()
    args = [torch.randn((1, hh * ww, cfg.in_channels), generator=gen, device="cuda"),
            torch.randn((1, n_txt, cfg.context_dim), generator=gen, device="cuda"),
            torch.tensor([0.5], device="cuda"),
            torch.randn((1, cfg.vec_dim), generator=gen, device="cuda"), pe]
    moe.launches = moe.dx_launches = moe.dw_launches = 0
    loss = dit(*args).float().square().mean()
    grads = torch.autograd.grad(loss, list(trainable.values()))
    assert (moe.launches, moe.dx_launches, moe.dw_launches) == (4, 1, 1)
    assert all(bool(torch.isfinite(g).all()) and g.abs().max() > 0 for g in grads)


# The SDXL UNet's attention: head_dim 64, cross-attention over T = 77 text
# tokens (fewer than one 128-column K/V tile, so the kernels mask columns
# 77-127 themselves: zero fill is not a mask), in bf16 and f32. The forward
# out within 2e-2 of max|ref| (bf16) or 1e-4 (f32), lse within 1e-3; dq,
# dk and dv within 2e-2 (bf16) or 1e-4 (f32) of max|ref|. "negative" shifts
# q by +3.8 and k by -3.8, so the logits sit near -116 and the median lse
# below -88, where a zero-filled K row would give exp(-lse) = inf.
@pytest.mark.parametrize("shape,dtype,negative", [
    ((1, 1024, 77, 20, 64), torch.bfloat16, False),  # level-2 cross-attention
    ((2, 4096, 77, 10, 64), torch.bfloat16, False),  # level-1 cross-attention, CFG batch
    ((1, 1024, 1024, 20, 64), torch.bfloat16, False),  # level-2 self-attention
    ((2, 1024, 77, 20, 64), torch.bfloat16, True),
    ((2, 300, 77, 4, 64), torch.float32, False),
    ((2, 300, 77, 4, 64), torch.float32, True),
])
def test_kernels_at_sdxl_shapes_match_plain(gen, shape, dtype, negative):
    _match_plain_with_tails(gen, shape, dtype, 3.8 if negative else 0.0)


# the ragged tails of the Wan 2.2 shapes at fewer heads: the 257 ViT-H tokens
# (2 * 128 + 1, a K/V tail tile of one valid row), the TI2V-5B's 4,356 tokens
# (a 4-row Q tail) and a 16-row tail (its 121-frame 27,280); "negative" shifts
# q by +3.2 and k by -3.2 (logits near -116 at head_dim 128)
@pytest.mark.parametrize("shape,dtype,negative", [
    ((1, 8100, 257, 4, 128), torch.bfloat16, False),
    ((1, 8100, 257, 4, 128), torch.bfloat16, True),
    ((1, 4356, 4356, 2, 128), torch.bfloat16, True),
    ((1, 1040, 1040, 2, 128), torch.bfloat16, False),
    ((1, 300, 257, 4, 128), torch.float32, True),
])
def test_kernels_at_wan22_tails_match_plain(gen, shape, dtype, negative):
    _match_plain_with_tails(gen, shape, dtype, 3.2 if negative else 0.0)


def _match_plain_with_tails(gen, shape, dtype, shift):
    b, s, t, h, d = shape
    q, k, v = _qkv(gen, b, s, t, h, d, torch.float32)
    negative = shift != 0.0
    if negative:
        q, k = q + shift, k - shift
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out, lse = fa.flash_attention_fwd(q, k, v)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(x + 1 for x in before)
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float())
    if negative:
        assert ref_lse.median().item() < -88.0
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert (out.float() - ref_out).abs().max().item() <= tol * min(1.0, ref_out.abs().max().item())
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())
    for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
        assert x.dtype == dtype and x.shape == r.shape and bool(torch.isfinite(x).all()), name
        assert (x.float() - r).abs().max().item() <= tol * r.abs().max().item(), name


def test_sdxl_unet_on_the_card_matches_the_cpu(gen):
    """The SDXL UNet module (head_dim 64 at every level, the added condition)
    at a tiny depth in f32, on the card against the CPU: the forward, and
    one checkpointed LoRA step's loss and gradients; each attention launches
    the forward twice (forward and recompute), dq and dk/dv once."""
    import dataclasses

    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.unet import UNet2DCondition, UNetConfig, unet_lora_targets
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(UNetConfig.tiny(), block_out_channels=(64, 64, 128), transformer_layers=(0, 1, 1),
                              head_dim=64, cross_attention_dim=128, addition_time_embed_dim=32,
                              projection_class_embeddings_dim=64 + 6 * 32, remat=True)
    gpu = init_parameters(UNet2DCondition(cfg, device="cuda"), gen).requires_grad_(False)
    cpu = UNet2DCondition(cfg).requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    args = [torch.randn((2, 16, 16, 4), generator=g), torch.tensor([37, 811]),
            torch.randn((2, 77, 128), generator=g),
            {"time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]]).repeat(2, 1),
             "text_embeds": torch.randn((2, 64), generator=g)}]
    gpu_args = [{k: v.cuda() for k, v in a.items()} if isinstance(a, dict) else a.cuda() for a in args]
    blocks = 1 + 1 + 1 + 2 + 2  # down, down, mid, up, up
    before = fa.launches
    with torch.inference_mode():
        ref, out = cpu(*args), gpu(*gpu_args).cpu()
    assert fa.launches == before + 2 * blocks
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    spec = LoRASpec(rank=4, alpha=4.0, target_patterns=unet_lora_targets())
    lg, lc = build_lora(gpu, spec, gen), build_lora(cpu, spec, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in lg.values():
            m.b.normal_(0.0, 0.05, generator=gen)
    cpu.load_state_dict(gpu.state_dict())
    names = [(n, leaf) for n in lg for leaf in ("a", "b", "scale")]
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    results = []
    for model, lora, inputs in ((gpu, lg, gpu_args), (cpu, lc, args)):
        loss = model(*inputs).float().square().mean()
        results.append((loss.item(), torch.autograd.grad(loss, [getattr(lora[n], leaf) for n, leaf in names])))
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (before[0] + 4 * blocks, before[1] + 2 * blocks,
                                                              before[2] + 2 * blocks)
    (loss, grads), (ref_loss, ref_grads) = results
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    for (name, leaf), x, r in zip(names, grads, ref_grads):
        assert (x.cpu() - r).abs().max().item() <= 1e-3 * r.abs().max().item(), f"{name}.{leaf}"
