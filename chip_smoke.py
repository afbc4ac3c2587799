#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py [--profile DIR]``.

Phases (any failure raises and the script exits non-zero):
  1. environment: versions, card name and power limit, TF32 off, the five
     kernel libraries built in parallel (one nvcc each), the registers and
     spills of the wgmma kernels (flash forward, dk/dv, dq; the two MoE dx
     passes) from ``-Xptxas -v``;
  2. the flash forward kernel against its plain version at the shapes the
     paths give it (ragged, S != T, smaller than a tile, D 64 and 128, the
     fused-projection views, a view TMA cannot read, which is copied), timed
     against it and against the library yardstick at the flux 1024^2, the
     ragged 1008^2 and the hidream 1024^2 shapes;
  3. the flash backward kernels (dq, dk/dv) the same way, with a case of
     strongly negative logits (an unmasked K/V tail would make dq NaN), their
     bits checked from run to run;
  4. the grouped SwiGLU MoE kernels (forward, dx and its hidden pass, the
     bank gradients dw) the same way, at the hidream shapes with a real top-2
     routing, dx and the hidden pass's dh and act bits checked from run to
     run;
  5. full-width, reduced-depth flux and hidream DiTs on the card against the
     same modules on the CPU: the forward, one LoRA training step's loss and
     gradients, and (hidream) one full fine-tune step of the first block's
     expert banks;
  6. the flux-dev LoRA ``sd_trainer`` job at 1024^2 through
     ``ai_toolkit_tpu_torch.jobs``, with the launches of every kernel per step
     checked, and no flash input copied for TMA, as in every job phase
     (``--profile DIR`` adds a ``torch.profiler`` split of its last step,
     written to DIR);
  7. the flux-dev ``generate`` job at 1024x1024, 8 steps, 2 prompts, loading
     the LoRA the train job saved, launch count checked;
  8. a ragged resolution (1008x1008, 4481 tokens), 1 prompt, 2 steps;
  9. the main path of this slice: the hidream LoRA ``sd_trainer`` job at
     1024^2 on an fp8 base with the grouped MoE dispatch, launches per step
     checked (``--profile DIR`` profiles its last step too);
  10. the hidream ``generate`` job at 1024x1024, 8 steps, 2 prompts, with
     the LoRA it saved;
  11. the main path of this slice: the hidream full fine-tune ``sd_trainer``
     job (bf16 base, grouped MoE, the expert banks of the first double and
     single block trained), launches per step checked, the untrained weights
     held against a fresh seeded init and the save reloaded.
The line before the last is the kernel table; the last line is the result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# (B, S, T, H, D), dtype, out tolerance vs the f32 plain version, a fraction of
# max|ref| and never more than that absolute: at T ~ 4600 a typical |out| of
# random inputs is ~0.02 (sqrt(e/T)), so an absolute 2e-2 would pass a wrong
# P.V half; lse (QK^T and the softmax) is held to LSE_TOL absolute
FLASH_CASES = [
    ((1, 4608, 4608, 24, 128), torch.bfloat16, 2e-2),  # flux-dev 1024^2: 512 text + 4096 image
    ((1, 4481, 4481, 24, 128), torch.bfloat16, 2e-2),  # 1008^2: ragged tails
    ((1, 4352, 4352, 20, 128), torch.bfloat16, 2e-2),  # hidream 1024^2: 256 text + 4096 image
    ((2, 300, 190, 4, 64), torch.bfloat16, 2e-2),  # S != T, both ragged, D=64
    ((2, 190, 300, 4, 128), torch.bfloat16, 2e-2),  # S < T
    ((1, 16, 16, 2, 128), torch.bfloat16, 2e-2),  # smaller than one tile
    ((1, 16, 16, 2, 64), torch.bfloat16, 2e-2),
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),  # rect, ragged, D=64
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),  # smaller than one tile
]
LSE_TOL = 1e-3
MAIN_SHAPE = (1, 4608, 24, 128)
RAGGED_SHAPE = (1, 4481, 24, 128)  # flux-dev at 1008^2: 512 text + 3969 image tokens, masked tails
HIDREAM_SHAPE = (1, 4352, 20, 128)  # hidream at 1024^2: 256 text + 4096 image tokens
TIMED_SHAPES = [("main", MAIN_SHAPE), ("ragged", RAGGED_SHAPE), ("hidream", HIDREAM_SHAPE)]
# the kernels redesigned for Hopper (wgmma, TMA): their compiler reports are printed
SM90_KERNELS = ("flash_fwd_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90", "moe_dx_hidden_sm90",
                "moe_dx_out_sm90")
SM90_LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd", "moe_gmm_bwd")
BLOCKS_PER_FORWARD = 19 + 38  # flux-dev double + single blocks, one attention each
# backward: (B, S, T, H, D), dtype, tolerance on max|dX - ref| / max|ref| for dq, dk, dv:
# bf16 inputs with p and ds rounded to bf16 before the second products (f32
# accumulation) leave ~4e-3; f32 differs from the f32 plain version by summation order only
BWD_CASES = [
    ((1, 4608, 4608, 24, 128), torch.bfloat16, 2e-2),
    ((1, 4481, 4481, 24, 128), torch.bfloat16, 2e-2),
    ((1, 4352, 4352, 20, 128), torch.bfloat16, 2e-2),  # hidream
    ((2, 300, 190, 4, 64), torch.bfloat16, 2e-2),
    ((2, 190, 300, 4, 128), torch.bfloat16, 2e-2),
    ((1, 16, 16, 2, 128), torch.bfloat16, 2e-2),
    ((1, 16, 16, 2, 64), torch.bfloat16, 2e-2),
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),
]
# logits near -116 (q shifted by +SHIFT, k by -SHIFT), so lse ~ -106: dq's p of a
# zero-filled K row past T would be exp(-lse) = inf, a NaN unless masked (T = 190 ragged)
NEGATIVE_CASE = ((2, 300, 190, 4, 128), 3.2)
# q, k, v as views of a fused projection [B, S, 3*H*D + extra] from element
# `start` on: ((B, S, H, D), extra, start, bf16 inputs TMA must copy)
FUSED_VIEWS = [
    ((2, 200, 4, 128), 0, 0, 0),  # the double blocks' fused qkv
    ((1, 1100, 24, 128), 4 * 3072, 0, 0),  # the single blocks' linear1 output
    ((2, 200, 4, 64), 1, 1, 3),  # no TMA view: q, k, v copied
]
# grouped SwiGLU: (tokens, d, h, experts), dtype, tolerance on max|out - ref| / max|ref|
# for the forward and dx against the f32 plain version, the expert that gets no
# token (or None); a real top-2 routing of random activations. bf16 rounds the
# SwiGLU activation (forward) and dh1/dh3 (dx) to bf16 between the two GEMMs
# (f32 accumulation); f32 differs from the plain version by summation order only
MOE_CASES = [
    ((4096, 2560, 6912, 4), torch.bfloat16, 2e-2, None),  # double block: 4096 image tokens x top-2
    ((4352, 2560, 6912, 4), torch.bfloat16, 2e-2, None),  # single block: 256 text + 4096 image
    ((1000, 2560, 6912, 4), torch.bfloat16, 2e-2, 3),  # ragged, expert 3 gets no token
    ((100, 64, 128, 3), torch.float32, 1e-4, None),
]
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "moe_gmm_fwd", "moe_gmm_bwd", "moe_gmm_dw")
HIDREAM_BLOCKS = 16 + 32  # double + single blocks: one attention and one MoE FFN each
# the full fine-tune's filter: the expert banks of the first double and single block
FT_BANKS = ["double_blocks.0.img_mlp.experts", "single_blocks.0.mlp.experts"]
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TRAIN_WARMUP = 2
TRAIN_TIMED = 3


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def environment() -> str:
    phase("environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ai_toolkit_tpu_torch.ops.kernels import build

    cached = {name: build.library_path(name).is_file() for name in KERNELS}
    t0 = time.perf_counter()
    times = build.build_all(list(KERNELS), verbose=True)
    for name in KERNELS:
        print(f"kernel build: {name} {times[name]:.2f} s"
              f"{' (library already built from these sources)' if cached[name] else ''}")
    print(f"kernel builds in parallel: {time.perf_counter() - t0:.2f} s wall")
    for name in SM90_LIBRARIES:
        report = build.report(name)
        if report is None:
            print(f"ptxas -v: {name}: no report kept beside the library (built without one)")
        for line in _ptxas_summary(report or ""):
            print(f"ptxas -v: {line}")
    return smi.splitlines()[0]


def _ptxas_summary(report: str) -> list[str]:
    """Registers, shared memory and spills of the wgmma kernels (SM90_KERNELS)
    from a ``-Xptxas -v`` report, one line per instantiation."""
    out, kernel = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in SM90_KERNELS if k in line), None)
            if kernel is not None:  # the template arguments: D, or (mode, tile width)
                args = re.findall(r"Li(\d+)E", line.split(kernel, 1)[1])
                out.append(f"{kernel}<{', '.join(args) or '?'}>:")
        elif kernel is not None and ("registers" in line or "spill" in line):
            out[-1] += " " + line.split(":", 1)[-1].strip().rstrip(",") + ";"
    return out


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _time_ms(fn, reps: int, inner: int = 10) -> list[float]:
    """``reps`` samples of the device time of one call of ``fn``: CUDA events
    around ``inner`` calls back to back, divided by ``inner``, so that the
    host's time to launch a call hides behind the device's work on the
    previous one (a sub-millisecond kernel timed alone also times its launch)."""
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / inner)
    return out


def _in_turns(kern, plain, reps: int = 10) -> tuple[float, float, int]:
    """Medians (kernel ms, plain ms) over plain, kernel, kernel, plain runs of
    ``reps`` samples each, after a warm-up of each; the plain versions (10 ms
    and more a call) are timed one call a sample."""
    for f in (kern, plain):
        _time_ms(f, 2, 1)
    p = _time_ms(plain, reps, 1)
    kt = _time_ms(kern, reps)
    kt += _time_ms(kern, reps)
    p += _time_ms(plain, reps, 1)
    return statistics.median(kt), statistics.median(p), len(kt)


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card: the larger of the bf16 tensor-core time and the
    HBM time; and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_layout(*xs):
    """[B,S,H,D] -> contiguous [B,H,S,D] copies for scaled_dot_product_attention."""
    return [x.transpose(1, 2).contiguous() for x in xs]


def _sdpa_bwd_ms(q, k, v, g) -> float:
    """The library yardstick of the backward kernels: one scaled_dot_product_attention
    backward, which gives dq, dk and dv."""
    qt, kt, vt, gt = _sdpa_layout(q, k, v, g)
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    return statistics.median(_time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True), 20))


def _fused_qkv(b, s, h, d, extra, start, gen):
    """q, k, v as views of one fused bf16 projection ``[B, S, 3*H*D + extra]``."""
    fused = _rand((b, s, 3 * h * d + extra), torch.bfloat16, gen)
    return fused[..., start:start + 3 * h * d].unflatten(-1, (3, h, d)).unbind(2)


def kernel_vs_plain() -> dict:
    phase("flash_attention_fwd kernel vs plain version")
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(0)
    max_err = 0.0
    cases = [(shape, dt, tol, None, 0) for shape, dt, tol in FLASH_CASES]
    for (b, s, h, d), extra, start, copies in FUSED_VIEWS:
        cases.append(((b, s, s, h, d), torch.bfloat16, 2e-2, _fused_qkv(b, s, h, d, extra, start, gen), copies))
    for (b, s, t, h, d), dt, tol, qkv, copies in cases:
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), dt, gen), _rand((b, t, h, d), dt, gen), _rand((b, t, h, d), dt, gen))
        before = fa.tma_copies
        out, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref_out).abs().max().item()
        ref_max = ref_out.abs().max().item()
        out_tol = tol * min(1.0, ref_max)
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        print(f"(B,S,T,H,D)=({b},{s},{t},{h},{d}) {str(dt)[6:]} v_stride={tuple(v.stride())} "
              f"out_err={err:.3e} (max|ref| {ref_max:.3e}, tol {out_tol:.3e}) lse_err={lse_err:.3e} "
              f"(tol {LSE_TOL:g}) TMA copies {fa.tma_copies - before}")
        check(finite and err <= out_tol and lse_err <= LSE_TOL, "kernel disagrees with its plain version")
        check(fa.tma_copies - before == copies, f"{fa.tma_copies - before} TMA copies, expected {copies}")
        max_err = max(max_err, err)

    res = {}
    for label, shape in TIMED_SHAPES:
        q, k, v = (_rand(shape, torch.bfloat16, gen) for _ in range(3))
        ms, plain_ms, n = _in_turns(lambda: fa.flash_attention_fwd(q, k, v),
                                    lambda: fa.flash_attention_fwd_plain(q, k, v))
        qt, kt, vt = _sdpa_layout(q, k, v)
        library_ms = statistics.median(_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20))
        b, s, h, d = shape
        flops = 4 * b * s * s * h * d  # two products; q, k, v in and out out in bf16, lse in f32
        bound, by = _bound_ms(flops, 2 * 4 * b * s * h * d + 4 * b * h * s)
        print(f"{label} shape {shape} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms, median of {n}; library scaled_dot_product_attention "
              f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s); kernel / library "
              f"{ms / library_ms:.2f}x; bound {bound:.4f} ms ({by})")
        res[label] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound, "bound_by": by}
        del q, k, v, qt, kt, vt
    return res["main"]


def bwd_kernels_vs_plain() -> dict:
    phase("flash_attention_bwd dq and dk/dv kernels vs plain versions")
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1)
    cases = [(shape, dt, tol, None, 0) for shape, dt, tol in BWD_CASES]
    (b, s, t, h, d), shift = NEGATIVE_CASE
    qkv = [torch.randn((b, n, h, d), generator=gen, device="cuda") for n in (s, t, t)]
    cases.append(((b, s, t, h, d), torch.bfloat16, 2e-2,
                  ((qkv[0] + shift).bfloat16(), (qkv[1] - shift).bfloat16(), qkv[2].bfloat16()), 0))
    for (b, s, h, d), extra, start, copies in FUSED_VIEWS:
        cases.append(((b, s, s, h, d), torch.bfloat16, 2e-2, _fused_qkv(b, s, h, d, extra, start, gen), copies))
    err = {"dq": 0.0, "dkv": 0.0}
    for (b, s, t, h, d), dt, tol, qkv, copies in cases:
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), dt, gen), _rand((b, t, h, d), dt, gen), _rand((b, t, h, d), dt, gen))
        g = _rand((b, s, h, d), dt, gen)
        out, lse = fa.flash_attention_fwd(q, k, v)
        before = fa.tma_copies
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())
        rel, absd = [], []
        for x, r in zip((dq, dk, dv), refs):
            a = (x.float() - r).abs().max().item()
            absd.append(a)
            rel.append(a / r.abs().max().item())
        finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
        print(f"(B,S,T,H,D)=({b},{s},{t},{h},{d}) {str(dt)[6:]} q_stride={tuple(q.stride())} "
              f"rel err dq/dk/dv = {rel[0]:.3e}/{rel[1]:.3e}/{rel[2]:.3e} (tol {tol:g}); "
              f"max abs {absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e}; min lse {lse.min().item():.1f}; "
              f"TMA copies {fa.tma_copies - before}")
        check(finite and max(rel) <= tol, "backward kernels disagree with their plain versions")
        # dq and dk/dv each copy the q, k, v that TMA cannot read (dO is contiguous)
        check(fa.tma_copies - before == 2 * copies, f"{fa.tma_copies - before} TMA copies, expected {2 * copies}")
        err["dq"] = max(err["dq"], absd[0])
        err["dkv"] = max(err["dkv"], absd[1], absd[2])
        del refs
        torch.cuda.empty_cache()

    res = {}
    for label, shape in TIMED_SHAPES:
        b, s, h, d = shape
        q, k, v, g = (_rand(shape, torch.bfloat16, gen) for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.flash_attention_bwd_delta(out, g)
        if label == "main":  # one owner per tile, no atomics: the same bits from run to run
            runs = [(fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
                     *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)) for _ in range(2)]
            check(all(torch.equal(x, y) for x, y in zip(*runs)), "dq or dk/dv differs from run to run")
            print("main shape: dq, dk and dv the same bits in two runs")
            del runs
        lib_bwd = _sdpa_bwd_ms(q, k, v, g)
        for name, kern, plain, ops, tensors in (  # operations per B*H*S*T*D; [B,S,H,D] tensors in and out
            ("dq", lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
             lambda: fa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale), 6, 5),  # q k v dO in, dq out
            ("dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale),
             lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale), 8, 6),  # dk dv out
        ):
            ms, plain_ms, n = _in_turns(kern, plain)
            flops = ops * b * h * s * s * d
            bound, by = _bound_ms(flops, 2 * tensors * b * s * h * d + 8 * b * h * s)
            print(f"{label} shape {shape} bf16 {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{ops}*B*H*S*T*D = {flops:.4e} operations), plain {plain_ms:.4f} ms, median of {n}; "
                  f"kernel / library backward ({10 * b * h * s * s * d:.4e} operations) "
                  f"{ms / lib_bwd:.2f}x; bound {bound:.4f} ms ({by}; the kernel at {100 * bound / ms:.1f} % "
                  f"of its rate)")
            if label == "main":
                res[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                             "bound_by": by, "library_ms": lib_bwd}
        flops = 10 * b * h * s * s * d
        print(f"{label} shape: library scaled_dot_product_attention backward (dq, dk, dv) {lib_bwd:.4f} ms "
              f"({flops / lib_bwd / 1e9:.1f} TFLOP/s of 10*B*H*S*T*D = {flops:.4e} operations; bound "
              f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms)")
        if label == "main":
            qt, kt, vt, gt = _sdpa_layout(q, k, v, g)
            qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
            lib_fb = statistics.median(_time_ms(lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), gt), 20))
            print(f"main shape: library forward+backward {lib_fb:.4f} ms; kernels dq+dkv "
                  f"{res['dq']['ms'] + res['dkv']['ms']:.4f} ms")
            del qt, kt, vt, gt
        del q, k, v, g, out, lse, delta
        torch.cuda.empty_cache()
    return res


def _routed_rows(n_tok, d, e, dtype, gen, empty=None):
    """Expert-sorted rows of a top-2 routing of random activations, as the
    MoE FFN's dispatch builds them: (x_sorted, tile_group, routed row count)."""
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    x = _rand((n_tok, d), dtype, gen)
    logits = torch.randn((n_tok, e), generator=gen, device="cuda")
    if empty is not None:
        logits[:, empty] = -30.0
    _, topi = torch.topk(torch.softmax(logits, -1), 2)
    x_sorted, tile_group, _ = moe_gmm.dispatch_rows(x, topi, e)
    return x_sorted, tile_group, topi.numel()


def moe_kernels_vs_plain() -> dict:
    phase("moe_gmm forward, dx and dw kernels vs plain versions")
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    gen = torch.Generator("cuda").manual_seed(2)
    err = {"moe": 0.0, "moe_dx": 0.0, "moe_dw": 0.0}
    for (n_tok, d, h, e), dt, tol, empty in MOE_CASES:
        banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).to(dt)
                 for s in ((e, d, h), (e, d, h), (e, h, d))]
        xs, tg, n = _routed_rows(n_tok, d, e, dt, gen, empty)
        dy = _rand(xs.shape, dt, gen)
        y = moe_gmm.grouped_swiglu(xs, *banks, tg)
        dx = moe_gmm.grouped_swiglu_dx(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        torch.cuda.synchronize()
        rel, absd = [], []
        for name, out, ref in (
                ("moe", y, moe_gmm.grouped_swiglu_plain(xs.float(), *banks, tg, moe_gmm.BLOCK_M)),
                ("moe_dx", dx, moe_gmm.grouped_swiglu_dx_plain(xs.float(), dy.float(), *banks, tg,
                                                              moe_gmm.BLOCK_M))):
            check(out.dtype == dt and bool(torch.isfinite(out).all()), f"{name} output not finite")
            a = (out.float() - ref).abs().max().item()
            absd.append(a)
            rel.append(a / ref.abs().max().item())
            err[name] = max(err[name], a)
        groups = torch.bincount(tg.long(), minlength=e).tolist()
        print(f"(tokens,d,h,E)=({n_tok},{d},{h},{e}) {str(dt)[6:]} routed rows {n} -> {xs.shape[0]} "
              f"(tiles per expert {groups}) rel err fwd/dx = {rel[0]:.3e}/{rel[1]:.3e} (tol {tol:g}); "
              f"max abs {absd[0]:.3e}/{absd[1]:.3e}")
        check(max(rel) <= tol, "the MoE kernels disagree with their plain versions")
        # the hidden pass dw shares (DW_HIDDEN): dh = [dh1 | dh3] and act against the plain
        # intermediates; dx, dh and act the same bits from run to run (one owner per tile)
        dh, act = moe_gmm.grouped_swiglu_hidden(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        again = (moe_gmm.grouped_swiglu_dx(xs, dy, *banks, tg, moe_gmm.BLOCK_M),
                 *moe_gmm.grouped_swiglu_hidden(xs, dy, *banks, tg, moe_gmm.BLOCK_M))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((dx, dh, act), again)), "MoE dx, dh or act differs "
                                                                            "from run to run")
        rel_h = []
        for name, got, ref in zip(("dh", "act"), (dh, act), moe_gmm.grouped_swiglu_hidden_plain(
                xs.float(), dy.float(), *banks, tg, moe_gmm.BLOCK_M)):
            check(got.dtype == dt and bool(torch.isfinite(got).all()), f"{name} not finite")
            rel_h.append((got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item())
        print(f"  hidden pass (DW_HIDDEN) rel err dh/act = {rel_h[0]:.3e}/{rel_h[1]:.3e} (tol {tol:g}); "
              f"dx, dh and act the same bits in two runs")
        check(max(rel_h) <= tol, "the hidden pass disagrees with its plain version")
        del y, dx, dh, act, again
        # the bank gradients, each against the f32 plain version (f32 banks: an f32 result)
        dws = moe_gmm.grouped_swiglu_dw(xs, dy, *banks, tg, moe_gmm.BLOCK_M)
        torch.cuda.synchronize()
        refs = moe_gmm.grouped_swiglu_dw_plain(xs.float(), dy.float(), *(b.float() for b in banks), tg,
                                               moe_gmm.BLOCK_M)
        rel_dw = []
        for name, got, ref in zip(("dw1", "dw3", "dw2"), dws, refs):
            check(got.dtype == dt and got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"{name} not finite or of the wrong type")
            a = (got.float() - ref).abs().max().item()
            rel_dw.append(a / ref.abs().max().item())
            err["moe_dw"] = max(err["moe_dw"], a)
            check(empty is None or not got[empty].any(), f"{name} of the empty expert is not zero")
        print(f"  dw rel err dw1/dw3/dw2 = {rel_dw[0]:.3e}/{rel_dw[1]:.3e}/{rel_dw[2]:.3e} (tol {tol:g})"
              f"{'; the empty expert gets zeros' if empty is not None else ''}")
        check(max(rel_dw) <= tol, "the dw kernel disagrees with its plain version")
        del banks, xs, dy, dws, refs
        torch.cuda.empty_cache()

    # timing at the double-block shape
    (n_tok, d, h, e), dt = MOE_CASES[0][:2]
    banks = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5).to(dt)
             for s in ((e, d, h), (e, d, h), (e, h, d))]
    w1, w3, w2 = banks
    xs, tg, n = _routed_rows(n_tok, d, e, dt, gen)
    dy = _rand(xs.shape, dt, gen)
    # the library yardstick: one cuBLAS product sequence per expert over the
    # same sorted rows (its padding rows included), its autograd for dx
    runs = [(g, r0, r1) for g, r0, r1 in moe_gmm.expert_runs(tg, moe_gmm.BLOCK_M)]
    xr = xs.detach().requires_grad_()
    parts = [xr[r0:r1] for _, r0, r1 in runs]

    def library():
        return [(F.silu(xp @ w1[g]) * (xp @ w3[g])) @ w2[g] for xp, (g, _, _) in zip(parts, runs)]

    @torch.no_grad()
    def library_fwd():
        return library()

    lib_out = library()
    # the weight-gradient yardstick: the same product sequence's autograd for W1, W3 and W2
    wr = [w.detach().requires_grad_() for w in banks]
    lib_out_w = [(F.silu(xs[r0:r1] @ wr[0][g]) * (xs[r0:r1] @ wr[1][g])) @ wr[2][g] for g, r0, r1 in runs]
    res = {}
    for name, kern, plain, lib, flops, nbytes in (
        ("moe", lambda: moe_gmm.grouped_swiglu(xs, w1, w3, w2, tg),
         lambda: moe_gmm.grouped_swiglu_plain(xs, w1, w3, w2, tg, moe_gmm.BLOCK_M), library_fwd,
         6 * n * d * h, 2 * (3 * e * d * h + 2 * n * d)),  # banks, x in, y out
        ("moe_dx", lambda: moe_gmm.grouped_swiglu_dx(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: moe_gmm.grouped_swiglu_dx_plain(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: torch.autograd.grad(lib_out, xr, [dy[r0:r1] for _, r0, r1 in runs], retain_graph=True),
         10 * n * d * h, 2 * (3 * e * d * h + 3 * n * d)),  # banks, x and dy in, dx out
        # the hidden pass alone (DW_HIDDEN: h1, h3, dp, then dh and act), dw's share of dx's first pass
        ("moe_hidden", lambda: moe_gmm.grouped_swiglu_hidden(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: moe_gmm.grouped_swiglu_hidden_plain(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M), None,
         6 * n * d * h, 2 * (3 * e * d * h + 2 * n * d + 3 * n * h)),  # banks, x, dy in; dh, act out
        # dw from x and dy: its first pass (h1, h3, dp) and the products, 12 N d h
        ("moe_dw", lambda: moe_gmm.grouped_swiglu_dw(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: moe_gmm.grouped_swiglu_dw_plain(xs, dy, w1, w3, w2, tg, moe_gmm.BLOCK_M),
         lambda: torch.autograd.grad(lib_out_w, wr, [dy[r0:r1] for _, r0, r1 in runs], retain_graph=True),
         12 * n * d * h, 2 * (6 * e * d * h + 2 * n * d)),  # banks, x and dy in, dW1 dW3 dW2 out
    ):
        ms, plain_ms, reps = _in_turns(kern, plain)
        library_ms = statistics.median(_time_ms(lib, 20)) if lib else None
        bound, by = _bound_ms(flops, nbytes)
        res[name] = {"max_abs_err": err.get(name), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound, "bound_by": by}
        # what the library call computes: the forward's 6 N d h; its autograd keeps h1 and h3
        # (no recompute): 6 N d h for x, 8 N d h for W1, W3 and W2
        lib_ops = {"moe": (6, ""), "moe_dx": (6, ", h1 and h3 saved"), "moe_dw": (8, ", h1 and h3 saved")}
        library = (f"library per-expert cuBLAS {library_ms:.4f} ms ({lib_ops[name][0]}*N*d*h = "
                   f"{lib_ops[name][0] * n * d * h:.4e} operations{lib_ops[name][1]})" if lib else
                   "no library call computes it alone")
        print(f"double-block shape ({n_tok} tokens x top-2 = {n} rows, d {d}, h {h}, E {e}) bf16 {name}: "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of {flops:.4e} operations), plain "
              f"{plain_ms:.4f} ms, median of {reps}; {library}; bound {bound:.4f} ms ({by}; the kernel at "
              f"{100 * bound / ms:.1f} % of its rate)")
    # the dw products alone, as the backward runs them beside dx on the first pass's dh and act
    dh, act = _rand((xs.shape[0], 2 * h), dt, gen), _rand((xs.shape[0], h), dt, gen)
    prod_ms = statistics.median(_time_ms(lambda: moe_gmm._launch_dw_products(xs, dy, dh, act, tg, e), 20))
    prod_bound, prod_by = _bound_ms(6 * n * d * h, 2 * (2 * n * d + 3 * n * h + 3 * e * d * h))
    print(f"dw products alone ([dW1 | dW3] = x^T dh, dW2 = act^T dy on a given dh and act): "
          f"{prod_ms:.4f} ms ({6 * n * d * h / prod_ms / 1e9:.1f} TFLOP/s), bound {prod_bound:.4f} ms "
          f"({prod_by})")
    del dh, act, wr, lib_out_w
    xt = _rand((n_tok, d), dt, gen)
    dense_ms = statistics.median(_time_ms(lambda: torch.einsum(
        "esh,ehd->esd", F.silu(torch.einsum("sd,edh->esh", xt, w1)) * torch.einsum("sd,edh->esh", xt, w3),
        w2), 10))
    print(f"for information: the dense dispatch (every expert on all {n_tok} tokens, cuBLAS) "
          f"{dense_ms:.4f} ms")
    del banks, w1, w3, w2, xs, dy, xr, parts, lib_out
    torch.cuda.empty_cache()
    return res


def _reset_launches() -> None:
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
    moe_gmm.launches = moe_gmm.dx_launches = moe_gmm.dw_launches = 0


def _launches() -> dict[str, int]:
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
    from ai_toolkit_tpu_torch.ops.kernels import moe_gmm

    return {"fwd": fa.launches, "dq": fa.dq_launches, "dkv": fa.dkv_launches,
            "moe": moe_gmm.launches, "moe_dx": moe_gmm.dx_launches, "moe_dw": moe_gmm.dw_launches}


def _check_no_tma_copies(what: str) -> None:
    """The job paths hand the flash kernels views TMA reads as they are."""
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    print(f"TMA copies in {what}: {fa.tma_copies}")
    check(fa.tma_copies == 0, f"{what} copied {fa.tma_copies} flash inputs for TMA")


def _counts(fwd=0, dq=0, dkv=0, moe=0, moe_dx=0, moe_dw=0) -> dict[str, int]:
    return {"fwd": fwd, "dq": dq, "dkv": dkv, "moe": moe, "moe_dx": moe_dx, "moe_dw": moe_dw}


def dit_reference(label: str, cfg, targets: list[str], fwd_launches: dict, step_launches: dict,
                  ft_launches: dict | None = None) -> None:
    """A full-width DiT cut to 1 double + 1 single block in f32, on the card
    against the same module on the CPU (which takes the kernels' plain
    versions): the forward, one LoRA training step's loss and gradients and,
    with ``ft_launches``, one full fine-tune step of the double block's expert
    banks (the dw kernel)."""
    phase(f"full-width {label} DiT (1 double + 1 single block, f32): card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.flux_dit import FluxDiT
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    cfg = dataclasses.replace(cfg, depth_double=1, depth_single=1, dtype=torch.float32)
    # a frozen base, as in LoRA training
    gpu = init_parameters(FluxDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    gpu.eval().requires_grad_(False)
    cpu = FluxDiT(cfg, device="cpu").eval().requires_grad_(False)
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    n_txt, hh, ww = 32, 8, 12
    inputs = [torch.randn((1, hh * ww, cfg.in_channels), generator=g),
              torch.randn((1, n_txt, cfg.context_dim), generator=g),
              torch.tensor([0.7]), torch.randn((1, cfg.vec_dim), generator=g)]
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None],
                         list(cfg.axes_dim), cfg.theta)
    guidance = torch.tensor([4.0])
    gpu_in = [*(x.cuda() for x in inputs), pe.cuda(), guidance.cuda()]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs, pe, guidance)
        out = gpu(*gpu_in).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"forward: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) kernel launches={_launches()}")
    check(_launches() == fwd_launches and bool(torch.isfinite(out).all())
          and err <= tol, "DiT on the card disagrees with the CPU")

    # one LoRA training step's loss and gradients; b is made non-zero, else the
    # gradient of a is zero and the check proves nothing about it
    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=targets)
    lg = build_lora(gpu, spec, torch.Generator("cuda").manual_seed(2))
    gb = torch.Generator("cuda").manual_seed(3)
    with torch.no_grad():
        for m in lg.values():
            m.b.normal_(0.0, 0.01, generator=gb)
    lc = build_lora(cpu, spec, torch.Generator().manual_seed(2))
    cpu.load_state_dict(gpu.state_dict())
    gpu.gradient_checkpointing = True  # the dots_flash policy, as in training
    target = torch.randn(out.shape, generator=g)
    names = [f"{n}.{leaf}" for n in lg for leaf in ("a", "b", "scale")]

    def loss_and_grads(model, params, args, tgt):
        loss = (model(*args).float() - tgt).square().mean()
        return loss.item(), torch.autograd.grad(loss, params)

    def compare(what, gpu_params, cpu_params, expected):
        _reset_launches()
        ref_loss, ref_grads = loss_and_grads(cpu, cpu_params, [*inputs, pe, guidance], target)
        loss, grads = loss_and_grads(gpu, gpu_params, gpu_in, target.cuda())
        launches = _launches()
        worst = max(((gd.cpu() - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item()
                    for gd, gr in zip(grads, ref_grads))
        # f32 both sides, TF32 off: summation order and the kernels' FMA order only
        print(f"{what}: loss card {loss:.6f} vs CPU {ref_loss:.6f}; {len(grads)} tensors, "
              f"worst max|dgrad|/max|grad| {worst:.3e} (tol 1e-3); kernel launches={launches}")
        check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3
              and launches == expected, f"{what} on the card disagrees")

    def lora_params(lora):
        return [getattr(lora[n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1]) for n in names]

    compare("LoRA train step", lora_params(lg), lora_params(lc), step_launches)
    if ft_launches is not None:
        from ai_toolkit_tpu_torch.jobs.train_process import select_trainable

        # the LoRA overlays stay (equal on both sides) and freeze with the rest
        banks = ["double_blocks.0.img_mlp.experts"]
        gpu_banks, cpu_banks = (list(select_trainable(m, banks, None).values()) for m in (gpu, cpu))
        compare("full fine-tune step of the double block's expert banks", gpu_banks, cpu_banks,
                ft_launches)


def _train_dataset(n: int = 4, size: int = 1024) -> str:
    """A handful of seeded 1024^2 PNGs with captions (smooth colour fields plus noise)."""
    import numpy as np
    from PIL import Image

    folder = os.path.join(OUT_DIR, "train_data")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    subjects = ["a red fox", "a lighthouse", "a bowl of fruit", "a mountain lake"]
    for i in range(n):
        f = rng.uniform(1, 6, 3)
        ph = rng.uniform(0, 6.3, 3)
        img = np.stack([np.sin(f[c] * 6.3 * (xx + yy * (c + 1) / 3) + ph[c]) for c in range(3)], -1)
        img = 127.5 * (img + 1) + rng.normal(0, 8, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(folder, f"img_{i}.png"))
        with open(os.path.join(folder, f"img_{i}.txt"), "w") as fh:
            fh.write(f"[trigger] photo of {subjects[i % len(subjects)]}")
    return folder


FLUX_MODEL = {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "dev"}}
HIDREAM_MODEL = {"name_or_path": "", "arch": "hidream",
                 "model_kwargs": {"size": "full", "moe_dispatch": "grouped"}}


def _run_train_job(name: str, model: dict, network: dict, per_step: dict[str, int],
                   profile_dir: str | None):
    """An ``sd_trainer`` job on the card with seeded random weights, one 1024
    bucket, latents cached in memory, no sampling; ``per_step`` is the
    launches of each kernel one step must make. Returns (result, process,
    report)."""
    import shutil

    from ai_toolkit_tpu_torch.jobs import get_job

    steps = TRAIN_WARMUP + TRAIN_TIMED + (1 if profile_dir else 0)
    shutil.rmtree(os.path.join(OUT_DIR, "train", name), ignore_errors=True)
    raw = {"job": "extension", "config": {"name": name, "process": [{
        "type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"),
        "trigger_word": "p3r5on",
        "network": network,
        "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": _train_dataset(), "caption_ext": "txt",
                      "caption_dropout_rate": 0.05, "shuffle_tokens": False, "cache_latents": True,
                      "cache_latents_to_disk": False, "resolution": [1024]}],
        "train": {"batch_size": 1, "steps": steps, "gradient_accumulation_steps": 1,
                  "train_unet": True, "gradient_checkpointing": True, "noise_scheduler": "flowmatch",
                  "timestep_type": "flux_shift", "optimizer": "adamw8bit", "lr": 1e-4,
                  "max_grad_norm": 1.0, "ema_config": {"use_ema": True, "ema_decay": 0.99},
                  "dtype": "bf16", "seed": 42},
        "model": model,
        "logging": {"log_every": 1}}]}}
    gc.collect()  # the previous job's model is unreachable; free it before the next
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if profile_dir:
        os.environ["AIT_PROFILE_DIR"] = os.path.join(profile_dir, name)
    t0 = time.perf_counter()
    job = get_job(raw, device="cuda")
    _reset_launches()  # count only the launches of this run of the path
    (result,) = job.run()
    launches = _launches()
    wall = time.perf_counter() - t0
    os.environ.pop("AIT_PROFILE_DIR", None)
    proc = job.processes[0]
    losses, step_ms = result["losses"], result["step_ms"]
    timed = step_ms[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{result['trainable_params']:,} trainable params"
          f"{' in ' + str(result['lora_modules']) + ' LoRA modules' if result['lora_modules'] else ''}")
    print(f"losses per step: {', '.join(f'{x:.5f}' for x in losses)}")
    print(f"step ms: {', '.join(f'{x:.1f}' for x in step_ms)}; median of steps "
          f"{TRAIN_WARMUP + 1}-{TRAIN_WARMUP + TRAIN_TIMED}: {statistics.median(timed):.1f} ms"
          f"{' (the last step ran under the profiler)' if profile_dir else ''}")
    print(f"job wall {wall:.1f} s (model build, seeded init and latent/text caching included), "
          f"peak allocated {peak:.2f} GiB, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    got = {k: v / steps for k, v in launches.items()}
    check(got == per_step, f"launches per step {got} != {per_step}")
    _check_no_tma_copies(name)
    return result, proc, {"launches": launches, "steps": steps, "median_step_ms": statistics.median(timed),
                          "peak_gib": peak, "wall_s": wall}


def train_job(name: str, model: dict, per_step: dict[str, int], profile_dir: str | None) -> dict:
    """A LoRA ``sd_trainer`` job on the card (configs/examples/train_lora_flux_tpu.yaml,
    train_lora_hidream_tpu.yaml); the save is the EMA copy of the factors."""
    from ai_toolkit_tpu_torch.io.lora_file import load_lora_file

    result, proc, report = _run_train_job(name, model, {"type": "lora", "linear": 16, "linear_alpha": 16},
                                          per_step, profile_dir)
    steps = report["steps"]
    tr, ema = proc.state.trainable, proc.state.ema
    b_keys = [k for k in tr if k.endswith(".b")]
    check(all(bool(tr[k].abs().max() > 0) for k in b_keys), "a LoRA b factor is still zero")
    check(any(not torch.equal(ema[k], tr[k]) for k in tr), "the EMA equals the trainable parameters")
    path = result["save_path"]
    check(os.path.isfile(path), f"no LoRA file at {path}")
    tree, meta = load_lora_file(path)
    check(len(tree) == result["lora_modules"] and meta.get("step") == str(steps),
          f"LoRA file reloads with {len(tree)} modules, metadata {meta}")
    saved_b = max(float(v["b"].abs().max()) for v in tree.values())
    print(f"saved {path}: {len(tree)} modules, max|b| {saved_b:.3e} (EMA copy, fp16)")
    check(saved_b > 0, "the saved LoRA has zero b factors")
    del proc, tr, ema
    return {**report, "lora_path": path}


def fullft_job(name: str, model: dict, per_step: dict[str, int], profile_dir: str | None,
               seed: int = 42) -> dict:
    """The full fine-tune ``sd_trainer`` job on the card
    (configs/examples/train_full_finetune_flux_tpu.yaml's branch, ``network:
    {type: full}``) filtered by ``model.only_if_contains``: the trained
    tensors moved, every other DiT tensor equals a fresh init from the job's
    seed bit for bit, the EMA differs from the trained tensors, and the final
    save holds exactly the trained tensors (not the EMA) in their dtype."""
    from safetensors import safe_open

    from ai_toolkit_tpu_torch.models.flux_dit import FluxDiT
    from ai_toolkit_tpu_torch.models.hidream_model import hidream_dit_config
    from ai_toolkit_tpu_torch.ops.layers import init_parameters

    result, proc, report = _run_train_job(name, model, {"type": "full"}, per_step, profile_dir)
    tr, ema = proc.state.trainable, proc.state.ema
    dit = proc.variables["dit"]
    proc.variables = proc.state = None  # the text encoders and the VAE go
    check(all(not torch.equal(ema[k], tr[k]) for k in tr), "the EMA equals a trained tensor")
    with safe_open(result["save_path"], framework="pt", device="cpu") as f:
        keys = sorted(f.keys())
        check(keys == sorted(tr), f"the save holds {keys}, not the trained {sorted(tr)}")
        for k in keys:
            saved = f.get_tensor(k)
            check(saved.dtype == tr[k].dtype == torch.bfloat16 and torch.equal(saved, tr[k].detach().cpu()),
                  f"saved {k} is not the trained tensor in bf16")
    print(f"saved {result['save_path']}: {len(keys)} tensors in bf16, equal to the trained ones "
          f"(not the EMA)")
    del ema
    gc.collect()
    torch.cuda.empty_cache()
    # the job's DiT is the first component built from its seed: rebuild it
    fresh = init_parameters(FluxDiT(hidream_dit_config(model["model_kwargs"]["moe_dispatch"]), device="cuda"),
                            torch.Generator("cuda").manual_seed(seed)).state_dict()
    n_same = 0
    for k, p in dit.named_parameters():
        same = torch.equal(p, fresh[k])
        check(same != (k in tr), f"{k}: {'trained but unchanged' if same else 'changed but not trained'}")
        n_same += same
    print(f"{len(tr)} trained tensors moved; the other {n_same} DiT tensors equal a fresh seeded init")
    del fresh, dit, tr, proc
    return report


def generate_job(model: dict, width: int, height: int, steps: int, prompts: list[str],
                 per_step: dict[str, int], lora_path: str | None = None) -> dict[str, int]:
    """A ``generate`` job on the card; ``per_step`` is the launches of each
    kernel one denoise step must make."""
    from PIL import Image

    from ai_toolkit_tpu_torch.jobs import run_job

    proc = {"type": "generate", "training_folder": OUT_DIR, "model": model,
            "sample": {"sampler": "flowmatch", "width": width, "height": height, "guidance_scale": 4,
                       "sample_steps": steps, "seed": 42, "walk_seed": True, "prompts": prompts}}
    if lora_path:
        proc["lora_path"] = lora_path
    raw = {"job": "generate", "config": {"name": f"smoke_{model['arch']}_{width}x{height}",
                                         "process": [proc]}}
    gc.collect()  # the previous job's model is unreachable; free it before the next
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _reset_launches()  # count only the launches of this run of the path
    (result,) = run_job(raw, device="cuda")
    launches = _launches()
    wall = time.perf_counter() - t0
    for path in result["images"]:
        check(os.path.isfile(path) and Image.open(path).size == (width, height), f"bad image {path}")
    recs = result["timings"]
    check(len(recs) == len(prompts) and all(r["latents_finite"] for r in recs),
          f"non-finite latents: {recs}")
    for r in recs:
        steps_ms = r["step_ms"]
        print(f"image {r['width']}x{r['height']}: encode {r['encode_ms']:.1f} ms, denoise steps "
              f"{', '.join(f'{x:.1f}' for x in steps_ms)} ms (median {statistics.median(steps_ms):.1f}), "
              f"VAE decode {r['decode_ms']:.1f} ms, total {r['total_s']:.3f} s")
    print(f"job wall {wall:.1f} s (model build + seeded init included), "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}{' (LoRA ' + lora_path + ' overlaid)' if lora_path else ''}")
    expected = {k: v * len(prompts) * steps for k, v in per_step.items()}
    check(launches == expected, f"launches {launches} != {expected}")
    _check_no_tma_copies(raw["config"]["name"])
    return launches


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default=None, help="write a torch.profiler split of one step of each "
                                                        "train job here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = environment()
    fwd = kernel_vs_plain()
    bwd = bwd_kernels_vs_plain()

    moe = moe_kernels_vs_plain()
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, flux_lora_targets
    from ai_toolkit_tpu_torch.models.hidream_model import hidream_dit_config, hidream_lora_targets

    dit_reference("flux-dev", FluxConfig.dev(), flux_lora_targets(), _counts(fwd=2), _counts(2, 2, 2))
    # grouped MoE in f32: the kernels' CUDA-core path inside the model; with
    # checkpointing the MoE forward runs twice per block
    # the full fine-tune step: the double block's attention and MoE input need no
    # gradient, so only the single block runs dq, dk/dv and MoE dx; dw runs once
    dit_reference("hidream (grouped MoE)", hidream_dit_config("grouped"), hidream_lora_targets(),
                  _counts(fwd=2, moe=2), _counts(2, 2, 2, moe=4, moe_dx=2),
                  _counts(2, 1, 1, moe=4, moe_dx=1, moe_dw=1))

    phase("flux-dev LoRA sd_trainer job, 1024x1024, batch 1, rank 16, adamw8bit, EMA")
    flux_step = _counts(BLOCKS_PER_FORWARD, BLOCKS_PER_FORWARD, BLOCKS_PER_FORWARD)
    train = train_job("smoke_flux_lora", {**FLUX_MODEL, "quantize": False}, flux_step, args.profile)

    phase("flux-dev generate job, 1024x1024, 8 steps, 2 prompts, with the trained LoRA")
    prompts = ["p3r5on photo of a red fox", "macro photo of a dew drop on a leaf"]
    generate_job(FLUX_MODEL, 1024, 1024, 8, prompts, _counts(fwd=BLOCKS_PER_FORWARD),
                 lora_path=train["lora_path"])

    phase("ragged resolution: flux-dev 1008x1008 (4481 tokens), 2 steps, 1 prompt")
    generate_job(FLUX_MODEL, 1008, 1008, 2, prompts[:1], _counts(fwd=BLOCKS_PER_FORWARD))

    phase("main path of this slice: hidream LoRA sd_trainer job, 1024x1024, fp8 base, grouped MoE, "
          "batch 1, rank 16, adamw8bit, EMA")
    # per step: the attention forward once per block (its outputs are kept by the
    # checkpoint policy), the grouped MoE forward twice (forward and recompute), one dq,
    # dk/dv and MoE dx per block
    hidream_step = _counts(HIDREAM_BLOCKS, HIDREAM_BLOCKS, HIDREAM_BLOCKS, 2 * HIDREAM_BLOCKS,
                           HIDREAM_BLOCKS)
    hidream = train_job("smoke_hidream_lora", {**HIDREAM_MODEL, "quantize": True, "qtype": "qfloat8"},
                        hidream_step, args.profile)

    phase("hidream generate job, 1024x1024, 8 steps, 2 prompts, bf16 base, with the trained LoRA")
    generate_job(HIDREAM_MODEL, 1024, 1024, 8, prompts, _counts(fwd=HIDREAM_BLOCKS, moe=HIDREAM_BLOCKS),
                 lora_path=hidream["lora_path"])

    phase("main path of this slice: hidream full fine-tune sd_trainer job, 1024x1024, bf16 base, "
          "grouped MoE, the expert banks of double_blocks.0 and single_blocks.0, adamw8bit, EMA")
    # per step: nothing upstream of double_blocks.0's MoE needs a gradient, so that
    # block's attention and MoE run no backward kernel: dq, dk/dv and MoE dx in the
    # other 47 blocks; the two trained MoE layers each launch dw once
    ft_step = _counts(HIDREAM_BLOCKS, HIDREAM_BLOCKS - 1, HIDREAM_BLOCKS - 1, 2 * HIDREAM_BLOCKS,
                      HIDREAM_BLOCKS - 1, moe_dw=2)
    fullft = fullft_job("smoke_hidream_fullft", {**HIDREAM_MODEL, "quantize": False,
                                                 "only_if_contains": FT_BANKS}, ft_step, args.profile)

    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ai_toolkit_tpu")]
    check(not banned, f"the port imported {banned[:5]}")
    print(card)
    src = "ai_toolkit_tpu_torch/csrc/"
    pallas = "ai_toolkit_tpu/ops/pallas/flash_attention.py"
    gmm = "ai_toolkit_tpu/ops/pallas/moe_gmm.py"
    # launches: each kernel's count over its main path's run (flash: the flux
    # train job; MoE forward and dx: the hidream LoRA job; dw: the full fine-tune)
    rows = [("flash_attention_fwd", src + "flash_attention_fwd.cu", f"{pallas}:31", train, "fwd", fwd),
            ("flash_attention_bwd_dq", src + "flash_attention_bwd.cu", f"{pallas}:152", train, "dq",
             bwd["dq"]),
            ("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu", f"{pallas}:174", train, "dkv",
             bwd["dkv"]),
            ("moe_gmm_fwd", src + "moe_gmm_fwd.cu", f"{gmm}:99", hidream, "moe", moe["moe"]),
            ("moe_gmm_dx", src + "moe_gmm_bwd.cu", f"{gmm}:121", hidream, "moe_dx", moe["moe_dx"]),
            ("moe_gmm_dw", src + "moe_gmm_dw.cu", f"{gmm}:149", fullft, "moe_dw", moe["moe_dw"])]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": run["launches"][key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for name, source, replaces, run, key, r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
