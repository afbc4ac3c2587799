#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure raises and the script exits non-zero):
  1. environment: versions, card name and power limit, TF32 off, kernel build;
  2. every kernel of the generate path against its plain PyTorch version at
     the shapes that path gives it, and timed against it;
  3. a full-width, reduced-depth flux DiT on the card against the same module
     on the CPU (plain attention) on a small input;
  4. the main path: the flux-dev ``generate`` job at 1024x1024, 8 steps,
     2 prompts, through ``ai_toolkit_tpu_torch.jobs.run_job``, with the kernel
     launch count checked;
  5. a ragged resolution (1008x1008, 4481 tokens), 1 prompt, 2 steps.
The line before the last is the kernel table; the last line is the result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

# (B, S, T, H, D), dtype, out tolerance vs the f32 plain version
FLASH_CASES = [
    ((1, 4608, 4608, 24, 128), torch.bfloat16, 2e-2),  # flux-dev 1024^2: 512 text + 4096 image
    ((1, 4481, 4481, 24, 128), torch.bfloat16, 2e-2),  # 1008^2: ragged tails
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),  # rect, ragged, D=64
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),  # smaller than one tile
]
LSE_TOL = 1e-3
MAIN_SHAPE = (1, 4608, 24, 128)
BLOCKS_PER_FORWARD = 19 + 38  # flux-dev double + single blocks, one attention each


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

    cached = build.library_path("flash_attention_fwd").is_file()
    t0 = time.perf_counter()
    build.build("flash_attention_fwd", verbose=True)
    print(f"kernel build: flash_attention_fwd {time.perf_counter() - t0:.2f} s"
          f"{' (library already built from these sources)' if cached else ''}")
    return smi.splitlines()[0]


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _time_ms(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def kernel_vs_plain() -> dict:
    phase("flash_attention_fwd kernel vs plain version")
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(0)
    max_err = 0.0
    cases = [(shape, dt, tol, None) for shape, dt, tol in FLASH_CASES]
    # single-block split: q, k, v are strided views of the fused linear1 output
    b, s, h, d, mlp = 1, 1100, 24, 128, 4 * 3072
    lin1 = _rand((b, s, 3 * h * d + mlp), torch.bfloat16, gen)
    cases.append(((b, s, s, h, d), torch.bfloat16, 2e-2,
                  lin1[..., : 3 * h * d].unflatten(-1, (3, h, d)).unbind(2)))
    for (b, s, t, h, d), dt, tol, qkv in cases:
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), dt, gen), _rand((b, t, h, d), dt, gen), _rand((b, t, h, d), dt, gen))
        out, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        print(f"(B,S,T,H,D)=({b},{s},{t},{h},{d}) {str(dt)[6:]} v_stride={tuple(v.stride())} "
              f"out_err={err:.3e} (tol {tol:g}) lse_err={lse_err:.3e} (tol {LSE_TOL:g})")
        check(finite and err <= tol and lse_err <= LSE_TOL, "kernel disagrees with its plain version")
        max_err = max(max_err, err)

    q, k, v = (_rand(MAIN_SHAPE, torch.bfloat16, gen) for _ in range(3))
    kern = lambda: fa.flash_attention_fwd(q, k, v)  # noqa: E731
    plain = lambda: fa.flash_attention_fwd_plain(q, k, v)  # noqa: E731
    for f in (kern, plain):
        _time_ms(f, 3)  # warm-up
    # alternate plain, kernel, kernel, plain on the same card
    p = _time_ms(plain, 10); kt = _time_ms(kern, 10); kt += _time_ms(kern, 10); p += _time_ms(plain, 10)
    ms, plain_ms = statistics.median(kt), statistics.median(p)
    b, s, h, d = MAIN_SHAPE
    flops = 4 * b * s * s * h * d
    print(f"main shape {MAIN_SHAPE} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s), median of {len(kt)}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def dit_reference() -> None:
    phase("full-width flux DiT (1 double + 1 single block, f32): card vs CPU")
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa
    from ai_toolkit_tpu_torch.ops.layers import init_parameters
    from ai_toolkit_tpu_torch.ops.rope import image_position_ids, multi_axis_rope

    cfg = dataclasses.replace(FluxConfig.dev(), depth_double=1, depth_single=1, dtype=torch.float32)
    gpu = init_parameters(FluxDiT(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0)).eval()
    cpu = FluxDiT(cfg, device="cpu").eval()
    cpu.load_state_dict(gpu.state_dict())
    g = torch.Generator().manual_seed(1)
    n_txt, hh, ww = 32, 8, 12
    inputs = [torch.randn((1, hh * ww, cfg.in_channels), generator=g),
              torch.randn((1, n_txt, cfg.context_dim), generator=g),
              torch.tensor([0.7]), torch.randn((1, cfg.vec_dim), generator=g)]
    pe = multi_axis_rope(torch.from_numpy(image_position_ids(hh, ww, text_len=n_txt))[None],
                         list(cfg.axes_dim), cfg.theta)
    guidance = torch.tensor([4.0])
    before = fa.launches
    with torch.inference_mode():
        ref = cpu(*inputs, pe, guidance)
        out = gpu(*(x.cuda() for x in inputs), pe.cuda(), guidance.cuda()).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel launches={fa.launches - before}")
    check(fa.launches - before == 2 and bool(torch.isfinite(out).all()) and err <= tol,
          "DiT on the card disagrees with the CPU")


def generate_job(width: int, height: int, steps: int, prompts: list[str]) -> int:
    from PIL import Image

    from ai_toolkit_tpu_torch.jobs import run_job
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    raw = {"job": "generate", "config": {"name": f"smoke_{width}x{height}", "process": [{
        "type": "generate", "training_folder": OUT_DIR,
        "model": {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "dev"}},
        "sample": {"sampler": "flowmatch", "width": width, "height": height, "guidance_scale": 4,
                   "sample_steps": steps, "seed": 42, "walk_seed": True, "prompts": prompts}}]}}
    gc.collect()  # the previous job's model is unreachable; free it before the next
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.launches = 0  # count only the launches of this run of the main path
    (result,) = run_job(raw, device="cuda")
    launches = fa.launches
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
          f"flash launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = environment()
    k = kernel_vs_plain()
    dit_reference()

    phase("main path: flux-dev generate job, 1024x1024, 8 steps, 2 prompts")
    prompts = ["a watercolor fox in a misty forest", "macro photo of a dew drop on a leaf"]
    launches = generate_job(1024, 1024, 8, prompts)
    expected = len(prompts) * 8 * BLOCKS_PER_FORWARD
    check(launches == expected, f"flash launches {launches} != {expected}")

    phase("ragged resolution: 1008x1008 (4481 tokens), 2 steps, 1 prompt")
    ragged = generate_job(1008, 1008, 2, prompts[:1])
    check(ragged == 2 * BLOCKS_PER_FORWARD, f"flash launches {ragged} != {2 * BLOCKS_PER_FORWARD}")

    check(not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")],
          "jax was imported")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "ai_toolkit_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ai_toolkit_tpu/ops/pallas/flash_attention.py:31",
        "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
