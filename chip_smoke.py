#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py [--profile DIR]``.

Phases (any failure raises and the script exits non-zero):
  1. environment: versions, card name and power limit, TF32 off, both kernel
     libraries built in parallel;
  2. the flash forward kernel against its plain version at the shapes the
     paths give it, timed against it and against the library yardstick;
  3. the flash backward kernels (dq, dk/dv) the same way;
  4. a full-width, reduced-depth flux DiT on the card against the same module
     on the CPU: the forward, and one LoRA training step's loss and gradients;
  5. the main path of this slice: the flux-dev LoRA ``sd_trainer`` job at
     1024^2 through ``ai_toolkit_tpu_torch.jobs``, with the launches of every
     kernel per step checked (``--profile DIR`` adds a ``torch.profiler``
     split of its last step, written to DIR);
  6. the generate path: the flux-dev ``generate`` job at 1024x1024, 8 steps,
     2 prompts, loading the LoRA the train job saved, launch count checked;
  7. a ragged resolution (1008x1008, 4481 tokens), 1 prompt, 2 steps.
The line before the last is the kernel table; the last line is the result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

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
# backward: (B, S, T, H, D), dtype, tolerance on max|dX - ref| / max|ref| for dq, dk, dv:
# bf16 inputs with p and ds rounded to bf16 before the second products (f32
# accumulation) leave ~4e-3; f32 differs from the f32 plain version by summation order only
BWD_CASES = [
    ((1, 4608, 4608, 24, 128), torch.bfloat16, 2e-2),
    ((1, 4481, 4481, 24, 128), torch.bfloat16, 2e-2),
    ((2, 300, 190, 4, 64), torch.float32, 1e-4),
    ((1, 16, 16, 2, 128), torch.float32, 1e-4),
]
KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
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


def _in_turns(kern, plain, reps: int = 10) -> tuple[float, float, int]:
    """Medians (kernel ms, plain ms) over plain, kernel, kernel, plain runs of
    ``reps`` each, after a warm-up of each."""
    for f in (kern, plain):
        _time_ms(f, 2)
    p = _time_ms(plain, reps)
    kt = _time_ms(kern, reps)
    kt += _time_ms(kern, reps)
    p += _time_ms(plain, reps)
    return statistics.median(kt), statistics.median(p), len(kt)


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card: the larger of the bf16 tensor-core time and the
    HBM time; and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_layout(*xs):
    """[B,S,H,D] -> contiguous [B,H,S,D] copies for scaled_dot_product_attention."""
    return [x.transpose(1, 2).contiguous() for x in xs]


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
    ms, plain_ms, n = _in_turns(lambda: fa.flash_attention_fwd(q, k, v),
                                lambda: fa.flash_attention_fwd_plain(q, k, v))
    qt, kt, vt = _sdpa_layout(q, k, v)
    library_ms = statistics.median(_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20))
    b, s, h, d = MAIN_SHAPE
    flops = 4 * b * s * s * h * d
    bound, by = _bound_ms(flops, 2 * 4 * b * s * h * d + 4 * b * h * s)
    print(f"main shape {MAIN_SHAPE} bf16: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s), median of {n}; "
          f"library scaled_dot_product_attention {library_ms:.4f} ms; bound {bound:.4f} ms ({by})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by}


def bwd_kernels_vs_plain() -> dict:
    phase("flash_attention_bwd dq and dk/dv kernels vs plain versions")
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1)
    cases = [(shape, dt, tol, None) for shape, dt, tol in BWD_CASES]
    b, s, h, d, mlp = 1, 1100, 24, 128, 4 * 3072
    lin1 = _rand((b, s, 3 * h * d + mlp), torch.bfloat16, gen)
    cases.append(((b, s, s, h, d), torch.bfloat16, 2e-2,
                  lin1[..., : 3 * h * d].unflatten(-1, (3, h, d)).unbind(2)))
    err = {"dq": 0.0, "dkv": 0.0}
    for (b, s, t, h, d), dt, tol, qkv in cases:
        q, k, v = qkv if qkv is not None else (
            _rand((b, s, h, d), dt, gen), _rand((b, t, h, d), dt, gen), _rand((b, t, h, d), dt, gen))
        g = _rand((b, s, h, d), dt, gen)
        out, lse = fa.flash_attention_fwd(q, k, v)
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
              f"max abs {absd[0]:.3e}/{absd[1]:.3e}/{absd[2]:.3e}")
        check(finite and max(rel) <= tol, "backward kernels disagree with their plain versions")
        err["dq"] = max(err["dq"], absd[0])
        err["dkv"] = max(err["dkv"], absd[1], absd[2])
        del refs
        torch.cuda.empty_cache()

    b, s, h, d = MAIN_SHAPE
    q, k, v, g = (_rand(MAIN_SHAPE, torch.bfloat16, gen) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.flash_attention_bwd_delta(out, g)
    res = {}
    for name, kern, plain, flops, nbytes in (
        ("dq", lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),
         lambda: fa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, scale),
         6 * b * h * s * s * d, 2 * 5 * b * s * h * d + 8 * b * h * s),  # q k v dO in, dq out
        ("dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale),
         lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, scale),
         8 * b * h * s * s * d, 2 * 6 * b * s * h * d + 8 * b * h * s),  # q k v dO in, dk dv out
    ):
        ms, plain_ms, n = _in_turns(kern, plain)
        bound, by = _bound_ms(flops, nbytes)
        res[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by}
        print(f"main shape {MAIN_SHAPE} bf16 {name}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, median of {n}; "
              f"bound {bound:.4f} ms ({by})")
    torch.cuda.empty_cache()
    # library yardstick: one scaled_dot_product_attention backward gives dq, dk and dv
    qt, kt, vt, gt = _sdpa_layout(q, k, v, g)
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    lib_bwd = statistics.median(_time_ms(
        lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True), 20))
    lib_fb = statistics.median(_time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), gt), 20))
    total = res["dq"]["ms"] + res["dkv"]["ms"]
    print(f"library scaled_dot_product_attention backward {lib_bwd:.4f} ms, forward+backward "
          f"{lib_fb:.4f} ms; kernels dq+dkv {total:.4f} ms (bound of the whole backward, "
          f"10*B*H*S*T*D FLOPs: {10 * b * h * s * s * d / PEAK_BF16_FLOPS * 1e3:.4f} ms)")
    for name in res:
        res[name]["library_ms"] = lib_bwd
    return res


def _reset_launches() -> None:
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def _launches() -> dict[str, int]:
    from ai_toolkit_tpu_torch.ops.kernels import flash_attention as fa

    return {"fwd": fa.launches, "dq": fa.dq_launches, "dkv": fa.dkv_launches}


def dit_reference() -> None:
    phase("full-width flux DiT (1 double + 1 single block, f32): card vs CPU")
    from ai_toolkit_tpu_torch.adapters.lora import LoRASpec, build_lora
    from ai_toolkit_tpu_torch.models.flux_dit import FluxConfig, FluxDiT, flux_lora_targets
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
    gpu_in = [*(x.cuda() for x in inputs), pe.cuda(), guidance.cuda()]
    _reset_launches()
    with torch.inference_mode():
        ref = cpu(*inputs, pe, guidance)
        out = gpu(*gpu_in).cpu()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # f32 both sides, TF32 off; summation order only
    print(f"forward: out {tuple(out.shape)} max|ref|={scale:.3f} max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) kernel launches={_launches()}")
    check(_launches() == {"fwd": 2, "dq": 0, "dkv": 0} and bool(torch.isfinite(out).all())
          and err <= tol, "DiT on the card disagrees with the CPU")

    # one LoRA training step's loss and gradients; b is made non-zero, else the
    # gradient of a is zero and the check proves nothing about it
    spec = LoRASpec(rank=16, alpha=16.0, target_patterns=flux_lora_targets())
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

    def loss_and_grads(model, lora, args, tgt):
        params = [getattr(lora[n.rsplit(".", 1)[0]], n.rsplit(".", 1)[1]) for n in names]
        loss = (model(*args).float() - tgt).square().mean()
        return loss.item(), torch.autograd.grad(loss, params)

    _reset_launches()
    ref_loss, ref_grads = loss_and_grads(cpu, lc, [*inputs, pe, guidance], target)
    loss, grads = loss_and_grads(gpu, lg, gpu_in, target.cuda())
    launches = _launches()
    worst = max(((gd.cpu() - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item()
                for gd, gr in zip(grads, ref_grads))
    # f32 both sides, TF32 off: summation order and the kernels' FMA order only
    print(f"LoRA train step: loss card {loss:.6f} vs CPU {ref_loss:.6f}; {len(names)} LoRA tensors, "
          f"worst max|dgrad|/max|grad| {worst:.3e} (tol 1e-3); kernel launches={launches}")
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst <= 1e-3
          and launches == {"fwd": 2, "dq": 2, "dkv": 2}, "LoRA training step on the card disagrees")


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


def train_job(profile_dir: str | None) -> dict:
    """The main path: configs/examples/train_lora_flux_tpu.yaml with seeded
    random weights, bf16 base (no quantize), one 1024 bucket, latents cached
    in memory, no sampling, one card."""
    import shutil

    from ai_toolkit_tpu_torch.io.lora_file import load_lora_file
    from ai_toolkit_tpu_torch.jobs import get_job

    steps = TRAIN_WARMUP + TRAIN_TIMED + (1 if profile_dir else 0)
    name = "smoke_flux_lora"
    shutil.rmtree(os.path.join(OUT_DIR, "train", name), ignore_errors=True)
    raw = {"job": "extension", "config": {"name": name, "process": [{
        "type": "sd_trainer", "training_folder": os.path.join(OUT_DIR, "train"),
        "trigger_word": "p3r5on",
        "network": {"type": "lora", "linear": 16, "linear_alpha": 16},
        "save": {"dtype": "float16", "save_every": 250, "max_step_saves_to_keep": 4},
        "datasets": [{"folder_path": _train_dataset(), "caption_ext": "txt",
                      "caption_dropout_rate": 0.05, "shuffle_tokens": False, "cache_latents": True,
                      "cache_latents_to_disk": False, "resolution": [1024]}],
        "train": {"batch_size": 1, "steps": steps, "gradient_accumulation_steps": 1,
                  "train_unet": True, "gradient_checkpointing": True, "noise_scheduler": "flowmatch",
                  "timestep_type": "flux_shift", "optimizer": "adamw8bit", "lr": 1e-4,
                  "max_grad_norm": 1.0, "ema_config": {"use_ema": True, "ema_decay": 0.99},
                  "dtype": "bf16", "seed": 42},
        "model": {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "dev"}, "quantize": False},
        "logging": {"log_every": 1}}]}}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if profile_dir:
        os.environ["AIT_PROFILE_DIR"] = profile_dir
    t0 = time.perf_counter()
    job = get_job(raw, device="cuda")
    _reset_launches()  # count only the launches of this run of the main path
    (result,) = job.run()
    launches = _launches()
    wall = time.perf_counter() - t0
    os.environ.pop("AIT_PROFILE_DIR", None)
    proc = job.processes[0]
    losses, step_ms = result["losses"], result["step_ms"]
    timed = step_ms[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"LoRA: {result['lora_modules']} modules, {result['lora_params']:,} trainable params")
    print(f"losses per step: {', '.join(f'{x:.5f}' for x in losses)}")
    print(f"step ms: {', '.join(f'{x:.1f}' for x in step_ms)}; median of steps "
          f"{TRAIN_WARMUP + 1}-{TRAIN_WARMUP + TRAIN_TIMED}: {statistics.median(timed):.1f} ms"
          f"{' (the last step ran under the profiler)' if profile_dir else ''}")
    print(f"job wall {wall:.1f} s (model build, seeded init and latent/text caching included), "
          f"peak allocated {peak:.2f} GiB, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    per_step = {k: v / steps for k, v in launches.items()}
    check(per_step == {"fwd": BLOCKS_PER_FORWARD, "dq": BLOCKS_PER_FORWARD, "dkv": BLOCKS_PER_FORWARD},
          f"launches per step {per_step} != {BLOCKS_PER_FORWARD} of each kernel")
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
    del job, proc, tr, ema
    return {"launches": launches, "steps": steps, "median_step_ms": statistics.median(timed),
            "peak_gib": peak, "lora_path": path}


def generate_job(width: int, height: int, steps: int, prompts: list[str],
                 lora_path: str | None = None) -> int:
    from PIL import Image

    from ai_toolkit_tpu_torch.jobs import run_job

    proc = {"type": "generate", "training_folder": OUT_DIR,
            "model": {"name_or_path": "", "arch": "flux", "model_kwargs": {"size": "dev"}},
            "sample": {"sampler": "flowmatch", "width": width, "height": height, "guidance_scale": 4,
                       "sample_steps": steps, "seed": 42, "walk_seed": True, "prompts": prompts}}
    if lora_path:
        proc["lora_path"] = lora_path
    raw = {"job": "generate", "config": {"name": f"smoke_{width}x{height}", "process": [proc]}}
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
    expected = len(prompts) * steps * BLOCKS_PER_FORWARD
    check(launches == {"fwd": expected, "dq": 0, "dkv": 0}, f"launches {launches} != {expected} forward")
    return launches["fwd"]


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default=None, help="write a torch.profiler split of one train step here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = environment()
    fwd = kernel_vs_plain()
    bwd = bwd_kernels_vs_plain()
    dit_reference()

    phase("main path: flux-dev LoRA sd_trainer job, 1024x1024, batch 1, rank 16, adamw8bit, EMA")
    train = train_job(args.profile)

    phase("generate path: flux-dev generate job, 1024x1024, 8 steps, 2 prompts, with the trained LoRA")
    prompts = ["p3r5on photo of a red fox", "macro photo of a dew drop on a leaf"]
    generate_job(1024, 1024, 8, prompts, lora_path=train["lora_path"])

    phase("ragged resolution: 1008x1008 (4481 tokens), 2 steps, 1 prompt")
    generate_job(1008, 1008, 2, prompts[:1])

    banned = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ai_toolkit_tpu")]
    check(not banned, f"the port imported {banned[:5]}")
    print(card)
    src = "ai_toolkit_tpu_torch/csrc/"
    pallas = "ai_toolkit_tpu/ops/pallas/flash_attention.py"
    rows = [("flash_attention_fwd", src + "flash_attention_fwd.cu", f"{pallas}:31", "fwd", fwd),
            ("flash_attention_bwd_dq", src + "flash_attention_bwd.cu", f"{pallas}:152", "dq", bwd["dq"]),
            ("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu", f"{pallas}:174", "dkv", bwd["dkv"])]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": train["launches"][key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for name, source, replaces, key, r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
