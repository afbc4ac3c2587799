"""Image generation (``ai_toolkit_tpu/generation.py`` in PyTorch): the plain
flow-matching Euler loop of flux and hidream (hidream has no guidance embed
and, as in the JAX ``generate_flux``, no CFG pass).

A LoRA (``{module name: {a, b, scale}}``, ``io/lora_file.load_lora_file``)
is overlaid on the DiT for the call, as the JAX package passes its ``lora``
collection. Unported branches of the JAX ``generate_flux`` (the unconditional
LoRA, control/edit and IP-adapter conditioning, ``use_flux_cfg`` negative passes, x0-prediction
and arch-specific schedules) and of ``generate`` (DDPM samplers, video,
audio) raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.adapters.lora import attach_lora, detach_lora
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_flux(
    model,
    variables: dict,
    gen: GenerateImageConfig,
    lora: dict | None = None,
    schedule: FlowMatchSchedule | None = None,
    noise: np.ndarray | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """Returns a uint8 HWC image. ``noise`` ``[1, h, w, C]`` replaces the
    initial latent noise (tests inject the JAX noise); by default it comes
    from a ``torch.Generator`` seeded with ``gen.seed``. ``stats``, when
    given, receives the phase times (host clock, synchronised on a CUDA
    device) and whether the final latents were finite."""
    if getattr(model.config, "use_flux_cfg", False):
        raise NotImplementedError("use_flux_cfg (negative-prompt CFG pass) is not ported yet")
    if any(getattr(gen, a, None) for a in ("ctrl_img", "ctrl_img_2", "ctrl_img_3")):
        raise NotImplementedError("control / edit images come with a later slice")
    if gen.sampler not in (None, "flowmatch"):
        raise NotImplementedError(f"sampler '{gen.sampler}' is not ported (flowmatch only)")
    schedule = schedule or FlowMatchSchedule()
    device = model.device
    h, w, c = model.latent_shape(gen.height, gen.width)
    rec = stats if stats is not None else {}
    if lora:
        attach_lora(variables["dit"], {k: {n: x.to(device) for n, x in v.items()} for k, v in lora.items()})
    try:
        return _generate_flux(model, variables, gen, schedule, noise, rec, h, w, c)
    finally:
        if lora:
            detach_lora(variables["dit"])


def _generate_flux(model, variables, gen, schedule, noise, rec, h, w, c) -> np.ndarray:
    device = model.device
    with torch.inference_mode():
        t0 = time.perf_counter()
        cond = model.encode_prompt(variables, [gen.prompt])
        pe = model.rope_table(h, w, cond["txt"].shape[1])
        cond = {**cond, "pe": pe,
                "guidance": torch.full((1,), gen.guidance_scale, dtype=torch.float32, device=device)}
        if noise is None:
            g = torch.Generator(device=device).manual_seed(gen.seed)
            x = torch.randn((1, h, w, c), generator=g, dtype=torch.float32, device=device)
        else:
            x = torch.from_numpy(np.array(noise, dtype=np.float32)).to(device)
        sigmas = schedule.inference_sigmas(gen.sample_steps,
                                           image_seq_len=model.image_seq_len(gen.height, gen.width))
        _sync(device)
        t1 = time.perf_counter()
        rec["encode_ms"] = (t1 - t0) * 1e3
        rec["step_ms"] = []
        for i in range(gen.sample_steps):
            t_in = torch.full((1,), float(sigmas[i]), dtype=torch.float32, device=device)
            v = model.predict(variables, x, t_in, cond)
            x = schedule.euler_step(x, v, sigmas[i], sigmas[i + 1])
            _sync(device)
            t2 = time.perf_counter()
            rec["step_ms"].append((t2 - t1) * 1e3)
            t1 = t2
        rec["latents_finite"] = bool(torch.isfinite(x).all())
        img = model.decode_latents(variables, x)
        out = _to_uint8(img)
        rec["decode_ms"] = (time.perf_counter() - t1) * 1e3
        rec["total_s"] = time.perf_counter() - t0
    return out


def generate(model, variables, gen: GenerateImageConfig, lora=None, schedule=None, stats=None):
    if hasattr(model, "frame_count_snapper") or hasattr(model, "latent_shape_audio"):
        raise NotImplementedError("video / audio generation is not ported yet")
    if not model.is_flow_matching:
        raise NotImplementedError("DDPM-family samplers (generate_sd) are not ported yet")
    return generate_flux(model, variables, gen, lora, schedule, stats=stats)


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    arr = img[0].float().cpu().numpy()
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_image_atomic(img: np.ndarray, path: str) -> None:
    """Write-then-rename PNG (JAX ``save_image_atomic``)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.png"
    Image.fromarray(img).save(tmp)
    os.replace(tmp, path)
