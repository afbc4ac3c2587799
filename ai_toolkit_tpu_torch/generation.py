"""Image and video generation (``ai_toolkit_tpu/generation.py`` in PyTorch):
the plain flow-matching Euler loop of flux and hidream (hidream has no
guidance embed and, as in the JAX ``generate_flux``, no CFG pass), the DDIM
loop of SD 1.x / 2.x and SDXL with classifier-free guidance as one batch of
two (``generate_sd``; SD 1.x / 2.x take the one CLIP's context and no added
condition, and a textual-inversion bank in ``variables["emb"]`` gives the
trigger its vectors), and Wan's video Euler loop (``generate_video``: frames
snapped to the VAE's grid, the (t, y, x) rope table, an i2v arch's first
frame ``ctrl_img`` through its vision tower, sigmas shifted for the clip's
token count, each step routed to a multistage pair's expert by its sigma
through ``predict``, one decode of every frame, uint8 frames written as an
animated webp by :func:`save_video_atomic`; LTX-2's joint model steps its
audio tokens beside the video's and decodes them through the vocoder, and
:func:`save_wav_atomic` writes the track).

A LoRA (``{module name: {a, b, scale}}``, ``io/lora_file.load_lora_file``)
is overlaid on the model's DiT or UNet for the call (one network on both
experts of a multistage pair), as the JAX package passes its ``lora``
collection. A control arch (flex2, flux_kontext, qwen_image_edit, a base
flux whose ``img_in`` a control-LoRA adapter widened) samples
with the control latents of the model's ``sampling_control_latents`` (the
encoded ``ctrl_img``, or the blank layout without one: zeros for
qwen_image_edit, whose rope table always holds the control tokens, JAX's
``is_edit`` branch), and chroma's Approximator takes the sample's
``guidance_scale`` as its guidance, as in JAX. SD3, Qwen-Image, Lumina2
and OmniGen2 sample with no CFG pass: the JAX ``generate_flux`` gives them
none, and their ``guidance_scale`` reaches only a ``guidance`` their DiTs
do not read (ROADMAP Queue 3); OmniGen2 samples without references, as
JAX gives it none (its ``sampling_control_latents`` is ``None``). Unported branches of the JAX ``generate_flux`` (the
unconditional LoRA, the multi-reference edit archs' ``ctrl_img_2`` /
``ctrl_img_3``, IP-adapter
conditioning, ``use_flux_cfg`` negative passes, x0-prediction and
arch-specific schedules), of ``generate_sd`` (the k-diffusion, LCM and PNDM samplers, the
unconditional LoRA) and of ``generate`` (text-to-audio: :data:`GENERATE_AUDIO`) raise
``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.adapters.lora import attach_lora, detach_lora, share_lora
from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig
from ai_toolkit_tpu_torch.samplers.ddpm import DDPMSchedule
from ai_toolkit_tpu_torch.samplers.flowmatch import FlowMatchSchedule


AUDIO_SAMPLE_RATE = 48_000  # a joint model's waveform rate (JAX generate_video's default, the one its callers take)
GENERATE_AUDIO = "text-to-audio sampling (JAX generate_audio, the ace_step family) is not ported (ROADMAP Queue 1 item 6a)"


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
    cond: dict | None = None,
) -> np.ndarray:
    """Returns a uint8 HWC image. ``cond`` adds entries to the prompt's
    conditioning (the train job's ``ip_tokens`` from a ``ctrl_img`` through
    a vision_direct adapter). ``noise`` ``[1, h, w, C]`` replaces the
    initial latent noise (tests inject the JAX noise); by default it comes
    from a ``torch.Generator`` seeded with ``gen.seed``. ``stats``, when
    given, receives the phase times (host clock, synchronised on a CUDA
    device) and whether the final latents were finite."""
    if getattr(model.config, "use_flux_cfg", False):
        raise NotImplementedError("use_flux_cfg (negative-prompt CFG pass) is not ported yet")
    if getattr(gen, "ctrl_img_2", None) or getattr(gen, "ctrl_img_3", None):
        raise NotImplementedError("ctrl_img_2 / ctrl_img_3 (multi-reference edit archs) come with a later slice")
    if getattr(gen, "ctrl_img", None) and not model.takes_control:
        raise NotImplementedError(f"ctrl_img on arch '{model.config.arch}', which takes no control latents "
                                  f"(ported: flex2, flux_kontext, model_kwargs.control, qwen_image_edit, and "
                                  f"flux / flux_schnell under a control_lora adapter)")
    if gen.sampler not in (None, "flowmatch"):
        raise NotImplementedError(f"sampler '{gen.sampler}' is not ported (flowmatch only)")
    schedule = schedule or FlowMatchSchedule()
    device = model.device
    h, w, c = model.latent_shape(gen.height, gen.width)
    rec = stats if stats is not None else {}
    with _overlaid(model, variables, lora):
        return _generate_flux(model, variables, gen, schedule, noise, rec, h, w, c, cond or {})


@contextlib.contextmanager
def _overlaid(model, variables: dict, lora: dict | None):
    """``lora`` attached to the model's main component (one network on every
    expert of a multistage pair) for the block."""
    nets = [variables[name] for name in model.experts]
    if lora:
        modules = attach_lora(nets[0], {k: {n: x.to(model.device) for n, x in v.items()} for k, v in lora.items()})
        for net in nets[1:]:
            share_lora(net, modules)
    try:
        yield
    finally:
        if lora:
            for net in nets:
                detach_lora(net)


def _generate_flux(model, variables, gen, schedule, noise, rec, h, w, c, extra) -> np.ndarray:
    device = model.device
    with torch.inference_mode():
        t0 = time.perf_counter()
        cond = model.encode_prompt(variables, [gen.prompt])
        pe = model.rope_table(h, w, cond["txt"].shape[1])
        cond = {**cond, "pe": pe,
                "guidance": torch.full((1,), gen.guidance_scale, dtype=torch.float32, device=device), **extra}
        if model.takes_control:
            cond["control_latents"] = model.sampling_control_latents(variables, h, w, gen.ctrl_img, gen.width,
                                                                     gen.height)
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


def generate_sd(
    model,
    variables: dict,
    gen: GenerateImageConfig,
    lora: dict | None = None,
    schedule: DDPMSchedule | None = None,
    noise: np.ndarray | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """DDIM with classifier-free guidance (JAX ``generate_sd``'s ``ddim`` /
    ``ddpm`` branch): the negative prompt and the prompt as one batch of two
    when ``guidance_scale`` > 1. Returns a uint8 HWC image; ``noise`` and
    ``stats`` as in :func:`generate_flux`."""
    sampler = (gen.sampler or "ddim").lower()
    if sampler not in ("ddim", "ddpm", "flowmatch"):  # flowmatch: the config default, DDIM in JAX too
        raise NotImplementedError(f"sampler '{gen.sampler}' for a DDPM model is not ported yet "
                                  f"(slice G: the k-diffusion, LCM and PNDM samplers; ported: ddim, ddpm)")
    schedule = schedule or DDPMSchedule()
    h, w, c = model.latent_shape(gen.height, gen.width)
    with _overlaid(model, variables, lora):
        return _generate_sd(model, variables, gen, schedule, noise,
                            stats if stats is not None else {}, h, w, c)


def _generate_sd(model, variables, gen, schedule, noise, rec, h, w, c) -> np.ndarray:
    device = model.device
    do_cfg = gen.guidance_scale > 1.0
    with torch.inference_mode():
        t0 = time.perf_counter()
        cond = model.encode_prompt(variables, [gen.negative_prompt, gen.prompt] if do_cfg else [gen.prompt])
        if "pooled" in cond:  # SDXL's added condition; SD 1.x / 2.x have none
            cond = {"context": cond["context"],
                    "added_cond": model.added_cond(cond["pooled"], gen.height, gen.width)}
        if noise is None:
            g = torch.Generator(device=device).manual_seed(gen.seed)
            x = torch.randn((1, h, w, c), generator=g, dtype=torch.float32, device=device)
        else:
            x = torch.from_numpy(np.array(noise, dtype=np.float32)).to(device)
        ts = schedule.ddim_timesteps(gen.sample_steps)
        _sync(device)
        t1 = time.perf_counter()
        rec["encode_ms"] = (t1 - t0) * 1e3
        rec["step_ms"] = []
        for i in range(len(ts)):
            t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
            xin = torch.cat([x, x]) if do_cfg else x
            pred = model.predict(variables, xin, torch.full((xin.shape[0],), float(ts[i]), device=device), cond)
            if do_cfg:
                uncond, text = pred.chunk(2)
                pred = uncond + gen.guidance_scale * (text - uncond)
            x = schedule.ddim_step(x, pred, torch.full((1,), int(ts[i]), device=device),
                                   torch.full((1,), t_prev, device=device))
            _sync(device)
            t2 = time.perf_counter()
            rec["step_ms"].append((t2 - t1) * 1e3)
            t1 = t2
        rec["latents_finite"] = bool(torch.isfinite(x).all())
        out = _to_uint8(model.decode_latents(variables, x))
        rec["decode_ms"] = (time.perf_counter() - t1) * 1e3
        rec["total_s"] = time.perf_counter() - t0
    return out


def generate_video(
    model,
    variables: dict,
    gen: GenerateImageConfig,
    lora: dict | None = None,
    schedule: FlowMatchSchedule | None = None,
    noise: np.ndarray | None = None,
    stats: dict | None = None,
    cond: dict | None = None,
    noise_audio: np.ndarray | None = None,
):
    """Text- or image-to-video (JAX ``generate_video``, wan and ltx2): returns
    uint8 frames ``[T, H, W, 3]``, T the snapped ``gen.num_frames``. ``noise``
    ``[1, t, h, w, C]`` and ``stats`` as in :func:`generate_flux`; ``cond``,
    the prompt's (and first frame's) conditioning from
    :func:`encode_video_cond`, spares the call the text encoder and the vision
    tower. A joint audio-video model returns ``(frames, waveform [S, 2] f32)``:
    its audio tokens, ``round(T / fps * AUDIO_SAMPLE_RATE / downscale)`` of
    them (``noise_audio`` ``[1, Na, C_a]``, else drawn after the video's),
    take one Euler step at each sigma beside the video's."""
    schedule = schedule or FlowMatchSchedule()
    nf = model.frame_count_snapper(max(gen.num_frames, 1))
    shape = model.latent_shape(gen.height, gen.width, nf)
    audio = None
    if getattr(model, "joint_audio", False):
        secs = nf / float(gen.fps or 16)
        n_audio = max(1, int(round(secs * AUDIO_SAMPLE_RATE / model.audio_vae_config.downscale)))
        audio = (n_audio, noise_audio)
    with _overlaid(model, variables, lora):
        return _generate_video(model, variables, gen, schedule, noise, stats if stats is not None else {}, shape,
                               cond, audio)


def encode_video_cond(model, variables: dict, gen: GenerateImageConfig) -> dict:
    """A video prompt's conditioning: the UMT5 states ``txt`` and, with
    ``gen.ctrl_img``, the i2v first frame's CLIP-vision tokens ``img_cond``
    (the image resized to the clip's size by PIL, as in JAX)."""
    with torch.inference_mode():
        cond = model.encode_prompt(variables, [gen.prompt])
        if getattr(gen, "ctrl_img", None):
            from PIL import Image

            with Image.open(gen.ctrl_img) as im:
                px = np.asarray(im.convert("RGB").resize((gen.width, gen.height)), np.float32) / 127.5 - 1.0
            cond["img_cond"] = model.encode_image_cond(variables, torch.from_numpy(px)[None])
    return cond


def _generate_video(model, variables, gen, schedule, noise, rec, shape, cond, audio):
    device = model.device
    t_lat, h, w, _ = shape
    with torch.inference_mode():
        t0 = time.perf_counter()
        if cond is None:
            cond = encode_video_cond(model, variables, gen)
            _sync(device)
            rec["encode_ms"] = (time.perf_counter() - t0) * 1e3
        cond = dict(cond)
        t1 = time.perf_counter()
        cond["pe"] = model.rope_table(t_lat, h, w)
        pt, ph, pw = model.dit_config.patch_size
        rec["tokens"] = (t_lat // pt) * (h // ph) * (w // pw)
        g = torch.Generator(device=device).manual_seed(gen.seed)
        if noise is None:
            x = torch.randn((1, *shape), generator=g, dtype=torch.float32, device=device)
        else:
            x = torch.from_numpy(np.array(noise, dtype=np.float32)).to(device)
        xa = None
        if audio is not None:
            n_audio, noise_audio = audio
            cond["pe_audio"] = model.audio_rope_table(n_audio)
            rec["audio_tokens"] = n_audio
            if noise_audio is None:
                xa = torch.randn((1, n_audio, model.av_config.audio_in_channels), generator=g,
                                 dtype=torch.float32, device=device)
            else:
                xa = torch.from_numpy(np.array(noise_audio, dtype=np.float32)).to(device)
        sigmas = schedule.inference_sigmas(gen.sample_steps, image_seq_len=rec["tokens"])
        rec["step_ms"], rec["experts"] = [], []
        for i in range(gen.sample_steps):
            t = torch.full((1,), float(sigmas[i]), device=device)
            if xa is not None:  # both streams, one Euler step each at the shared sigma
                v, va = model.predict(variables, x, t, {**cond, "noisy_audio": xa})
                xa = schedule.euler_step(xa, va, sigmas[i], sigmas[i + 1])
            else:
                v = model.predict(variables, x, t, cond)
            rec["experts"].append(getattr(model, "last_expert", None))
            x = schedule.euler_step(x, v, sigmas[i], sigmas[i + 1])
            _sync(device)
            t2 = time.perf_counter()
            rec["step_ms"].append((t2 - t1) * 1e3)
            t1 = t2
        rec["latents_finite"] = bool(torch.isfinite(x).all())
        frames = _to_uint8(model.decode_latents(variables, x))
        wav = None if xa is None else model.decode_audio(variables, xa)[0].float().cpu().numpy()
        rec["decode_ms"] = (time.perf_counter() - t1) * 1e3
        rec["total_s"] = time.perf_counter() - t0
    return frames if wav is None else (frames, wav)


def generate(model, variables, gen: GenerateImageConfig, lora=None, schedule=None, stats=None, cond=None):
    if hasattr(model, "frame_count_snapper"):
        return generate_video(model, variables, gen, lora, schedule, stats=stats, cond=cond)
    if hasattr(model, "latent_shape_audio"):
        raise NotImplementedError(GENERATE_AUDIO)
    if not model.is_flow_matching:
        return generate_sd(model, variables, gen, lora, schedule, stats=stats)
    return generate_flux(model, variables, gen, lora, schedule, stats=stats, cond=cond)


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


def save_video_atomic(frames: np.ndarray, path: str, fps: int = 16) -> None:
    """Write-then-rename ``[T, H, W, 3]`` uint8 frames as an animated webp
    (T > 1) or a still image (JAX ``save_video_atomic``)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ims = [Image.fromarray(f) for f in frames]
    tmp = path + ".tmp" + os.path.splitext(path)[1]
    if len(ims) == 1:
        ims[0].save(tmp)
    else:
        ims[0].save(tmp, save_all=True, append_images=ims[1:], duration=max(1, int(round(1000 / max(fps, 1)))),
                    loop=0)
    os.replace(tmp, path)


def save_wav_atomic(waveform: np.ndarray, path: str, sample_rate: int = AUDIO_SAMPLE_RATE) -> None:
    """Write-then-rename ``[S, C]`` f32 in [-1, 1] as a 16-bit wav (JAX ``save_wav_atomic``)."""
    from scipy.io import wavfile

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.wav"
    wavfile.write(tmp, sample_rate, (np.clip(waveform, -1.0, 1.0) * 32767.0).astype(np.int16))
    os.replace(tmp, path)
