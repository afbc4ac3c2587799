"""Batch generation job (``ai_toolkit_tpu/jobs/generate_process.py`` in PyTorch).
A process-level ``lora_path`` (a LoRA file as the train job saves it: PEFT
for a DiT, under Wan's JAX module names for Wan, kohya for the UNet) is
overlaid on the model's DiT or UNet while the prompts are generated. A video
model encodes every prompt (and an i2v arch every first frame, ``ctrl_img``)
first and then releases its text encoder and vision tower from the device,
which the denoising and the decode do not use; it writes each clip as an
animated webp (a one-frame clip as an image)."""

from __future__ import annotations

import gc
import os
import time

import torch

from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ProcessConfig
from ai_toolkit_tpu_torch.generation import (encode_video_cond, generate, save_image_atomic, save_video_atomic,
                                             save_wav_atomic)
from ai_toolkit_tpu_torch.io.lora_file import load_lora_file
from ai_toolkit_tpu_torch.models.registry import get_model_class


class GenerateProcess:
    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        self.device = torch.device(device)
        self.output_dir = os.path.join(cfg.training_folder, job_name)

    def run(self):
        cfg = self.cfg
        if cfg.model.lora_path:
            raise NotImplementedError("model.lora_path (merge into the base at load) comes with "
                                      "checkpoint loading; give the process-level lora_path")
        model = get_model_class(cfg.model.arch)(cfg.model, self.device)
        variables = model.load_variables(torch.Generator(device=self.device).manual_seed(0))
        lora = None
        if cfg.extras.get("lora_path"):
            names = [n for n, _ in variables[model.main_component].named_modules()]
            lora, _ = load_lora_file(cfg.extras["lora_path"], module_names=names,
                                     module_name=getattr(model, "lora_module_name", None))
        video = hasattr(model, "frame_count_snapper")
        gens = [GenerateImageConfig.from_sample(cfg.sample, item, cfg.sample.seed + (i if cfg.sample.walk_seed else 0))
                for i, item in enumerate(cfg.sample.prompts)]
        timings = [{"width": gen.width, "height": gen.height} for gen in gens]
        conds = [None] * len(gens)
        if video:  # every prompt's conditioning, then the encoders leave the device
            for i, gen in enumerate(gens):
                t0 = time.perf_counter()
                conds[i] = encode_video_cond(model, variables, gen)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings[i]["encode_ms"] = (time.perf_counter() - t0) * 1e3
            for name in ("t5", "clip_vision"):
                variables.pop(name, None)
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        outputs = []
        for i, (gen, cond) in enumerate(zip(gens, conds)):
            out = generate(model, variables, gen, lora=lora, stats=timings[i], cond=cond)
            wav = None
            if isinstance(out, tuple):  # a joint audio-video model: the frames and the waveform
                out, wav = out
            if video:
                ext = "webp" if out.shape[0] > 1 else gen.output_ext
                path = os.path.join(self.output_dir, f"{self.job_name}_{i:04d}.{ext}")
                timings[i]["frames"] = out.shape[0]
                save_video_atomic(out, path, fps=gen.fps)
                if wav is not None:
                    save_wav_atomic(wav, os.path.splitext(path)[0] + ".wav")
            else:
                path = os.path.join(self.output_dir, f"{self.job_name}_{i:04d}.{gen.output_ext}")
                save_image_atomic(out, path)
            outputs.append(path)
        return {"images": outputs, "timings": timings}
