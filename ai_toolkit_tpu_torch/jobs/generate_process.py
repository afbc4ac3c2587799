"""Batch generation job (``ai_toolkit_tpu/jobs/generate_process.py`` in PyTorch).
A process-level ``lora_path`` (a PEFT-layout LoRA file, as the train job
saves it) is overlaid on the DiT while the prompts are generated."""

from __future__ import annotations

import os

import torch

from ai_toolkit_tpu_torch.config.modules import GenerateImageConfig, ProcessConfig
from ai_toolkit_tpu_torch.generation import generate, save_image_atomic
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
            lora, _ = load_lora_file(cfg.extras["lora_path"])
        outputs, timings = [], []
        for i, item in enumerate(cfg.sample.prompts):
            seed = cfg.sample.seed + (i if cfg.sample.walk_seed else 0)
            gen = GenerateImageConfig.from_sample(cfg.sample, item, seed)
            timings.append({"width": gen.width, "height": gen.height})
            out = generate(model, variables, gen, lora=lora, stats=timings[-1])
            path = os.path.join(self.output_dir, f"{self.job_name}_{i:04d}.{gen.output_ext}")
            save_image_atomic(out, path)
            outputs.append(path)
        return {"images": outputs, "timings": timings}
