"""Job dispatch (``ai_toolkit_tpu/jobs/dispatch.py`` in PyTorch).

Ported process types: generation (``generate``, ``pure_lora_generator``), the
trainer (``sd_trainer``, ``diffusion_trainer``, ``ui_trainer``,
``textual_inversion_trainer``), the concept
slider (``slider``, ``concept_slider``, ``slider_trainer``), the ultimate
slider (``ultimate_slider``, ``ultimate_slider_trainer``,
``image_reference_slider_trainer``) and LoRA extraction (``extract_lora``);
every other process type of the JAX package raises ``NotImplementedError``
naming what is missing. Each process runs on the job's ``device``.
"""

from __future__ import annotations

from typing import Any

import torch

from ai_toolkit_tpu_torch.config.modules import JobConfig

PROCESS_TYPES = {
    "generate": "generate",
    "pure_lora_generator": "generate",
    "sd_trainer": "train",
    "diffusion_trainer": "train",
    "ui_trainer": "train",
    "textual_inversion_trainer": "train",
    "slider": "slider",
    "concept_slider": "slider",
    "slider_trainer": "slider",
    "ultimate_slider": "ultimate_slider",
    "ultimate_slider_trainer": "ultimate_slider",
    "image_reference_slider_trainer": "ultimate_slider",
    "extract_lora": "extract",
}


class Job:
    def __init__(self, job_config: JobConfig, device: torch.device | str):
        self.config = job_config
        self.processes = []
        for proc_cfg in job_config.processes:
            kind = PROCESS_TYPES.get(proc_cfg.type)
            if kind is None:
                raise NotImplementedError(
                    f"process type '{proc_cfg.type}' is not ported to ai_toolkit_tpu_torch yet "
                    f"(ported: {sorted(PROCESS_TYPES)})")
            if kind == "generate":
                from ai_toolkit_tpu_torch.jobs.generate_process import GenerateProcess as Process
            elif kind == "slider":
                from ai_toolkit_tpu_torch.jobs.slider_process import TrainSliderProcess as Process
            elif kind == "ultimate_slider":
                from ai_toolkit_tpu_torch.jobs.ultimate_slider_process import UltimateSliderProcess as Process
            elif kind == "extract":
                from ai_toolkit_tpu_torch.jobs.extract_process import ExtractLoraProcess as Process
            else:
                from ai_toolkit_tpu_torch.jobs.train_process import SDTrainProcess as Process
            self.processes.append(Process(job_config.name, proc_cfg, device))

    def run(self) -> list[Any]:
        return [p.run() for p in self.processes]


def get_job(raw_config: dict, device: torch.device | str) -> Job:
    return Job(JobConfig.from_raw(raw_config), device)


def run_job(raw_config: dict, device: torch.device | str):
    """Run a job dict (the ``ai_toolkit_tpu_torch.config.get_config`` schema) on ``device``."""
    return get_job(raw_config, device).run()
