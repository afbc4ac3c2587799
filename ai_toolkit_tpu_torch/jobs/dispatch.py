"""Job dispatch (``ai_toolkit_tpu/jobs/dispatch.py`` in PyTorch).

Only the generation process types are ported; every other process type of
the JAX package raises ``NotImplementedError`` naming what is missing.
"""

from __future__ import annotations

from typing import Any

import torch

from ai_toolkit_tpu.config.modules import JobConfig

PROCESS_TYPES = {
    "generate": "generate",
    "pure_lora_generator": "generate",
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
            from ai_toolkit_tpu_torch.jobs.generate_process import GenerateProcess

            self.processes.append(GenerateProcess(job_config.name, proc_cfg, device))

    def run(self) -> list[Any]:
        return [p.run() for p in self.processes]


def get_job(raw_config: dict, device: torch.device | str) -> Job:
    return Job(JobConfig.from_raw(raw_config), device)


def run_job(raw_config: dict, device: torch.device | str):
    """Run a job dict (the ``ai_toolkit_tpu.config.get_config`` schema) on ``device``."""
    return get_job(raw_config, device).run()
