"""LoRA checkpoint saves and rotation (``ai_toolkit_tpu/io/checkpoint.py``
``CheckpointManager`` in PyTorch): ``<name>_<step:09d>.safetensors`` every
``save_every`` steps, keeping the newest ``max_step_saves_to_keep``, and a
final ``<name>.safetensors``, in the ``peft`` or ``kohya`` layout
(``io/lora_file.py``); the step rides in the metadata. The optimizer
state file and resume come with a later slice (``latest_save_path`` lets the
job refuse a folder it would have resumed from).
"""

from __future__ import annotations

import glob
import os
import re
import time

import numpy as np

from ai_toolkit_tpu_torch.io.lora_file import save_lora_file

SOFTWARE_META = {"software": "ai_toolkit_tpu", "format": "lora"}


class CheckpointManager:
    def __init__(self, save_root: str, name: str, max_step_saves_to_keep: int = 4,
                 dtype=np.float16, fmt: str = "peft", key_map=None):
        self.save_root = save_root
        self.name = name
        self.max_keep = max_step_saves_to_keep
        self.dtype = dtype
        self.fmt = fmt
        self.key_map = key_map  # port module name -> the file's (io/lora_file.flatten_lora)
        os.makedirs(save_root, exist_ok=True)

    def path_for_step(self, step: int) -> str:
        return os.path.join(self.save_root, f"{self.name}_{step:09d}.safetensors")

    def final_path(self) -> str:
        return os.path.join(self.save_root, f"{self.name}.safetensors")

    def _step_files(self) -> list[tuple[int, str]]:
        out = []
        for f in glob.glob(os.path.join(self.save_root, f"{self.name}_*.safetensors")):
            m = re.search(rf"{re.escape(self.name)}_(\d+)\.safetensors$", f)
            if m:
                out.append((int(m.group(1)), f))
        return sorted(out)

    def latest_save_path(self) -> str | None:
        """Newest step save, else the final save, else None."""
        steps = self._step_files()
        if steps:
            return steps[-1][1]
        final = self.final_path()
        return final if os.path.isfile(final) else None

    def save(self, lora: dict, step: int, final: bool = False) -> str:
        meta = {**SOFTWARE_META, "ss_training_comment": self.name, "step": str(int(step)),
                "timestamp": str(int(time.time()))}
        path = self.final_path() if final else self.path_for_step(step)
        save_lora_file(lora, path, metadata=meta, dtype=self.dtype, fmt=self.fmt, key_map=self.key_map)
        if not final:
            self.clean_up_saves()
        return path

    def clean_up_saves(self) -> None:
        """Keep only the newest ``max_keep`` step saves."""
        steps = self._step_files()
        for _, f in (steps[: -self.max_keep] if self.max_keep > 0 else []):
            os.remove(f)
