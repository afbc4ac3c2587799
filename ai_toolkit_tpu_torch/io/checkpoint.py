"""LoRA checkpoint saves and rotation (``ai_toolkit_tpu/io/checkpoint.py``
``CheckpointManager`` in PyTorch): ``<name>_<step:09d>.safetensors`` every
``save_every`` steps, keeping the newest ``max_step_saves_to_keep``, and a
final ``<name>.safetensors``, in the ``peft`` or ``kohya`` layout
(``io/lora_file.py``); the step rides in the metadata.

Resume (JAX ``load_latest`` / ``_save_opt_state`` / ``load_opt_state``):
:meth:`CheckpointManager.load_latest` reads the newest save back, and
``training_state.safetensors`` beside the saves, written with every save,
holds what else the run needs to go on exactly as it would have: the
trainable tensors as trained (the save holds the EMA copy, in the save
dtype), the optimizer's moments and count, the EMA, the step and the state
of the job's random generator (``TrainState.state_dict``). It takes the
place of the JAX package's ``optimizer.msgpack``.
"""

from __future__ import annotations

import glob
import os
import re
import time

import numpy as np
import torch

from ai_toolkit_tpu_torch.io.lora_file import load_lora_file, save_lora_file

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

    def state_path(self) -> str:
        return os.path.join(self.save_root, "training_state.safetensors")

    def save_state(self, state: dict[str, torch.Tensor], step: int) -> None:
        """Write ``state`` (``TrainState.state_dict`` and the generator) for
        the save at ``step``, through a temporary file."""
        from safetensors.torch import save_file

        tmp = self.state_path() + ".tmp"
        save_file({k: v.detach().contiguous().cpu() for k, v in state.items()}, tmp, metadata={"step": str(int(step))})
        os.replace(tmp, self.state_path())

    def load_state(self) -> tuple[dict[str, torch.Tensor] | None, int]:
        """(the state file's tensors, its step), or (None, 0) without one."""
        from safetensors import safe_open

        if not os.path.isfile(self.state_path()):
            return None, 0
        with safe_open(self.state_path(), framework="pt") as f:
            return {k: f.get_tensor(k) for k in f.keys()}, int(f.metadata().get("step", 0))

    def load_latest(self, **kwargs) -> tuple[dict | None, int]:
        """(the newest save's LoRA tree ``{module: {a, b, scale}}``, its
        step), or (None, 0) without a save; ``kwargs`` go to
        ``io/lora_file.load_lora_file``."""
        path = self.latest_save_path()
        if path is None:
            return None, 0
        tree, meta = load_lora_file(path, **kwargs)
        return tree, int(meta.get("step", 0))

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

    def save(self, lora: dict, step: int, final: bool = False, extra_flat: dict | None = None) -> str:
        meta = {**SOFTWARE_META, "ss_training_comment": self.name, "step": str(int(step)),
                "timestamp": str(int(time.time()))}
        path = self.final_path() if final else self.path_for_step(step)
        save_lora_file(lora, path, metadata=meta, dtype=self.dtype, fmt=self.fmt, key_map=self.key_map,
                       extra_flat=extra_flat)
        if not final:
            self.clean_up_saves()
        return path

    def clean_up_saves(self) -> None:
        """Keep only the newest ``max_keep`` step saves."""
        steps = self._step_files()
        for _, f in (steps[: -self.max_keep] if self.max_keep > 0 else []):
            os.remove(f)
