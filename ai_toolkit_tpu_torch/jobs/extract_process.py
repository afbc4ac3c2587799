"""The LoRA extraction job (``ai_toolkit_tpu/jobs/extract_process.py``
``ExtractLoraProcess`` in PyTorch), process type ``extract_lora``: the
difference of two sets of weights, SVD'd into a LoRA
(``adapters/extract.py``) on the job's device, saved through
``io/lora_file.py`` in fp16 with the JAX job's keys.

Two modes, from the process's own keys:

- ``base_weights`` / ``tuned_weights``: two flat safetensors files of
  ``<module>.kernel`` tensors in the JAX layout (``[in, out]``, or a stacked
  ``[L, in, out]``), read as they are; the LoRA is keyed by ``<module>``
  (a stack by ``<module>.<l>``), in ``format`` (default kohya, with
  ``prefix``, default ``lora_transformer``).
- ``base_model`` / ``extract_model``: two checkpoints of ``arch`` (else the
  model section's, else ``sd1``; ``model_kwargs``) through the port's
  loaders; every ``Linear`` of the main component (the UNet, the DiT) is a
  kernel, the file is in the arch's export layout (its
  ``lora_key_layout``, else PEFT for a flow DiT and kohya ``lora_unet`` for
  the UNet) under the module names the JAX job writes (the model's
  ``lora_key``).

``rank`` (else the network's, else 16), ``alpha`` (else the rank) and
``output_path`` (else ``<training_folder>/<name>_extracted.safetensors``).
"""

from __future__ import annotations

import os
import time

import torch

from ai_toolkit_tpu_torch.adapters.extract import extract_lora_from_diff
from ai_toolkit_tpu_torch.config.modules import ModelConfig, ProcessConfig, TrainConfig
from ai_toolkit_tpu_torch.io.lora_file import save_lora_file
from ai_toolkit_tpu_torch.jobs.train_process import _sync
from ai_toolkit_tpu_torch.ops.layers import Linear

EXTRACT_KEYS = ("base_model", "extract_model", "arch", "model_kwargs", "base_weights", "tuned_weights", "rank",
                "alpha", "output_path", "format", "prefix")
FORMATS = ("kohya", "peft", "comfy")


def read_flat_kernels(path: str, device: torch.device) -> dict[str, torch.Tensor]:
    """``{module: kernel}`` of a flat file's ``<module>.kernel`` tensors; the
    file's other tensors are not kernels and are left out, as the JAX
    job's tree walk leaves them."""
    from safetensors.torch import load_file

    return {k[: -len(".kernel")]: v.to(device) for k, v in load_file(path).items() if k.endswith(".kernel")}


def model_kernels(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Every ``Linear`` weight of ``module`` as a JAX ``[in, out]`` f32 kernel,
    by module name (a quantized weight dequantized)."""
    return {name: m.dequantized().detach().t().float() for name, m in module.named_modules()
            if isinstance(m, Linear)}


class ExtractLoraProcess:
    """Process type ``extract_lora``."""

    def __init__(self, job_name: str, cfg: ProcessConfig, device: torch.device | str):
        self.job_name = job_name
        self.cfg = cfg
        self.device = torch.device(device)

    def _refuse_unported(self) -> None:
        cfg, ex = self.cfg, self.cfg.extras
        unknown = sorted(set(ex) - set(EXTRACT_KEYS))
        if unknown:
            raise NotImplementedError(f"extract_lora keys {unknown} are not read (read: {list(EXTRACT_KEYS)})")
        if "base_model" in ex or "extract_model" in ex:
            if not ("base_model" in ex and "extract_model" in ex):
                raise ValueError("extract needs BOTH base_model and extract_model")
        elif not ("base_weights" in ex and "tuned_weights" in ex):
            raise ValueError("extract needs base_model + extract_model or base_weights + tuned_weights")
        if ex.get("format") not in (None,) + FORMATS:
            raise NotImplementedError(f"format '{ex['format']}' (ported: {list(FORMATS)})")
        if cfg.datasets or cfg.sample.prompts or cfg.train != TrainConfig() or cfg.adapter or cfg.embedding \
                or cfg.slider:
            raise NotImplementedError("extract_lora reads its own keys, the network's rank and the model's arch; "
                                      "datasets, samples, train settings and adapters are not read")

    def _load_pair(self) -> tuple[dict, dict, object]:
        """The main component's kernels of both checkpoints, and the model."""
        from ai_toolkit_tpu_torch.models.registry import get_model_class

        ex = self.cfg.extras
        arch = ex.get("arch") or self.cfg.model.arch or "sd1"
        kernels, model = [], None
        for path in (ex["base_model"], ex["extract_model"]):
            mc = ModelConfig.from_dict({"arch": arch, "name_or_path": str(path),
                                        "model_kwargs": dict(ex.get("model_kwargs", {}))})
            model = get_model_class(arch)(mc, self.device)
            variables = model.load_variables(torch.Generator(device=self.device).manual_seed(0))
            kernels.append(model_kernels(variables[model.main_component]))
            del variables
        return kernels[0], kernels[1], model

    @staticmethod
    def export_layout(model) -> tuple[str, str]:
        """(format, kohya prefix) of the arch's LoRA files (JAX ``_export_layout``)."""
        layout = model.lora_key_layout() if hasattr(model, "lora_key_layout") else "kohya"
        fmt = layout if layout != "kohya" else ("peft" if model.is_flow_matching else "kohya")
        return fmt, "lora_transformer" if model.is_flow_matching else "lora_unet"

    def run(self) -> dict:
        self._refuse_unported()
        ex, dev = self.cfg.extras, self.device
        rank = int(ex.get("rank", self.cfg.network.rank if self.cfg.network else 16))
        fmt, prefix, key_map = ex.get("format"), ex.get("prefix"), None
        t0 = time.perf_counter()
        if "base_model" in ex:
            base, tuned, model = self._load_pair()
            key_map = getattr(model, "lora_key", None)
            auto_fmt, auto_prefix = self.export_layout(model)
            fmt, prefix = fmt or auto_fmt, prefix or auto_prefix
        else:
            base, tuned = read_flat_kernels(ex["base_weights"], dev), read_flat_kernels(ex["tuned_weights"], dev)
        _sync(dev)
        load_s, t0 = time.perf_counter() - t0, time.perf_counter()
        self.lora = lora = extract_lora_from_diff(base, tuned, rank=rank, alpha=ex.get("alpha"))
        _sync(dev)
        svd_s = time.perf_counter() - t0
        out = ex.get("output_path", os.path.join(self.cfg.training_folder, f"{self.job_name}_extracted.safetensors"))
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        save_lora_file(lora, out, metadata={"extracted": "true", "rank": rank}, fmt=fmt or "kohya",
                       key_map=key_map, prefix=prefix or "lora_transformer")
        print(f"extracted {len(lora)} modules at rank {rank} (SVD {svd_s:.2f} s): {out}")
        return {"output": out, "modules": len(lora), "load_s": load_s, "svd_s": svd_s,
                "bytes": os.path.getsize(out)}
