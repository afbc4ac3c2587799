"""LoRA safetensors export and import (``ai_toolkit_tpu/io/lora_file.py`` in PyTorch).

A LoRA here is ``{module name: {a [in, r], b [r, out], scale}}`` keyed by the
port's module names, which are the external (BFL) names the JAX package's key
map produces, so no key map is needed. The file layout is PEFT's:
``transformer.<module>.lora_A.weight`` = a^T ``[r, in]`` and
``.lora_B.weight`` = b^T ``[out, r]``, no alpha (the layout the JAX job writes
for flow-matching DiTs, ``jobs/train_process.py:2015-2017``). A missing alpha
means alpha = rank (scale 1), as in the JAX ``unflatten_lora``. The kohya and
ComfyUI layouts and LyCORIS files come with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

ROOT = "transformer"
_SUFFIXES = {".lora_A.weight": "down", ".lora_B.weight": "up", ".alpha": "alpha"}


def flatten_lora(lora: dict[str, dict[str, torch.Tensor]], dtype=np.float16) -> dict[str, np.ndarray]:
    """LoRA tree -> flat ``{external key: array}`` (JAX ``flatten_lora``)."""
    out: dict[str, np.ndarray] = {}
    for name, leaf in lora.items():
        a = leaf["a"].detach().float().cpu().numpy()
        b = leaf["b"].detach().float().cpu().numpy()
        # safetensors writes the raw buffer: make the transposes C-contiguous
        out[f"{ROOT}.{name}.lora_A.weight"] = np.ascontiguousarray(a.T.astype(dtype))
        out[f"{ROOT}.{name}.lora_B.weight"] = np.ascontiguousarray(b.T.astype(dtype))
    return out


def unflatten_lora(flat: dict[str, np.ndarray]) -> dict[str, dict[str, torch.Tensor]]:
    """Flat external dict -> LoRA tree (inverse of :func:`flatten_lora`)."""
    groups: dict[str, dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        for suffix, part in _SUFFIXES.items():
            if key.endswith(suffix):
                groups.setdefault(key[: -len(suffix)], {})[part] = v
                break
    lora: dict[str, dict[str, torch.Tensor]] = {}
    for mod, parts in groups.items():
        if "down" not in parts or "up" not in parts:
            continue
        if not mod.startswith(ROOT + "."):
            raise NotImplementedError(f"LoRA key '{mod}': only the PEFT layout is ported")
        name = mod[len(ROOT) + 1:]
        down = parts["down"].astype(np.float32)
        if down.ndim != 2:
            raise NotImplementedError(f"LoRA '{name}': conv factors are not ported")
        a = torch.from_numpy(np.ascontiguousarray(down.T))
        b = torch.from_numpy(np.ascontiguousarray(parts["up"].astype(np.float32).T))
        rank = a.shape[1]
        alpha = float(np.asarray(parts.get("alpha", rank)).reshape(-1)[0])
        lora[name] = {"a": a, "b": b, "scale": torch.tensor(alpha / rank, dtype=torch.float32)}
    return lora


def save_lora_file(lora: dict[str, dict[str, torch.Tensor]], path: str,
                   metadata: dict | None = None, dtype=np.float16) -> None:
    from safetensors.numpy import save_file

    meta = {str(k): str(v) for k, v in (metadata or {}).items()}
    save_file(flatten_lora(lora, dtype), path, metadata=meta)


def load_lora_file(path: str) -> tuple[dict[str, dict[str, torch.Tensor]], dict]:
    """Returns (LoRA tree on the CPU, metadata)."""
    from safetensors import safe_open

    with safe_open(path, framework="numpy") as f:
        meta = dict(f.metadata() or {})
        flat = {k: f.get_tensor(k) for k in f.keys()}
    return unflatten_lora(flat), meta
