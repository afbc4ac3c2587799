"""LoRA safetensors export and import (``ai_toolkit_tpu/io/lora_file.py`` in PyTorch).

A LoRA here is ``{module name: {a [in, r], b [r, out], scale}}`` keyed by the
port's module names, which are the external names the JAX package's key maps
produce (BFL for the flux DiT, diffusers for the UNet), so no key map is
needed. Three file layouts, as the JAX job writes them
(``jobs/train_process.py:1332-1337``):

- ``peft`` (flow-matching DiTs): ``transformer.<module>.lora_A.weight`` =
  a^T ``[r, in]`` and ``.lora_B.weight`` = b^T ``[out, r]``, no alpha;
- ``comfy`` (a model whose ``lora_key_layout()`` says so, Qwen-Image): the
  same under the root ``diffusion_model.``;
- ``kohya`` (the UNet): ``lora_unet_<module with '.' -> '_'>.lora_down.weight``
  = a^T, ``.lora_up.weight`` = b^T and ``.alpha`` = scale * rank (another
  ``prefix`` than ``lora_unet`` on the way out: the extract job's
  ``lora_transformer``).

A model whose JAX files carry other module names than the port's (Wan: the
JAX job writes its own module paths, ``block_3.self_q``) gives ``key_map``
on the way out and ``module_name`` on the way back. A missing alpha means
alpha = rank (scale 1), as in the JAX ``unflatten_lora``. Kohya keys are
ambiguous on ``_`` (``attn1_to_q``), so loading them needs the model's
module names. A LyCORIS LoKr file (``lycoris_<module>.lokr_w1`` /
``.lokr_w2``), the frozen accuracy-recovery adapter's other layout, loads
through :func:`load_lokr_file`. Conv factors (LoCon) keep the torch layout
both ways: ``lora_down`` = a ``[r, in, kh, kw]``, ``lora_up`` = b ``[out, r,
1, 1]``. The text-encoder prefixes (``lora_te*``) come with a later slice.

The trainable LyCORIS networks and DoRA save through :func:`save_adapter_file`
(JAX ``save_adapter_file``): ``<prefix>_<module with '_'>`` keys, LoKr's
``.lokr_w1`` / ``.lokr_w2`` / ``.alpha`` (= scale), DoRA's ``.lora_down.weight``
/ ``.lora_up.weight`` / ``.alpha`` (= scale * rank) / ``.dora_scale``
(``[1, out]``), and LoHa's LyCORIS ``.hada_w1_a`` / ``.hada_w1_b`` /
``.hada_w2_a`` / ``.hada_w2_b`` / ``.alpha`` (= scale * rank) in the torch
orientation, ``(hada_w1_a @ hada_w1_b) * (hada_w2_a @ hada_w2_b) * alpha / r``
the ``[out, in]`` delta (JAX writes no LoHa tensor: ROADMAP Queue 3).
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import numpy as np
import torch

ROOT = "transformer"
ROOTS = {"peft": ROOT, "comfy": "diffusion_model"}
_SUFFIXES = {".lora_A.weight": "down", ".lora_B.weight": "up", ".lora_down.weight": "down",
             ".lora_up.weight": "up", ".alpha": "alpha"}
KOHYA_PREFIX = "lora_unet"


def flatten_lora(lora: dict[str, dict[str, torch.Tensor]], dtype=np.float16,
                 fmt: str = "peft", key_map: Callable[[str], str] | None = None,
                 prefix: str = KOHYA_PREFIX) -> dict[str, np.ndarray]:
    """LoRA tree -> flat ``{external key: array}`` (JAX ``flatten_lora``);
    ``key_map``: port module name -> the file's module name."""
    out: dict[str, np.ndarray] = {}
    for module, leaf in lora.items():
        name = key_map(module) if key_map is not None else module
        a = leaf["a"].detach().float().cpu().numpy()
        b = leaf["b"].detach().float().cpu().numpy()
        conv = a.ndim == 4  # a [r, in, kh, kw], b [out, r, 1, 1]: the file's layout already
        # safetensors writes the raw buffer: make the transposes C-contiguous
        down, up = (np.ascontiguousarray(x.astype(dtype)) for x in ((a, b) if conv else (a.T, b.T)))
        rank = a.shape[0] if conv else a.shape[1]
        if fmt in ROOTS:
            out[f"{ROOTS[fmt]}.{name}.lora_A.weight"] = down
            out[f"{ROOTS[fmt]}.{name}.lora_B.weight"] = up
        elif fmt == "kohya":
            key = f"{prefix}_{name.replace('.', '_')}"
            out[f"{key}.lora_down.weight"] = down
            out[f"{key}.lora_up.weight"] = up
            out[f"{key}.alpha"] = np.asarray(float(leaf["scale"]) * rank, dtype)
        else:
            raise NotImplementedError(f"LoRA layout '{fmt}' (ported: peft, comfy, kohya)")
    return out


def _module_name(key: str, kohya_names: dict[str, str] | None,
                 module_name: Callable[[str], str] | None = None) -> str:
    for root in ROOTS.values():
        if key.startswith(root + "."):
            name = key[len(root) + 1:]
            return module_name(name) if module_name is not None else name
    if key.startswith(KOHYA_PREFIX + "_"):
        if kohya_names is None:
            raise ValueError(f"LoRA key '{key}': a kohya key needs the model's module names")
        name = kohya_names.get(key[len(KOHYA_PREFIX) + 1:])
        if name is None:
            raise KeyError(f"LoRA key '{key}' names no module of this model")
        return name
    raise NotImplementedError(f"LoRA key '{key}': only the PEFT, ComfyUI and the UNet's kohya layouts are ported")


def unflatten_lora(flat: dict[str, np.ndarray], module_names: Iterable[str] | None = None,
                   module_name: Callable[[str], str] | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """Flat external dict -> LoRA tree (inverse of :func:`flatten_lora`);
    ``module_names``: the model's module names, which resolve kohya keys;
    ``module_name``: the inverse of a ``key_map``."""
    kohya_names = None if module_names is None else {n.replace(".", "_"): n for n in module_names}
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
        name = _module_name(mod, kohya_names, module_name)
        down, up = parts["down"].astype(np.float32), parts["up"].astype(np.float32)
        conv = down.ndim == 4  # LoCon: the torch layout in the file and here
        a = torch.from_numpy(np.ascontiguousarray(down if conv else down.T))
        b = torch.from_numpy(np.ascontiguousarray(up if conv else up.T))
        rank = a.shape[0] if conv else a.shape[1]
        alpha = float(np.asarray(parts.get("alpha", rank)).reshape(-1)[0])
        lora[name] = {"a": a, "b": b, "scale": torch.tensor(alpha / rank, dtype=torch.float32)}
    return lora


def save_lora_file(lora: dict[str, dict[str, torch.Tensor]], path: str, metadata: dict | None = None,
                   dtype=np.float16, fmt: str = "peft", key_map: Callable[[str], str] | None = None,
                   prefix: str = KOHYA_PREFIX, extra_flat: dict[str, np.ndarray] | None = None) -> None:
    """``extra_flat``: entries written beside the LoRA's as they are (an
    adapter's expansion or grafted tensors, JAX ``save_lora_file``)."""
    from safetensors.numpy import save_file

    meta = {str(k): str(v) for k, v in (metadata or {}).items()}
    flat = flatten_lora(lora, dtype, fmt, key_map, prefix)
    flat.update(extra_flat or {})
    save_file(flat, path, metadata=meta)


def load_lora_file(path: str, module_names: Iterable[str] | None = None,
                   module_name: Callable[[str], str] | None = None
                   ) -> tuple[dict[str, dict[str, torch.Tensor]], dict]:
    """Returns (LoRA tree on the CPU, metadata); ``module_names`` and
    ``module_name`` as in :func:`unflatten_lora`."""
    from safetensors import safe_open

    with safe_open(path, framework="numpy") as f:
        meta = dict(f.metadata() or {})
        flat = {k: f.get_tensor(k) for k in f.keys()}
    return unflatten_lora(flat, module_names, module_name), meta


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def save_adapter_file(tree: dict[str, dict[str, torch.Tensor]], kind: str, path: str,
                      key: Callable[[str], str], metadata: dict | None = None, dtype=np.float16) -> None:
    """Write a LyCORIS network or DoRA ``{module name: {leaf: tensor}}`` (the
    overlays' parameters) as JAX ``save_adapter_file`` does (module
    docstring); ``key(name)`` gives the file's module key, without the
    ``.<part>`` suffix."""
    from safetensors.numpy import save_file

    def c(x: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(x.astype(dtype))

    flat: dict[str, np.ndarray] = {}
    for name, leaf in tree.items():
        k = key(name)
        scale = float(leaf["scale"])
        if kind == "lokr":  # already the torch layout: JAX writes its w1 / w2 transposed
            flat[f"{k}.lokr_w1"], flat[f"{k}.lokr_w2"] = c(_np32(leaf["w1"])), c(_np32(leaf["w2"]))
            flat[f"{k}.alpha"] = np.asarray(scale, dtype)
        elif kind == "dora":
            a, b = _np32(leaf["a"]), _np32(leaf["b"])
            flat[f"{k}.lora_down.weight"], flat[f"{k}.lora_up.weight"] = c(a.T), c(b.T)
            flat[f"{k}.alpha"] = np.asarray(scale * a.shape[1], dtype)
            flat[f"{k}.dora_scale"] = c(_np32(leaf["magnitude"])[None, :])
        elif kind == "loha":
            w1a, w1b, w2a, w2b = (_np32(leaf[p]) for p in ("w1a", "w1b", "w2a", "w2b"))
            flat[f"{k}.hada_w1_a"], flat[f"{k}.hada_w1_b"] = c(w1b.T), c(w1a.T)
            flat[f"{k}.hada_w2_a"], flat[f"{k}.hada_w2_b"] = c(w2b.T), c(w2a.T)
            flat[f"{k}.alpha"] = np.asarray(scale * w1a.shape[1], dtype)
        else:
            raise ValueError(kind)
    save_file(flat, path, metadata={str(k): str(v) for k, v in (metadata or {}).items()})


def load_loha_file(path: str) -> dict[str, dict[str, np.ndarray]]:
    """A LyCORIS LoHa file -> ``{file module key: {w1a [in, r], w1b [r, out],
    w2a, w2b, scale}}`` in JAX's leaf layout (the inverse of
    :func:`save_adapter_file`'s ``loha``)."""
    from safetensors import safe_open

    groups: dict[str, dict[str, np.ndarray]] = {}
    with safe_open(path, framework="numpy") as f:
        for key in f.keys():
            mod, _, part = key.rpartition(".")
            groups.setdefault(mod, {})[part] = f.get_tensor(key).astype(np.float32)
    out = {}
    for mod, p in groups.items():
        rank = p["hada_w1_b"].shape[0]
        out[mod] = {"w1a": p["hada_w1_b"].T, "w1b": p["hada_w1_a"].T, "w2a": p["hada_w2_b"].T,
                    "w2b": p["hada_w2_a"].T, "scale": np.float32(float(p["alpha"]) / rank)}
    return out


def is_lokr_file(path: str) -> bool:
    """JAX's test for a LoKr accuracy-recovery adapter
    (``jobs/train_process.py:129-133``): the file's first key starts with
    ``lycoris`` and some key names ``lokr``."""
    from safetensors import safe_open

    with safe_open(path, framework="numpy") as f:
        keys = list(f.keys())
    return bool(keys) and keys[0].startswith("lycoris") and any("lokr" in k for k in keys)


_LOKR_PREFIXES = ("lycoris_", "lora_transformer_", "lora_unet_")


def load_lokr_file(path: str, module_names: Iterable[str]) -> dict[str, dict[str, torch.Tensor]]:
    """A LyCORIS LoKr file -> ``{module name: {w1, w2, scale}}`` in the torch
    layout (``w1`` ``[o1, i1]``, ``w2`` ``[o2, i2]``), keyed by the model's
    module names (``module_names`` resolve the ``_``-joined keys). The scale
    is 1 whatever alpha the file stores, the full-rank LoKr convention (JAX
    ``io/lora_file.load_lokr_file``); a key that names no module raises."""
    from safetensors import safe_open

    names = {n.replace(".", "_"): n for n in module_names}
    groups: dict[str, dict[str, np.ndarray]] = {}
    with safe_open(path, framework="numpy") as f:
        for key in f.keys():
            for part in ("lokr_w1", "lokr_w2", "alpha"):
                if key.endswith("." + part):
                    groups.setdefault(key[: -(len(part) + 1)], {})[part] = f.get_tensor(key)
                    break
    out: dict[str, dict[str, torch.Tensor]] = {}
    for mod, parts in groups.items():
        if "lokr_w1" not in parts or "lokr_w2" not in parts:
            continue
        ext = next((mod[len(p):] for p in _LOKR_PREFIXES if mod.startswith(p)), mod)
        name = names.get(ext)
        if name is None:
            raise KeyError(f"LoKr key '{mod}' names no module of this model")
        alpha = float(np.asarray(parts.get("alpha", 1.0)).reshape(-1)[0])
        if alpha not in (0.0, 1.0) and alpha != parts["lokr_w2"].shape[0]:
            print(f"lokr load: non-unit alpha {alpha} on {mod} ignored (full-rank LoKr multiplier is 1.0)")
        out[name] = {"w1": torch.from_numpy(parts["lokr_w1"].astype(np.float32)),
                     "w2": torch.from_numpy(parts["lokr_w2"].astype(np.float32)),
                     "scale": torch.tensor(1.0)}
    return out
