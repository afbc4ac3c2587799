"""Reading checkpoints into modules (``ai_toolkit_tpu/io/torch_import.py``
``load_safetensors_dir`` in the port).

A checkpoint is one ``.safetensors`` file or an HF-layout directory of
shards. :class:`SafetensorsIndex` maps every tensor name (with the BFL single
file's ``model.diffusion_model.`` prefix stripped, as the JAX loaders strip
it) to its shard, and reads one tensor at a time with
``safe_open(framework="pt")``. :func:`load_module` fills a module's
parameters from it in place, on the module's device and in its dtype, so no
host copy of the whole model is ever built.

The load is strict: every tensor of the module must be found with its shape,
or the load raises naming the first that is missing. Tied tensors (T5's
``shared`` and ``encoder.embed_tokens``) need one of their names. A
``sources`` entry builds a tensor from several checkpoint tensors (a layout
map, ``io/hidream_layout.py``), and an ``adapt`` function reshapes a
checkpoint tensor whose layout differs from the module's (a 1x1 conv read
into a Linear).
"""

from __future__ import annotations

import contextlib
import glob
import os
from typing import Callable

import torch
from torch import nn

STRIP_PREFIXES = ("model.diffusion_model.",)


def safetensors_files(path: str) -> list[str]:
    """``path`` itself when it is a file, else the ``*.safetensors`` shards of
    the directory, sorted."""
    if os.path.isfile(path):
        return [path]
    return sorted(glob.glob(os.path.join(path, "*.safetensors")))


class SafetensorsIndex:
    """Tensor name -> shard of a checkpoint file or directory; a context
    manager that keeps each shard open while it is read."""

    def __init__(self, path: str, strip: tuple[str, ...] = STRIP_PREFIXES):
        from safetensors import safe_open

        self.path = path
        self.files = safetensors_files(path)
        self.where: dict[str, tuple[str, str]] = {}
        for f in self.files:
            with safe_open(f, framework="pt") as sf:
                for key in sf.keys():
                    name = key
                    for p in strip:
                        name = name.removeprefix(p)
                    self.where[name] = (f, key)
        self._stack = contextlib.ExitStack()
        self._open: dict[str, object] = {}
        self.used: set[str] = set()

    def __enter__(self) -> "SafetensorsIndex":
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self._open.clear()

    def __contains__(self, name: str) -> bool:
        return name in self.where

    def keys(self) -> list[str]:
        return list(self.where)

    def get(self, name: str) -> torch.Tensor:
        from safetensors import safe_open

        f, key = self.where[name]
        if f not in self._open:
            self._open[f] = self._stack.enter_context(safe_open(f, framework="pt"))
        self.used.add(name)
        return self._open[f].get_tensor(key)

    def unmatched(self) -> list[str]:
        return sorted(set(self.where) - self.used)


Source = tuple[Callable[..., torch.Tensor], list[str]]


def squeeze_to(t: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``t`` reshaped to ``shape`` when the two differ only by axes of size 1
    (an RMS gamma ``[C, 1, 1, 1]`` read as ``[C]``, a 1x1 conv as a Linear)."""
    if t.shape != shape and [d for d in t.shape if d != 1] == [d for d in shape if d != 1]:
        return t.reshape(shape)
    return t


def squeeze_adapt(name: str, t: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """:func:`squeeze_to` as ``load_module``'s ``adapt`` (SD 1.x's 1x1-conv
    ``proj_in`` / ``proj_out``, the LDM VAE's 1x1-conv attention)."""
    return squeeze_to(t, target.shape)


@torch.no_grad()
def load_module(module: nn.Module, index: SafetensorsIndex, what: str,
                sources: dict[str, Source] | None = None, keep: Callable[[str], bool] | None = None,
                adapt: Callable[[str, torch.Tensor, torch.Tensor], torch.Tensor] | None = None) -> int:
    """Fill every tensor of ``module.state_dict()`` from ``index`` in place:
    by its own name, by ``sources[name]`` (a function of the named checkpoint
    tensors), or, for names ``keep`` accepts, not at all (they keep their
    values). ``adapt(name, tensor, target)`` may reshape a checkpoint tensor.
    Raises ``KeyError`` naming the first missing tensor, ``ValueError`` on a
    shape that differs. Returns the number of tensors loaded."""
    sources = sources or {}
    groups: dict[int, list[str]] = {}
    targets: dict[int, torch.Tensor] = {}
    for name, t in module.state_dict(keep_vars=True).items():
        groups.setdefault(id(t), []).append(name)
        targets[id(t)] = t
    missing, n = [], 0
    for tid, names in groups.items():
        target = targets[tid]
        if keep is not None and all(keep(k) for k in names):
            continue
        name = next((k for k in names if k in sources), None)
        if name is not None:
            fn, keys = sources[name]
            absent = [k for k in keys if k not in index]
            if absent:
                missing.append(absent[0])
                continue
            value = fn(*[index.get(k) for k in keys])
        else:
            name = next((k for k in names if k in index), None)
            if name is None:
                missing.append(names[0])
                continue
            value = index.get(name)
        if adapt is not None:
            value = adapt(name, value, target)
        if value.shape != target.shape:
            raise ValueError(f"{what}: '{name}' in {index.path} has shape {tuple(value.shape)}, "
                             f"the module's is {tuple(target.shape)}")
        target.copy_(value)
        n += 1
    if missing:
        raise KeyError(f"{what}: {index.path} has no '{missing[0]}' ({len(missing)} of the module's "
                       f"{len(groups)} tensors missing)")
    return n
