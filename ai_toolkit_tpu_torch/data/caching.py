"""Latent and text-embedding caches (``ai_toolkit_tpu/data/caching.py`` in the
port): every item is VAE-encoded once, one encode call per bucket chunk, and
kept in memory; prompts are encoded once per distinct caption. The disk
latent cache (``cache_latents_to_disk``) comes with a later slice."""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ai_toolkit_tpu_torch.data.dataset import FileItem, load_pixels


def latent_key(item: FileItem) -> tuple:
    return (item.path, item.bucket, item.flip, item.flip_y)


def cache_latents(items: Iterable[FileItem], encode_fn: Callable[[np.ndarray], np.ndarray],
                  batch_size: int = 8) -> dict[tuple, np.ndarray]:
    """Encode every item; returns ``{latent_key(item): latent [h, w, C] f32}``.
    Items are grouped by bucket so every ``encode_fn`` call has one shape."""
    memory: dict[tuple, np.ndarray] = {}
    by_bucket: dict[tuple[int, int], list[FileItem]] = {}
    for it in items:
        if latent_key(it) not in memory:
            by_bucket.setdefault(it.bucket, []).append(it)
    for _, bucket_items in sorted(by_bucket.items()):
        pending = list({latent_key(it): it for it in bucket_items}.values())
        for i in range(0, len(pending), batch_size):
            chunk = pending[i: i + batch_size]
            lats = np.asarray(encode_fn(np.stack([load_pixels(it) for it in chunk])), np.float32)
            for it, lat in zip(chunk, lats):
                memory[latent_key(it)] = lat
    return memory


class TextEmbedCache:
    """Memoized prompt -> conditioning dict: ``encode_fn(prompts)`` returns
    batched tensors, kept per prompt on their device."""

    def __init__(self, encode_fn: Callable[[list[str]], dict]):
        self.encode_fn = encode_fn
        self.cache: dict[str, dict[str, torch.Tensor]] = {}

    def get(self, prompts: list[str]) -> dict[str, torch.Tensor]:
        missing = list(dict.fromkeys(p for p in prompts if p not in self.cache))
        if missing:
            out = self.encode_fn(missing)
            for i, p in enumerate(missing):
                self.cache[p] = {k: v[i] for k, v in out.items() if v is not None}
        rows = [self.cache[p] for p in prompts]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
