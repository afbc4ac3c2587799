"""Latent and text-embedding caches (``ai_toolkit_tpu/data/caching.py`` in the
port): every item is VAE-encoded once, one encode call per chunk of one
bucket, kind and frame count (an image latent ``[h, w, C]``, a video latent
``[T, h, w, C]``, an audio latent ``[T, C]``: the model's ``encode_images``
takes waveforms too, as JAX's ``encode_images = encode_audio`` alias does), and kept in memory (:func:`cache_latents`) or on disk
(:func:`cache_latents_to_disk`, the job's ``cache_latents_to_disk``: one
safetensors file of the fp16 latent per item, named by the md5 of the
file's path, mtime, size and the item's bucket, flip and frame count, as
the JAX cache names it; a file that is there is read, not encoded again).
Prompts are encoded once per distinct caption."""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Iterable

import numpy as np
import torch

from ai_toolkit_tpu_torch.data.dataset import FileItem, load_pixels


def latent_key(item: FileItem) -> tuple:
    return (item.path, item.bucket, item.flip, item.flip_y, item.num_frames)


def _cache_key(item: FileItem, version: str) -> str:
    """JAX ``_cache_key`` (``num_samples``, an audio item's sample count, is 0
    for images and videos). JAX leaves ``flip_y`` out, so two repeats of one file
    flipped differently would share a file; the port adds it when it is set."""
    st = os.stat(item.path)
    raw = (f"{item.path}|{st.st_mtime_ns}|{st.st_size}|{item.bucket}|{item.flip}|"
           f"{item.num_frames}|{item.num_samples}|{version}")
    if item.flip_y:
        raw += "|flip_y"
    return hashlib.md5(raw.encode()).hexdigest()


def latent_cache_path(item: FileItem, cache_dir: str, version: str = "v1") -> str:
    return os.path.join(cache_dir, f"{_cache_key(item, version)}.safetensors")


def load_cached_latent(item: FileItem, cache_dir: str, version: str = "v1") -> np.ndarray:
    from safetensors.numpy import load_file

    return load_file(latent_cache_path(item, cache_dir, version))["latent"].astype(np.float32)


def cache_latents_to_disk(items: Iterable[FileItem], encode_fn: Callable[[np.ndarray], np.ndarray],
                          cache_dir: str, batch_size: int = 8, version: str = "v1") -> tuple[int, int]:
    """Encode every item that has no file under ``cache_dir`` yet and write
    its latent there in fp16 (JAX ``cache_latents``); returns (items
    encoded, items found on disk), each file counted once."""
    from safetensors.numpy import save_file

    os.makedirs(cache_dir, exist_ok=True)
    by_bucket: dict[tuple, dict[str, FileItem]] = {}
    for it in items:
        by_bucket.setdefault((it.bucket, it.kind, it.num_frames), {})[latent_cache_path(it, cache_dir, version)] = it
    encoded = hits = 0
    for _, paths in sorted(by_bucket.items()):
        pending = [(p, it) for p, it in paths.items() if not os.path.isfile(p)]
        hits += len(paths) - len(pending)
        for i in range(0, len(pending), batch_size):
            chunk = pending[i: i + batch_size]
            lats = np.asarray(encode_fn(np.stack([load_pixels(it) for _, it in chunk])))
            for (p, _), lat in zip(chunk, lats):
                tmp = p + ".tmp"
                save_file({"latent": lat.astype(np.float16)}, tmp)
                os.replace(tmp, p)
            encoded += len(chunk)
    return encoded, hits


def cache_latents(items: Iterable[FileItem], encode_fn: Callable[[np.ndarray], np.ndarray],
                  batch_size: int = 8) -> dict[tuple, np.ndarray]:
    """Encode every item; returns ``{latent_key(item): latent f32}``. Items are
    grouped by (bucket, kind, frame count) so every ``encode_fn`` call has one
    shape."""
    memory: dict[tuple, np.ndarray] = {}
    by_bucket: dict[tuple, list[FileItem]] = {}
    for it in items:
        if latent_key(it) not in memory:
            by_bucket.setdefault((it.bucket, it.kind, it.num_frames), []).append(it)
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
