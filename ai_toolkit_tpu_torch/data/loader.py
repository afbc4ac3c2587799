"""Data loader (``ai_toolkit_tpu/data/loader.py`` in the port): an endless
stream of bucket batches over epochs, each epoch re-shuffled and re-batched.
Batches are host numpy: latents from the in-memory latent cache or, without
one, encoded on the fly with ``encode_fn``, plus processed captions and the
per-example loss multiplier. The JAX loader's prefetch thread is not needed:
with cached latents a batch is a dictionary lookup.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from ai_toolkit_tpu_torch.config.modules import DatasetConfig
from ai_toolkit_tpu_torch.data.caching import latent_key
from ai_toolkit_tpu_torch.data.dataset import FileItem, FolderDataset, load_pixels


class DataLoader:
    def __init__(self, datasets: list[FolderDataset], batch_size: int,
                 latent_cache: dict[tuple, np.ndarray] | None = None,
                 encode_fn: Callable[[np.ndarray], np.ndarray] | None = None):
        if latent_cache is None and encode_fn is None:
            raise ValueError("need a latent cache or encode_fn (on-the-fly encoding)")
        self.datasets = datasets
        self.batch_size = batch_size
        self.latent_cache = latent_cache
        self.encode_fn = encode_fn
        self.epoch = 0

    def _load_batch(self, ds: FolderDataset, batch: list[FileItem]) -> dict:
        if self.latent_cache is not None:
            lat = np.stack([self.latent_cache[latent_key(it)] for it in batch])
        else:
            lat = np.asarray(self.encode_fn(np.stack([load_pixels(it) for it in batch])))
        cfg = ds.cfg
        mult = cfg.loss_multiplier * (cfg.network_weight if cfg.is_reg else 1.0)
        return {
            "bucket": batch[0].bucket,
            "latents": lat.astype(np.float32),
            "captions": [ds.processed_caption(it) for it in batch],
            "loss_multiplier": np.full((len(batch),), mult, np.float32),
            "is_reg": batch[0].is_reg,
        }

    def _epoch_plan(self) -> list[tuple[FolderDataset, list[FileItem]]]:
        plan = [(ds, b) for ds in self.datasets for b in ds.build_batches(self.batch_size)]
        order = np.random.default_rng(self.epoch).permutation(len(plan))
        return [plan[i] for i in order]

    def __iter__(self) -> Iterator[dict]:
        """Endless stream over epochs (the train loop counts steps)."""
        while True:
            plan = self._epoch_plan()
            self.epoch += 1
            for ds, batch in plan:
                yield self._load_batch(ds, batch)


def build_dataloader(dataset_configs: list[DatasetConfig], batch_size: int,
                     bucket_divisibility: int, trigger_word: str | None = None,
                     latent_cache: dict | None = None, encode_fn=None, seed: int = 42) -> DataLoader:
    datasets = [FolderDataset(cfg, bucket_divisibility, trigger_word, seed=seed + i)
                for i, cfg in enumerate(dataset_configs)]
    return DataLoader(datasets, batch_size, latent_cache=latent_cache, encode_fn=encode_fn)
