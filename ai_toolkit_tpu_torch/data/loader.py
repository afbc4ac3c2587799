"""Data loader (``ai_toolkit_tpu/data/loader.py`` in the port): an endless
stream of bucket batches over epochs, each epoch re-shuffled and re-batched.
Batches are host numpy: latents (an image's ``[h, w, C]``, a video's ``[T,
h, w, C]``; one bucket, kind and frame count a batch) from the in-memory
latent cache, from the disk cache's files (``latent_cache_dir``) or,
without either, encoded on the fly with ``encode_fn``, plus
processed captions and the per-example loss multiplier; with the dataset's
``do_i2v``, a video batch also carries each clip's ``first_frame`` ``[B,
H, W, 3]`` (the clip decoded again, as the JAX loader does), and with
``do_audio`` its ``audio_waveform`` ``[B, S, 2]``: each clip's sidecar
``.wav`` over the clip's duration (``audio_duration``, else frames / fps),
zeros for a clip without one (JAX ``loader.py:116-126``). An audio batch's
latents are ``[B, T, C]``. When an item of
the batch has a control image, the batch carries ``control_pixels`` ``[B, H,
W, 3]`` (zeros for an item without one), and with an inpaint image
``inpaint_keep`` ``[B, H, W, 1]`` (ones for an item without one), loaded
from their files with every batch, under either latent cache too (JAX
``loader.py:132-145``); when every item of the batch has its paired
negative image, the batch carries ``unconditional_pixels`` ``[B, H, W, 3]``
(JAX ``loader.py:129-131``), and none when one item lacks it. The JAX loader's
prefetch thread is not needed: with cached latents a batch is a dictionary
lookup. ``iter_from(n)`` starts the stream after its first ``n`` batches,
drawing their captions' random numbers but loading no latent, so a resumed
job sees the batches the uninterrupted one would have. With ``want_pixels``
an image batch also carries its ``pixels`` ``[B, H, W, 3]`` in [-1, 1], the
vision adapters' input (JAX ``loader.py:85-92``).
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from ai_toolkit_tpu_torch.config.modules import DatasetConfig
from ai_toolkit_tpu_torch.data.caching import latent_key, load_cached_latent
from ai_toolkit_tpu_torch.data.dataset import (FileItem, FolderDataset, load_control, load_inpaint_keep,
                                               load_pixels, load_sidecar_audio, load_unconditional, load_video)


class DataLoader:
    def __init__(self, datasets: list[FolderDataset], batch_size: int,
                 latent_cache: dict[tuple, np.ndarray] | None = None,
                 encode_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                 latent_cache_dir: str | None = None, want_pixels: bool = False):
        if latent_cache is None and encode_fn is None and latent_cache_dir is None:
            raise ValueError("need a latent cache, latent_cache_dir or encode_fn (on-the-fly encoding)")
        self.datasets = datasets
        self.batch_size = batch_size
        self.latent_cache = latent_cache
        self.latent_cache_dir = latent_cache_dir
        self.encode_fn = encode_fn
        self.want_pixels = want_pixels  # an image batch also carries its pixels (a vision adapter's input)
        self.epoch = 0

    def _load_batch(self, ds: FolderDataset, batch: list[FileItem]) -> dict:
        imgs = None
        if self.latent_cache_dir is not None:
            lat = np.stack([load_cached_latent(it, self.latent_cache_dir) for it in batch])
        elif self.latent_cache is not None:
            lat = np.stack([self.latent_cache[latent_key(it)] for it in batch])
        else:
            imgs = np.stack([load_pixels(it) for it in batch])
            lat = np.asarray(self.encode_fn(imgs))
        cfg = ds.cfg
        mult = cfg.loss_multiplier * (cfg.network_weight if cfg.is_reg else 1.0)
        out = {
            "bucket": batch[0].bucket,
            "latents": lat.astype(np.float32),
            "captions": [ds.processed_caption(it) for it in batch],
            "loss_multiplier": np.full((len(batch),), mult, np.float32),
            "is_reg": batch[0].is_reg,
        }
        if self.want_pixels and batch[0].kind == "image":
            out["pixels"] = imgs if imgs is not None else np.stack([load_pixels(it) for it in batch])
        if cfg.do_i2v and batch[0].kind == "video":
            out["first_frame"] = np.stack([load_video(it)[0] for it in batch])
        if cfg.do_audio and batch[0].kind == "video":
            # joint AV: the sidecar tracks over the clip's duration, zeros where a video has none
            sr = cfg.audio_sample_rate
            n = int((cfg.audio_duration or batch[0].num_frames / float(cfg.fps or 16)) * sr)
            wavs = [load_sidecar_audio(it, sr, n) for it in batch]
            out["audio_waveform"] = np.stack([np.zeros((n, 2), np.float32) if w is None else w for w in wavs])
        uncond = [load_unconditional(it) for it in batch]
        if all(u is not None for u in uncond):
            out["unconditional_pixels"] = np.stack(uncond)
        bw, bh = batch[0].bucket
        controls = [load_control(it) for it in batch]
        if any(c is not None for c in controls):
            blank = np.zeros((bh, bw, 3), np.float32)
            out["control_pixels"] = np.stack([blank if c is None else c for c in controls])
        keeps = [load_inpaint_keep(it) for it in batch]
        if any(k is not None for k in keeps):
            keep_all = np.ones((bh, bw, 1), np.float32)  # no file: keep everything
            out["inpaint_keep"] = np.stack([keep_all if k is None else k for k in keeps])
        return out

    def _epoch_plan(self) -> list[tuple[FolderDataset, list[FileItem]]]:
        plan = [(ds, b) for ds in self.datasets for b in ds.build_batches(self.batch_size)]
        order = np.random.default_rng(self.epoch).permutation(len(plan))
        return [plan[i] for i in order]

    def __iter__(self) -> Iterator[dict]:
        """Endless stream over epochs (the train loop counts steps)."""
        return self.iter_from(0)

    def iter_from(self, skip: int) -> Iterator[dict]:
        """The stream without its first ``skip`` batches; a skipped batch
        draws its captions (their random numbers) but loads nothing."""
        while True:
            plan = self._epoch_plan()
            self.epoch += 1
            for ds, batch in plan:
                if skip > 0:
                    skip -= 1
                    for it in batch:
                        ds.processed_caption(it)
                    continue
                yield self._load_batch(ds, batch)


def build_dataloader(dataset_configs: list[DatasetConfig], batch_size: int,
                     bucket_divisibility: int, trigger_word: str | None = None,
                     latent_cache: dict | None = None, encode_fn=None, seed: int = 42,
                     latent_cache_dir: str | None = None, want_pixels: bool = False) -> DataLoader:
    datasets = [FolderDataset(cfg, bucket_divisibility, trigger_word, seed=seed + i)
                for i, cfg in enumerate(dataset_configs)]
    return DataLoader(datasets, batch_size, latent_cache=latent_cache, encode_fn=encode_fn,
                      latent_cache_dir=latent_cache_dir, want_pixels=want_pixels)
