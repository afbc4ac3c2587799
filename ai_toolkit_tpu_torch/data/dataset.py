"""Folder dataset: scan, bucket, batch (``ai_toolkit_tpu/data/dataset.py`` in
the port, the image path). Every image of the folder is assigned an aspect
bucket at the dataset's resolution; batches are built per bucket, so each
batch has one latent shape.

Video, audio, masks, control / inpaint / unconditional images, augmentations,
random crops and several resolutions per dataset raise
``NotImplementedError`` naming their slice.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np

from ai_toolkit_tpu_torch.config.modules import DatasetConfig
from ai_toolkit_tpu_torch.data.buckets import get_bucket_for_image_size, resize_and_crop_size
from ai_toolkit_tpu_torch.data.captions import load_caption_pair, process_caption
from ai_toolkit_tpu_torch.utils.unported import refuse_unported

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")

# DatasetConfig options of the JAX dataset this port does not take yet
_UNPORTED_OPTIONS = ("augmentations", "clip_image_path", "clip_image_augmentations", "mask_path",
                     "inpaint_path", "unconditional_path", "control_path", "controls",
                     "random_crop", "random_scale", "alpha_mask", "do_i2v", "do_audio",
                     "use_short_captions")


@dataclass
class FileItem:
    path: str
    caption: str
    caption_short: str = ""
    width: int = 0
    height: int = 0
    bucket: tuple[int, int] = (0, 0)  # (w, h) pixel bucket
    resolution: int = 512
    is_reg: bool = False
    flip: bool = False
    flip_y: bool = False


class FolderDataset:
    """One dataset entry (one DatasetConfig)."""

    def __init__(self, cfg: DatasetConfig, bucket_divisibility: int = 16,
                 trigger_word: str | None = None, seed: int = 42):
        refuse_unported(cfg, _UNPORTED_OPTIONS, DatasetConfig(), f"dataset {cfg.folder_path}")
        if cfg.num_frames > 1:
            raise NotImplementedError("video datasets come with the video slice")
        if len(cfg.resolution) != 1:
            raise NotImplementedError(
                f"dataset resolution {cfg.resolution}: several resolutions (multi-bucket "
                f"training) come with a later slice; give one")
        self.cfg = cfg
        self.divisibility = max(bucket_divisibility,
                                cfg.bucket_tolerance if not cfg.buckets else bucket_divisibility)
        self.trigger_word = trigger_word or cfg.trigger_word
        self.rng = random.Random(seed)
        self.items: list[FileItem] = []
        self._scan()

    def _scan(self):
        from PIL import Image

        folder = self.cfg.folder_path
        if not os.path.isdir(folder):
            raise FileNotFoundError(f"dataset folder not found: {folder}")
        paths: list[str] = []
        for root, dirs, files in os.walk(folder):
            dirs[:] = sorted(d for d in dirs if d != "_controls")
            for f in sorted(files):
                lf = f.lower()
                if lf.endswith(IMAGE_EXTS):
                    paths.append(os.path.join(root, f))
                elif lf.endswith((".mp4", ".webm", ".avi", ".mov", ".wav", ".flac", ".mp3", ".ogg")):
                    raise NotImplementedError(f"{f}: video / audio datasets come with later slices")
        for p in paths:
            try:
                with Image.open(p) as im:
                    w, h = im.size
            except OSError:
                continue
            caption, caption_short = load_caption_pair(p, self.cfg.caption_ext, self.cfg.default_caption)
            for res in self.cfg.resolution:
                for _ in range(max(1, self.cfg.num_repeats)):
                    if self.cfg.enable_bucketing and self.cfg.buckets:
                        bucket = get_bucket_for_image_size(w, h, res, self.divisibility)
                    else:
                        bucket = (res, res)
                    flip = self.cfg.flip_x and self.rng.random() < 0.5
                    flip_y = self.cfg.flip_y and self.rng.random() < 0.5
                    self.items.append(FileItem(
                        path=p, caption=caption, caption_short=caption_short, width=w, height=h,
                        bucket=bucket, resolution=res, is_reg=self.cfg.is_reg, flip=flip,
                        flip_y=flip_y))

    def processed_caption(self, item: FileItem) -> str:
        return process_caption(
            item.caption,
            trigger_word=self.trigger_word,
            caption_dropout_rate=self.cfg.caption_dropout_rate,
            token_dropout_rate=self.cfg.token_dropout_rate,
            shuffle_tokens=self.cfg.shuffle_tokens or self.cfg.caption_shuffle,
            keep_tokens=self.cfg.keep_tokens,
            rng=self.rng,
        )

    def build_batches(self, batch_size: int, shuffle: bool = True) -> list[list[FileItem]]:
        """Group by bucket, batch within buckets, pad the last partial batch by
        repeating items."""
        by_bucket: dict[tuple[int, int], list[FileItem]] = {}
        for it in self.items:
            by_bucket.setdefault(it.bucket, []).append(it)
        batches = []
        for _, items in sorted(by_bucket.items()):
            if shuffle:
                self.rng.shuffle(items)
            for i in range(0, len(items), batch_size):
                chunk = items[i: i + batch_size]
                while len(chunk) < batch_size:
                    chunk = chunk + chunk[: batch_size - len(chunk)]
                batches.append(chunk)
        if shuffle:
            self.rng.shuffle(batches)
        return batches


def load_pixels(item: FileItem) -> np.ndarray:
    """The item's image decoded, cover-resized and center-cropped to its
    bucket: ``[H, W, 3]`` f32 in [-1, 1]."""
    from PIL import Image

    with Image.open(item.path) as im:
        img = im.convert("RGB")
    bw, bh = item.bucket
    rw, rh, x0, y0 = resize_and_crop_size(img.width, img.height, bw, bh)
    img = img.resize((rw, rh), Image.BICUBIC).crop((x0, y0, x0 + bw, y0 + bh))
    arr = np.asarray(img, np.float32) / 127.5 - 1.0
    if item.flip:
        arr = arr[:, ::-1]
    if item.flip_y:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)
