"""Folder dataset: scan, bucket, batch (``ai_toolkit_tpu/data/dataset.py`` in
the port, the image and video paths). Every image and video of the folder
gives one item per resolution of the dataset (and per repeat), each assigned
an aspect bucket at its resolution; batches are built per (bucket, kind,
frame count), so each batch has one latent shape. A video is
``num_frames`` frames sampled uniformly over the clip, decoded with OpenCV
(``cv2``, imported where it is used, as in the JAX package).

An image's control image (``control_path``: a folder or a list of folders,
matched by the image's file name) and inpaint image (``inpaint_path``:
matched by stem, its alpha or its inverted grey the keep mask) are loaded
per batch as JAX ``FileItem.load_control`` / ``load_inpaint_mask`` load
them: bicubic cover-resize to the bucket, center crop, the item's flips.
Only the first control of an item is read: the control archs of the port
(flex2, flux_kontext) take one, as in JAX. An image's paired negative
(``unconditional_path``: a folder, matched by the image's file name; the
slider and guidance losses' pairs) is loaded the same way
(:func:`load_unconditional`, JAX ``FileItem.load_unconditional``).

An audio file is an item of its own (``kind`` audio, bucket ``(0, 0)``,
``audio_duration`` seconds at ``audio_sample_rate``, JAX
``FileItem.load_audio``), except a ``.wav`` with a video's stem, which is
that video's sidecar track and never an item (JAX ``_scan``); with the
dataset's ``do_audio`` the loader reads it beside the video
(:func:`load_sidecar_audio`). An image's loss mask (``mask_path``: a folder,
matched by the image's file name) is read as grey in [0, 1], bicubic
cover-resized and center-cropped with its image and flipped with it
(:func:`load_mask`, JAX ``FileItem.load_mask``). Generated controls and
augmentations raise ``NotImplementedError`` naming their slice. The
options no JAX module reads (``random_crop``, ``random_scale``,
``alpha_mask``, ``mask_min_value``, ...: ``_JAX_UNREAD_OPTIONS``) are not
read here either, and each prints a line saying what the run does.
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
VIDEO_EXTS = (".mp4", ".webm", ".avi", ".mov")
AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg")

# DatasetConfig options of the JAX dataset this port does not take yet, each
# with where it comes (ROADMAP Queue 1)
_UNPORTED_OPTIONS = {
    "augmentations": "the augmentations (JAX data/augmentations.py) come with ROADMAP Queue 1 item 6h",
    "clip_image_augmentations": "the vision-encoder images' augmentations (JAX data/augmentations.py) come with "
                                "ROADMAP Queue 1 item 6h",
    "controls": "the control generator comes with ROADMAP Queue 1 item 6f",
    "use_short_captions": "the short captions come with ROADMAP Queue 1 item 5",
}
# DatasetConfig options that no module of the JAX config, loader, job, step or losses reads (a JAX
# fault each, ROADMAP Queue 3): the port reads none either, and prints what a run does instead
_JAX_UNREAD_OPTIONS = {
    "random_crop": "each image is center-cropped to its bucket",
    "random_scale": "each image is cover-resized to its bucket, unscaled",
    "alpha_mask": "no loss mask comes from the image's alpha",
    "mask_min_value": "the loss mask is clipped to [0, 1]",
    "num_workers": "the loader runs as without it",
    "shrink_video_to_frames": "a video gives num_frames frames sampled over the whole clip",
    "cache_clip_vision_to_disk": "only the adapter's cache_clip_vision_to_disk caches vision embeds",
}


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
    kind: str = "image"  # image | video | audio
    num_frames: int = 1
    num_samples: int = 0  # an audio item's sample count
    sample_rate: int = 44100  # an audio item's rate
    control_paths: tuple[str, ...] = ()  # the image's control images, one per control_path folder that has it
    inpaint_path: str | None = None  # the dataset's inpaint folder
    unconditional_path: str | None = None  # the paired negative image with the same file name
    mask_path: str | None = None  # the loss mask with the same file name (read when it exists)


class FolderDataset:
    """One dataset entry (one DatasetConfig)."""

    def __init__(self, cfg: DatasetConfig, bucket_divisibility: int = 16,
                 trigger_word: str | None = None, seed: int = 42):
        default = DatasetConfig()
        refuse_unported(cfg, _UNPORTED_OPTIONS, default, f"dataset {cfg.folder_path}")
        for name, instead in _JAX_UNREAD_OPTIONS.items():
            if getattr(cfg, name) != getattr(default, name):
                print(f"JAX fault mirrored: dataset {cfg.folder_path}: {name} {getattr(cfg, name)!r} is not read by "
                      f"the JAX loader, job or loss; {instead}")
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
        paths: list[tuple[str, str]] = []
        for root, dirs, files in os.walk(folder):
            dirs[:] = sorted(d for d in dirs if d != "_controls")
            for f in sorted(files):
                lf = f.lower()
                if lf.endswith(IMAGE_EXTS):
                    paths.append((os.path.join(root, f), "image"))
                elif lf.endswith(VIDEO_EXTS):
                    paths.append((os.path.join(root, f), "video"))
                elif lf.endswith(AUDIO_EXTS):
                    paths.append((os.path.join(root, f), "audio"))
        video_stems = {os.path.splitext(p)[0] for p, k in paths if k == "video"}
        if any(k == "audio" and os.path.splitext(p)[0] in video_stems for p, k in paths):
            # a video's sidecar audio belongs to the video, never to the item list
            if not self.cfg.do_audio:
                print(f"dataset {folder}: ignoring sidecar audio files (set do_audio: true to train the joint AV "
                      f"stream)")
            paths = [(p, k) for p, k in paths if not (k == "audio" and os.path.splitext(p)[0] in video_stems)]
        num_samples = int((self.cfg.audio_duration or 10.0) * self.cfg.audio_sample_rate)
        for p, kind in paths:
            w = h = 0
            try:
                if kind == "image":
                    with Image.open(p) as im:
                        w, h = im.size
                elif kind == "video":
                    import cv2

                    cap = cv2.VideoCapture(p)
                    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                    cap.release()
            except OSError:
                continue
            caption, caption_short = load_caption_pair(p, self.cfg.caption_ext, self.cfg.default_caption)
            ctrl = self.cfg.control_path
            controls = tuple(cp for root in (ctrl if isinstance(ctrl, list) else [ctrl] if ctrl else [])
                             if os.path.isfile(cp := os.path.join(root, os.path.basename(p))))
            uncond = (os.path.join(self.cfg.unconditional_path, os.path.basename(p))
                      if self.cfg.unconditional_path else None)
            mask = os.path.join(self.cfg.mask_path, os.path.basename(p)) if self.cfg.mask_path else None
            for res in self.cfg.resolution:
                for _ in range(max(1, self.cfg.num_repeats)):
                    if kind == "audio":
                        bucket = (0, 0)
                    elif self.cfg.enable_bucketing and self.cfg.buckets and w and h:
                        bucket = get_bucket_for_image_size(w, h, res, self.divisibility)
                    else:
                        bucket = (res, res)
                    flip = kind != "audio" and self.cfg.flip_x and self.rng.random() < 0.5
                    flip_y = kind != "audio" and self.cfg.flip_y and self.rng.random() < 0.5
                    self.items.append(FileItem(
                        path=p, caption=caption, caption_short=caption_short, width=w, height=h,
                        bucket=bucket, resolution=res, is_reg=self.cfg.is_reg, flip=flip,
                        flip_y=flip_y, kind=kind, num_frames=self.cfg.num_frames if kind == "video" else 1,
                        control_paths=controls, inpaint_path=self.cfg.inpaint_path,
                        unconditional_path=uncond if uncond and os.path.isfile(uncond) else None,
                        mask_path=mask,
                        num_samples=num_samples if kind == "audio" else 0, sample_rate=self.cfg.audio_sample_rate))

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
        """Group by (bucket, kind, frame count), batch within groups, pad the
        last partial batch by repeating items."""
        by_bucket: dict[tuple, list[FileItem]] = {}
        for it in self.items:
            by_bucket.setdefault((it.bucket, it.kind, it.num_frames), []).append(it)
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


def _fit_to_bucket(item: FileItem, img):
    """A PIL image cover-resized (bicubic, in its own mode) and center-cropped
    to the item's bucket (JAX ``FileItem.load_image``)."""
    from PIL import Image

    bw, bh = item.bucket
    rw, rh, x0, y0 = resize_and_crop_size(img.width, img.height, bw, bh)
    return img.resize((rw, rh), Image.BICUBIC).crop((x0, y0, x0 + bw, y0 + bh))


def _flipped(item: FileItem, arr: np.ndarray) -> np.ndarray:
    if item.flip:
        arr = arr[:, ::-1]
    if item.flip_y:
        arr = arr[::-1]
    return np.ascontiguousarray(arr)


def _rgb(item: FileItem, path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        img = im.convert("RGB")
    return _flipped(item, np.asarray(_fit_to_bucket(item, img), np.float32) / 127.5 - 1.0)


def load_pixels(item: FileItem) -> np.ndarray:
    """The item's image ``[H, W, 3]`` or video ``[T, H, W, 3]``, decoded,
    cover-resized and center-cropped to its bucket, f32 in [-1, 1]; an audio
    item's waveform ``[S, 2]`` (:func:`load_audio`)."""
    if item.kind == "audio":
        return load_audio(item.path, item.sample_rate, item.num_samples or None)
    return load_video(item) if item.kind == "video" else _rgb(item, item.path)


def load_audio(path: str, sample_rate: int = 44100, num_samples: int | None = None) -> np.ndarray:
    """A wav file as ``[S, C]`` f32 in [-1, 1] at ``sample_rate`` (JAX
    ``FileItem.load_audio``): integer PCM over its type's max, unsigned
    around 128, mono doubled to stereo, another rate resampled by linear
    ``np.interp`` over the clip, then cropped or zero-padded to
    ``num_samples``."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        data = (data.astype(np.float32) - 128) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = np.stack([data, data], axis=-1)
    if sr != sample_rate:
        n_out = int(len(data) * sample_rate / sr)
        x_old, x_new = np.linspace(0, 1, len(data)), np.linspace(0, 1, n_out)
        data = np.stack([np.interp(x_new, x_old, data[:, c]) for c in range(data.shape[1])], -1)
    if num_samples:
        data = data[:num_samples] if len(data) >= num_samples else np.pad(data, ((0, num_samples - len(data)), (0, 0)))
    return data.astype(np.float32)


def load_sidecar_audio(item: FileItem, sample_rate: int, num_samples: int) -> np.ndarray | None:
    """A video's track: the ``.wav`` with its stem beside it, as
    :func:`load_audio` gives it, or None (JAX ``FileItem.load_sidecar_audio``)."""
    p = os.path.splitext(item.path)[0] + ".wav"
    return load_audio(p, sample_rate, num_samples) if os.path.isfile(p) else None


def load_control(item: FileItem) -> np.ndarray | None:
    """The item's first control image at its bucket, f32 ``[H, W, 3]`` in
    [-1, 1] (JAX ``FileItem.load_control``), or None without one."""
    return _rgb(item, item.control_paths[0]) if item.control_paths else None


def load_controls(item: FileItem) -> list[np.ndarray]:
    """Every control image of the item, one per control folder that has it
    (JAX ``FileItem.load_controls``)."""
    return [_rgb(item, p) for p in item.control_paths]


def load_unconditional(item: FileItem) -> np.ndarray | None:
    """The item's paired negative image at its bucket, f32 ``[H, W, 3]`` in
    [-1, 1], with the item's flips (JAX ``FileItem.load_unconditional``), or
    None without one."""
    return _rgb(item, item.unconditional_path) if item.unconditional_path else None


def load_mask(item: FileItem) -> np.ndarray | None:
    """The item's loss mask ``[H, W, 1]`` f32 in [0, 1]: its grey, bicubic
    cover-resized and center-cropped to the bucket, with the item's flips
    (JAX ``FileItem.load_mask``); None when the file is not there."""
    if not item.mask_path or not os.path.isfile(item.mask_path):
        return None
    from PIL import Image

    with Image.open(item.mask_path) as im:
        m = _fit_to_bucket(item, im.convert("L"))
    return _flipped(item, np.asarray(m, np.float32) / 255.0)[..., None]


def load_inpaint_keep(item: FileItem) -> np.ndarray | None:
    """The keep mask ``[H, W, 1]`` in [0, 1] (1 = keep) from the inpaint
    folder's image with the item's stem (JAX ``FileItem.load_inpaint_mask``):
    resized in its own mode, then an RGBA image's alpha, else 1 - its grey
    (white marks the region to inpaint); None without one."""
    if not item.inpaint_path:
        return None
    import glob

    from PIL import Image

    stem = os.path.splitext(os.path.basename(item.path))[0]
    cands = [c for c in sorted(glob.glob(os.path.join(item.inpaint_path, stem + ".*")))
             if os.path.splitext(c)[1].lower() in IMAGE_EXTS]
    if not cands:
        return None
    with Image.open(cands[0]) as im:
        img = _fit_to_bucket(item, im)
    if img.mode == "RGBA":
        keep = np.asarray(img.split()[-1], np.float32) / 255.0
    else:
        keep = 1.0 - np.asarray(img.convert("L"), np.float32) / 255.0
    return _flipped(item, keep)[..., None]


def load_video(item: FileItem) -> np.ndarray:
    """``item.num_frames`` frames sampled uniformly over the clip (the last
    decoded frame repeated when the clip runs short), each cover-resized with
    bicubic and center-cropped to the bucket: ``[T, H, W, 3]`` f32 in [-1, 1]
    (JAX ``FileItem.load_video``)."""
    import cv2

    cap = cv2.VideoCapture(item.path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 1
    want = item.num_frames
    counts: dict[int, int] = {}
    for i in np.linspace(0, max(total - 1, 0), want).round().astype(int):
        counts[int(i)] = counts.get(int(i), 0) + 1
    frames, last, i = [], None, 0
    ok, frame = cap.read()
    while ok and len(frames) < want:
        frames += [frame] * counts.get(i, 0)
        last = frame
        i += 1
        ok, frame = cap.read()
    cap.release()
    while len(frames) < want:
        frames.append(last if last is not None else np.zeros((8, 8, 3), np.uint8))
    bw, bh = item.bucket
    out = []
    for f in frames:
        f = cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
        fh, fw = f.shape[:2]
        rw, rh, x0, y0 = resize_and_crop_size(fw, fh, bw, bh)
        out.append(cv2.resize(f, (rw, rh), interpolation=cv2.INTER_CUBIC)[y0:y0 + bh, x0:x0 + bw])
    arr = np.stack(out).astype(np.float32) / 127.5 - 1.0
    if item.flip:
        arr = arr[:, :, ::-1]
    if item.flip_y:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)
