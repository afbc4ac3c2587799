"""The control-LoRA adapter (``ai_toolkit_tpu/adapters/control_lora.py`` in
PyTorch): train a control LoRA on a base flux DiT.

The control image is VAE-encoded, packed and channel-concatenated with the
noisy latents; ``img_in`` grows a full-rank input expansion over the new
channels (an ``ops.layers.Ctrl`` on the Linear, ``N(0, 1) * 0.01``), and a
LoRA covers the rest of the DiT (``img_in`` excluded). With
``has_inpainting_input`` the one control is ``[masked latents, mask]``
(:func:`assemble_inpaint_control`, host numpy, the JAX function's draws).

The save holds the LoRA in the flux layout and the expansion under
``transformer.x_embedder.weight`` (``[out, extra_in]``, the torch layout):
:func:`control_lora_extra_flat`, read back by
:func:`load_control_lora_expansion` and resized by :func:`upgrade_expansion`.
"""

from __future__ import annotations

import numpy as np
import torch

X_EMBEDDER_KEY = "transformer.x_embedder.weight"
X_EMBEDDER_BIAS = "transformer.x_embedder.bias"


def control_lora_extra_channels(base_packed_channels: int, num_control_images: int,
                                has_inpainting_input: bool) -> int:
    """The expansion's packed input width: ``base * num_control_images``, or
    ``base + 4`` for the inpainting input (masked latents and the one-channel
    mask, packed 2x2)."""
    if has_inpainting_input:
        return base_packed_channels + 4
    return base_packed_channels * num_control_images


def init_control_lora(hidden: int, base_packed_channels: int, generator: torch.Generator,
                      num_control_images: int = 1, has_inpainting_input: bool = False,
                      device=None) -> torch.Tensor:
    """The expansion ``w`` ``[extra_in, hidden]`` f32, ``N(0, 1) * 0.01`` from
    ``generator`` (JAX ``init_control_lora``)."""
    if has_inpainting_input and num_control_images != 1:
        raise ValueError("control_lora: has_inpainting_input requires num_control_images=1 (the inpaint latent "
                         "is the control)")
    extra_in = control_lora_extra_channels(base_packed_channels, num_control_images, has_inpainting_input)
    w = torch.empty(extra_in, hidden, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w * 0.01


def assemble_inpaint_control(latents: np.ndarray, keep_mask_px: np.ndarray | None, host_rng: np.random.Generator,
                             control_image_dropout: float = 0.0,
                             invert_inpaint_mask_chance: float = 0.0) -> np.ndarray:
    """The train-time inpainting control ``[B, h, w, C + 1]``: [masked latents,
    mask] (mask 1 = inpaint), with random blobs when no mask is given and the
    dropout layout (zero latents, all-ones mask); ``host_rng`` drawn in the JAX
    function's order, so equal generators give equal tensors bit for bit."""
    from ai_toolkit_tpu_torch.models.flux_model import _random_blob_mask

    b, h, w, c = latents.shape
    lat = np.asarray(latents, np.float32)
    do_dropout = host_rng.random() < float(control_image_dropout)
    keep = None
    if keep_mask_px is not None and not do_dropout:
        import cv2

        keep = np.stack([cv2.resize(m[..., 0], (w, h), interpolation=cv2.INTER_LINEAR)
                         for m in np.asarray(keep_mask_px, np.float32)])[..., None]
    if keep is None and not do_dropout:
        keep = 1.0 - _random_blob_mask(b, h, w, host_rng)
    if keep is not None and not do_dropout:
        if invert_inpaint_mask_chance > 0.0 and host_rng.random() < float(invert_inpaint_mask_chance):
            keep = 1.0 - keep
        return np.concatenate([lat * keep, 1.0 - keep], axis=-1)
    return np.concatenate([np.zeros_like(lat), np.ones((b, h, w, 1), np.float32)], axis=-1)


def assemble_control(latents: np.ndarray, host_rng: np.random.Generator, num_control: int, dropout: float,
                     encode_one=None, encode_multi=None) -> np.ndarray:
    """The non-inpainting control ``[B, h, w, C * num_control]`` (JAX
    ``_prepare_batch``'s control_lora branch): zeros when the dropout draw
    hits or the batch has no control image; else the encoded controls
    channel-concatenated, the slots past those the batch has left zero.
    ``encode_one()`` gives the batch's first control latents ``[B, h, w,
    C]``; ``encode_multi()`` its several ``[B, n, h, w, C]`` (None when the
    batch has no control image or only one slot)."""
    b, h, w, c = latents.shape
    drop = host_rng.random() < dropout
    if drop or encode_one is None:
        return np.zeros((b, h, w, c * num_control), np.float32)
    if num_control > 1 and encode_multi is not None:
        per = np.asarray(encode_multi(num_control), np.float32)  # [B, n_have, h, w, C]
        n_have = per.shape[1]
        out = np.moveaxis(per, 1, 3).reshape(b, h, w, n_have * c)
        if n_have < num_control:
            out = np.concatenate([out, np.zeros((b, h, w, (num_control - n_have) * c), np.float32)], axis=-1)
        return out
    one = np.asarray(encode_one(), np.float32)
    return one if num_control == 1 else np.concatenate([one] + [np.zeros_like(one)] * (num_control - 1), axis=-1)


def control_lora_extra_flat(w: torch.Tensor, b: torch.Tensor | None = None) -> dict[str, np.ndarray]:
    """The expansion in the save layout: ``w`` ``[extra_in, out]`` as the torch
    ``[out, extra_in]`` weight, contiguous, f32 (and the bias)."""
    out = {X_EMBEDDER_KEY: np.ascontiguousarray(w.detach().float().cpu().numpy().T)}
    if b is not None:
        out[X_EMBEDDER_BIAS] = b.detach().float().cpu().numpy()
    return out


def load_control_lora_expansion(path: str) -> dict[str, np.ndarray] | None:
    """The expansion of a save file as ``{"w": [extra_in, out][, "b"]}``, or
    None when the file has no expansion (a plain LoRA file)."""
    from safetensors import safe_open

    with safe_open(path, framework="numpy") as f:
        keys = set(f.keys())
        if X_EMBEDDER_KEY not in keys:
            return None
        entry = {"w": np.ascontiguousarray(f.get_tensor(X_EMBEDDER_KEY).T)}
        if X_EMBEDDER_BIAS in keys:
            entry["b"] = f.get_tensor(X_EMBEDDER_BIAS)
    return entry


def upgrade_expansion(loaded_w: np.ndarray, extra_in: int) -> np.ndarray:
    """Resize a read expansion's input dim to ``extra_in``: doubled by tiling
    until it is at least as wide, then truncated."""
    w = np.asarray(loaded_w)
    while w.shape[0] < extra_in:
        w = np.concatenate([w, w], axis=0)
    return w[:extra_in]
