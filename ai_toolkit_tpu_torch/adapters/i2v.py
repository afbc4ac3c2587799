"""The i2v adapter (``ai_toolkit_tpu/adapters/i2v.py`` in PyTorch): turn a
frozen Wan text-to-video DiT into an image-to-video one.

Three trainable pieces are grafted onto the t2v DiT (:func:`graft_i2v`):
each block's decoupled image K/V on its cross-attention (``attn2.add_k_proj``
/ ``add_v_proj``, kernels scaled by :data:`I2V_ADD_KV_SCALE`, and the K norm
``norm_added_k``), the image MLP ``condition_embedder.image_embedder``, and,
with ``i2v_do_start_frame``, the frame embedder: an ``ops.layers.Ctrl`` on
``patch_embedding`` over the first-frame conditioning (the VAE's temporal
downscale of mask channels and the latents of ``[first frame, zeros...]``,
:func:`assemble_first_frame_control`), patchified on its own and
feature-concatenated with the noisy latents' tokens. The grafted leaves are
the parameters a fresh i2v DiT has and the t2v one lacks (JAX
``new_leaves``), seeded from the job's generator, trained as f32 masters
cast to the DiT's dtype, as JAX trains its f32 overlay.

The save holds, beside the LoRA, the reference's ``attn_hog.{i}.*``,
``image_embedder.*`` and ``frame_embedder.*`` keys in the torch layout, f32
(:func:`i2v_extra_flat`; :func:`load_i2v_from_flat` reads them back).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ai_toolkit_tpu_torch.ops.layers import Ctrl, Linear, RMSNorm, init_parameters

I2V_ADD_KV_SCALE = 1e-3  # the fresh image K/V kernels' scale

# a grafted block parameter (under ``blocks.{i}.attn2.``) -> (the reference key under ``attn_hog.{i}.``,
# the JAX DiT's module and leaf)
_BLOCK_KEYS = {
    "add_k_proj.weight": ("add_k_proj.weight", "cross_k_img", "kernel"),
    "add_k_proj.bias": ("add_k_proj.bias", "cross_k_img", "bias"),
    "add_v_proj.weight": ("add_v_proj.weight", "cross_v_img", "kernel"),
    "add_v_proj.bias": ("add_v_proj.bias", "cross_v_img", "bias"),
    "norm_added_k.weight": ("norm_added_k.weight", "cross_k_img_norm", "scale"),
}
# a grafted image-MLP parameter (under ``condition_embedder.image_embedder.``) -> (the reference key
# under ``image_embedder.``, the JAX module and leaf)
_EMBEDDER_KEYS = {
    "norm1.weight": ("norm1.weight", "img_emb_norm1", "scale"),
    "norm1.bias": ("norm1.bias", "img_emb_norm1", "bias"),
    "ff.net.0.proj.weight": ("ff.net.0.proj.weight", "img_emb_in", "kernel"),
    "ff.net.0.proj.bias": ("ff.net.0.proj.bias", "img_emb_in", "bias"),
    "ff.net.2.weight": ("ff.net.2.weight", "img_emb_out", "kernel"),
    "ff.net.2.bias": ("ff.net.2.bias", "img_emb_out", "bias"),
    "norm2.weight": ("norm2.weight", "img_emb_norm2", "scale"),
    "norm2.bias": ("norm2.bias", "img_emb_norm2", "bias"),
}
_EMBEDDER = "condition_embedder.image_embedder."


def jax_leaf_path(name: str) -> tuple[str, ...]:
    """The JAX path (unrolled layout) of a grafted parameter's port name, as in
    ``new_leaves``' tree: ``blocks.3.attn2.add_k_proj.weight`` ->
    ``("block_3", "cross_k_img", "kernel")``."""
    if name.startswith(_EMBEDDER):
        _, module, leaf = _EMBEDDER_KEYS[name[len(_EMBEDDER):]]
        return module, leaf
    _, i, rest = name.split(".", 2)
    _, module, leaf = _BLOCK_KEYS[rest[len("attn2."):]]
    return f"block_{i}", module, leaf


def graft_i2v(dit: torch.nn.Module, generator: torch.Generator) -> dict[str, torch.nn.Parameter]:
    """Make the t2v ``WanDiT`` ``dit`` an i2v one in place: the image K/V and
    its norm on every block's cross-attention and the image MLP, seeded from
    ``generator`` with the JAX package's initializers (``lecun_normal``
    kernels, zero biases, unit scales), the K/V kernels times
    :data:`I2V_ADD_KV_SCALE`; every grafted Linear keeps an f32 master. Returns
    the grafted parameters by name: those the i2v DiT has and the t2v one
    lacks (JAX ``new_leaves``)."""
    from ai_toolkit_tpu_torch.models.wan_dit import WanImageEmbedding

    cfg = dit.cfg
    if cfg.i2v:
        raise ValueError("i2v adapter needs a t2v base; this DiT already takes image tokens")
    cfg = dataclasses.replace(cfg, i2v=True)
    dev = dit.patch_embedding.stored_weight.device
    before = {n for n, _ in dit.named_parameters()}
    dit.cfg = cfg
    d, dt = cfg.dim, cfg.dtype
    linears = []
    with torch.no_grad():
        for blk in dit.blocks:
            blk.cfg = cfg
            attn = blk.attn2
            attn.add_k_proj = Linear(d, d, device=dev, dtype=dt)
            attn.add_v_proj = Linear(d, d, device=dev, dtype=dt)
            attn.norm_added_k = RMSNorm(d, device=dev)
            for m in (attn.add_k_proj, attn.add_v_proj, attn.norm_added_k):
                init_parameters(m, generator)
            for m in (attn.add_k_proj, attn.add_v_proj):
                m.weight.mul_(I2V_ADD_KV_SCALE)
            linears += [attn.add_k_proj, attn.add_v_proj]
        emb = init_parameters(WanImageEmbedding(cfg, device=dev), generator)
        dit.condition_embedder.image_embedder = emb
        linears += [emb.ff.net[0].proj, emb.ff.net[2]]
    for m in linears:
        m.keep_f32_master()
    grafted = {n: p for n, p in dit.named_parameters() if n not in before}
    for p in grafted.values():
        p.requires_grad_(True)
    return grafted


def init_frame_embedder_ctrl(dim: int, latent_channels: int, patch_size: tuple[int, int, int],
                             generator: torch.Generator, mask_channels: int = 4, device=None) -> Ctrl:
    """The frame embedder as an expansion on ``patch_embedding``: ``extra_in =
    (mask_channels + latent_channels) * pt * ph * pw`` features, position-major
    (``wan_patchify``'s order); ``w`` ``N(0, 1) / sqrt(extra_in)``, ``b`` 0."""
    pt, ph, pw = patch_size
    extra_in = (mask_channels + latent_channels) * pt * ph * pw
    w = torch.empty(extra_in, dim, dtype=torch.float32, device=device).normal_(0.0, 1.0, generator=generator)
    return Ctrl(w / math.sqrt(extra_in), torch.zeros(dim, dtype=torch.float32, device=device))


def assemble_first_frame_control(first_frame: np.ndarray, num_latent_frames: int, encode_fn,
                                 temporal_downscale: int = 4) -> np.ndarray:
    """The first-frame conditioning ``[B, T, h, w, td + C]``: the latents of
    ``[first frame, zeros x (F - 1)]`` (``encode_fn``: pixels ``[B, F, H, W,
    3]`` -> latents ``[B, T, h, w, C]``) behind a ``td``-channel mask that is 1
    on latent frame 0 (JAX ``assemble_first_frame_control``)."""
    b = first_frame.shape[0]
    td = temporal_downscale
    num_frames = (num_latent_frames - 1) * td + 1
    video = np.zeros((b, num_frames) + first_frame.shape[1:], np.float32)
    video[:, 0] = first_frame
    lat = np.asarray(encode_fn(video), np.float32)
    mask = np.zeros(lat.shape[:-1] + (td,), np.float32)
    mask[:, 0] = 1.0
    return np.concatenate([mask, lat], axis=-1)


def _f32(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32))


def i2v_extra_flat(grafted: dict[str, torch.Tensor], ctrl_w: torch.Tensor | None = None,
                   ctrl_b: torch.Tensor | None = None,
                   patch_size: tuple[int, int, int] = (1, 2, 2)) -> dict[str, np.ndarray]:
    """The grafted pieces in the reference's keys, f32, the torch layout
    (JAX ``i2v_extra_flat``): ``attn_hog.{i}.add_k_proj`` / ``add_v_proj`` /
    ``norm_added_k`` and an identity ``norm_added_q``, ``image_embedder.*``,
    and with the frame embedder ``frame_embedder.patch_embedding.weight``
    ``[dim, cin, pt, ph, pw]`` and its bias. ``grafted``: ``{port name:
    tensor}`` as :func:`graft_i2v` names them."""
    flat: dict[str, np.ndarray] = {}
    blocks = sorted({int(n.split(".")[1]) for n in grafted if n.startswith("blocks.")})
    for i in blocks:
        for ours, (theirs, _, _) in _BLOCK_KEYS.items():
            flat[f"attn_hog.{i}.{theirs}"] = _f32(grafted[f"blocks.{i}.attn2.{ours}"])
        d = flat[f"attn_hog.{i}.norm_added_k.weight"].shape[0]
        flat[f"attn_hog.{i}.norm_added_q.weight"] = np.ones((d,), np.float32)
    for ours, (theirs, _, _) in _EMBEDDER_KEYS.items():
        flat[f"image_embedder.{theirs}"] = _f32(grafted[_EMBEDDER + ours])
    if ctrl_w is not None:
        pt, ph, pw = patch_size
        w = _f32(ctrl_w)  # [(pt*ph*pw)*cin, d], position-major
        d = w.shape[1]
        cin = w.shape[0] // (pt * ph * pw)
        flat["frame_embedder.patch_embedding.weight"] = np.ascontiguousarray(
            w.reshape(pt, ph, pw, cin, d).transpose(4, 3, 0, 1, 2))
        flat["frame_embedder.patch_embedding.bias"] = _f32(ctrl_b)
    return flat


def load_i2v_from_flat(flat: dict[str, np.ndarray], patch_size: tuple[int, int, int] = (1, 2, 2)
                       ) -> tuple[dict[str, np.ndarray], tuple[np.ndarray, np.ndarray] | None]:
    """The inverse of :func:`i2v_extra_flat`: ``({port name: array},
    (ctrl w, ctrl b) or None)``."""
    grafted: dict[str, np.ndarray] = {}
    blocks = sorted({int(k.split(".")[1]) for k in flat if k.startswith("attn_hog.")})
    for i in blocks:
        for ours, (theirs, _, _) in _BLOCK_KEYS.items():
            grafted[f"blocks.{i}.attn2.{ours}"] = np.asarray(flat[f"attn_hog.{i}.{theirs}"])
    for ours, (theirs, _, _) in _EMBEDDER_KEYS.items():
        grafted[_EMBEDDER + ours] = np.asarray(flat[f"image_embedder.{theirs}"])
    ctrl = None
    if "frame_embedder.patch_embedding.weight" in flat:
        pt, ph, pw = patch_size
        conv = np.asarray(flat["frame_embedder.patch_embedding.weight"])
        d, cin = conv.shape[0], conv.shape[1]
        w = conv.transpose(2, 3, 4, 1, 0).reshape(pt * ph * pw * cin, d)
        ctrl = (np.ascontiguousarray(w), np.asarray(flat["frame_embedder.patch_embedding.bias"]))
    return grafted, ctrl
