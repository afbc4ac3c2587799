"""The NextDiT transformer of Lumina-Image-2.0 (``ai_toolkit_tpu/models/lumina2_dit.py``
in PyTorch), diffusers ``Lumina2Transformer2DModel``, and its blocks, which
OmniGen2 builds on (``models/omnigen2_dit.py``).

Modules carry the diffusers names (``layers.{i}.attn.to_q``,
``layers.{i}.feed_forward.linear_1``, ``layers.{i}.norm1.linear``,
``context_refiner.{i}.norm1``, ``time_caption_embed.caption_embedder.1``,
``norm_out.linear_2``), so a diffusers state dict loads as it is. One block:
GQA attention (24 / 8 heads of 96) with per-head RMS q/k norms before an
interleaved-pair rope in f32, and a SwiGLU; the modulated block scales its
norms by ``1 + scale`` and adds ``tanh(gate) * norm(out)`` in f32 (4 chunks
of ``norm1.linear(silu(temb))``), the caption refiners have no modulation.
Rope ids: caption token i gets (i, i, i) in every padded slot; an image
token (r, c) gets (that sample's caption length, r, c). The caption
refiners run under a key mask of the caption, the noise refiners with no
mask, the joint ``[caption | image]`` stack under the caption's key mask;
every mask (and the head dims 96 and 120) sends attention to the plain
path, as the JAX package sends it to XLA: no flash kernel runs here.
With ``gradient_checkpointing`` each joint block is recomputed in the
backward from its inputs (JAX ``remat`` on the joint stack).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.embeddings import timestep_embedding
from ai_toolkit_tpu_torch.ops.layers import LayerNorm, Linear, RMSNorm, lora_checkpoint


@dataclass(frozen=True)
class Lumina2Config:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    dim: int = 2304
    n_layers: int = 26
    n_refiner_layers: int = 2
    n_heads: int = 24
    n_kv_heads: int = 8
    cap_feat_dim: int = 2304  # Gemma2-2B's width
    ffn_hidden: int = 6144  # 256 * ceil(2/3 * 4 * 2304 / 256)
    axes_dims: tuple[int, ...] = (32, 32, 32)
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    adaln_embed_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def adaln_dim(self) -> int:
        return min(self.dim, self.adaln_embed_dim)

    @classmethod
    def tiny(cls, **kw) -> "Lumina2Config":
        base = dict(in_channels=4, out_channels=4, dim=32, n_layers=2, n_refiner_layers=1, n_heads=2,
                    n_kv_heads=1, cap_feat_dim=24, ffn_hidden=64, axes_dims=(4, 6, 6), dtype=torch.float32)
        base.update(kw)
        return cls(**base)


def _omegas(cfg, device) -> list[torch.Tensor]:
    return [1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
            for d in cfg.axes_dims]


def caption_angles(cfg, b: int, t_max: int, device) -> torch.Tensor:
    """``[B, t_max, hd/2]``: caption slot i at ids (i, i, i), padded slots too."""
    ti = torch.arange(t_max, dtype=torch.float32, device=device)
    return torch.cat([(ti[:, None] * o[None]).expand(b, t_max, -1) for o in _omegas(cfg, device)], dim=-1)


def grid_angles(cfg, hp: int, wp: int, shift: torch.Tensor) -> torch.Tensor:
    """``[B, hp*wp, hd/2]``: token (r, c) at ids (shift[b], r, c)."""
    o0, o1, o2 = _omegas(cfg, shift.device)
    yy, xx = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=shift.device),
                            torch.arange(wp, dtype=torch.float32, device=shift.device), indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    b, n = shift.shape[0], hp * wp
    return torch.cat([shift.float()[:, None, None] * o0[None, None, :] * torch.ones((1, n, 1), device=shift.device),
                      (yy[:, None] * o1[None]).expand(b, n, -1), (xx[:, None] * o2[None]).expand(b, n, -1)], dim=-1)


def lumina2_pos_angles(cfg, hp: int, wp: int, cap_lens: torch.Tensor, t_max: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rope angles ``(caption [B, t_max, hd/2], image [B, hp*wp, hd/2])``:
    the image's first axis is each sample's caption length."""
    return caption_angles(cfg, cap_lens.shape[0], t_max, cap_lens.device), grid_angles(cfg, hp, wp, cap_lens)


def apply_rope(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs ``(x[2i], x[2i+1])`` of ``x [B, S, H, D]``
    by ``ang [B, S, D/2]``, in f32, cast back (diffusers lumina
    ``apply_rotary_emb``)."""
    xf = x.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    c, s = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    return torch.stack([xe * c - xo * s, xe * s + xo * c], dim=-1).reshape(x.shape).to(x.dtype)


class Lumina2Attention(nn.Module):
    """diffusers ``Attention`` with per-head RMS ``norm_q`` / ``norm_k`` and
    GQA, as the lumina2 processor drives it."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, dt, hd = cfg.dim, cfg.dtype, cfg.head_dim
        self.n_heads, self.n_kv, self.hd = cfg.n_heads, cfg.n_kv_heads, hd
        self.to_q = Linear(d, cfg.n_heads * hd, bias=False, device=device, dtype=dt)
        self.to_k = Linear(d, cfg.n_kv_heads * hd, bias=False, device=device, dtype=dt)
        self.to_v = Linear(d, cfg.n_kv_heads * hd, bias=False, device=device, dtype=dt)
        self.to_out = nn.ModuleList([Linear(cfg.n_heads * hd, d, bias=False, device=device, dtype=dt)])
        self.norm_q = RMSNorm(hd, eps=cfg.norm_eps, device=device)
        self.norm_k = RMSNorm(hd, eps=cfg.norm_eps, device=device)

    def forward(self, x, ang, mask):
        q = self.norm_q(self.to_q(x).unflatten(-1, (self.n_heads, self.hd)))
        k = self.norm_k(self.to_k(x).unflatten(-1, (self.n_kv, self.hd)))
        v = self.to_v(x).unflatten(-1, (self.n_kv, self.hd))
        q, k = apply_rope(q, ang), apply_rope(k, ang)
        if self.n_kv != self.n_heads:  # GQA: repeat the kv heads
            rep = self.n_heads // self.n_kv
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        return self.to_out[0](dot_product_attention(q, k, v, mask=mask).flatten(2))


class LuminaFeedForward(nn.Module):
    """``linear_2(silu(linear_1(x)) * linear_3(x))``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d, h, dt = cfg.dim, cfg.ffn_hidden, cfg.dtype
        self.linear_1 = Linear(d, h, bias=False, device=device, dtype=dt)
        self.linear_2 = Linear(h, d, bias=False, device=device, dtype=dt)
        self.linear_3 = Linear(d, h, bias=False, device=device, dtype=dt)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)) * self.linear_3(x))


class LuminaRMSNormZero(nn.Module):
    """``norm1`` of a modulated block: ``linear`` (adaLN, 4 chunks) and ``norm``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.linear = Linear(cfg.adaln_dim, 4 * cfg.dim, device=device, dtype=cfg.dtype)
        self.norm = RMSNorm(cfg.dim, eps=cfg.norm_eps, device=device)


class Lumina2Block(nn.Module):
    """The Lumina2 (and OmniGen2) transformer block, modulated by ``temb`` or
    not (the caption refiner, whose ``norm1`` is a plain RMSNorm)."""

    def __init__(self, cfg, modulation: bool = True, *, device=None):
        super().__init__()
        self.modulation = modulation
        self.attn = Lumina2Attention(cfg, device=device)
        self.feed_forward = LuminaFeedForward(cfg, device=device)
        self.norm1 = (LuminaRMSNormZero(cfg, device=device) if modulation
                      else RMSNorm(cfg.dim, eps=cfg.norm_eps, device=device))
        self.norm2 = RMSNorm(cfg.dim, eps=cfg.norm_eps, device=device)
        self.ffn_norm1 = RMSNorm(cfg.dim, eps=cfg.norm_eps, device=device)
        self.ffn_norm2 = RMSNorm(cfg.dim, eps=cfg.norm_eps, device=device)

    def forward(self, x, ang, mask, temb=None):
        if not self.modulation:
            x = x + self.norm2(self.attn(self.norm1(x), ang, mask))
            return x + self.ffn_norm2(self.feed_forward(self.ffn_norm1(x)))
        dt = x.dtype
        lin = self.norm1.linear
        mod = lin(F.silu(temb.to(lin.compute_dtype))).float()[:, None]
        sc_a, g_a, sc_m, g_m = mod.chunk(4, dim=-1)
        g_a, g_m = torch.tanh(g_a), torch.tanh(g_m)
        h = (self.norm1.norm(x).float() * (1.0 + sc_a)).to(dt)
        x = x + (g_a * self.norm2(self.attn(h, ang, mask)).float()).to(dt)
        h = (self.ffn_norm1(x).float() * (1.0 + sc_m)).to(dt)
        return x + (g_m * self.ffn_norm2(self.feed_forward(h)).float()).to(dt)


class TimestepEmbedding(nn.Module):
    """``linear_2(silu(linear_1(emb)))`` (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, device=device, dtype=dtype)
        self.linear_2 = Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class TimeCaptionEmbed(nn.Module):
    """``timestep_embedder`` (the 256-wide sinusoid of t through an MLP to
    ``min(dim, 1024)``) and ``caption_embedder`` (RMSNorm, then a Linear
    with a bias)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, cfg.adaln_dim, device=device, dtype=cfg.dtype)
        self.caption_embedder = nn.Sequential(RMSNorm(cfg.cap_feat_dim, eps=cfg.norm_eps, device=device),
                                              Linear(cfg.cap_feat_dim, cfg.dim, device=device, dtype=cfg.dtype))

    def forward(self, t, cap, time_factor: float):
        dt = self.timestep_embedder.linear_1.compute_dtype
        temb = self.timestep_embedder(timestep_embedding(t, 256, time_factor=time_factor).to(dt))
        return temb, self.caption_embedder(cap)


class LuminaLayerNormContinuous(nn.Module):
    """``norm_out``: an affine-free LayerNorm (eps 1e-6) times
    ``1 + linear_1(silu(temb))``, then ``linear_2``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt, p = cfg.dtype, cfg.patch_size
        self.linear_1 = Linear(cfg.adaln_dim, cfg.dim, device=device, dtype=dt)
        self.norm = LayerNorm(cfg.dim, eps=1e-6, affine=False, device=device)
        self.linear_2 = Linear(cfg.dim, p * p * cfg.out_channels, device=device, dtype=dt)

    def forward(self, x, temb):
        scale = self.linear_1(F.silu(temb.to(self.linear_1.compute_dtype)))
        return self.linear_2(self.norm(x) * (1.0 + scale[:, None]))


def key_mask(key_ok: torch.Tensor) -> torch.Tensor:
    """``[B, 1, S, S]`` from the keys each row may attend ``[B, S]``."""
    b, s = key_ok.shape
    return key_ok[:, None, None, :].expand(b, 1, s, s)


class Lumina2DiT(nn.Module):
    """``forward(img [B, N, p*p*C] patch-major, cap [B, T, cap_feat_dim],
    t [B] (already 1 - t), cap_mask [B, T] bool | None, img_ang, cap_ang)``
    -> ``[B, N, p*p*C_out]``."""

    time_factor = 1.0

    def __init__(self, cfg: Lumina2Config, *, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.x_embedder = Linear(p * p * cfg.in_channels, cfg.dim, device=device, dtype=cfg.dtype)
        self.time_caption_embed = TimeCaptionEmbed(cfg, device=device)
        self.noise_refiner = nn.ModuleList(Lumina2Block(cfg, True, device=device)
                                           for _ in range(cfg.n_refiner_layers))
        self.context_refiner = nn.ModuleList(Lumina2Block(cfg, False, device=device)
                                             for _ in range(cfg.n_refiner_layers))
        self.layers = nn.ModuleList(Lumina2Block(cfg, True, device=device) for _ in range(cfg.n_layers))
        self.norm_out = LuminaLayerNormContinuous(cfg, device=device)
        self.gradient_checkpointing = False

    def embed(self, img, cap, t, cap_mask, cap_ang):
        """The time embedding, the refined caption and the embedded image
        tokens, and the caption's key mask ``[B, T]``."""
        b, t_max = cap.shape[0], cap.shape[1]
        temb, cap = self.time_caption_embed(t, cap, self.time_factor)
        x = self.x_embedder(img)
        if cap_mask is None:
            cap_mask = torch.ones((b, t_max), dtype=torch.bool, device=cap.device)
        cap_mask = cap_mask.bool()
        cmask = key_mask(cap_mask)
        for blk in self.context_refiner:
            cap = blk(cap, cap_ang, cmask)
        return temb, cap, x, cap_mask

    def joint(self, joint, ang, key_ok, temb, n_img):
        """The joint stack over ``[caption | ... | image]``; returns the
        last ``n_img`` tokens through ``norm_out``."""
        mask = key_mask(key_ok)
        for blk in self.layers:
            if self.gradient_checkpointing and torch.is_grad_enabled():
                joint = lora_checkpoint(blk, joint, ang, mask, temb)
            else:
                joint = blk(joint, ang, mask, temb)
        return self.norm_out(joint[:, joint.shape[1] - n_img:], temb)

    def forward(self, img, cap, t, cap_mask, img_ang, cap_ang):
        b, n_img = img.shape[:2]
        temb, cap, x, cap_mask = self.embed(img, cap, t, cap_mask, cap_ang)
        for blk in self.noise_refiner:
            x = blk(x, img_ang, None, temb)
        key_ok = torch.cat([cap_mask, torch.ones((b, n_img), dtype=torch.bool, device=x.device)], dim=1)
        return self.joint(torch.cat([cap, x], dim=1), torch.cat([cap_ang, img_ang], dim=1), key_ok, temb, n_img)


def lumina2_lora_targets() -> list[str]:
    """The joint layers and both refiners (JAX ``lumina2_lora_targets``)."""
    return [r"^layers\.", r"^noise_refiner\.", r"^context_refiner\."]


# the port's Linear names in a block -> the JAX module path the LoRA file carries
_JAX_LINEAR = {"attn.to_q": "attn.to_q", "attn.to_k": "attn.to_k", "attn.to_v": "attn.to_v",
               "attn.to_out.0": "attn.to_out", "feed_forward.linear_1": "ffn_w1",
               "feed_forward.linear_2": "ffn_w2", "feed_forward.linear_3": "ffn_w3", "norm1.linear": "norm1_lin"}
_PORT_LINEAR = {v: k for k, v in _JAX_LINEAR.items()}
# the port's refiner stacks -> the JAX module prefix of their blocks
_REFINERS = {"noise_refiner": "noise_refiner_", "context_refiner": "context_refiner_",
             "ref_image_refiner": "ref_refiner_"}
_PORT_REFINERS = {v: k for k, v in _REFINERS.items()}


def nextdit_lora_key(name: str, scanned: bool) -> str:
    """The module name a LoRA file of the JAX job carries for the port's
    ``name`` (``layers.3.feed_forward.linear_1``). The JAX job's key map
    matches none of these modules, so its files hold the JAX module paths,
    dot-joined: the joint layers per layer of the scanned stack
    (``layers.block.ffn_w1.3``) or unrolled (``layer_3.ffn_w1``), each
    refiner block unrolled (``noise_refiner_0.attn.to_out``,
    ``ref_refiner_1.norm1_lin``)."""
    stack, i, rest = name.split(".", 2)
    leaf = _JAX_LINEAR[rest]
    if stack == "layers":
        return f"layers.block.{leaf}.{i}" if scanned else f"layer_{i}.{leaf}"
    return f"{_REFINERS[stack]}{i}.{leaf}"


def nextdit_module_name(key: str) -> str:
    """Inverse of :func:`nextdit_lora_key`, for both layouts."""
    head, rest = key.split(".", 1)
    if key.startswith("layers.block."):
        leaf, i = key[len("layers.block."):].rsplit(".", 1)
        return f"layers.{i}.{_PORT_LINEAR[leaf]}"
    if head.startswith("layer_"):
        return f"layers.{head[len('layer_'):]}.{_PORT_LINEAR[rest]}"
    for prefix, stack in _PORT_REFINERS.items():
        if head.startswith(prefix) and head[len(prefix):].isdigit():
            return f"{stack}.{head[len(prefix):]}.{_PORT_LINEAR[rest]}"
    raise KeyError(f"LoRA key module '{key}' names no NextDiT block Linear")
