"""LTX-2 joint audio-video DiT (``ai_toolkit_tpu/models/ltx2_av.py``
``LTX2AVDiT`` in PyTorch).

Video tokens ``[B, Nv, 128]`` and audio tokens ``[B, Na, 128]`` run side
by side through one stack of joint blocks. Each block runs six attentions,
each with its q / k / v / o projections and its QK RMSNorm across heads:
video self-attention (32 x 128, the (t, y, x) rope), audio self-attention
(32 x 64, a 1-D rope over audio time), then the bidirectional AV cross
attention at the 2048 inner width (``a2v``: video queries over audio keys;
``v2a``: audio queries over video keys; no rope across modalities), then
each stream's text cross-attention (unmodulated, its own text projection of
the caption states), then each stream's tanh-GELU FFN. Every stage but the
text one is adaLN-modulated: per-stream tables of six (``modulation``,
``audio_modulation``) and of three for the AV stage (``av_video_table``,
``av_audio_table``), added in f32 to the global projections of each
stream's time embedding and rounded to the compute dtype chunk by chunk.
Each stream ends in its own modulated head. With ``gradient_checkpointing``
every block is recomputed in the backward, as the JAX ``nn.remat`` does
(the flash forward runs again). Every attention goes to the port's dispatch
(``ops/attention.py``): at head dims 128 and 64 that is the flash kernel.

Module names are the JAX ones (``blocks.3.a2v_q``, ``audio_time_proj``),
so the LoRA file carries the JAX job's module paths; the modulation tables
are f32 parameters under their JAX names.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.models.wan_dit import WanConfig
from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.embeddings import timestep_embedding
from ai_toolkit_tpu_torch.ops.layers import LayerNorm, Linear, RMSNorm, lora_checkpoint
from ai_toolkit_tpu_torch.ops.rope import apply_rope


@dataclass(frozen=True)
class LTX2AVConfig:
    video: WanConfig = field(default_factory=WanConfig)
    audio_in_channels: int = 128
    audio_dim: int = 2048
    audio_ffn_dim: int = 8192
    audio_heads: int = 32  # x 64 head_dim = 2048

    @classmethod
    def tiny(cls) -> "LTX2AVConfig":
        return cls(video=WanConfig.tiny(), audio_in_channels=4, audio_dim=32, audio_ffn_dim=64, audio_heads=2)

    @property
    def audio_head_dim(self) -> int:
        return self.audio_dim // self.audio_heads

    @property
    def av_inner_dim(self) -> int:
        """The cross-modality attention width (``audio_cross_attention_dim``)."""
        return min(self.audio_dim, self.video.dim)


# the attentions of a block: (name, query width, key / value width, inner width, heads) as functions of the config
def _attentions(cfg: LTX2AVConfig):
    dv, da, v = cfg.video.dim, cfg.audio_dim, cfg.video
    inner = cfg.av_inner_dim
    return [("self", dv, dv, dv, v.num_heads), ("audio_self", da, da, da, cfg.audio_heads),
            ("a2v", dv, da, inner, cfg.audio_heads), ("v2a", da, dv, inner, cfg.audio_heads),
            ("cross", dv, dv, dv, v.num_heads), ("audio_cross", da, da, da, cfg.audio_heads)]


def _ln(dim: int, affine: bool = False, device=None) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6, affine=affine, device=device)


class AVBlock(nn.Module):
    def __init__(self, cfg: LTX2AVConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt, dv, da = cfg.video.dtype, cfg.video.dim, cfg.audio_dim
        self.heads: dict[str, int] = {}
        for name, d_q, d_kv, d_inner, nh in _attentions(cfg):
            d_out = d_q
            self.heads[name] = nh
            setattr(self, f"{name}_q", Linear(d_q, d_inner, device=device, dtype=dt))
            setattr(self, f"{name}_q_norm", RMSNorm(d_inner, device=device))
            setattr(self, f"{name}_k", Linear(d_kv, d_inner, device=device, dtype=dt))
            setattr(self, f"{name}_k_norm", RMSNorm(d_inner, device=device))
            setattr(self, f"{name}_v", Linear(d_kv, d_inner, device=device, dtype=dt))
            setattr(self, f"{name}_o", Linear(d_inner, d_out, device=device, dtype=dt))
        self.norm1, self.audio_norm1 = _ln(dv), _ln(da)
        self.av_norm_v, self.av_norm_a = _ln(dv), _ln(da)
        self.norm2, self.audio_norm2 = _ln(dv, True, device), _ln(da, True, device)
        self.norm3, self.audio_norm3 = _ln(dv), _ln(da)
        self.ffn_in = Linear(dv, cfg.video.ffn_dim, device=device, dtype=dt)
        self.ffn_out = Linear(cfg.video.ffn_dim, dv, device=device, dtype=dt)
        self.audio_ffn_in = Linear(da, cfg.audio_ffn_dim, device=device, dtype=dt)
        self.audio_ffn_out = Linear(cfg.audio_ffn_dim, da, device=device, dtype=dt)
        f32 = dict(device=device, dtype=torch.float32)
        self.modulation = nn.Parameter(torch.empty(6, dv, **f32))
        self.audio_modulation = nn.Parameter(torch.empty(6, da, **f32))
        self.av_video_table = nn.Parameter(torch.empty(3, dv, **f32))
        self.av_audio_table = nn.Parameter(torch.empty(3, da, **f32))

    def init_weights(self, generator: torch.Generator) -> None:
        for t in (self.modulation, self.audio_modulation, self.av_video_table, self.av_audio_table):
            t.normal_(0.0, 0.02, generator=generator)

    def _attn(self, name: str, h_q, h_kv, pe_q=None, pe_k=None):
        nh = self.heads[name]
        q = getattr(self, f"{name}_q_norm")(getattr(self, f"{name}_q")(h_q))
        k = getattr(self, f"{name}_k_norm")(getattr(self, f"{name}_k")(h_kv))
        v = getattr(self, f"{name}_v")(h_kv)
        q, k, v = (x.unflatten(-1, (nh, x.shape[-1] // nh)) for x in (q, k, v))
        if pe_q is not None:
            q = apply_rope(q, pe_q)
        if pe_k is not None:
            k = apply_rope(k, pe_k)
        return getattr(self, f"{name}_o")(dot_product_attention(q, k, v).flatten(2))

    def forward(self, xv, xa, ctx_v, ctx_a, ev, ea, av_v, av_a, pe_v, pe_a):
        """xv ``[B, Nv, Dv]``, xa ``[B, Na, Da]``; ev / ea ``[B, 6, D]`` and
        av_v / av_a ``[B, 3, D]`` the streams' time projections."""
        dt = self.cfg.video.dtype

        def mods(e, table):
            return [m[:, None].to(dt) for m in (e.float() + table).unbind(1)]

        sh_v, sc_v, g_v, shf_v, scf_v, gf_v = mods(ev, self.modulation)
        sh_a, sc_a, g_a, shf_a, scf_a, gf_a = mods(ea, self.audio_modulation)
        avs_v, avc_v, avg_v = mods(av_v, self.av_video_table)
        avs_a, avc_a, avg_a = mods(av_a, self.av_audio_table)
        # 1. self-attention per stream, each with its own rope
        h = self.norm1(xv) * (1 + sc_v) + sh_v
        xv = xv + g_v * self._attn("self", h, h, pe_v, pe_v)
        h = self.audio_norm1(xa) * (1 + sc_a) + sh_a
        xa = xa + g_a * self._attn("audio_self", h, h, pe_a, pe_a)
        # 2. bidirectional AV cross-attention, no rope across modalities
        hv = self.av_norm_v(xv) * (1 + avc_v) + avs_v
        ha = self.av_norm_a(xa) * (1 + avc_a) + avs_a
        xv = xv + avg_v * self._attn("a2v", hv, ha)
        xa = xa + avg_a * self._attn("v2a", ha, hv)
        # 3. text cross-attention per stream, unmodulated
        xv = xv + self._attn("cross", self.norm2(xv), ctx_v)
        xa = xa + self._attn("audio_cross", self.audio_norm2(xa), ctx_a)
        # 4. FFN per stream
        h = self.norm3(xv) * (1 + scf_v) + shf_v
        xv = xv + gf_v * self.ffn_out(F.gelu(self.ffn_in(h), approximate="tanh"))
        h = self.audio_norm3(xa) * (1 + scf_a) + shf_a
        xa = xa + gf_a * self.audio_ffn_out(F.gelu(self.audio_ffn_in(h), approximate="tanh"))
        return xv, xa


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class LTX2AVDiT(nn.Module):
    """Returns ``(video_pred_tokens, audio_pred_tokens)``."""

    def __init__(self, cfg: LTX2AVConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        v = cfg.video
        self.gradient_checkpointing = v.remat
        dt, dv, da = v.dtype, v.dim, cfg.audio_dim
        kw = dict(device=device, dtype=dt)
        self.patch_embedding = Linear(v.patch_dim, dv, **kw)
        self.audio_proj_in = Linear(cfg.audio_in_channels, da, **kw)
        self.text_embedding_in, self.text_embedding_out = Linear(v.text_dim, dv, **kw), Linear(dv, dv, **kw)
        self.audio_text_in, self.audio_text_out = Linear(v.text_dim, da, **kw), Linear(da, da, **kw)
        for name, d in (("time", dv), ("audio_time", da)):
            setattr(self, f"{name}_fc1", Linear(v.freq_dim, d, **kw))
            setattr(self, f"{name}_fc2", Linear(d, d, **kw))
            setattr(self, f"{name}_proj", Linear(d, 6 * d, **kw))
        self.av_mod_video = Linear(dv, 3 * dv, **kw)
        self.av_mod_audio = Linear(da, 3 * da, **kw)
        self.blocks = nn.ModuleList(AVBlock(cfg, device=device) for _ in range(v.num_layers))
        for name, d, out in (("head", dv, v.patch_dim), ("audio_head", da, cfg.audio_in_channels)):
            setattr(self, f"{name}_modulation", nn.Parameter(torch.empty(2, d, device=device, dtype=torch.float32)))
            setattr(self, f"{name}_time", Linear(d, 2 * d, **kw))
            setattr(self, f"{name}_norm", _ln(d))
            setattr(self, f"{name}_out", Linear(d, out, **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        self.head_modulation.normal_(0.0, 0.02, generator=generator)
        self.audio_head_modulation.normal_(0.0, 0.02, generator=generator)

    def _time(self, name: str, t: torch.Tensor, d: int):
        dt = self.cfg.video.dtype
        temb = timestep_embedding(t, self.cfg.video.freq_dim).to(dt)
        temb = getattr(self, f"{name}_fc2")(F.silu(getattr(self, f"{name}_fc1")(temb)))
        return temb, getattr(self, f"{name}_proj")(F.silu(temb)).unflatten(-1, (6, d))

    def _head(self, name: str, x, temb):
        d = x.shape[-1]
        dt = self.cfg.video.dtype
        he = (getattr(self, f"{name}_time")(F.silu(temb)).unflatten(-1, (2, d)).float()
              + getattr(self, f"{name}_modulation")).to(dt)
        h = getattr(self, f"{name}_norm")(x) * (1 + he[:, 1:2]) + he[:, 0:1]
        return getattr(self, f"{name}_out")(h)

    def forward(self, xv, xa, context, t, pe_v, pe_a):
        """xv ``[B, Nv, video_patch_dim]``, xa ``[B, Na, audio_in_channels]``,
        context ``[B, S, text_dim]``, t ``[B]`` in [0, 1] (one sigma for both
        streams), pe_v / pe_a the streams' rope tables."""
        cfg = self.cfg
        dt, dv, da = cfg.video.dtype, cfg.video.dim, cfg.audio_dim
        xv, xa = self.patch_embedding(xv), self.audio_proj_in(xa)
        ctx = context.to(dt)
        ctx_v = self.text_embedding_out(_gelu_tanh(self.text_embedding_in(ctx)))
        ctx_a = self.audio_text_out(_gelu_tanh(self.audio_text_in(ctx)))
        temb_v, ev = self._time("time", t, dv)
        temb_a, ea = self._time("audio_time", t, da)
        av_v = self.av_mod_video(F.silu(temb_v)).unflatten(-1, (3, dv))
        av_a = self.av_mod_audio(F.silu(temb_a)).unflatten(-1, (3, da))
        for blk in self.blocks:
            args = (xv, xa, ctx_v, ctx_a, ev, ea, av_v, av_a, pe_v, pe_a)
            if self.gradient_checkpointing and torch.is_grad_enabled():
                xv, xa = lora_checkpoint(blk, *args)
            else:
                xv, xa = blk(*args)
        return self._head("head", xv, temb_v), self._head("audio_head", xa, temb_a)


def av_lora_key(name: str, scanned: bool) -> str:
    """The JAX job's module name for ``blocks.3.a2v_q``: ``block_3.a2v_q``
    unrolled (``tiny``), ``blocks.block.a2v_q.3`` scanned."""
    _, i, leaf = name.split(".", 2)
    return f"blocks.block.{leaf}.{i}" if scanned else f"block_{i}.{leaf}"


def av_module_name(key: str) -> str:
    """Inverse of :func:`av_lora_key`, for both layouts."""
    parts = key.split(".")
    if parts[:2] == ["blocks", "block"] and len(parts) == 4:
        return f"blocks.{parts[3]}.{parts[2]}"
    if len(parts) == 2 and parts[0].startswith("block_"):
        return f"blocks.{parts[0][len('block_'):]}.{parts[1]}"
    raise KeyError(f"LoRA key module '{key}' names no AV block Linear")
