"""FLUX-class rectified-flow DiT (``ai_toolkit_tpu/models/flux_dit.py`` in PyTorch).

Modules carry the BFL checkpoint names (``double_blocks.{i}.img_attn.qkv``,
``single_blocks.{i}.linear1``, ``final_layer.adaLN_modulation.1``, ...), so a
BFL state dict loads as it is; ``io/from_jax.py`` maps JAX trees onto them.
One module per block (the JAX package's ``nn.scan`` stacking has no
counterpart here). Dense GELU flux, and the hidream-class MoE flags of the
JAX config (``moe_experts``, ``moe_top_k``, ``moe_dispatch``,
``moe_shared_hidden``, ``qk_norm_across_heads``): a routed SwiGLU
:class:`MoEFFN` in the image stream of every block, a dense
:class:`SwiGLU` in the text stream of a double block, the single block with
separate attention and FFN sublayers. The control archs widen ``img_in``
(``in_channels``: the noisy latents and the channel-concatenated control
latents, ``control_channels`` of them) and keep ``out_channels`` at the
latent width. Chroma (``chroma_mod``) drops ``time_in``, ``vector_in``,
``guidance_in`` and every block's modulation projection: one
:class:`Approximator` (BFL ``distilled_guidance_layer``) maps the timestep,
the guidance and a sinusoidal index of each modulation vector to all of
them (JAX ``flux_dit.py:656-679``). The SD3 (diffusers MMDiT) flags of
the JAX config: ``qk_norm`` off (sd3-medium has no QK RMSNorm), a learned
absolute ``pos_embed`` table added after ``img_in`` and read at the
centre-cropped rows ``pos_ids`` (``pos_embed_max_size``), a last
``final_block`` that is context_pre_only (:class:`FinalDoubleBlock`) and
``dual_attention_layers`` leading ``dual_blocks`` whose image stream adds an
image-only attention ``img2_attn`` (sd3.5-medium); the blocks run
``dual_blocks`` -> ``double_blocks`` -> ``final_block`` -> ``single_blocks``,
each stack indexed from 0 as the JAX stacks are. The NeRF head of
chroma_radiance belongs to a later slice and has no field here.

Gradient checkpointing (``FluxDiT.gradient_checkpointing``) wraps every block
in ``torch.utils.checkpoint`` with the JAX ``dots_flash`` remat policy
(``ai_toolkit_tpu/models/flux_dit.py:707-716``): the outputs of matrix
products without batch dims (``aten.mm`` / ``aten.addmm``) and of the flash
forward (``ait::flash_attention_fwd``: out and lse) are kept, everything else
is recomputed, so the backward never re-runs the attention forward kernel.
``FluxConfig.checkpoint_policy = "full"`` keeps only each block's inputs and
recomputes the whole block (JAX ``remat_policy: "full"``), for a DiT whose
saved products would not fit (Qwen-Image's 60 blocks).
The grouped MoE op (``ait::grouped_swiglu``) is recomputed, as JAX's
``dots_with_no_batch_dims_saveable`` recomputes the Pallas call: a
checkpointed step launches its forward kernel twice per MoE layer.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ai_toolkit_tpu_torch.ops.attention import dot_product_attention
from ai_toolkit_tpu_torch.ops.embeddings import TimestepEmbedder, timestep_embedding
from ai_toolkit_tpu_torch.ops.kernels.moe_gmm import moe_dispatch_swiglu
from ai_toolkit_tpu_torch.ops.layers import (
    AdaLayerNormZero,
    LayerNorm,
    Linear,
    QuantizedWeight,
    RMSNorm,
    lecun_normal_,
    lora_checkpoint,
    modulate,
)
from ai_toolkit_tpu_torch.ops.rope import apply_rope


@dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64  # 16 latent ch * 2*2 packing (+ control_channels)
    out_channels: int | None = None  # None -> in_channels (control models differ)
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    depth_double: int = 19
    depth_single: int = 38
    context_dim: int = 4096  # t5-xxl
    vec_dim: int = 768  # clip-l pooled
    axes_dim: tuple[int, ...] = (16, 56, 56)
    theta: float = 10_000.0
    guidance_embed: bool = True
    # hidream-class MoE FFN (0 experts: the dense GELU MLP of flux)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "dense"  # dense | grouped (the CUDA grouped SwiGLU kernels)
    moe_shared_hidden: int = 0  # 0 -> mlp width // 2
    qk_norm_across_heads: bool = False  # QK RMSNorm over the full inner dim
    # packed control latents concatenated to the image tokens' channels (flex2, kontext)
    control_channels: int = 0
    # chroma: every modulation vector from one Approximator; no time_in / vector_in / guidance_in
    chroma_mod: bool = False
    approximator_hidden: int = 5120
    approximator_depth: int = 5
    # SD3 / MMDiT: QK RMSNorm (off in sd3-medium), the learned absolute position
    # table [1, m*m, h] (0: none), the context_pre_only last block, the leading
    # blocks with a second image-only attention (sd3.5-medium)
    qk_norm: bool = True
    pos_embed_max_size: int = 0
    final_context_pre_only: bool = False
    dual_attention_layers: int = 0
    # what a checkpointed block keeps: "dots_flash" (the products and the flash
    # forward's out / lse) or "full" (only the block inputs); JAX's field is
    # remat_policy, whose default is "full"
    checkpoint_policy: str = "dots_flash"
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def dev(cls) -> "FluxConfig":
        return cls()

    @classmethod
    def schnell(cls) -> "FluxConfig":
        return cls(guidance_embed=False)

    @classmethod
    def tiny(cls) -> "FluxConfig":
        return cls(
            in_channels=16, hidden_size=64, num_heads=4, head_dim=16, depth_double=2,
            depth_single=2, context_dim=64, vec_dim=64, axes_dim=(4, 6, 6), dtype=torch.float32,
        )


def _norm(cfg: FluxConfig) -> LayerNorm:
    """flux's parameter-free LayerNorm (eps 1e-6), in f32."""
    return LayerNorm(cfg.hidden_size, eps=1e-6, affine=False)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden, device=device, dtype=dtype)
        self.out_layer = Linear(hidden, hidden, device=device, dtype=dtype)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Approximator(nn.Module):
    """Chroma's distilled-guidance layer (JAX ``flux_dit.Approximator``, BFL
    ``distilled_guidance_layer``): ``in_proj`` (64 -> hidden), then
    ``depth`` x ``x + layers[i](norms[i](x))``, then ``out_proj`` (hidden ->
    the model width)."""

    in_dim = 64  # timestep(16) | guidance(16) | modulation index(32)

    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        hh, dt = cfg.approximator_hidden, cfg.dtype
        self.in_proj = Linear(self.in_dim, hh, device=device, dtype=dt)
        self.layers = nn.ModuleList(MLPEmbedder(hh, hh, device=device, dtype=dt)
                                    for _ in range(cfg.approximator_depth))
        self.norms = nn.ModuleList(RMSNorm(hh, weight_name="scale", device=device)
                                   for _ in range(cfg.approximator_depth))
        self.out_proj = Linear(hh, cfg.hidden_size, device=device, dtype=dt)

    def forward(self, x):
        x = self.in_proj(x)
        for layer, norm in zip(self.layers, self.norms):
            x = x + layer(norm(x))
        return self.out_proj(x)


def chroma_mod_count(cfg: FluxConfig) -> int:
    """The Approximator's rows: 3 per single block, 2 x 6 per double block
    (image and text), 2 for the final layer (344 at flux-dev's depth)."""
    return 3 * cfg.depth_single + 12 * cfg.depth_double + 2


def chroma_approximator_input(cfg: FluxConfig, t: torch.Tensor, guidance: torch.Tensor | None) -> torch.Tensor:
    """The Approximator's input ``[B, rows, 64]`` (JAX ``flux_dit.py:666-674``):
    ``[timestep_embedding(t, 16) | timestep_embedding(g, 16)]`` beside
    ``timestep_embedding(i, 32)`` of each row index ``i``, both with the time
    factor 1000 and cast to the model dtype before the concat; ``g`` is 0
    without guidance."""
    n_mod, b = chroma_mod_count(cfg), t.shape[0]
    g = guidance if guidance is not None else torch.zeros_like(t)
    tg = torch.cat([timestep_embedding(t, 16), timestep_embedding(g, 16)], dim=-1)
    idx = timestep_embedding(torch.arange(n_mod, dtype=torch.float32, device=t.device), 32)
    return torch.cat([tg[:, None].expand(b, n_mod, 32).to(cfg.dtype),
                      idx[None].expand(b, n_mod, 32).to(cfg.dtype)], dim=-1)


class QKNorm(nn.Module):
    def __init__(self, head_dim: int, *, device=None):
        super().__init__()
        self.query_norm = RMSNorm(head_dim, weight_name="scale", device=device)
        self.key_norm = RMSNorm(head_dim, weight_name="scale", device=device)

    def forward(self, q, k):
        return self.query_norm(q), self.key_norm(k)


def _qkv_heads(cfg: FluxConfig, qkv: torch.Tensor, norm: QKNorm | None):
    """Fused qkv output -> QK-normed q, k and v ``[B, S, H, D]``; the norm runs
    per head, or over the full inner dim (hidream), or not at all (``norm``
    None: sd3-medium)."""
    if cfg.qk_norm_across_heads:
        q, k, v = qkv.chunk(3, dim=-1)
        q, k = norm(q, k)
        return tuple(t.unflatten(-1, (cfg.num_heads, cfg.head_dim)) for t in (q, k, v))
    q, k, v = qkv.unflatten(-1, (3, cfg.num_heads, cfg.head_dim)).unbind(2)
    return (q, k, v) if norm is None else (*norm(q, k), v)


def _qk_norm(cfg: FluxConfig, device) -> QKNorm | None:
    if not cfg.qk_norm:
        return None
    return QKNorm(cfg.hidden_size if cfg.qk_norm_across_heads else cfg.head_dim, device=device)


class SelfAttention(nn.Module):
    """BFL ``img_attn``/``txt_attn``: fused qkv, QK norm, out proj (none for
    the text stream of a context_pre_only block, ``proj=False``)."""

    def __init__(self, cfg: FluxConfig, *, proj: bool = True, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.qkv = Linear(h, 3 * h, device=device, dtype=cfg.dtype)
        self.norm = _qk_norm(cfg, device)
        if proj:
            self.proj = Linear(h, h, device=device, dtype=cfg.dtype)

    def qkv_heads(self, x):
        return _qkv_heads(self.cfg, self.qkv(x), self.norm)


def _attend(q, k, v, pe, mask=None):
    """RoPE-rotate q and k, then joint attention over ``[B, S, H, D]``."""
    return dot_product_attention(apply_rope(q, pe), apply_rope(k, pe), v, mask=mask)


class SwiGLU(nn.Module):
    """``w2(silu(w1 x) * w3 x)``, no biases (JAX ``flux_dit.SwiGLU``)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.w1 = Linear(dim, hidden, bias=False, device=device, dtype=dtype)
        self.w3 = Linear(dim, hidden, bias=False, device=device, dtype=dtype)
        self.w2 = Linear(hidden, dim, bias=False, device=device, dtype=dtype)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Bank(QuantizedWeight):
    """One expert bank ``weight`` ``[E, in, out]`` in the JAX layout (the
    grouped kernels read it as it is), lecun-normal over ``in``; it may be
    quantized like a Linear (JAX ``_BankKernel``)."""

    def __init__(self, experts: int, fan_in: int, fan_out: int, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, fan_in, fan_out, device=device, dtype=dtype))
        self._init_quant()

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)

    def quantize_(self, fn) -> None:
        self._set_quantized(*fn(self.weight.detach()))


class ExpertBanks(nn.Module):
    def __init__(self, experts: int, dim: int, hidden: int, dtype: torch.dtype, *, device=None):
        super().__init__()
        self.w1 = Bank(experts, dim, hidden, dtype, device=device)
        self.w3 = Bank(experts, dim, hidden, dtype, device=device)
        self.w2 = Bank(experts, hidden, dim, dtype, device=device)


class MoEFFN(nn.Module):
    """Routed SwiGLU experts plus a shared expert (JAX ``flux_dit.MoEFFN``,
    reference hidream ``src/models/moe.py``): an f32 gate on ``x.float()``,
    the top-k of its softmax as unnormalised gates, and one of two exact,
    dropless dispatches over one parameter layout:

    - ``dense``: every expert on every token, gate-weighted combine (E x the
      FFN operations, plain torch products);
    - ``grouped``: :func:`~ai_toolkit_tpu_torch.ops.kernels.moe_gmm.moe_dispatch_swiglu`,
      the gather into expert-sorted tiles and the CUDA grouped SwiGLU kernels
      (top-k x the operations)."""

    def __init__(self, dim: int, hidden: int, experts: int, top_k: int, dtype: torch.dtype, *,
                 shared_hidden: int = 0, dispatch: str = "dense", device=None):
        super().__init__()
        if dispatch not in ("dense", "grouped"):
            raise ValueError(f"moe_dispatch '{dispatch}' (dense | grouped)")
        self.top_k, self.dtype, self.dispatch = top_k, dtype, dispatch
        self.gate = Linear(dim, experts, bias=False, device=device, dtype=torch.float32)
        self.experts = ExpertBanks(experts, dim, hidden, dtype, device=device)
        self.shared = SwiGLU(dim, shared_hidden or hidden // 2, dtype, device=device)

    def forward(self, x):
        scores = torch.softmax(self.gate(x.float()), dim=-1)
        topv, topi = torch.topk(scores, self.top_k, dim=-1)
        banks = self.experts
        w1, w3, w2 = (b.dequantized().to(self.dtype) for b in (banks.w1, banks.w3, banks.w2))
        xd = x.to(self.dtype)
        if self.dispatch == "grouped":
            routed = moe_dispatch_swiglu(xd, topv, topi, w1, w3, w2)
        else:
            # hidream norm_topk_prob=False: the raw softmax scores are the gates
            gates = torch.zeros_like(scores).scatter_add_(-1, topi, topv)
            act = F.silu(torch.einsum("bsd,edh->ebsh", xd, w1)) * torch.einsum("bsd,edh->ebsh", xd, w3)
            outs = torch.einsum("ebsh,ehd->ebsd", act, w2)
            routed = torch.einsum("ebsd,bse->bsd", outs.float(), gates).to(x.dtype)
        return routed + self.shared(x)


def _mlp(cfg: FluxConfig, device, moe: bool = True) -> nn.Module:
    """Block FFN (JAX ``_ffn``): flux's dense GELU(tanh) MLP (BFL keys ``.0``
    and ``.2``), or with ``moe_experts`` the MoE FFN; ``moe=False`` on a MoE
    config is the dense SwiGLU at the routed width (hidream's text stream)."""
    h, m = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    if cfg.moe_experts:
        if not moe:
            return SwiGLU(h, m, cfg.dtype, device=device)
        return MoEFFN(h, m, cfg.moe_experts, cfg.moe_top_k, cfg.dtype,
                      shared_hidden=cfg.moe_shared_hidden, dispatch=cfg.moe_dispatch, device=device)
    return nn.Sequential(Linear(h, m, device=device, dtype=cfg.dtype), nn.GELU(approximate="tanh"),
                         Linear(m, h, device=device, dtype=cfg.dtype))


class DoubleBlock(nn.Module):
    """With ``chroma_mod`` the block has no ``img_mod`` / ``txt_mod``: it takes
    ``mod`` = (image, text) vectors ``[B, 2, 3, h]`` (two sets of shift,
    scale, gate) from the Approximator. A ``dual`` block (sd3.5-medium's
    SD35AdaLayerNormZeroX) has a 9-way ``img_mod`` whose last three chunks
    drive ``img2_attn``, an image-only attention off the same pre-attention
    norm, over the image rows of the rope table (JAX ``flux_dit.py:408-463``)."""

    def __init__(self, cfg: FluxConfig, *, dual: bool = False, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.dual = dual
        # registered in this order, so a seeded init draws flux's weights as before
        if not cfg.chroma_mod:
            self.img_mod = AdaLayerNormZero(h, 9 if dual else 6, device=device, dtype=cfg.dtype)
        self.img_norm1, self.img_norm2 = _norm(cfg), _norm(cfg)
        self.img_attn = SelfAttention(cfg, device=device)
        if dual:
            self.img2_attn = SelfAttention(cfg, device=device)
        self.img_mlp = _mlp(cfg, device)
        if not cfg.chroma_mod:
            self.txt_mod = AdaLayerNormZero(h, 6, device=device, dtype=cfg.dtype)
        self.txt_norm1, self.txt_norm2 = _norm(cfg), _norm(cfg)
        self.txt_attn = SelfAttention(cfg, device=device)
        self.txt_mlp = _mlp(cfg, device, moe=False)

    def forward(self, img, txt, vec, pe, mask=None, mod=None):
        if mod is not None:
            im, tm = mod
            i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = im.flatten(1, 2).unbind(1)
            t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = tm.flatten(1, 2).unbind(1)
        else:
            i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2, *i_dual = self.img_mod(vec)
            t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = self.txt_mod(vec)
        img_ln = self.img_norm1(img)
        iq, ik, iv = self.img_attn.qkv_heads(modulate(img_ln, i_shift1, i_scale1))
        tq, tk, tv = self.txt_attn.qkv_heads(modulate(self.txt_norm1(txt), t_shift1, t_scale1))
        # joint attention over [txt | img]
        attn = _attend(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                       torch.cat([tv, iv], dim=1), pe, mask)
        s_txt = txt.shape[1]
        t_attn, i_attn = attn[:, :s_txt].flatten(2), attn[:, s_txt:].flatten(2)

        img = img + i_gate1[:, None] * self.img_attn.proj(i_attn)
        if self.dual:
            i_shift3, i_scale3, i_gate3 = i_dual
            q2, k2, v2 = self.img2_attn.qkv_heads(modulate(img_ln, i_shift3, i_scale3))
            img = img + i_gate3[:, None] * self.img2_attn.proj(_attend(q2, k2, v2, pe[:, s_txt:]).flatten(2))
        img = img + i_gate2[:, None] * self.img_mlp(modulate(self.img_norm2(img), i_shift2, i_scale2))
        txt = txt + t_gate1[:, None] * self.txt_attn.proj(t_attn)
        txt = txt + t_gate2[:, None] * self.txt_mlp(modulate(self.txt_norm2(txt), t_shift2, t_scale2))
        return img, txt


class FinalDoubleBlock(nn.Module):
    """SD3's last joint block (diffusers JointTransformerBlock with
    context_pre_only, JAX ``FinalDoubleBlock``): the text stream is normed by
    a continuous AdaLN, ``txt_mod`` (a plain Linear on ``silu(vec)``, chunks in
    diffusers' (scale, shift) order), and feeds q, k and v to the joint
    attention; it has no output projection or FFN, and only the image
    stream comes out."""

    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.img_mod = AdaLayerNormZero(h, 6, device=device, dtype=cfg.dtype)
        self.img_norm1, self.img_norm2 = _norm(cfg), _norm(cfg)
        self.img_attn = SelfAttention(cfg, device=device)
        self.img_mlp = _mlp(cfg, device)
        self.txt_mod = Linear(h, 2 * h, device=device, dtype=cfg.dtype)
        self.txt_norm1 = _norm(cfg)
        self.txt_attn = SelfAttention(cfg, proj=False, device=device)

    def forward(self, img, txt, vec, pe, mask=None):
        i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = self.img_mod(vec)
        t_scale, t_shift = self.txt_mod(F.silu(vec.to(self.txt_mod.compute_dtype))).chunk(2, dim=-1)
        iq, ik, iv = self.img_attn.qkv_heads(modulate(self.img_norm1(img), i_shift1, i_scale1))
        tq, tk, tv = self.txt_attn.qkv_heads(modulate(self.txt_norm1(txt), t_shift, t_scale))
        attn = _attend(torch.cat([tq, iq], dim=1), torch.cat([tk, ik], dim=1),
                       torch.cat([tv, iv], dim=1), pe, mask)
        img = img + i_gate1[:, None] * self.img_attn.proj(attn[:, txt.shape[1]:].flatten(2))
        return img + i_gate2[:, None] * self.img_mlp(modulate(self.img_norm2(img), i_shift2, i_scale2))


class PosEmbed(nn.Module):
    """SD3's learned absolute position table ``pos_embed`` ``[1, m*m, h]``
    (diffusers ``pos_embed.pos_embed``), normal(0.02) init."""

    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        m = cfg.pos_embed_max_size
        self.pos_embed = nn.Parameter(torch.empty(1, m * m, cfg.hidden_size, device=device, dtype=cfg.dtype))

    def init_weights(self, generator: torch.Generator) -> None:
        tmp = torch.empty(self.pos_embed.shape, dtype=torch.float32, device=self.pos_embed.device)
        self.pos_embed.copy_(tmp.normal_(0.0, 0.02, generator=generator))

    def forward(self, img: torch.Tensor, pos_ids: torch.Tensor | None) -> torch.Tensor:
        if pos_ids is None:
            pos_ids = torch.arange(img.shape[1], device=img.device)
        return img + self.pos_embed[:, pos_ids].to(img.dtype)


class SingleBlock(nn.Module):
    """With ``chroma_mod``: no ``modulation``; ``mod`` ``[B, 3, h]`` is the
    block's shift, scale and gate from the Approximator."""

    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.hidden, self.num_heads, self.head_dim = h, cfg.num_heads, cfg.head_dim
        mlp = int(h * cfg.mlp_ratio)
        # fused qkv + mlp-in projection (one big matmul), then [attn | act] -> out
        self.linear1 = Linear(h, 3 * h + mlp, device=device, dtype=cfg.dtype)
        self.linear2 = Linear(h + mlp, h, device=device, dtype=cfg.dtype)
        self.norm = QKNorm(cfg.head_dim, device=device)
        self.pre_norm = _norm(cfg)
        if not cfg.chroma_mod:
            self.modulation = AdaLayerNormZero(h, 3, device=device, dtype=cfg.dtype)

    def forward(self, x, vec, pe, mask=None, mod=None):
        shift, scale, gate = mod.unbind(1) if mod is not None else self.modulation(vec)
        lin1 = self.linear1(modulate(self.pre_norm(x), shift, scale))
        qkv, mlp = lin1[..., : 3 * self.hidden], lin1[..., 3 * self.hidden:]
        # q, k, v stay strided views of lin1; the attention reads them through strides
        q, k, v = qkv.unflatten(-1, (3, self.num_heads, self.head_dim)).unbind(2)
        q, k = self.norm(q, k)
        attn = _attend(q, k, v, pe, mask)
        out = torch.cat([attn.flatten(2), F.gelu(mlp, approximate="tanh")], dim=-1)
        return x + gate[:, None] * self.linear2(out)


class MoESingleBlock(nn.Module):
    """The hidream-style single block (JAX ``SingleBlock`` with
    ``moe_experts``): attention and the MoE FFN as separate sublayers, six
    modulation chunks."""

    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.modulation = AdaLayerNormZero(h, 6, device=device, dtype=cfg.dtype)
        self.pre_norm, self.ffn_norm = _norm(cfg), _norm(cfg)
        self.qkv = Linear(h, 3 * h, device=device, dtype=cfg.dtype)
        self.norm = _qk_norm(cfg, device)
        self.proj = Linear(h, h, device=device, dtype=cfg.dtype)
        self.mlp = _mlp(cfg, device)

    def forward(self, x, vec, pe, mask=None):
        shift1, scale1, gate1, shift2, scale2, gate2 = self.modulation(vec)
        q, k, v = _qkv_heads(self.cfg, self.qkv(modulate(self.pre_norm(x), shift1, scale1)), self.norm)
        x = x + gate1[:, None] * self.proj(_attend(q, k, v, pe, mask).flatten(2))
        return x + gate2[:, None] * self.mlp(modulate(self.ffn_norm(x), shift2, scale2))


class LastLayer(nn.Module):
    """BFL ``final_layer``: adaLN (shift, scale) then the output projection to
    ``out_channels``; with ``chroma_mod`` no ``adaLN_modulation``: ``mod``
    ``[B, 2, h]`` is the shift and scale from the Approximator."""

    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.norm_final = _norm(cfg)
        self.linear = Linear(h, cfg.out_channels or cfg.in_channels, device=device, dtype=cfg.dtype)
        if not cfg.chroma_mod:
            self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(h, 2 * h, device=device, dtype=cfg.dtype))

    def forward(self, x, vec, mod=None):
        shift, scale = mod.unbind(1) if mod is not None else self.adaLN_modulation(vec).chunk(2, dim=-1)
        return self.linear(modulate(self.norm_final(x), shift, scale))


# JAX dots_with_no_batch_dims_saveable + save_only_these_names("flash_out", "flash_lse")
_DOTS_FLASH_SAVE = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.ait.flash_attention_fwd.default}


def _dots_flash_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_FLASH_SAVE else CheckpointPolicy.PREFER_RECOMPUTE


_dots_flash_context = functools.partial(create_selective_checkpoint_contexts, _dots_flash_policy)


class FluxDiT(nn.Module):
    def __init__(self, cfg: FluxConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.gradient_checkpointing = False
        h, dt = cfg.hidden_size, cfg.dtype
        self.img_in = Linear(cfg.in_channels, h, device=device, dtype=dt)
        if cfg.pos_embed_max_size:
            self.pos_embed = PosEmbed(cfg, device=device)
        self.txt_in = Linear(cfg.context_dim, h, device=device, dtype=dt)
        if cfg.chroma_mod:
            self.distilled_guidance_layer = Approximator(cfg, device=device)
        else:
            self.time_in = TimestepEmbedder(h, device=device, dtype=dt)
            self.vector_in = MLPEmbedder(cfg.vec_dim, h, device=device, dtype=dt)
            if cfg.guidance_embed:
                self.guidance_in = TimestepEmbedder(h, device=device, dtype=dt)
        n_dual = 0 if cfg.chroma_mod else cfg.dual_attention_layers
        n_final = int(cfg.final_context_pre_only)
        if n_dual:
            self.dual_blocks = nn.ModuleList(DoubleBlock(cfg, dual=True, device=device) for _ in range(n_dual))
        self.double_blocks = nn.ModuleList(DoubleBlock(cfg, device=device)
                                           for _ in range(cfg.depth_double - n_dual - n_final))
        if n_final:
            self.final_block = FinalDoubleBlock(cfg, device=device)
        single = MoESingleBlock if cfg.moe_experts else SingleBlock
        self.single_blocks = nn.ModuleList(single(cfg, device=device) for _ in range(cfg.depth_single))
        self.final_layer = LastLayer(cfg, device=device)

    def forward(
        self,
        img: torch.Tensor,  # [B, N_img, in_channels] packed latent tokens
        txt: torch.Tensor,  # [B, N_txt, context_dim] t5 states
        t: torch.Tensor,  # [B] in [0, 1]
        y: torch.Tensor,  # [B, vec_dim] clip pooled
        pe: torch.Tensor,  # [B|1, N_txt+N_img, head_dim/2, 2, 2] rope table
        guidance: torch.Tensor | None = None,  # [B]
        txt_mask: torch.Tensor | None = None,  # [B, N_txt] bool (attn_masking)
        pos_ids: torch.Tensor | None = None,  # [N_img] rows of pos_embed (sd3)
    ) -> torch.Tensor:
        cfg = self.cfg
        img = self.img_in(img)
        if cfg.pos_embed_max_size:
            img = self.pos_embed(img, pos_ids)
        txt = self.txt_in(txt)
        vec = sing_mod = img_mod = txt_mod = fin_mod = None
        if cfg.chroma_mod:
            sing_mod, img_mod, txt_mod, fin_mod = self.chroma_mods(t, guidance)
        else:
            vec = self.time_in(t)
            if cfg.guidance_embed:
                g = guidance if guidance is not None else torch.full(t.shape, 4.0, dtype=t.dtype, device=t.device)
                vec = vec + self.guidance_in(g)
            vec = vec + self.vector_in(y.to(cfg.dtype))

        mask = None
        if txt_mask is not None:
            # key-padding mask over [txt | img]: padded prompt tokens are
            # invisible to every query (forces the plain attention path)
            key_ok = torch.cat([txt_mask.bool(), torch.ones(img.shape[:2], dtype=torch.bool,
                                                            device=img.device)], dim=1)
            mask = key_ok[:, None, None, :]

        for blk in getattr(self, "dual_blocks", ()):
            img, txt = self._block(blk, img, txt, vec, pe, mask)
        for i, blk in enumerate(self.double_blocks):
            mod = ((img_mod[:, i], txt_mod[:, i]),) if cfg.chroma_mod else ()
            img, txt = self._block(blk, img, txt, vec, pe, mask, *mod)
        if cfg.final_context_pre_only:
            img = self._block(self.final_block, img, txt, vec, pe, mask)
        x = torch.cat([txt, img], dim=1)
        for i, blk in enumerate(self.single_blocks):
            x = self._block(blk, x, vec, pe, mask, *((sing_mod[:, i],) if cfg.chroma_mod else ()))
        return self.final_layer(x[:, txt.shape[1]:], vec, fin_mod)

    def chroma_mods(self, t: torch.Tensor, guidance: torch.Tensor | None):
        """Every modulation vector of a chroma forward from the Approximator
        (JAX ``flux_dit.py:656-679``, input :func:`chroma_approximator_input`):
        the singles' ``[B, ds, 3, h]``, the doubles' image and text ``[B, dd,
        2, 3, h]`` and the final layer's ``[B, 2, h]``."""
        dd, ds = self.cfg.depth_double, self.cfg.depth_single
        mods = self.distilled_guidance_layer(chroma_approximator_input(self.cfg, t, guidance))
        return (mods[:, :3 * ds].unflatten(1, (ds, 3)),
                mods[:, 3 * ds:3 * ds + 6 * dd].unflatten(1, (dd, 2, 3)),
                mods[:, 3 * ds + 6 * dd:3 * ds + 12 * dd].unflatten(1, (dd, 2, 3)),
                mods[:, -2:])

    def _block(self, blk: nn.Module, *args):
        if self.gradient_checkpointing and torch.is_grad_enabled():
            if self.cfg.checkpoint_policy == "full":
                return lora_checkpoint(blk, *args)
            return lora_checkpoint(blk, *args, context_fn=_dots_flash_context)
        return blk(*args)


def flux_lora_targets() -> list[str]:
    """Default LoRA targeting: every Linear of the transformer blocks (JAX
    ``flux_lora_targets``, over the port's BFL module names; sd3's
    ``dual_blocks`` and ``final_block`` too)."""
    return [r"^double_blocks\.", r"^single_blocks\.", r"^dual_blocks\.", r"^final_block\."]


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/2)(W/2), 4C] tokens in the *patch-major* feature
    order ``(ph pw c)`` (hidream patchify; JAX ``pack_latents``)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, N, 4C] -> [B, H, W, C] (patch-major inverse)."""
    b, _, c4 = tokens.shape
    x = tokens.reshape(b, h // 2, w // 2, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c4 // 4)


def pack_latents_cmajor(latents: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/2)(W/2), 4C] tokens in the BFL channel-major
    feature order ``(c ph pw)``."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents_cmajor(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, N, 4C] -> [B, H, W, C] (channel-major inverse)."""
    b, _, c4 = tokens.shape
    x = tokens.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c4 // 4)
