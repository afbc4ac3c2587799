"""IP-Adapter (``ai_toolkit_tpu/adapters/ip_adapter.py`` in PyTorch): the
image projections, the UNet's decoupled cross-attention K/V and the flux
family's per-block decoupled K/V, with their files.

The projections, f32 as in JAX: :class:`ImageProjModel` (the pooled CLIP
embedding -> ``n_tokens`` context tokens, a Linear and a LayerNorm) and the
perceiver :class:`Resampler` of ``ip_adapter_plus`` (learned latents that
cross-attend the CLIP patch tokens through ``depth`` layers, then
``proj_out`` and ``norm_out``). Their parameter names are the JAX module
names (``layer_{i}_to_q``, ``norm_out``, ...), so a state dict under
``image_proj.`` is the file's layout.

The UNet's sites: every ``TransformerBlock`` gets a :class:`UNetIP` in its
``ip`` slot, ``{ip_k, ip_v}`` ``[dim, cross_dim]`` (the torch layout of
JAX's ``[cross_dim, dim]`` leaves, the file's ``to_k_ip.weight``) and a
``scale``, all f32 and all trained, as JAX trains the whole ``ip``
collection; K and V start as copies of the block's frozen ``attn2`` K / V
weights (:func:`build_ip_collection`). The block's ``attn2`` query attends
to ``ip_context @ ip_k^T`` / ``@ ip_v^T`` too, and ``scale`` times that
output joins before ``attn2``'s out-projection (``models/unet.py``).

The flux family's sites: each chosen block gets an :class:`IPKV` in its
``ip`` slot: ``to_k`` and ``to_v`` ``[hidden, mid]`` (the torch layout of
JAX's ``[mid, hidden]`` leaves) and a ``scale``, all f32 and all trained.
The block's rotated joint query attends to ``ip_tokens @ to_k^T`` / ``@
to_v^T`` and adds ``scale`` times the result (``models/flux_dit._attend``).
``from_qkv`` (vision_direct) starts both projections from the block's
frozen K weight, its first ``mid`` input columns times 0.01 (when ``mid``
exceeds the hidden size, the extra columns are seeded N(0, 0.01) draws,
which the JAX package draws from its own key). The K weight is read
dequantized: the JAX function reads the kernel from ``params``, which a
quantized base has emptied, and fails there (ROADMAP Queue 3). ``random``
(``ip_adapter`` on flux) draws both uniformly in +-1/sqrt(mid), torch
``nn.Linear``'s default, and needs no base weight (JAX reads the emptied
kernel for its shape and fails on a quantized base too).

Files: :func:`ip_adapter_flat` is JAX ``save_ip_adapter``'s layout
(``image_proj.*``, then ``ip_adapter.{i}.to_k_ip.weight`` / ``to_v_ip`` in
the JAX walk's order, sorted module names at each level); on flux it writes
the K/V through :func:`flux_ip_flat` ``(fmt="ip")``, where JAX's walk finds
no ``ip_k`` leaf and writes ``image_proj.*`` alone (ROADMAP Queue 3).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import LayerNorm, Linear, init_parameters


class ImageProjModel(nn.Module):
    """The pooled CLIP embedding ``[B, E]`` -> ``[B, n_tokens, cross_dim]``."""

    def __init__(self, embed_dim: int, cross_dim: int, n_tokens: int = 4, *, device=None):
        super().__init__()
        self.cross_dim, self.n_tokens = cross_dim, n_tokens
        self.proj = Linear(embed_dim, cross_dim * n_tokens, device=device, dtype=torch.float32)
        self.norm = LayerNorm(cross_dim, device=device)

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(embeds.float()).reshape(embeds.shape[0], self.n_tokens, self.cross_dim)
        return self.norm(x)


class Resampler(nn.Module):
    """The ip-adapter-plus perceiver: ``n_tokens`` learned latents
    cross-attend ``[patch tokens, latents]`` in ``depth`` layers (pre-norm
    attention, then a bias-free exact-gelu feed-forward, each added), then
    ``proj_out`` to ``cross_dim`` and ``norm_out``."""

    def __init__(self, embed_dim: int, cross_dim: int, n_tokens: int = 16, dim: int = 768, depth: int = 4,
                 heads: int = 12, ff_mult: int = 4, *, device=None):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        f32 = torch.float32
        self.latents = nn.Parameter(torch.empty(1, n_tokens, dim, device=device, dtype=f32))
        self.proj_in = Linear(embed_dim, dim, device=device, dtype=f32)
        for i in range(depth):
            for n in ("norm_x", "norm_q", "norm_ff"):
                setattr(self, f"layer_{i}_{n}", LayerNorm(dim, device=device))
            setattr(self, f"layer_{i}_to_q", Linear(dim, dim, bias=False, device=device, dtype=f32))
            setattr(self, f"layer_{i}_to_kv", Linear(dim, 2 * dim, bias=False, device=device, dtype=f32))
            setattr(self, f"layer_{i}_to_out", Linear(dim, dim, bias=False, device=device, dtype=f32))
            setattr(self, f"layer_{i}_ff_in", Linear(dim, dim * ff_mult, bias=False, device=device, dtype=f32))
            setattr(self, f"layer_{i}_ff_out", Linear(dim * ff_mult, dim, bias=False, device=device, dtype=f32))
        self.proj_out = Linear(dim, cross_dim, device=device, dtype=f32)
        self.norm_out = LayerNorm(cross_dim, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        tmp = torch.randn(self.latents.shape, generator=generator, device=self.latents.device)
        self.latents.copy_(tmp * self.dim ** -0.5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``[B, S, E]`` (CLIP's penultimate states) -> ``[B, n_tokens, cross_dim]``."""
        b, hd = tokens.shape[0], self.dim // self.heads
        lat = self.latents.expand(b, -1, -1)
        x = self.proj_in(tokens.float())

        def heads(y):
            return y.reshape(b, -1, self.heads, hd).transpose(1, 2)

        for i in range(self.depth):
            layer = lambda n: getattr(self, f"layer_{i}_{n}")  # noqa: E731
            xl, ql = layer("norm_x")(x), layer("norm_q")(lat)
            q = layer("to_q")(ql)
            k, v = layer("to_kv")(torch.cat([xl, ql], dim=1)).chunk(2, dim=-1)
            attn = torch.softmax((heads(q) @ heads(k).transpose(-1, -2)) * hd ** -0.5, dim=-1)
            lat = lat + layer("to_out")((attn @ heads(v)).transpose(1, 2).reshape(b, -1, self.dim))
            h = layer("ff_in")(layer("norm_ff")(lat))
            lat = lat + layer("ff_out")(F.gelu(h, approximate="none"))
        return self.norm_out(self.proj_out(lat))


class UNetIP(nn.Module):
    """One UNet cross-attention site's decoupled K/V: ``ip_k`` / ``ip_v``
    ``[dim, cross_dim]`` and ``scale``, f32 parameters."""

    def __init__(self, ip_k: torch.Tensor, ip_v: torch.Tensor, scale: float):
        super().__init__()
        self.ip_k = nn.Parameter(ip_k.float().contiguous())
        self.ip_v = nn.Parameter(ip_v.float().contiguous())
        self.scale = nn.Parameter(torch.tensor(float(scale), device=ip_k.device))


def unet_ip_sites(unet: nn.Module) -> list[tuple[str, nn.Module]]:
    """The UNet's transformer blocks ``(name, block)`` in the order of JAX's
    walk over its ``ip`` collection (module names sorted at each level, as
    ``save_ip_adapter`` walks them)."""
    from ai_toolkit_tpu_torch.io.from_jax import unet_jax_path

    n = len(unet.cfg.block_out_channels)
    blocks = [(name, m) for name, m in unet.named_modules() if re.search(r"\.transformer_blocks\.\d+$", name)]
    return sorted(blocks, key=lambda nb: tuple(unet_jax_path(nb[0] + ".attn2.to_k", n).split(".")[:-1]))


@torch.no_grad()
def build_ip_collection(unet: nn.Module, scale: float = 1.0) -> dict[str, UNetIP]:
    """Attach a :class:`UNetIP` to every transformer block of ``unet``, K and
    V copied from its ``attn2`` K / V weights (JAX ``build_ip_collection``);
    returns ``{block name: UNetIP}`` in :func:`unet_ip_sites`' order."""
    out = {}
    for name, blk in unet_ip_sites(unet):
        a = blk.attn2
        blk.ip = UNetIP(a.to_k.dequantized().float().clone(), a.to_v.dequantized().float().clone(), scale)
        out[name] = blk.ip
    return out


def init_ip_proj(embed_dim: int, cross_dim: int, n_tokens: int, generator: torch.Generator, device, plus: bool = False,
                 resampler_dim: int = 768, resampler_depth: int = 4, resampler_heads: int = 12) -> nn.Module:
    """The seeded projection of JAX ``init_ip_adapter``: the :class:`Resampler`
    over patch tokens for ``plus``, else :class:`ImageProjModel` over the
    pooled embedding."""
    if plus:
        mod = Resampler(embed_dim, cross_dim, n_tokens, resampler_dim, resampler_depth, resampler_heads,
                        device=device)
    else:
        mod = ImageProjModel(embed_dim, cross_dim, n_tokens, device=device)
    return init_parameters(mod, generator)


def ip_adapter_flat(proj: nn.Module, ip: dict, flux: bool = False) -> dict[str, np.ndarray]:
    """JAX ``save_ip_adapter``'s layout, f32: ``image_proj.<param>`` (torch
    layout; the latents as they are), then the K/V as
    ``ip_adapter.{i}.to_k_ip.weight`` / ``to_v_ip.weight``: the UNet's in
    ``ip``'s order (:func:`unet_ip_sites`), flux's through
    :func:`flux_ip_flat` ``(fmt="ip")``."""
    flat = {f"image_proj.{k}": v.detach().float().cpu().numpy() for k, v in proj.state_dict().items()}
    if flux:
        flat.update(flux_ip_flat(ip, fmt="ip"))
        return flat
    for idx, m in enumerate(ip.values()):
        flat[f"ip_adapter.{idx}.to_k_ip.weight"] = m.ip_k.detach().float().cpu().numpy()
        flat[f"ip_adapter.{idx}.to_v_ip.weight"] = m.ip_v.detach().float().cpu().numpy()
    return flat


class IPKV(nn.Module):
    def __init__(self, to_k: torch.Tensor, to_v: torch.Tensor, scale: float):
        super().__init__()
        self.to_k = nn.Parameter(to_k.float().contiguous())
        self.to_v = nn.Parameter(to_v.float().contiguous())
        self.scale = nn.Parameter(torch.tensor(float(scale), device=to_k.device))

    def kv(self, tokens: torch.Tensor, heads: int, head_dim: int, dtype: torch.dtype):
        """(k, v ``[B, N, heads, head_dim]`` in ``dtype``, scale f32)."""
        x = tokens.to(dtype)
        k = (x @ self.to_k.to(dtype).t()).unflatten(-1, (heads, head_dim))
        v = (x @ self.to_v.to(dtype).t()).unflatten(-1, (heads, head_dim))
        return k, v, self.scale


def _k_weight(linear, hidden: int) -> torch.Tensor:
    """The K rows ``[hidden, hidden]`` of a fused qkv (+ mlp) projection, f32."""
    return linear.dequantized()[hidden:2 * hidden].float()


@torch.no_grad()
def build_flux_ip_collection(dit: nn.Module, mid_dim: int, generator: torch.Generator | None = None,
                             only_double: bool = False, scale: float = 1.0, init: str = "from_qkv") -> dict[str, IPKV]:
    """Attach an :class:`IPKV` (``init``: ``from_qkv`` or ``random``) to every
    double block and, unless ``only_double``, every single block of ``dit``;
    returns ``{block name: IPKV}``, doubles first."""
    hidden = dit.cfg.hidden_size
    out: dict[str, IPKV] = {}
    blocks = [(f"double_blocks.{i}", b, b.img_attn.qkv) for i, b in enumerate(dit.double_blocks)]
    if not only_double:
        blocks += [(f"single_blocks.{i}", b, b.linear1) for i, b in enumerate(dit.single_blocks)]
    for name, blk, lin in blocks:
        if init == "random":
            lim = 1.0 / math.sqrt(mid_dim)
            dev = lin.weight.device if lin.weight is not None else lin.qvalue.device
            wk, wv = ((torch.rand(hidden, mid_dim, generator=generator, device=dev) * 2 - 1) * lim for _ in range(2))
            blk.ip = IPKV(wk, wv, scale)
            out[name] = blk.ip
            continue
        kw = _k_weight(lin, hidden)
        if mid_dim <= hidden:
            wk = kw[:, :mid_dim] * 0.01
        else:
            pad = torch.randn(hidden, mid_dim - hidden, generator=generator, device=kw.device) * 0.01
            wk = torch.cat([kw * 0.01, pad], dim=1)
        blk.ip = IPKV(wk, wk.clone(), scale)
        out[name] = blk.ip
    return out


def detach_ip(dit: nn.Module) -> None:
    for blk in [*dit.double_blocks, *dit.single_blocks]:
        if hasattr(blk, "ip"):
            del blk.ip


def _flux_names(fmt: str) -> tuple[str, str, str]:
    return (("to_k_adapter", "to_v_adapter", "adapter_modules") if fmt == "vd"
            else ("to_k_ip", "to_v_ip", "ip_adapter"))


def _flux_order(ip: dict) -> list[str]:
    return sorted(ip, key=lambda name: (not name.startswith("double_"), int(name.rsplit(".", 1)[1])))


def flux_ip_flat(ip: dict[str, IPKV], fmt: str = "vd") -> dict[str, np.ndarray]:
    """The reference's keys ``[hidden, mid]``, doubles then singles in block
    order (JAX ``flux_ip_flat``): vision_direct's
    ``adapter_modules.{i}.to_k_adapter.weight`` / ``to_v_adapter.weight``
    (``fmt="vd"``), or ip-adapter's ``ip_adapter.{i}.to_k_ip.weight`` /
    ``to_v_ip.weight`` (``fmt="ip"``); the scales are not written, as in JAX."""
    kname, vname, prefix = _flux_names(fmt)
    flat: dict[str, np.ndarray] = {}
    for idx, name in enumerate(_flux_order(ip)):
        flat[f"{prefix}.{idx}.{kname}.weight"] = ip[name].to_k.detach().float().cpu().numpy()
        flat[f"{prefix}.{idx}.{vname}.weight"] = ip[name].to_v.detach().float().cpu().numpy()
    return flat


@torch.no_grad()
def load_flux_ip_flat(flat: dict[str, np.ndarray], ip: dict[str, IPKV], fmt: str = "vd") -> None:
    """The inverse of :func:`flux_ip_flat` into ``ip``'s modules (JAX
    ``load_flux_ip_flat``: the scales stay as they are)."""
    kname, vname, prefix = _flux_names(fmt)
    for idx, name in enumerate(_flux_order(ip)):
        ip[name].to_k.copy_(torch.as_tensor(np.asarray(flat[f"{prefix}.{idx}.{kname}.weight"])))
        ip[name].to_v.copy_(torch.as_tensor(np.asarray(flat[f"{prefix}.{idx}.{vname}.weight"])))
