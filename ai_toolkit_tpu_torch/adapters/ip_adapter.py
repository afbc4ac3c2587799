"""The per-block decoupled K/V of a vision_direct adapter on a flux-family DiT
(``ai_toolkit_tpu/adapters/ip_adapter.py`` ``build_flux_ip_collection`` /
``flux_ip_flat`` in PyTorch).

Each chosen block gets an :class:`IPKV` in its ``ip`` slot: ``to_k`` and
``to_v`` ``[hidden, mid]`` (the torch layout of JAX's ``[mid, hidden]``
leaves) and a ``scale``, all f32 and all trained, as JAX trains the whole
``ip`` collection. The block's rotated joint query attends to
``ip_tokens @ to_k^T`` / ``@ to_v^T`` and adds ``scale`` times the result
(``models/flux_dit._attend``).

``from_qkv`` (vision_direct) starts both projections from the block's
frozen K weight, its first ``mid`` input columns times 0.01 (when ``mid``
exceeds the hidden size, the extra columns are seeded N(0, 0.01) draws,
which the JAX package draws from its own key). The K weight is read
dequantized: the JAX function reads the kernel from ``params``, which a
quantized base has emptied, and fails there (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
                             only_double: bool = False, scale: float = 1.0) -> dict[str, IPKV]:
    """Attach an :class:`IPKV` (``from_qkv`` init) to every double block and,
    unless ``only_double``, every single block of ``dit``; returns ``{block
    name: IPKV}``, doubles first."""
    hidden = dit.cfg.hidden_size
    out: dict[str, IPKV] = {}
    blocks = [(f"double_blocks.{i}", b, b.img_attn.qkv) for i, b in enumerate(dit.double_blocks)]
    if not only_double:
        blocks += [(f"single_blocks.{i}", b, b.linear1) for i, b in enumerate(dit.single_blocks)]
    for name, blk, lin in blocks:
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


def flux_ip_flat(ip: dict[str, IPKV]) -> dict[str, np.ndarray]:
    """The reference's vision_direct keys, ``adapter_modules.{i}.to_k_adapter.weight``
    / ``to_v_adapter.weight`` ``[hidden, mid]``, doubles then singles in
    block order (JAX ``flux_ip_flat(fmt="vd")``); the scales are not written,
    as in JAX."""
    def order(name):
        return not name.startswith("double_"), int(name.rsplit(".", 1)[1])

    flat: dict[str, np.ndarray] = {}
    for idx, name in enumerate(sorted(ip, key=order)):
        flat[f"adapter_modules.{idx}.to_k_adapter.weight"] = ip[name].to_k.detach().float().cpu().numpy()
        flat[f"adapter_modules.{idx}.to_v_adapter.weight"] = ip[name].to_v.detach().float().cpu().numpy()
    return flat
