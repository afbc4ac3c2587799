"""The CustomAdapter umbrella (``ai_toolkit_tpu/adapters/custom_adapter.py``
in PyTorch), for the types ported so far:

- ``redux``: vision tokens ``[B, N, E]`` -> up x3, silu, down ->
  ``[B, N, txt_dim]`` appended to the text stream (:class:`ReduxEncoder`);
- ``vision_direct`` on a flux-family DiT: the vision tokens feed the
  per-block decoupled K/V projections (``adapters/ip_adapter.py``), through
  the pixtral resampler (w_in, exact-erf GELU, w_out, both biased) when the
  tower is pixtral and ``flux_only_double`` is set
  (:class:`PixtralResampler`), else as they are (:class:`IdentityTokens`);
- ``t2i`` on a UNet: a batch's ``control_pixels`` through the trainable
  :class:`~ai_toolkit_tpu_torch.adapters.t2i_adapter.T2IAdapterNet` into
  ``adapter_residuals`` (the file's conv weights HWIO, as JAX writes a 4-D
  kernel).

Each module is f32, as the JAX modules are. :meth:`CustomAdapterRuntime.apply_cond`
edits the conditioning dict inside the differentiated step (JAX
``apply_cond``); :func:`append_ctx` extends ``txt_mask`` with visible rows
when the batch has one. :func:`save_custom_adapter` / :func:`load_custom_adapter`
write and read the JAX job's file: ``<type>.<module path>.weight`` (torch
layout) and ``.bias``, with ``adapter_type`` in the metadata. Every other
adapter type raises, naming its ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import Linear, init_parameters

PORTED_TYPES = ("redux", "vision_direct", "t2i")
# the JAX package's other CustomAdapter types: the adapters slice
UNPORTED_TYPES = ("decorator", "te_augmenter", "clip_fusion", "single_value", "photo_maker",
                  "photo_maker_full", "mean_flow", "ilora", "llm_adapter", "subpixel")


class ReduxEncoder(nn.Module):
    """vision tokens ``[B, N, E]`` -> ``[B, N, txt_dim]``: up x3, silu, down."""

    def __init__(self, vision_dim: int, txt_dim: int, *, device=None):
        super().__init__()
        self.redux_up = Linear(vision_dim, 3 * txt_dim, device=device, dtype=torch.float32)
        self.redux_down = Linear(3 * txt_dim, txt_dim, device=device, dtype=torch.float32)

    def forward(self, x):
        return self.redux_down(F.silu(self.redux_up(x)))


class PixtralResampler(nn.Module):
    """The reference's pixtral VisionLanguageAdapter: vision tokens -> the
    DiT's hidden size via w_in, exact-erf GELU, w_out."""

    def __init__(self, vision_dim: int, out_dim: int, *, device=None):
        super().__init__()
        self.w_in = Linear(vision_dim, out_dim, device=device, dtype=torch.float32)
        self.w_out = Linear(out_dim, out_dim, device=device, dtype=torch.float32)

    def forward(self, x):
        return self.w_out(F.gelu(self.w_in(x.float())))


class IdentityTokens(nn.Module):
    """The vision tokens go to the decoupled K/V as they are."""

    def forward(self, x):
        return x


def append_ctx(cond: dict, key: str, extra: torch.Tensor) -> dict:
    """``extra`` appended to ``cond[key]`` along the sequence in its dtype; a
    ``txt_mask`` grows by always-visible rows (JAX ``_append_ctx``)."""
    ctx = cond[key]
    out = {**cond, key: torch.cat([ctx, extra.to(ctx.dtype)], dim=1)}
    if cond.get("txt_mask") is not None and key == "txt":
        m = cond["txt_mask"]
        out["txt_mask"] = torch.cat([m, torch.ones(m.shape[0], extra.shape[1], dtype=m.dtype, device=m.device)],
                                    dim=1)
    return out


@dataclass
class CustomAdapterRuntime:
    """The adapter module, its type and the context key it edits ('txt' on a DiT)."""

    adapter_type: str
    module: nn.Module
    ctx_key: str = "txt"

    def apply_cond(self, cond: dict) -> dict:
        """The conditioning after the adapter: ``redux`` appends its tokens
        to the text, ``vision_direct`` sets ``ip_tokens``, ``t2i`` sets
        ``adapter_residuals`` from ``control_pixels``; a batch without its
        input passes as it is (JAX ``apply_cond``)."""
        if self.adapter_type == "t2i":
            px = cond.get("control_pixels")
            return cond if px is None else {**cond, "adapter_residuals": self.module(px)}
        vis = cond.get("vision_tokens")
        if vis is None:
            return cond
        if self.adapter_type == "redux":
            return append_ctx(cond, self.ctx_key, self.module(vis))
        return {**cond, "ip_tokens": self.module(vis)}


def refuse_unported_type(adapter_type: str) -> None:
    if adapter_type in UNPORTED_TYPES:
        raise NotImplementedError(f"custom adapter '{adapter_type}' comes with the adapters slice (ROADMAP Queue 1 "
                                  f"item 6e; ported: {list(PORTED_TYPES)})")
    if adapter_type not in PORTED_TYPES:
        raise NotImplementedError(f"adapter type '{adapter_type}' (ported custom adapters: {list(PORTED_TYPES)}; "
                                  f"besides them the port trains ip_adapter, ip_adapter_plus, control_lora and i2v)")


def init_custom_adapter(adapter_cfg: dict, ctx_dim: int, vision_dim: int, generator: torch.Generator, device,
                        dit_hidden: int | None = None, unet_channels: tuple[int, ...] | None = None
                        ) -> CustomAdapterRuntime:
    """The seeded adapter module (JAX ``init_custom_adapter``): ``dit_hidden``
    marks a flux-family ``vision_direct``; ``t2i`` takes the UNet's
    ``unet_channels`` and the adapter's ``downscale`` (the VAE's)."""
    t = adapter_cfg.get("type")
    refuse_unported_type(t)
    if t == "t2i":
        from ai_toolkit_tpu_torch.adapters.t2i_adapter import T2IAdapterNet

        mod = T2IAdapterNet(tuple(unet_channels), int(adapter_cfg.get("downscale", 8)), device=device)
        return CustomAdapterRuntime(t, init_parameters(mod, generator), "context")
    if t == "redux":
        mod = ReduxEncoder(vision_dim, ctx_dim, device=device)
    elif dit_hidden is None:
        raise NotImplementedError("vision_direct on a UNet (VisionDirectProj and the UNet's ip collection) comes "
                                  "with the adapters slice (ROADMAP Queue 1 item 6e)")
    elif adapter_cfg.get("image_encoder_arch") == "pixtral" and adapter_cfg.get("flux_only_double"):
        mod = PixtralResampler(vision_dim, dit_hidden, device=device)
    else:
        mod = IdentityTokens()
    return CustomAdapterRuntime(t, init_parameters(mod, generator))


def save_custom_adapter(flat: dict[str, np.ndarray], adapter_type: str, path: str, metadata: dict | None = None,
                        dtype=np.float32) -> None:
    """``flat`` (the module's tensors as ``<type>.<path>`` and any sibling
    tensors, already under their file names) in ``dtype``, with
    ``adapter_type`` in the metadata (JAX ``save_custom_adapter``)."""
    from safetensors.numpy import save_file

    meta = {"adapter_type": adapter_type, **(metadata or {})}
    save_file({k: np.ascontiguousarray(v.astype(dtype)) for k, v in flat.items()}, path,
              metadata={str(k): str(v) for k, v in meta.items()})


def load_custom_adapter(path: str) -> tuple[dict[str, torch.Tensor], str]:
    """-> ({name without the type prefix: tensor}, adapter_type)."""
    from safetensors import safe_open

    with safe_open(path, framework="pt") as f:
        atype = (f.metadata() or {}).get("adapter_type", "")
        out = {}
        for k in f.keys():
            parts = k.split(".")
            out[".".join(parts[1:] if parts[0] == atype else parts)] = f.get_tensor(k)
    return out, atype
