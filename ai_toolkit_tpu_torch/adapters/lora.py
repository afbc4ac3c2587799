"""LoRA on the port's ``Linear`` layers (``ai_toolkit_tpu/adapters/lora.py`` in PyTorch).

The JAX package keeps a LoRA network as a ``lora`` variable tree beside the
frozen params. Here each adapted ``ops.layers.Linear`` carries a
:class:`~ai_toolkit_tpu_torch.ops.layers.LoRA` submodule in ``.lora``, and a
network is addressed as ``{module name: LoRA}``: module names are the port's
(BFL for the flux DiT, ``double_blocks.0.img_attn.qkv``; diffusers for the
UNet, ``down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q``), which
are also the external names a LoRA file carries. Conv LoRA (``conv_rank``) is not ported.
JAX ``scale_lora`` (a scalar or per-sample ``[B]`` multiplier on every
scale) is ``ops.layers.lora_multiplier`` around the forward, which also
turns the network off (``ADAPTER_OFF``).

A frozen accuracy-recovery adapter (a LoRA or LoKr file shipped with a
quantized base, ``model.qtype: "int8|<path>"``) sits in each ``Linear``'s
``ara`` slot (:func:`attach_ara`), beside the trainable network, which
stacks with it by rank-concat (:func:`concat_loras`, in the forward).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from ai_toolkit_tpu_torch.config.modules import NetworkConfig
from ai_toolkit_tpu_torch.ops.layers import Linear, LoKr, LoRA, fold_scale


@dataclass
class LoRASpec:
    """Which modules get adapters, and at what rank."""

    rank: int = 16
    alpha: float = 16.0
    conv_rank: int | None = None
    conv_alpha: float | None = None
    # substring filters, matched against the port's dotted module names
    only_if_contains: list[str] | None = None
    ignore_if_contains: list[str] | None = None
    # model-provided default target patterns (regex); None = every Linear
    target_patterns: list[str] | None = None
    init_std: float = 0.01

    @classmethod
    def from_network_config(cls, cfg: NetworkConfig,
                            target_patterns: list[str] | None = None) -> "LoRASpec":
        return cls(
            rank=cfg.rank,
            alpha=cfg.alpha,
            conv_rank=cfg.conv,
            conv_alpha=cfg.conv_alpha if cfg.conv_alpha is not None else cfg.alpha,
            only_if_contains=cfg.only_if_contains,
            ignore_if_contains=cfg.ignore_if_contains,
            target_patterns=target_patterns,
        )


def _matches(name: str, spec: LoRASpec) -> bool:
    if spec.ignore_if_contains and any(s in name for s in spec.ignore_if_contains):
        return False
    if spec.only_if_contains:
        return any(s in name for s in spec.only_if_contains)
    if spec.target_patterns:
        return any(re.search(p, name) for p in spec.target_patterns)
    return True


def build_lora(model: nn.Module, spec: LoRASpec, generator: torch.Generator) -> dict[str, LoRA]:
    """Attach a LoRA to every matching ``Linear`` of ``model``, in module
    order: ``a`` ~ normal(0, ``init_std``) drawn from ``generator``, ``b`` = 0,
    ``scale`` = alpha / rank. Returns ``{module name: LoRA}``."""
    if spec.conv_rank:
        raise NotImplementedError("conv LoRA (network.conv) comes with a later slice (the UNet's conv layers)")
    lora: dict[str, LoRA] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and _matches(name, spec):
            adapter = LoRA(mod.in_features, spec.rank, mod.out_features, spec.alpha / spec.rank,
                           device=mod.stored_weight.device)
            with torch.no_grad():
                adapter.a.normal_(0.0, spec.init_std, generator=generator)
            mod.lora = adapter
            lora[name] = adapter
    return lora


def attach_lora(model: nn.Module, tree: dict[str, dict[str, torch.Tensor]]) -> dict[str, LoRA]:
    """Attach LoRA factors ``{module name: {a [in,r], b [r,out], scale}}``
    (``io/lora_file.load_lora_file``) to the named ``Linear`` modules."""
    modules = dict(model.named_modules())
    lora: dict[str, LoRA] = {}
    for name, leaf in tree.items():
        mod = modules.get(name)
        if not isinstance(mod, Linear):
            raise KeyError(f"LoRA module '{name}' is not a Linear of this model")
        a, b = leaf["a"], leaf["b"]
        if a.shape != (mod.in_features, a.shape[1]) or b.shape != (a.shape[1], mod.out_features):
            raise ValueError(f"LoRA '{name}': a {tuple(a.shape)} / b {tuple(b.shape)} do not fit "
                             f"[{mod.in_features} -> {mod.out_features}]")
        adapter = LoRA(mod.in_features, a.shape[1], mod.out_features, float(leaf["scale"]),
                       device=mod.stored_weight.device)
        with torch.no_grad():
            adapter.a.copy_(a)
            adapter.b.copy_(b)
        mod.lora = adapter
        lora[name] = adapter
    return lora


def share_lora(model: nn.Module, lora: dict[str, LoRA]) -> None:
    """Attach the ``LoRA`` modules of ``lora`` themselves (one set of
    parameters) to the same-named ``Linear`` modules of ``model``: a
    multistage model's other expert under the first expert's network."""
    modules = dict(model.named_modules())
    for name, adapter in lora.items():
        mod = modules.get(name)
        if not isinstance(mod, Linear):
            raise KeyError(f"LoRA module '{name}' is not a Linear of this model")
        mod.lora = adapter


def attach_ara(model: nn.Module, tree: dict[str, dict[str, torch.Tensor]], kind: str = "lora") -> int:
    """Put a frozen accuracy-recovery adapter into the ``ara`` slot of the
    named ``Linear`` modules: ``kind`` "lora" (``{a, b, scale}``, as
    :func:`attach_lora` takes it) or "lokr" (``{w1, w2, scale}``,
    ``io/lora_file.load_lokr_file``). Nothing in it trains. Returns the
    number of modules."""
    modules = dict(model.named_modules())
    for name, leaf in tree.items():
        mod = modules.get(name)
        if not isinstance(mod, Linear):
            raise KeyError(f"ARA module '{name}' is not a Linear of this model")
        dev = mod.stored_weight.device
        if kind == "lokr":
            w1, w2 = leaf["w1"], leaf["w2"]
            if (w1.shape[0] * w2.shape[0], w1.shape[1] * w2.shape[1]) != (mod.out_features, mod.in_features):
                raise ValueError(f"LoKr '{name}': kron({tuple(w1.shape)}, {tuple(w2.shape)}) does not fit "
                                 f"[{mod.out_features}, {mod.in_features}]")
            mod.ara = LoKr(w1, w2, float(leaf["scale"])).to(dev)
        else:
            a, b = leaf["a"], leaf["b"]
            if a.shape[0] != mod.in_features or b.shape != (a.shape[1], mod.out_features):
                raise ValueError(f"LoRA '{name}': a {tuple(a.shape)} / b {tuple(b.shape)} do not fit "
                                 f"[{mod.in_features} -> {mod.out_features}]")
            ara = LoRA(mod.in_features, a.shape[1], mod.out_features, float(leaf["scale"]), device=dev)
            with torch.no_grad():
                ara.a.copy_(a)
                ara.b.copy_(b)
            mod.ara = ara.requires_grad_(False)
    return len(tree)


def concat_loras(first: dict[str, LoRA], second: dict[str, LoRA]) -> dict[str, dict[str, torch.Tensor]]:
    """Two LoRA networks as one tree (JAX ``concat_loras``): per shared module
    ``a`` and the scale-folded ``b`` concatenated along the rank, scale 1, so
    the delta is a1 b1 s1 + a2 b2 s2 exactly; a module in only one passes
    through as it is. ``Linear.forward`` stacks an ARA with the trainable
    LoRA the same way."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    for name in {**first, **second}:
        x, y = first.get(name), second.get(name)
        if x is None or y is None:
            m = x if y is None else y
            out[name] = {"a": m.a, "b": m.b, "scale": m.scale}
            continue
        (ax, bx), (ay, by) = fold_scale(x), fold_scale(y)
        out[name] = {"a": torch.cat([ax, ay], dim=-1), "b": torch.cat([bx, by], dim=0),
                     "scale": torch.ones_like(x.scale)}
    return out


def detach_lora(model: nn.Module) -> None:
    """Remove every LoRA overlay from ``model``."""
    for mod in model.modules():
        if isinstance(mod, Linear):
            mod.lora = None


@torch.no_grad()
def merge_lora(model: nn.Module, multiplier: float = 1.0) -> None:
    """W' = W + multiplier * scale * (a @ b)^T for every attached LoRA, then
    detach it (JAX ``merge_lora``; torch weights are ``[out, in]``)."""
    for mod in model.modules():
        if isinstance(mod, Linear) and mod.lora is not None:
            if mod.qvalue is not None:
                raise NotImplementedError("merging a LoRA into a quantized base is not ported")
            lo = mod.lora
            delta = (lo.a @ lo.b) * (lo.scale * multiplier)
            mod.weight.add_(delta.t().to(mod.weight.dtype))
            mod.lora = None


def count_lora_params(lora: dict[str, LoRA]) -> int:
    """Elements of every ``a``, ``b`` and ``scale`` (JAX counts the leaf's
    three arrays too)."""
    return sum(p.numel() for m in lora.values() for p in m.parameters())
