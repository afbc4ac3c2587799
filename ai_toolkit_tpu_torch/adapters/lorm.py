"""LoRM, low-rank module replacement (``ai_toolkit_tpu/adapters/lorm.py`` in
PyTorch).

Each targeted ``Linear``'s kernel is factored by its singular values into
``a`` ``[in, r]`` and ``b`` ``[r, out]`` (``a @ b`` the best rank-``r``
approximation of the kernel ``[in, out]``), which train in its place
(``ops.layers.LoRM``); the weight is freed, as JAX deletes the kernel leaf.
The rank comes from an extract mode over the singular values S (JAX
``_rank_for``): ``fixed`` (the parameter), ``threshold`` (S > p),
``ratio`` (S > p max S), ``quantile`` / ``percentile`` (the cumulative sum
below p of the total) or ``percentage`` (p of the parameter count), at least
1 and at most the smaller width, and halved to ``out / 2`` when it reaches
that. A kernel with no more than ``parameter_threshold`` elements is kept.

JAX matches its targets with the model's patterns and ``ignore_if_contains``
(always ``proj_in`` and ``proj_out``), never ``only_if_contains``, and
factors 2-D kernels and scanned ``[L, in, out]`` stacks. The port mirrors
the layout JAX's config has: where JAX scans the blocks (every full size),
the same-named ``Linear`` of every block of a stack is factored at the
largest rank any of them selects, and ``parameter_threshold`` holds against
the whole stack; an unrolled model (``tiny``) factors each at its own rank.

The factors come from the eigendecomposition of the kernel's smaller Gram
matrix in float64 on the kernel's device (JAX: LAPACK's SVD in float64 on
the host). Singular vectors are defined up to sign, so the factors differ
from JAX's by signs; ``a @ b`` and the ranks do not."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch
from torch import nn

from ai_toolkit_tpu_torch.ops.layers import Linear, LoRM

MODES = ("fixed", "threshold", "ratio", "quantile", "percentile", "percentage")


@dataclass
class LoRMSpec:
    extract_mode: str = "ratio"
    extract_mode_param: float = 0.25
    parameter_threshold: int = 0
    target_patterns: list[str] = field(default_factory=list)  # regexes over the port's module names
    ignore_if_contains: tuple = ("proj_in", "proj_out")

    @classmethod
    def from_network_config(cls, net, target_patterns: list[str] | None) -> "LoRMSpec":
        """JAX ``_build_trainable``'s LoRM branch: the extract knobs from
        ``network_kwargs`` (``lorm_extract_mode`` / ``extract_mode``,
        ``lorm_extract_mode_param`` / ``extract_mode_param``,
        ``parameter_threshold``), the model's targets and
        ``ignore_if_contains`` plus ``proj_in`` / ``proj_out``."""
        kw = net.network_kwargs or {}
        mode = str(kw.get("lorm_extract_mode", kw.get("extract_mode", "ratio")))
        if mode not in MODES:
            raise ValueError(f"unknown lorm extract_mode {mode!r}")
        return cls(extract_mode=mode,
                   extract_mode_param=float(kw.get("lorm_extract_mode_param", kw.get("extract_mode_param", 0.25))),
                   parameter_threshold=int(kw.get("parameter_threshold", 0)),
                   target_patterns=list(target_patterns or []),
                   ignore_if_contains=tuple(list(net.ignore_if_contains or []) + ["proj_in", "proj_out"]))


def rank_for(s: torch.Tensor, spec: LoRMSpec, out_ch: int, in_ch: int) -> int:
    """JAX ``_rank_for`` over the singular values ``s`` (descending, f64)."""
    mode, p = spec.extract_mode, spec.extract_mode_param
    if mode == "fixed":
        r = int(p)
    elif mode == "threshold":
        r = int((s > p).sum())
    elif mode == "ratio":
        r = int((s > float(s.max()) * p).sum())
    elif mode in ("quantile", "percentile"):
        r = int((torch.cumsum(s, 0) < p * float(s.sum())).sum())
    else:  # percentage
        r = int(p * out_ch * in_ch / (in_ch + out_ch))
    r = max(1, min(out_ch, in_ch, r))
    if r >= out_ch / 2:
        r = max(1, int(out_ch / 2))
    return r


class _Spectrum:
    """The singular values of a kernel ``K = W^T`` ``[in, out]`` (``W`` the
    torch weight) and the singular vectors of its smaller side, from that
    side's Gram matrix in f64."""

    def __init__(self, w: torch.Tensor):
        k = w.detach().double().t()  # [in, out]
        self.left = k.shape[0] <= k.shape[1]
        evals, evecs = torch.linalg.eigh(k @ k.t() if self.left else k.t() @ k)
        self.s = torch.sqrt(torch.clamp(evals.flip(0), min=0.0))
        self.vecs = evecs.flip(1)

    def factors(self, w: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(a [in, r], b [r, out])`` in f32: ``a = U_r S_r``, ``b = V_r^T``."""
        k, v = w.detach().double().t(), self.vecs[:, :r]
        if self.left:  # K K^T = U S^2 U^T
            a, b = v * self.s[:r], (v.t() @ k) / self.s[:r, None]
        else:  # K^T K = V S^2 V^T
            a, b = k @ v, v.t()
        return a.float(), b.float()


def _matches(name: str, spec: LoRMSpec) -> bool:
    if any(w in name for w in spec.ignore_if_contains):
        return False
    return not spec.target_patterns or any(re.search(p, name) for p in spec.target_patterns)


def _stack_key(name: str) -> str:
    """The name of ``name``'s stack in a scanned layout: the block index of
    ``<list>.<i>.<rest>`` made a wildcard (a top-level module is its own)."""
    return re.sub(r"^(\w+)\.\d+\.", r"\1.*.", name, count=1)


@torch.no_grad()
def build_lorm(model: nn.Module, spec: LoRMSpec, scanned: bool) -> tuple[dict[str, LoRM], dict]:
    """Replace every matching ``Linear``'s kernel by its LoRM factors.
    ``scanned``: the JAX layout stacks the blocks (see the module
    docstring). Returns ``({module name: LoRM}, stats)``, the stats as JAX
    counts them (``modules`` per kernel leaf: a stack is one)."""
    groups: dict[str, list[tuple[str, Linear]]] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.lorm is None and _matches(name, spec):
            groups.setdefault(_stack_key(name) if scanned else name, []).append((name, mod))
    out: dict[str, LoRM] = {}
    stats = {"modules": 0, "params_before": 0, "params_after": 0, "ranks": []}
    for mods in groups.values():
        size = sum(m.in_features * m.out_features for _, m in mods)
        if size <= spec.parameter_threshold:
            continue
        spectra = [_Spectrum(m.dequantized()) for _, m in mods]
        r = max(rank_for(sp.s, spec, m.out_features, m.in_features) for sp, (_, m) in zip(spectra, mods))
        for sp, (name, m) in zip(spectra, mods):
            a, b = sp.factors(m.dequantized(), r)
            m.replace_by_lorm(LoRM(a, b))
            out[name] = m.lorm
            stats["params_after"] += a.numel() + b.numel()
        stats["modules"] += 1
        stats["params_before"] += size
        stats["ranks"].append(r)
        del spectra
    return out, stats


def lorm_stats_str(stats: dict) -> str:
    """JAX ``lorm_stats_str``."""
    before, after, ranks = stats["params_before"], stats["params_after"], stats["ranks"]
    if not ranks:
        return "LoRM: 0 modules"
    return (f"LoRM: {stats['modules']} modules replaced, {before:,} -> {after:,} params "
            f"({(1 - after / max(before, 1)) * 100:.1f}% reduction, ranks {min(ranks)}-{max(ranks)})")
