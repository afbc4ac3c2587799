"""LoRA extraction: the SVD of weight differences (``ai_toolkit_tpu/adapters/extract.py``
in PyTorch).

Kernels are in the JAX layout, ``[in, out]``, or stacked ``[L, in, out]``
(a scanned JAX stack), keyed by module name. The SVD runs in float64 with
``torch.linalg.svd`` on the kernels' device. Singular vectors are defined
only up to sign, so two extractions agree in their products ``a @ b *
scale``, not in their factors.
"""

from __future__ import annotations

import math

import torch


def svd_extract(diff: torch.Tensor, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` difference -> (a ``[in, r]``, b ``[r, out]``) in f32 with
    ``a @ b`` its best rank-``r`` approximation, ``sqrt(s)`` on each factor
    (JAX ``svd_extract``)."""
    u, s, vh = torch.linalg.svd(diff.double(), full_matrices=False)
    r = min(rank, s.shape[0])
    sqrt_s = torch.sqrt(s[:r])
    return (u[:, :r] * sqrt_s[None, :]).float(), (sqrt_s[:, None] * vh[:r]).float()


@torch.no_grad()
def extract_lora_from_diff(base: dict[str, torch.Tensor], tuned: dict[str, torch.Tensor], rank: int = 16,
                           alpha: float | None = None, min_diff: float = 1e-6) -> dict[str, dict[str, torch.Tensor]]:
    """``{module: {a, b, scale}}`` for every module of ``base`` whose kernel
    in ``tuned`` has its shape and differs by ``min_diff`` or more somewhere
    (JAX ``extract_lora_from_diff``): the difference in f32, its rank-``rank``
    SVD, and ``alpha / r`` (alpha defaults to ``rank``) baked out of the
    factors, so ``a @ b * scale`` is the rank-``r`` difference. A stacked
    kernel gives one SVD and one leaf per layer, keyed ``<module>.<l>`` (the
    JAX job's file keys for a stack)."""
    alpha = float(alpha if alpha is not None else rank)
    lora: dict[str, dict[str, torch.Tensor]] = {}
    for name, w0 in base.items():
        w1 = tuned.get(name)
        if w1 is None or w0.shape != w1.shape or w0.dim() not in (2, 3):
            continue
        diff = w1.float() - w0.float()
        if float(diff.abs().max()) < min_diff:
            continue
        layers = {name: diff} if diff.dim() == 2 else {f"{name}.{i}": d for i, d in enumerate(diff)}
        for key, d in layers.items():
            a, b = svd_extract(d, rank)
            scale = alpha / a.shape[1]
            lora[key] = {"a": a / math.sqrt(scale), "b": b / math.sqrt(scale),
                         "scale": torch.tensor(scale, dtype=torch.float32, device=a.device)}
    return lora
