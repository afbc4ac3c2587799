"""Training losses (``ai_toolkit_tpu/train/losses.py`` in PyTorch): the
``mse``, ``mae``, ``pseudo_huber`` (``huber_c``) and ``wavelet`` (mse over
the four single-level Haar subbands) cores, per-example timestep weights and
loss multipliers, the masked loss (the mask clipped to ``[0, 1]``: JAX's
``mask_min_value`` argument is never passed, so the dataset option is not
read; average-pooled to the wavelet's half size, the loss normalised by the
mask's coverage), the inverted-mask prior blend (outside the mask, the
prediction regresses toward the adapter-off prior), and the
differential-output-preservation loss. All weighting in f32."""

from __future__ import annotations

import torch


def haar_dwt2(x: torch.Tensor) -> torch.Tensor:
    """Single-level 2-D Haar transform ``[B, H, W, C] -> [B, H/2, W/2, 4C]``
    (LL | LH | HL | HH); an odd last row or column is dropped."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    a, b = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    c, d = x[:, 1::2, 0::2], x[:, 1::2, 1::2]
    return torch.cat([(a + b + c + d) * 0.5, (a - b + c - d) * 0.5,
                      (a + b - c - d) * 0.5, (a - b - c + d) * 0.5], dim=-1)


def _core(pred: torch.Tensor, target: torch.Tensor, loss_type: str, huber_c: float) -> torch.Tensor:
    if loss_type == "wavelet":
        d = haar_dwt2(pred.float()) - haar_dwt2(target.float())
        return d * d
    d = pred.float() - target.float()
    if loss_type == "mse":
        return d * d
    if loss_type == "mae":
        return d.abs()
    if loss_type == "pseudo_huber":
        return torch.sqrt(d * d + huber_c * huber_c) - huber_c
    raise ValueError(f"unknown loss_type {loss_type}")


def _mean_rest(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def compute_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    loss_type: str = "mse",
    huber_c: float = 0.001,
    timestep_weights: torch.Tensor | None = None,  # [B]
    loss_multiplier: torch.Tensor | None = None,  # [B]
    mask: torch.Tensor | None = None,  # broadcastable to pred, in [0, 1]
    prior_pred: torch.Tensor | None = None,  # the adapter-off prediction (inverted-mask prior)
    inverted_mask_prior_multiplier: float = 0.5,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Scalar loss and metrics ``{loss_raw}`` (and ``prior_loss`` with a prior)."""
    elem = _core(pred, target, loss_type, huber_c)
    aux: dict[str, torch.Tensor] = {}
    if mask is not None:
        mask = torch.clamp(mask.float(), 0.0, 1.0)
        if mask.dim() >= 3 and elem.dim() >= 3 and mask.shape[1] != elem.shape[1]:
            f = mask.shape[1] // elem.shape[1]  # the wavelet halves the spatial dims: pool the mask
            mask = mask[:, : elem.shape[1] * f, : elem.shape[2] * f]
            mask = mask.reshape(mask.shape[0], elem.shape[1], f, elem.shape[2], f, -1).mean(dim=(2, 4))
        per_ex = _mean_rest(elem * mask) / torch.clamp(_mean_rest(mask), min=1e-4)
        if prior_pred is not None and inverted_mask_prior_multiplier > 0:
            inv_per_ex = _mean_rest((1.0 - mask) * _core(pred, prior_pred.detach(), loss_type, huber_c))
            per_ex = per_ex + inverted_mask_prior_multiplier * inv_per_ex
            aux["prior_loss"] = inv_per_ex.mean()
    else:
        per_ex = _mean_rest(elem)
    if timestep_weights is not None:
        per_ex = per_ex * timestep_weights.float()
    if loss_multiplier is not None:
        per_ex = per_ex * loss_multiplier.float()
    aux["loss_raw"] = _mean_rest(elem).mean()
    return per_ex.mean(), aux


def diff_output_preservation_loss(pred: torch.Tensor, prior_pred: torch.Tensor,
                                  multiplier: float = 1.0) -> torch.Tensor:
    """DOP: mean squared distance of the prediction to the adapter-off prior."""
    d = pred.float() - prior_pred.detach().float()
    return (d * d).mean() * multiplier
