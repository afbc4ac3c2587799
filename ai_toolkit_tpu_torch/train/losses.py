"""Training loss (``ai_toolkit_tpu/train/losses.py`` ``compute_loss`` in PyTorch):
the ``mse`` core with optional per-example timestep weights and loss
multipliers, all weighting in f32. The other cores (mae, pseudo-huber,
wavelet), masked losses and prior blending raise ``NotImplementedError``."""

from __future__ import annotations

import torch


def compute_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    loss_type: str = "mse",
    timestep_weights: torch.Tensor | None = None,  # [B]
    loss_multiplier: torch.Tensor | None = None,  # [B]
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Scalar loss and metrics ``{loss_raw}``."""
    if loss_type != "mse":
        raise NotImplementedError(f"loss_type '{loss_type}' comes with the train-step knobs slice (mse only)")
    if mask is not None:
        raise NotImplementedError("masked losses come with the train-step knobs slice")
    d = pred.float() - target.float()
    elem = d * d
    per_ex = elem.mean(dim=tuple(range(1, elem.dim())))  # [B]
    loss_raw = per_ex.mean()
    if timestep_weights is not None:
        per_ex = per_ex * timestep_weights.float()
    if loss_multiplier is not None:
        per_ex = per_ex * loss_multiplier.float()
    return per_ex.mean(), {"loss_raw": loss_raw}
