"""Train state (``ai_toolkit_tpu/train/state.py`` in PyTorch): the trainable
parameters, the optimizer and its state (its step count), and an EMA of the
trainable parameters updated after each optimizer step (JAX
``TrainState.apply_gradients``). The frozen model lives in the model's
``variables``; the trainable parameters are tensors of those modules (the
LoRA factors), updated in place."""

from __future__ import annotations

import torch

from ai_toolkit_tpu_torch.train.optimizers import AdamW, weak


class TrainState:
    def __init__(self, trainable: dict[str, torch.Tensor], optimizer: AdamW, use_ema: bool = False):
        self.trainable = trainable
        self.optimizer = optimizer
        self.ema = ({k: v.detach().clone() for k, v in trainable.items()} if use_ema else None)

    @torch.no_grad()
    def apply_gradients(self, grads: list[torch.Tensor], ema_decay: float | None = None) -> None:
        """Optimizer step on ``trainable`` (``grads`` in its order), then
        ema <- ema * decay + p * (1 - decay) in the EMA's dtype, the scalars
        rounded to it as JAX rounds them (0.99 is 0.98828125 in bf16)."""
        self.optimizer.step(grads)
        if self.ema is not None and ema_decay is not None:
            for k, p in self.trainable.items():
                e = self.ema[k]
                e.copy_(e * weak(ema_decay, e.dtype) + p.to(e.dtype) * weak(1.0 - ema_decay, e.dtype))
