"""Train state (``ai_toolkit_tpu/train/state.py`` in PyTorch): the trainable
parameters, the optimizer and its state (its step count), and an EMA of the
trainable parameters updated after each optimizer step (JAX
``TrainState.apply_gradients``). The frozen model lives in the model's
``variables``; the trainable parameters are tensors of those modules (the
LoRA factors), updated in place. :meth:`TrainState.state_dict` is what a
resume restores: the trainable tensors, the optimizer's moments and count,
the EMA, the step and (DDPM with ``learnable_snr_gos``) the learnable SNR
state, ``lsnr`` (``train/step.LearnableSNR``), which the step updates with
its own AdamW."""

from __future__ import annotations

import torch

from ai_toolkit_tpu_torch.train.optimizers import AdamW, weak


class TrainState:
    def __init__(self, trainable: dict[str, torch.Tensor], optimizer: AdamW, use_ema: bool = False):
        self.trainable = trainable
        self.optimizer = optimizer
        self.step = 0  # optimizer steps taken (JAX ``TrainState.step``)
        self.ema = ({k: v.detach().clone() for k, v in trainable.items()} if use_ema else None)
        self.lsnr = None

    @torch.no_grad()
    def apply_gradients(self, grads: list[torch.Tensor], ema_decay: float | None = None) -> None:
        """Optimizer step on ``trainable`` (``grads`` in its order), then
        ema <- ema * decay + p * (1 - decay) in the EMA's dtype, the scalars
        rounded to it as JAX rounds them (0.99 is 0.98828125 in bf16)."""
        self.optimizer.step(grads)
        self.step += 1
        if self.ema is not None and ema_decay is not None:
            for k, p in self.trainable.items():
                e = self.ema[k]
                e.copy_(e * weak(ema_decay, e.dtype) + p.to(e.dtype) * weak(1.0 - ema_decay, e.dtype))

    def state_dict(self) -> dict[str, torch.Tensor]:
        names = list(self.trainable)
        out = {"step": torch.tensor(self.step, dtype=torch.int64)}
        out.update({f"trainable.{k}": v.detach() for k, v in self.trainable.items()})
        out.update({f"opt.{k}": v for k, v in self.optimizer.state_dict(names).items()})
        if self.ema is not None:
            out.update({f"ema.{k}": v for k, v in self.ema.items()})
        if self.lsnr is not None:
            for part in ("params", "m", "v"):
                out.update({f"lsnr.{part}.{k}": v for k, v in getattr(self.lsnr, part).items()})
            out.update({"lsnr.buffer": self.lsnr.buffer, "lsnr.count": self.lsnr.count})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> bool:
        """Restore :meth:`state_dict` in place; False, with nothing changed,
        when its names, shapes or dtypes are not this state's."""
        mine = self.state_dict()
        if set(mine) != set(state) or any(mine[k].shape != state[k].shape or mine[k].dtype != state[k].dtype
                                          for k in mine):
            return False
        for k, p in self.trainable.items():
            p.copy_(state[f"trainable.{k}"])
        for k, e in (self.ema or {}).items():
            e.copy_(state[f"ema.{k}"])
        if self.lsnr is not None:
            for part in ("params", "m", "v"):
                setattr(self.lsnr, part, {k: state[f"lsnr.{part}.{k}"].to(self.lsnr.buffer.device).clone()
                                          for k in getattr(self.lsnr, part)})
            self.lsnr.buffer = state["lsnr.buffer"].to(self.lsnr.buffer.device).clone()
            self.lsnr.count = state["lsnr.count"].to(self.lsnr.buffer.device).clone()
        self.optimizer.load_state_dict(list(self.trainable), {k[4:]: v for k, v in state.items()
                                                              if k.startswith("opt.")})
        self.step = int(state["step"])
        return True
