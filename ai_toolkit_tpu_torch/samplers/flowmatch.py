"""Flow-matching inference schedule (``ai_toolkit_tpu/samplers/flowmatch.py``,
the Euler sampling half, in PyTorch). Train-time timestep distributions come
with the training slice."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def calculate_flux_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.16,
) -> float:
    """Dynamic shift mu as a function of image sequence length (flux inference rule)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigma: float, t: torch.Tensor, kind: str = "exp") -> torch.Tensor:
    """Dynamic shift of uniform times: 'exp' (flux) or 'linear' (mu used directly)."""
    m = mu if kind == "linear" else math.exp(mu)
    return m / (m + (1.0 / t - 1.0) ** sigma)


@dataclass(frozen=True)
class FlowMatchSchedule:
    """Stateless flow-matching schedule. t=1 is pure noise, t=0 is data."""

    num_train_timesteps: int = 1000
    shift: float = 3.0
    use_dynamic_shifting: bool = True
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.16
    time_shift_type: str = "exp"

    def inference_sigmas(self, num_steps: int, image_seq_len: int | None = None) -> torch.Tensor:
        """Monotone decreasing f32 sigmas ``[num_steps + 1]``, from 1.0 to 0.0 (CPU)."""
        sigmas = torch.linspace(1.0, 1.0 / self.num_train_timesteps, num_steps, dtype=torch.float32)
        if self.use_dynamic_shifting and image_seq_len is not None:
            mu = calculate_flux_shift(image_seq_len, self.base_image_seq_len,
                                      self.max_image_seq_len, self.base_shift, self.max_shift)
            sigmas = time_shift(mu, 1.0, sigmas, self.time_shift_type)
        else:
            sigmas = self.shift * sigmas / (1.0 + (self.shift - 1.0) * sigmas)
        return torch.cat([sigmas, torch.zeros(1)])

    def euler_step(self, x: torch.Tensor, velocity: torch.Tensor, sigma: torch.Tensor,
                   sigma_next: torch.Tensor) -> torch.Tensor:
        """``x + (sigma_next - sigma) * v``; the sigma difference is taken in f32."""
        return x + (sigma_next - sigma) * velocity.to(x.dtype)
