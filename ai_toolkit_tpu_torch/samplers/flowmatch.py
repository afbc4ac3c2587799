"""Flow-matching schedule (``ai_toolkit_tpu/samplers/flowmatch.py`` in PyTorch):
the Euler sampling half and the training half the flux LoRA job takes
(timestep distributions ``linear``, ``sigmoid``, ``shift``, ``flux_shift``;
``add_noise``; the velocity target). The other train-time distributions
(``lognorm_blend``, ``weighted`` weights, ``one_step``) raise
``NotImplementedError``."""

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
    # a per-timestep loss-weight table of num_train_timesteps floats, read by
    # the 'weighted' timesteps (which raise: the train-step knobs slice)
    weighting_table: tuple | None = None

    # ---- training ----

    def timesteps_from_uniform(self, u: torch.Tensor, timestep_type: str,
                               image_seq_len: int | None = None,
                               timestep_bias: float = 1.0) -> torch.Tensor:
        """t in (0, 1] from uniform draws ``u`` ~ U(1e-4, 1 - 1e-4) ``[B]``, for
        the distributions that are a function of ``u`` (JAX
        ``sample_timesteps``)."""
        if timestep_type == "linear":
            t = u
        elif timestep_type in ("shift", "lumina2_shift"):
            t = self.shift * u / (1.0 + (self.shift - 1.0) * u)
        elif timestep_type == "flux_shift":
            seq = image_seq_len if image_seq_len is not None else 1024
            mu = calculate_flux_shift(seq, self.base_image_seq_len, self.max_image_seq_len,
                                      self.base_shift, self.max_shift)
            t = time_shift(mu, 1.0, u, self.time_shift_type)
        else:
            raise NotImplementedError(
                f"timestep_type '{timestep_type}' is not a function of u; ported: linear, "
                f"shift, flux_shift (sigmoid through sample_timesteps)")
        return self._finish(t, timestep_bias)

    def sample_timesteps(self, generator: torch.Generator, batch_size: int,
                         timestep_type: str = "sigmoid", image_seq_len: int | None = None,
                         timestep_bias: float = 1.0, device=None) -> torch.Tensor:
        """Sample t ``[B]`` f32 per example from ``generator``."""
        device = device if device is not None else generator.device
        if timestep_type == "sigmoid":
            z = torch.randn((batch_size,), generator=generator, dtype=torch.float32, device=device)
            return self._finish(torch.sigmoid(z), timestep_bias)
        if timestep_type in ("lognorm_blend", "one_step", "weighted"):
            raise NotImplementedError(
                f"timestep_type '{timestep_type}' comes with the train-step knobs slice")
        u = torch.rand((batch_size,), generator=generator, dtype=torch.float32, device=device)
        u = u * (1.0 - 2e-4) + 1e-4
        return self.timesteps_from_uniform(u, timestep_type, image_seq_len, timestep_bias)

    @staticmethod
    def _finish(t: torch.Tensor, timestep_bias: float) -> torch.Tensor:
        if timestep_bias != 1.0:
            t = torch.pow(t, timestep_bias)
        return torch.clamp(t, 1e-5, 1.0)

    @staticmethod
    def add_noise(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x_t = (1-t) x0 + t noise (t broadcast from [B] over sample dims)."""
        t = t.reshape(t.shape + (1,) * (x0.dim() - t.dim())).to(x0.dtype)
        return (1.0 - t) * x0 + t * noise

    @staticmethod
    def target(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Velocity target v = noise - x0."""
        return noise - x0

    @staticmethod
    def pred_to_x0(pred: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """A velocity prediction stepped all the way to x0: x0 = x_t - t v."""
        return x_t - t.reshape(t.shape + (1,) * (x_t.dim() - t.dim())).to(x_t.dtype) * pred

    # ---- sampling ----

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
