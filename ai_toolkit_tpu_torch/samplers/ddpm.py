"""DDPM schedule for epsilon / v-prediction models (``ai_toolkit_tpu/samplers/ddpm.py``
``DDPMSchedule`` in PyTorch), the parts the SDXL jobs take: the beta tables
(numpy, on the host, as in the JAX package), the timestep draws (the
``balanced`` uniform one, the cubic ``content`` / ``style`` skews, the
discrete two / four / eight step grids, ``one_step`` and ``next_sample``),
``add_noise``, the epsilon / v / sample targets, the SNR and its min-SNR-gamma
loss weight, ``pred_to_x0``, and DDIM sampling (``ddim_timesteps``,
``ddim_step``). The k-diffusion steppers raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

SLICE = "is not ported yet (ROADMAP Queue 1 item 3: the other samplers)"
# the JAX schedule's k-diffusion, LCM and PNDM steppers (ddpm.py:159-389)
_UNPORTED_STEPPERS = frozenset((
    "sigma_table", "inference_sigmas", "timestep_for_sigma", "scale_model_input", "denoised_from_eps",
    "euler_ancestral_step", "heun_step", "lms_coefficients", "lms_step", "lcm_timesteps", "lcm_step",
    "pndm_timesteps", "pndm_prev_sample", "dpm_2_step", "dpm_2_a_step", "dpmpp_2s_step", "dpmpp_2m_step",
))


@dataclass(frozen=True)
class DDPMSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # scaled_linear | linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample

    @cached_property
    def betas(self) -> np.ndarray:
        n = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            return np.linspace(self.beta_start**0.5, self.beta_end**0.5, n, dtype=np.float32) ** 2
        if self.beta_schedule == "linear":
            return np.linspace(self.beta_start, self.beta_end, n, dtype=np.float32)
        if self.beta_schedule == "squaredcos_cap_v2":
            t = np.arange(n + 1, dtype=np.float32) / n
            f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
            alphas = f[1:] / f[:-1]
            return np.clip(1.0 - alphas, 0.0, 0.999)
        raise ValueError(f"unknown beta schedule {self.beta_schedule}")

    @cached_property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas).astype(np.float32)

    @cached_property
    def _acp(self) -> torch.Tensor:
        return torch.from_numpy(self.alphas_cumprod)

    # ---- training ----

    def sample_timesteps(self, generator: torch.Generator, batch_size: int, min_t: int = 0,
                         max_t: int | None = None, content_or_style: str = "balanced",
                         timestep_type: str | None = None, next_sample_timesteps: int | None = None,
                         device=None) -> torch.Tensor:
        """Integer timestep indices ``[B]`` (JAX ``sample_timesteps``): a
        discrete grid's entries (``two_step``: 0 and n/2 - 1), zeros
        (``one_step``), ``next_sample``'s K-step ladder, the cubic skews
        (``content`` favours low noise, ``style`` high) mapped into ``[min_t,
        max_t)``, or the ``balanced`` uniform draw from ``[min_t + 1,
        max(min_t + 2, max_t - 1))`` (JAX ``randint``'s bounds)."""
        device = device if device is not None else generator.device
        n = self.num_train_timesteps
        max_t = max_t if max_t is not None else n
        if timestep_type in ("two_step", "four_step", "eight_step"):
            k = {"two_step": 2, "four_step": 4, "eight_step": 8}[timestep_type]
            choices = torch.tensor([0, n // 2 - 1] if k == 2 else [i * (n // k) for i in range(k)], device=device)
            return choices[torch.randint(0, k, (batch_size,), generator=generator, device=device)]
        if timestep_type == "one_step":
            return torch.zeros((batch_size,), dtype=torch.int64, device=device)
        if timestep_type == "next_sample":
            k = next_sample_timesteps or n
            return torch.randint(0, max(k - 2, 1), (batch_size,), generator=generator, device=device) * (n // k)
        if timestep_type is not None:
            raise ValueError(f"unknown DDPM timestep_type {timestep_type!r}")
        if content_or_style in ("content", "style"):
            u = torch.rand((batch_size,), generator=generator, dtype=torch.float32, device=device)
            return self.skewed_timesteps(u, content_or_style, min_t, max_t)
        if content_or_style != "balanced":
            raise ValueError(f"unknown content_or_style {content_or_style!r}")
        lo = min_t + 1
        hi = max(lo + 1, max_t - 1)
        return torch.randint(lo, hi, (batch_size,), generator=generator, device=device)

    def skewed_timesteps(self, u: torch.Tensor, content_or_style: str, min_t: int, max_t: int) -> torch.Tensor:
        """The cubic content / style skew of uniform draws ``u`` in f32."""
        n = self.num_train_timesteps
        idx = (u ** 3 if content_or_style == "content" else 1.0 - u ** 3) * n
        idx = min_t + idx * (max_t - 1 - min_t) / max(n - 1, 1)
        return torch.clamp(idx.to(torch.int32), min_t, max_t - 1).long()

    def _gather(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """f32 alphas_cumprod at the integer timesteps ``t``, shaped to broadcast."""
        v = self._acp.to(t.device)[t.long()]
        return v.reshape(v.shape + (1,) * (ndim - v.dim()))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        acp = self._gather(t, x0.dim()).to(x0.dtype)
        return torch.sqrt(acp) * x0 + torch.sqrt(1.0 - acp) * noise

    def target(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            acp = self._gather(t, x0.dim()).to(x0.dtype)
            return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * x0
        if self.prediction_type == "sample":
            return x0
        raise ValueError(self.prediction_type)

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        acp = self._acp.to(t.device)[t.long()]
        return acp / (1.0 - acp)

    def min_snr_weight(self, t: torch.Tensor, gamma: float) -> torch.Tensor:
        """min(snr, gamma) / snr (epsilon, sample) or / (snr + 1) (v-prediction), f32 ``[B]``."""
        snr = self.snr(t)
        w = torch.clamp(snr, max=gamma)
        if self.prediction_type == "v_prediction":
            return w / (snr + 1.0)
        return w / torch.clamp(snr, min=1e-8)

    def pred_to_x0(self, pred: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        acp = self._gather(t, x_t.dim()).to(x_t.dtype)
        if self.prediction_type == "epsilon":
            return (x_t - torch.sqrt(1.0 - acp) * pred) / torch.sqrt(acp)
        if self.prediction_type == "v_prediction":
            return torch.sqrt(acp) * x_t - torch.sqrt(1.0 - acp) * pred
        return pred

    # ---- DDIM sampling ----

    def ddim_timesteps(self, num_steps: int) -> np.ndarray:
        step = self.num_train_timesteps // num_steps
        return (np.arange(num_steps) * step)[::-1] + 1

    def ddim_step(self, x_t: torch.Tensor, pred: torch.Tensor, t: torch.Tensor,
                  t_prev: torch.Tensor) -> torch.Tensor:
        """One deterministic DDIM step (eta 0) from ``t`` to ``t_prev`` (-1:
        the end, alphas_cumprod 1), in f32, cast back to ``x_t``'s dtype."""
        acp_t = self._gather(t, x_t.dim())
        acp_prev = torch.where(t_prev >= 0, self._acp.to(t_prev.device)[t_prev.long().clamp(min=0)],
                               torch.ones((), device=t_prev.device))
        acp_prev = acp_prev.reshape(acp_prev.shape + (1,) * (x_t.dim() - acp_prev.dim()))
        xf, pf = x_t.float(), pred.float()
        x0 = self.pred_to_x0(pf, xf, t)
        if self.prediction_type == "epsilon":
            eps = pf
        else:
            eps = (xf - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
        return (torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps).to(x_t.dtype)

    def __getattr__(self, name: str):
        if name in _UNPORTED_STEPPERS:
            raise NotImplementedError(f"DDPMSchedule.{name} {SLICE}")
        raise AttributeError(name)
