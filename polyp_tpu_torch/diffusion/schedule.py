"""Noise schedules: the twin of polyp_tpu/diffusion/schedule.py.

The tables are float32 and computed in float32, as the reference computes
them: JAX runs without x64, so its "float64" requests (schedule.py:37-43)
are float32 arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor            # [T] float32
    alphas_cumprod: torch.Tensor   # [T] float32
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"

    @staticmethod
    def create(num_train_timesteps: int = 1000,
               beta_schedule: str = "linear",
               beta_start: float = 1e-4,
               beta_end: float = 2e-2,
               prediction_type: str = "epsilon") -> "DiffusionSchedule":
        """`linear` matches DDPMScheduler defaults (scratch path);
        `scaled_linear` with (0.00085, 0.012) is the SD-v1 schedule."""
        n = num_train_timesteps
        f32 = dict(dtype=torch.float32)
        if beta_schedule == "linear":
            betas = torch.linspace(beta_start, beta_end, n, **f32)
        elif beta_schedule == "scaled_linear":
            betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, n,
                                   **f32) ** 2
        elif beta_schedule == "squaredcos_cap_v2":
            t = torch.arange(n, **f32)

            def abar(i):
                return torch.cos((i / n + 0.008) / 1.008 * math.pi / 2) ** 2
            betas = torch.clamp(1.0 - abar(t + 1) / abar(t), 0.0, 0.999)
        else:
            raise ValueError(f"unknown beta_schedule: {beta_schedule}")
        return DiffusionSchedule(betas=betas,
                                 alphas_cumprod=torch.cumprod(1.0 - betas, 0),
                                 num_train_timesteps=n,
                                 prediction_type=prediction_type)

    def to(self, device: torch.device | str) -> "DiffusionSchedule":
        return DiffusionSchedule(self.betas.to(device),
                                 self.alphas_cumprod.to(device),
                                 self.num_train_timesteps,
                                 self.prediction_type)

    def _coefficients(self, x0: torch.Tensor, timesteps: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """√ᾱ_t and √(1−ᾱ_t) per sample, shaped to broadcast over x0."""
        abar = self.alphas_cumprod.to(x0.device)[timesteps]
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return (torch.sqrt(abar).reshape(shape).to(x0.dtype),
                torch.sqrt(1.0 - abar).reshape(shape).to(x0.dtype))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε with per-sample integer
        timesteps (DDPMScheduler.add_noise)."""
        sqrt_abar, sqrt_1m = self._coefficients(x0, timesteps)
        return sqrt_abar * x0 + sqrt_1m * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
        """The v-prediction target √ᾱ·ε − √(1−ᾱ)·x₀."""
        sqrt_abar, sqrt_1m = self._coefficients(x0, timesteps)
        return sqrt_abar * noise - sqrt_1m * x0

    def to_x0_eps(self, model_out: torch.Tensor, x_t: torch.Tensor,
                  t: int | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Convert a model output at the timestep `t` (a scalar, or one
        per sample) under `prediction_type` into (x̂₀, ε̂)."""
        abar = self.alphas_cumprod[t]
        if abar.dim():
            abar = abar.reshape((-1,) + (1,) * (x_t.dim() - 1))
        sqrt_abar, sqrt_1m = torch.sqrt(abar), torch.sqrt(1.0 - abar)
        if self.prediction_type == "epsilon":
            eps = model_out
            x0 = (x_t - sqrt_1m * eps) / sqrt_abar
        elif self.prediction_type == "v_prediction":
            x0 = sqrt_abar * x_t - sqrt_1m * model_out
            eps = sqrt_abar * model_out + sqrt_1m * x_t
        elif self.prediction_type == "sample":
            x0 = model_out
            eps = (x_t - sqrt_abar * x0) / sqrt_1m
        else:
            raise ValueError(self.prediction_type)
        return x0, eps


def inference_timesteps(num_train_timesteps: int, num_inference_steps: int,
                        spacing: str = "leading",
                        steps_offset: int = 0) -> list[int]:
    """Descending timestep subset for few-step sampling, with diffusers'
    spacing conventions ("leading", "linspace", "trailing"; see the
    reference's docstring, schedule.py:105-122)."""
    T, S = num_train_timesteps, num_inference_steps
    if spacing == "leading":
        ts = (np.arange(S) * (T // S)).round()[::-1] + steps_offset
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, S + 1).round()[::-1][:-1]
    elif spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / S)) - 1
    else:
        raise ValueError(f"unknown timestep spacing: {spacing}")
    return [int(t) for t in ts]
