"""Progressive distillation, inference half: the twin of the grids and the
DDIM transition of polyp_tpu/train/distill.py.

A student distilled for N steps samples on the trailing grid of N steps;
its teacher's two substeps per student step use the trailing grid of 2N
steps, whose even elements are the student grid and whose odd elements
are the midpoints (nesting needs T % 2N == 0). `distill_grid` builds those
tables and `ddim_transition` is the deterministic (η = 0) DDIM move that
both the sampler and the distillation targets take. The training half
(`distill_targets`, the distill step, the phase loop) is still to port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from polyp_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    inference_timesteps,
)


@dataclass(frozen=True)
class DistillGrid:
    """Per-student-step timestep tables for one halving phase (all [N])."""

    ts: torch.Tensor         # student timesteps (descending, trailing)
    ts_mid: torch.Tensor     # teacher midpoint timesteps
    abar_t: torch.Tensor     # ᾱ at ts
    abar_mid: torch.Tensor   # ᾱ at ts_mid
    abar_next: torch.Tensor  # ᾱ at the transition target (endpoint: ᾱ₀)
    num_steps: int = 0


def distill_grid(schedule: DiffusionSchedule, num_student_steps: int,
                 final_alpha_to_one: bool = False) -> DistillGrid:
    """The nested trailing grids of one phase (reference :81-104). Raises
    unless T % (2·N) == 0: only then is the student grid exactly the even
    elements of the teacher grid."""
    T, N = schedule.num_train_timesteps, num_student_steps
    if N < 1 or T % (2 * N) != 0:
        raise ValueError(
            f"progressive distillation needs T % (2*N) == 0 for nested "
            f"trailing grids; got T={T}, N={N}")
    ts_s = np.asarray(inference_timesteps(T, N, "trailing"))
    ts_2 = np.asarray(inference_timesteps(T, 2 * N, "trailing"))
    if not (ts_2[0::2] == ts_s).all():
        raise AssertionError("trailing grids failed to nest")
    ts_mid = ts_2[1::2]
    abar = schedule.alphas_cumprod.cpu()
    final_abar = torch.ones(1) if final_alpha_to_one else abar[:1]
    return DistillGrid(
        ts=torch.from_numpy(ts_s), ts_mid=torch.from_numpy(ts_mid),
        abar_t=abar[ts_s], abar_mid=abar[ts_mid],
        abar_next=torch.cat([abar[ts_s[1:]], final_abar]), num_steps=N)


def ddim_transition(x0: torch.Tensor, eps: torch.Tensor,
                    abar_next: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM transition from a (x̂₀, ε̂) decomposition:
    x′ = √ᾱ′·x̂₀ + √(1−ᾱ′)·ε̂ (reference :116-121), with ᾱ′ a scalar or one
    value per sample."""
    a = torch.as_tensor(abar_next, dtype=torch.float32, device=x0.device)
    a = a.reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
