"""Diffusion training losses: the twin of polyp_tpu/diffusion/losses.py.

The ε-MSE objective (in fp32, for every prediction type) and the
visual-influence auxiliary loss. Latents are NCHW here, so the latent mean
pools dims (2, 3).
"""

from __future__ import annotations

import torch

from polyp_tpu_torch.diffusion.schedule import DiffusionSchedule


def epsilon_mse_loss(schedule: DiffusionSchedule, model_out: torch.Tensor,
                     x0: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
    """MSE between the model output and its target under the schedule's
    prediction type (ε, v or x₀)."""
    if schedule.prediction_type == "epsilon":
        target = noise
    elif schedule.prediction_type == "v_prediction":
        target = schedule.velocity(x0, noise, timesteps)
    elif schedule.prediction_type == "sample":
        target = x0
    else:
        raise ValueError(schedule.prediction_type)
    return torch.mean(torch.square(model_out.float() - target.float()))


def visual_influence_loss(text_hidden_states: torch.Tensor,
                          latents: torch.Tensor,
                          proj_kernel: torch.Tensor,
                          proj_bias: torch.Tensor) -> torch.Tensor:
    """1 − cos(mean-pooled text states, Linear(4→768) of the mean-pooled
    latent): text states [N, 77, 768], latents NCHW [N, 4, h, w],
    `proj_kernel` [4, 768] (in, out)."""
    text_pooled = torch.mean(text_hidden_states.float(), dim=1)
    latent_pooled = torch.mean(latents.float(), dim=(2, 3))
    projected = latent_pooled @ proj_kernel + proj_bias
    cos = torch.sum(text_pooled * projected, -1) / (
        torch.linalg.norm(text_pooled, dim=-1)
        * torch.linalg.norm(projected, dim=-1) + 1e-8)
    return 1.0 - torch.mean(cos)
