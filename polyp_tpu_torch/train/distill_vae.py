"""VAE-decoder distillation: the twin of polyp_tpu/train/distill_vae.py.

A TinyDecoder (models/tiny_decoder.py) learns to match the full
AutoencoderKL decode pixel for pixel on scaled latents: MSE in fp32, the
teacher frozen and run inside each step under `torch.no_grad()` (its
GroupNorms take the GroupNorm kernel on the card), so a step is teacher
decode + student forward and backward + Adam.

Precision, as the other trainers of the port: fp32 master parameters,
cast to the decoder's parameter dtypes (bf16 convs, an fp32 `conv_out`)
inside the autograd graph through `torch.func.functional_call`; the
optimizer is optax.adam(cosine_decay_schedule(lr, total_steps or 10,000))
as `train/classifier.py::OptaxAdam` with a schedule.

Latents: whatever matches the serving distribution. The CLI
(cli/distill_vae.py) mixes VAE-encoded corpus images with the synthetic
generator below (spatially correlated Gaussians), or uses the generator
alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from polyp_tpu_torch.models.vae import SD_VAE_SCALING
from polyp_tpu_torch.train.classifier import OptaxAdam
from polyp_tpu_torch.utils.rng import stream_generator

Params = dict[str, torch.Tensor]
# the reference's cosine horizon when no total is given (its CLI never
# gives one): the rate has decayed only partly at the end of a shorter run
DEFAULT_HORIZON = 10_000
LOG_EVERY = 50


def latents_from_noise(white: torch.Tensor, coarse: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """The synthetic latents of (white [B, C, s, s], coarse [B, C, s/4,
    s/4], w [B, 1, 1, 1]): the coarse noise upsampled bilinearly (half-pixel
    centres, edges clamped, as jax.image.resize's "linear"), mixed
    w·smooth + (1 − w)·white, each sample scaled to unit RMS."""
    smooth = F.interpolate(coarse, size=white.shape[-2:], mode="bilinear",
                           align_corners=False)
    mix = w * smooth + (1.0 - w) * white
    return mix / torch.sqrt(torch.mean(mix ** 2, dim=(1, 2, 3),
                                       keepdim=True) + 1e-6)


def synthetic_latents(generator: torch.Generator, batch: int,
                      latent_size: int, channels: int = 4) -> torch.Tensor:
    """Spatially correlated pseudo-latents in the SCALED latent space
    (about unit variance; reference :45-63), on the generator's device:
    white noise, ¼-resolution noise and a per-sample mixing ratio in
    [0.2, 0.9), drawn in that order."""
    kw = dict(generator=generator, device=generator.device)
    white = torch.randn(batch, channels, latent_size, latent_size, **kw)
    coarse_size = max(latent_size // 4, 1)
    coarse = torch.randn(batch, channels, coarse_size, coarse_size, **kw)
    w = 0.2 + 0.7 * torch.rand(batch, 1, 1, 1, **kw)
    return latents_from_noise(white, coarse, w)


def make_teacher_decode(vae: nn.Module) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """The full decode the student learns: scaled latents → fp32 images,
    as the sampler decodes (pipeline.StableDiffusionSampler.decode)."""
    @torch.no_grad()
    def decode(z: torch.Tensor) -> torch.Tensor:
        return vae.decode(z / SD_VAE_SCALING)

    return decode


def cosine_decay(learning_rate: float, decay_steps: int
                 ) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(learning_rate, decay_steps): lr · ½(1 +
    cos(π · min(count, decay_steps) / decay_steps))."""
    def schedule(count: int) -> float:
        t = min(count, decay_steps) / decay_steps
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t))

    return schedule


@dataclass
class VAEDistillState:
    """The decoder, its fp32 masters (by state-dict name; they require
    grad), the optimizer over them, and the count of steps taken."""

    step: int
    decoder: nn.Module
    params: Params
    optimizer: OptaxAdam

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """The decoder on its masters, cast to its parameter dtypes."""
        dtypes = {k: p.dtype for k, p in self.decoder.named_parameters()}
        return functional_call(self.decoder, {
            k: v.to(dtypes[k]) for k, v in self.params.items()}, (z,))


def create_distill_state(decoder: nn.Module, learning_rate: float,
                         total_steps: int) -> VAEDistillState:
    """fp32 copies of `decoder`'s weights (its starting point) and
    optax.adam(cosine_decay_schedule(lr, max(total_steps, 1))) over them
    (reference :78-89)."""
    params = {k: p.detach().float().clone().requires_grad_()
              for k, p in decoder.named_parameters()}
    optimizer = OptaxAdam(list(params.values()), lr=cosine_decay(
        learning_rate, max(total_steps, 1)))
    return VAEDistillState(0, decoder, params, optimizer)


def distill_vae_step(state: VAEDistillState,
                     teacher_decode: Callable[[torch.Tensor], torch.Tensor],
                     z: torch.Tensor) -> tuple[VAEDistillState,
                                               torch.Tensor]:
    """One step, in place on `state`: the teacher's decode of `z`, the fp32
    MSE of the student's decode against it, its gradients, one Adam update
    (reference :92-102, with the teacher's decode its caller makes)."""
    target = teacher_decode(z)
    with torch.enable_grad():
        pred = state.apply(z)
        loss = torch.mean((pred.float() - target.float()) ** 2)
        grads = torch.autograd.grad(loss, list(state.params.values()))
    for p, g in zip(state.params.values(), grads):
        p.grad = g
    state.optimizer.step()
    for p in state.params.values():
        p.grad = None
    state.step += 1
    return state, loss.detach()


@torch.no_grad()
def decoder_rel_l2(state: VAEDistillState, teacher_decode,
                   latents: torch.Tensor) -> float:
    """Holdout fidelity: ‖student − teacher‖₂ / ‖teacher‖₂ over a latent
    batch (reference :105-114)."""
    ref = teacher_decode(latents).float()
    got = state.apply(latents).float()
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.clamp(torch.linalg.vector_norm(ref), min=1e-12))


@dataclass
class VAEDistillResult:
    params: Params
    losses: list
    rel_l2: float
    meta: dict


def distill_vae_decoder(vae: nn.Module, decoder: nn.Module,
                        latent_batches: Iterable[torch.Tensor],
                        learning_rate: float = 3e-4,
                        total_steps: int | None = None,
                        holdout: torch.Tensor | None = None,
                        log: Callable[[str, float, int], None] | None = None
                        ) -> VAEDistillResult:
    """Distil `decoder`, from its current weights, over `latent_batches`
    (SCALED latents [B, 4, h/8, w/8] on the device; their count bounds the
    run when `total_steps` is None); returns the fp32 masters, the losses
    and the holdout rel-L2 (reference :124-169); `log` gets the loss every
    LOG_EVERY steps. The default holdout is 4 synthetic latents from the
    stream (0, "distill-vae", "holdout").
    The trained masters are loaded into `decoder` (each rounded once to
    its parameter's dtype)."""
    teacher = make_teacher_decode(vae)
    state, losses, z = None, [], None
    for z in latent_batches:
        z = z.float()
        if state is None:
            state = create_distill_state(decoder, learning_rate,
                                         total_steps or DEFAULT_HORIZON)
        state, loss = distill_vae_step(state, teacher, z)
        losses.append(loss)
        if log and state.step % LOG_EVERY == 0:
            log("distill_vae_loss", loss.item(), state.step)
        if total_steps is not None and state.step >= total_steps:
            break
    if state is None:
        raise ValueError("latent_batches yielded no batches")
    losses = torch.stack(losses).tolist()
    if holdout is None:
        holdout = synthetic_latents(
            stream_generator(0, "distill-vae", "holdout",
                             device=z.device), 4, z.shape[-1], z.shape[1])
    rel = decoder_rel_l2(state, teacher, holdout)
    with torch.no_grad():
        for name, p in decoder.named_parameters():
            p.copy_(state.params[name])
    meta = {"base_channels": decoder.base_channels,
            "latent_channels": decoder.latent_channels,
            "blocks_per_stage": decoder.blocks_per_stage,
            "steps": state.step, "learning_rate": learning_rate,
            "final_loss": float(np.mean(losses[-20:])),
            "rel_l2": rel}
    return VAEDistillResult(
        params={k: v.detach() for k, v in state.params.items()},
        losses=losses, rel_l2=rel, meta=meta)
