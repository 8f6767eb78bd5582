"""Diffusion samplers: the twin of polyp_tpu/diffusion/samplers.py.

This package ports DDIM (η = 0) on the leading and trailing grids, and
classifier-free guidance, batch-doubled or folded. The steps run
as a Python loop: PyTorch runs eagerly, so the reference's `lax.scan` has
no counterpart the port needs. Sampling runs under `torch.no_grad()`; that
is the port's form of the reference's `ops.dispatch.inference()` scope and
what lets the inference-only kernels (fused GEGLU, GroupNorm) run.

`model_fn(x, t_batch) -> model_out` is an already-conditioned denoiser,
or a segment list [(n_steps, fn), ...] covering the steps in order (the
hybrid-precision split, pipeline.py): segment k runs its fn for its steps
with the step index continuing, which is the same loop as one fn when every
fn is the same. `init` supplies the starting latents x_T instead of drawing
them from the generator (the per-sample noise hook). Latents are fp32
throughout.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from polyp_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    inference_timesteps,
)

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Segments = Sequence[tuple[int, ModelFn]]


def _as_segments(model_fn: Union[ModelFn, Segments],
                 num_steps: int) -> list[tuple[int, ModelFn]]:
    """A model fn or a segment list → the segment list (reference :134-142):
    the counts must cover `num_steps`; empty segments are dropped."""
    if callable(model_fn):
        return [(num_steps, model_fn)]
    segments = [(int(n), fn) for n, fn in model_fn]
    total = sum(n for n, _ in segments)
    if total != num_steps:
        raise ValueError(f"model_fn segments cover {total} steps, "
                         f"sampler runs {num_steps}")
    return [(n, fn) for n, fn in segments if n > 0]


def _step_fns(model_fn: Union[ModelFn, Segments],
              num_steps: int) -> list[ModelFn]:
    """The fn of each step, in order."""
    return [fn for n, fn in _as_segments(model_fn, num_steps)
            for _ in range(n)]


def with_cfg(raw_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                              torch.Tensor],
             cond: torch.Tensor, uncond: torch.Tensor | None,
             guidance_scale: float | None) -> ModelFn:
    """Classifier-free guidance by batch doubling: one forward over
    (uncond, cond), in that order, as the reference's with_cfg (:102-112).
    `guidance_scale=None` means guidance is folded into the model (a
    distilled student): cond-only forwards at 1× batch, `uncond` unused
    (:94-100)."""

    if guidance_scale is None:
        def cond_only(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            return raw_fn(x, t, cond.expand(x.shape[0], *cond.shape[-2:]))

        return cond_only

    def model_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        emb2 = torch.cat([uncond.expand(n, *uncond.shape[-2:]),
                          cond.expand(n, *cond.shape[-2:])])
        out_u, out_c = raw_fn(torch.cat([x, x]), torch.cat([t, t]),
                              emb2).chunk(2)
        return out_u + guidance_scale * (out_c - out_u)

    return model_fn


@torch.no_grad()
def ddim_sample(model_fn: Union[ModelFn, Segments],
                schedule: DiffusionSchedule,
                shape: tuple[int, ...],
                generator: torch.Generator | None = None,
                num_steps: int = 50,
                init: torch.Tensor | None = None,
                spacing: str = "leading",
                steps_offset: int = 1) -> torch.Tensor:
    """Deterministic DDIM (η = 0) with SD-v1's scheduler config by default
    (reference :212-232): leading spacing with steps_offset=1, and
    set_alpha_to_one=False, so the last step lands on ᾱ₀ =
    alphas_cumprod[0], not 1. Progressively distilled students sample on
    the grid they were distilled onto: spacing="trailing",
    steps_offset=0 (train/distill.py)."""
    if init is not None:
        x = init.to(torch.float32)
    else:
        if generator is None:
            raise ValueError("ddim_sample needs a generator or init latents")
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
    schedule = schedule.to(x.device)
    abar = schedule.alphas_cumprod
    ts = inference_timesteps(schedule.num_train_timesteps, num_steps,
                             spacing, steps_offset)
    fns = _step_fns(model_fn, num_steps)
    for i, (t, fn) in enumerate(zip(ts, fns)):
        abar_prev = abar[ts[i + 1]] if i + 1 < num_steps else abar[0]
        out = fn(x, torch.full((x.shape[0],), t, device=x.device))
        x0, eps = schedule.to_x0_eps(out, x, t)
        dir_xt = torch.sqrt(torch.clamp(1.0 - abar_prev, min=0.0)) * eps
        x = torch.sqrt(abar_prev) * x0 + dir_xt
    return x


SAMPLERS = {"ddim": ddim_sample}


def get_sampler(name: str) -> Callable[..., torch.Tensor]:
    if name not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {name!r} is not ported yet: polyp_tpu_torch runs "
            f"{sorted(SAMPLERS)}; ROADMAP.md Queue 1 lists when the others "
            "land")
    return SAMPLERS[name]


def sample(name: str, model_fn: Union[ModelFn, Segments],
           schedule: DiffusionSchedule,
           shape: tuple[int, ...], generator: torch.Generator | None,
           num_steps: int, **kwargs) -> torch.Tensor:
    return get_sampler(name)(model_fn, schedule, shape, generator,
                             num_steps=num_steps, **kwargs)
