"""Diffusion samplers: the twin of polyp_tpu/diffusion/samplers.py.

This package ports DDIM (η = 0) on the leading and trailing grids, UniPC
(order 2, "bh2", data prediction; the reference's default and the port's),
and classifier-free guidance, batch-doubled or folded. The steps run
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

# (spacing, steps_offset) each sampler of the reference uses (reference
# :54-59): which timesteps a trajectory visits, without re-deriving each
# sampler's conventions
SAMPLER_SPACING: dict[str, tuple[str, int]] = {
    "ddpm": ("leading", 0),
    "ddim": ("leading", 1),
    "dpmpp_2m": ("linspace", 0),
    "unipc": ("linspace", 0),
}


def sampler_timesteps(name: str, num_train_timesteps: int,
                      num_steps: int) -> list[int]:
    """The descending timesteps `sample(name, ...)` visits at the sampler's
    default spacing (reference :62-68)."""
    spacing, offset = SAMPLER_SPACING[name]
    return inference_timesteps(num_train_timesteps, num_steps, spacing,
                               offset)


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


def _start(init: torch.Tensor | None, shape: tuple[int, ...],
           generator: torch.Generator | None, name: str) -> torch.Tensor:
    """The fp32 starting latents: `init`, or noise from `generator`."""
    if init is not None:
        return init.to(torch.float32)
    if generator is None:
        raise ValueError(f"{name} needs a generator or init latents")
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


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


def _lambda_tables(schedule: DiffusionSchedule, ts: list[int]):
    """(α, σ, λ) at each inference timestep, fp32 on the CPU (reference
    :272-278)."""
    abar = schedule.alphas_cumprod.cpu()[ts]
    alpha = torch.sqrt(abar)
    sigma = torch.sqrt(1.0 - abar)
    return alpha, sigma, torch.log(alpha) - torch.log(sigma)


def _phis(h: torch.Tensor):
    """φ₁ = expm1(−h), B(h) = φ₁ ("bh2"), φ₂ = φ₁/(−h) − 1, φ₃ = φ₂/(−h) − ½
    (reference :363-369)."""
    hh = -h
    phi1 = torch.expm1(hh)
    phi2 = phi1 / hh - 1.0
    return phi1, phi1, phi2, phi2 / hh - 0.5


def _nonzero(b: torch.Tensor) -> torch.Tensor:
    """The divisor of the reference's safe_div (:371-372): b, or 1 where
    |b| <= 1e-10."""
    return b if abs(b.item()) > 1e-10 else torch.ones_like(b)


@torch.no_grad()
def unipc_sample(model_fn: Union[ModelFn, Segments],
                 schedule: DiffusionSchedule,
                 shape: tuple[int, ...],
                 generator: torch.Generator | None = None,
                 num_steps: int = 25, use_corrector: bool = True,
                 init: torch.Tensor | None = None) -> torch.Tensor:
    """UniPC (Zhao et al. 2023) order 2, B(h) = expm1(−h) ("bh2"), data
    prediction: the reference's unipc_sample (:331-419), with
    UniPCMultistepScheduler's step structure on the linspace grid.

    * step 0: UniP order 1 (no history);
    * step i ≥ 1: UniC corrects the previous transition with the fresh x̂₀,
      order 1 at i = 1 (ρ = ½) and order 2 after (the 2×2 solve over the
      history node r₁ = (λ_{i−2} − λ_{i−1})/h and the new node 1); then UniP
      order 2 predicts the next sample;
    * `lower_order_final`: the last step returns its x̂₀.

    The reference computes every branch and masks with `jnp.where` (reading
    λ[i−1], λ[i−2] with wrap-around at i = 0, 1); here each step takes its
    branch. The step coefficients are fp32 scalars on the CPU, as the
    reference's tables are fp32; the latents stay fp32."""
    x = _start(init, shape, generator, "unipc_sample")
    schedule = schedule.to(x.device)
    ts = sampler_timesteps("unipc", schedule.num_train_timesteps, num_steps)
    alpha, sigma, lam = _lambda_tables(schedule, ts)
    one = torch.ones(1)
    alpha_next = torch.cat([alpha[1:], one])
    sigma_next = torch.cat([sigma[1:], one])  # the last entry is never used
    lam_next = torch.log(alpha_next) - torch.log(sigma_next)
    fns = _step_fns(model_fn, num_steps)
    x_corr_prev = m_prev = m_prev2 = None
    for i, (t, fn) in enumerate(zip(ts, fns)):
        out = fn(x, torch.full((x.shape[0],), t, device=x.device))
        m = schedule.to_x0_eps(out, x, t)[0]  # x̂₀ at ts[i], uncorrected x
        if i == num_steps - 1:
            return m  # lower_order_final: σ = 0 exactly

        # UniC: correct the i-1 -> i transition
        x_corr = x
        if use_corrector and i >= 1:
            h_c = lam[i] - lam[i - 1]
            phi1c, bhc, phi2c, phi3c = _phis(h_c)
            d1_new = m - m_prev
            if i == 1:
                d = (phi1c.item() * m_prev
                     + (bhc * 0.5).item() * d1_new)
            else:
                r1c = (lam[i - 2] - lam[i - 1]) / _nonzero(h_c)
                d1_hist = (m_prev2 - m_prev) / _nonzero(r1c).item()
                b1 = phi2c / bhc
                b2 = 2.0 * phi3c / bhc
                rho1 = (b1 - b2) / _nonzero(1.0 - r1c)
                rho2 = b1 - rho1
                d = phi1c.item() * m_prev + bhc.item() * (
                    rho1.item() * d1_hist + rho2.item() * d1_new)
            x_corr = (sigma[i] / sigma[i - 1]).item() * x_corr_prev \
                - alpha[i].item() * d

        # UniP: predict the i -> i+1 sample
        h_p = lam_next[i] - lam[i]
        phi1p, bhp, phi2p, _ = _phis(h_p)
        x_next = (sigma_next[i] / sigma[i]).item() * x_corr \
            - (alpha_next[i] * phi1p).item() * m
        if i >= 1:
            r1p = (lam[i - 1] - lam[i]) / _nonzero(h_p)
            d1p = (m_prev - m) / _nonzero(r1p).item()
            rho_p = phi2p / bhp
            x_next = x_next - (alpha_next[i] * bhp * rho_p).item() * d1p
        x, x_corr_prev, m_prev2, m_prev = x_next, x_corr, m_prev, m
    return x


SAMPLERS = {"ddim": ddim_sample, "unipc": unipc_sample}


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
