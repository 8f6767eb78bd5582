"""Diffusion samplers: the twin of polyp_tpu/diffusion/samplers.py.

The reference's four samplers: DDPM (ancestral, the scratch path), DDIM
(η ∈ [0, 1], on the leading and trailing grids), DPM-Solver++(2M) and
UniPC (order 2, "bh2", data prediction; the reference's default and the
port's), and classifier-free guidance, batch-doubled or folded. The steps run
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

The stochastic samplers (DDPM, DDIM with η > 0) draw their per-step noise
from the same generator, after the initial latents, and so need one even
when `init` is given. Their noise is one draw of the whole batch's shape a
step, so a row's trajectory depends on what it is batched with: the
coalescing contract of serve.py holds for the deterministic samplers only
(ddim η = 0, dpmpp_2m, unipc), as the reference says (its serve.py:43-47).
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


def _gaussian(shape: tuple[int, ...], generator: torch.Generator | None,
              name: str) -> torch.Tensor:
    """Standard normal fp32 noise of `shape` from `generator`, on its
    device: the initial latents, and the stochastic samplers' per-step
    noise."""
    if generator is None:
        raise ValueError(f"{name} needs a generator or init latents")
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


def _start(init: torch.Tensor | None, shape: tuple[int, ...],
           generator: torch.Generator | None, name: str) -> torch.Tensor:
    """The fp32 starting latents: `init`, or noise from `generator`."""
    if init is not None:
        return init.to(torch.float32)
    return _gaussian(shape, generator, name)


def _step_noise(x: torch.Tensor, generator: torch.Generator | None,
                name: str) -> torch.Tensor:
    """One step's noise for a stochastic sampler, on x's device."""
    if generator is None:
        raise ValueError(f"{name} draws noise at every step and needs a "
                         "generator, also when init latents are given")
    return _gaussian(tuple(x.shape), generator, name).to(x.device)


@torch.no_grad()
def ddpm_sample(model_fn: Union[ModelFn, Segments],
                schedule: DiffusionSchedule,
                shape: tuple[int, ...],
                generator: torch.Generator | None = None,
                num_steps: int | None = None,
                clip_sample: bool = True,
                init: torch.Tensor | None = None) -> torch.Tensor:
    """Ancestral DDPM with the fixed-small posterior variance and optional
    x̂₀ clipping (DDPMScheduler parity; the reference's ddpm_sample,
    :160-209), on the "ddpm" grid, every train timestep by default.
    ᾱ_prev is exactly 1 past the last step, the variance is clipped at
    1e-20, and noise is added only where t > 0."""
    x = _start(init, shape, generator, "ddpm_sample")
    schedule = schedule.to(x.device)
    T = schedule.num_train_timesteps
    num_steps = T if num_steps is None else num_steps
    ts = sampler_timesteps("ddpm", T, num_steps)
    abar = schedule.alphas_cumprod
    one = torch.ones((), device=x.device)
    fns = _step_fns(model_fn, num_steps)
    for i, (t, fn) in enumerate(zip(ts, fns)):
        abar_t = abar[t]
        abar_prev = abar[ts[i + 1]] if i + 1 < num_steps else one
        alpha_t = abar_t / abar_prev
        beta_t = 1.0 - alpha_t
        out = fn(x, torch.full((x.shape[0],), t, device=x.device))
        x0, _ = schedule.to_x0_eps(out, x, t)
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        # the posterior mean of q(x_{t-1} | x_t, x0)
        coef_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t)
        x = coef_x0 * x0 + coef_xt * x
        if t > 0:
            var = torch.clamp(beta_t * (1.0 - abar_prev) / (1.0 - abar_t),
                              min=1e-20)
            x = x + torch.sqrt(var) * _step_noise(x, generator,
                                                  "ddpm_sample")
    return x


@torch.no_grad()
def ddim_sample(model_fn: Union[ModelFn, Segments],
                schedule: DiffusionSchedule,
                shape: tuple[int, ...],
                generator: torch.Generator | None = None,
                num_steps: int = 50,
                init: torch.Tensor | None = None,
                spacing: str = "leading",
                steps_offset: int = 1,
                eta: float = 0.0,
                clip_sample: bool = False,
                final_alpha_to_one: bool = False) -> torch.Tensor:
    """DDIM (reference :212-269) with SD-v1's scheduler config by default:
    leading spacing with steps_offset=1, and set_alpha_to_one=False, so the
    last step lands on ᾱ₀ = alphas_cumprod[0], not 1
    (`final_alpha_to_one=True` for diffusers' plain DDIMScheduler()).
    Progressively distilled students sample on the grid they were
    distilled onto: spacing="trailing", steps_offset=0 (train/distill.py).
    `clip_sample` clips x̂₀ to [-1, 1] and recomputes ε̂ from it; η > 0
    adds σ-scaled noise from `generator` at every step (η = 1 is DDPM's
    variance on the DDIM grid); η = 0 is deterministic and draws none."""
    x = _start(init, shape, generator, "ddim_sample")
    schedule = schedule.to(x.device)
    abar = schedule.alphas_cumprod
    final_abar = (torch.ones((), device=x.device) if final_alpha_to_one
                  else abar[0])
    ts = inference_timesteps(schedule.num_train_timesteps, num_steps,
                             spacing, steps_offset)
    fns = _step_fns(model_fn, num_steps)
    for i, (t, fn) in enumerate(zip(ts, fns)):
        abar_t = abar[t]
        abar_prev = abar[ts[i + 1]] if i + 1 < num_steps else final_abar
        out = fn(x, torch.full((x.shape[0],), t, device=x.device))
        x0, eps = schedule.to_x0_eps(out, x, t)
        if clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
            eps = (x - torch.sqrt(abar_t) * x0) / torch.sqrt(1.0 - abar_t)
        if eta == 0:
            dir_xt = torch.sqrt(torch.clamp(1.0 - abar_prev, min=0.0)) * eps
            x = torch.sqrt(abar_prev) * x0 + dir_xt
            continue
        sigma = eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar_t)) \
            * torch.sqrt(1.0 - abar_t / abar_prev)
        dir_xt = torch.sqrt(torch.clamp(1.0 - abar_prev - sigma ** 2,
                                        min=0.0)) * eps
        x = torch.sqrt(abar_prev) * x0 + dir_xt \
            + sigma * _step_noise(x, generator, "ddim_sample")
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
def dpmpp_2m_sample(model_fn: Union[ModelFn, Segments],
                    schedule: DiffusionSchedule,
                    shape: tuple[int, ...],
                    generator: torch.Generator | None = None,
                    num_steps: int = 25,
                    init: torch.Tensor | None = None) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022, Algorithm 2; data prediction,
    midpoint) with DPMSolverMultistepScheduler's conventions, the
    reference's dpmpp_2m_sample (:282-328): the linspace grid, order 1 at
    the first step (no history), order 2 after (r = h_last / h, h guarded
    where |h| <= 1e-8), and `lower_order_final`: the last step integrates
    to σ = 0 at order 1, so the result is its x̂₀. Each step takes its
    branch where the reference masks with `jnp.where`; the coefficients are
    fp32 scalars on the CPU, as the reference's tables are fp32."""
    x = _start(init, shape, generator, "dpmpp_2m_sample")
    schedule = schedule.to(x.device)
    ts = sampler_timesteps("dpmpp_2m", schedule.num_train_timesteps,
                           num_steps)
    alpha, sigma, lam = _lambda_tables(schedule, ts)
    one = torch.ones(1)
    alpha_next = torch.cat([alpha[1:], one])
    sigma_next = torch.cat([sigma[1:], one])  # the last entry is never used
    lam_next = torch.log(alpha_next) - torch.log(sigma_next)
    fns = _step_fns(model_fn, num_steps)
    x0_prev = None
    for i, (t, fn) in enumerate(zip(ts, fns)):
        out = fn(x, torch.full((x.shape[0],), t, device=x.device))
        x0 = schedule.to_x0_eps(out, x, t)[0]
        if i == num_steps - 1:
            return x0  # lower_order_final: σ = 0 exactly
        h = lam_next[i] - lam[i]
        denoised = x0
        if i > 0:
            r = (lam[i] - lam[i - 1]) / (h if abs(h.item()) > 1e-8
                                         else torch.ones_like(h))
            half_inv_r = 1.0 / (2.0 * r)
            denoised = (1.0 + half_inv_r).item() * x0 \
                - half_inv_r.item() * x0_prev
        x = (sigma_next[i] / sigma[i]).item() * x \
            - (alpha_next[i] * torch.expm1(-h)).item() * denoised
        x0_prev = x0
    return x


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


SAMPLERS = {"ddpm": ddpm_sample, "ddim": ddim_sample,
            "dpmpp_2m": dpmpp_2m_sample, "unipc": unipc_sample}


def get_sampler(name: str) -> Callable[..., torch.Tensor]:
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}: the samplers are "
                         f"{sorted(SAMPLERS)}")
    return SAMPLERS[name]


def sample(name: str, model_fn: Union[ModelFn, Segments],
           schedule: DiffusionSchedule,
           shape: tuple[int, ...], generator: torch.Generator | None,
           num_steps: int, **kwargs) -> torch.Tensor:
    return get_sampler(name)(model_fn, schedule, shape, generator,
                             num_steps=num_steps, **kwargs)
