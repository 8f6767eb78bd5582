"""Progressive distillation: the twin of polyp_tpu/train/distill.py.

Each halving phase trains a student to do in ONE deterministic DDIM step
what its teacher does in two (Salimans & Ho, ICLR 2022), so phases go
start_steps → start_steps/2 → … → end_steps.

* **Nested trailing grids** (`distill_grid`). A student distilled for N
  steps samples on the trailing grid of N steps; its teacher's two
  substeps use the trailing grid of 2N steps, whose even elements are the
  student grid and whose odd elements are the midpoints (nesting needs
  T % 2N == 0). `ddim_transition` is the deterministic (η = 0) DDIM move
  that the sampler and the targets both take.
* **Closed-form x̃₀ target** (`distill_targets`): the x̃₀ whose single DDIM
  transition t → t′ lands on the teacher's two-substep result x″,
  x̃₀ = (x″ − (σ′/σ_t)·x_t) / (α′ − (σ′/σ_t)·α_t), in fp32.
* **Truncated-SNR loss**: E[max(SNR(t), 1) · ‖x̂₀ − x̃₀‖²] in fp32.
* **v-prediction students**: when the student's head differs from the
  teacher's, a reparam warmup (0-substep distillation: the teacher's own
  x̂₀ at the same t) comes first, with its own optimizer (a linear ramp,
  then a constant rate), and `check_reparam_converged` fails loudly when
  it has not closed the switch.
* **CFG folding**: with `guidance_scale`, the phase-0 teacher runs the
  [uncond, cond] pair at 2× batch (uncond first) and the student consumes
  `cond` only; later phases distill the previous, already folded, student.

Precision and memory, as the scratch trainer (train/scratch_ddpm.py): the
student's state keeps fp32 master parameters, which `SDOptimizer`
(clip_by_global_norm(1.0) + adamw on the phase's warmup-cosine schedule)
updates in place; each step casts them to the module's parameter dtypes
inside the autograd graph and runs the module on them through
`torch.func.functional_call`. The teacher's weights are cast once a phase
and run under `torch.no_grad()`, so its GroupNorms and GEGLUs take the
kernels on the card; the student's forward is under autograd (plain
GroupNorm and GEGLU, the flash forward with its plain backward).

The student always holds its own copy of its starting weights. It starts
FROM its teacher's, and the optimizer updates the masters in place, so a
student sharing storage with the teacher would move the teacher mid-phase
(the torch form of the reference's donation hazard, its :179-186).

Random draws: a step's draws come in one `DistillDraws` (the timestep
indices and ε, in the roles of the reference's `k_idx, k_noise =
split(key)`), from the named generator stream `distill_draws(role, phase,
step)`: "warmup" (the reference's fold_in(PRNGKey(17), step)), "probe"
(PRNGKey(41)) and "phase" (fold_in(PRNGKey(23 + phase), step)). Tests hand
both packages the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from polyp_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    inference_timesteps,
)
from polyp_tpu_torch.train.scratch_ddpm import cosine_warmup_schedule
from polyp_tpu_torch.train.sd_finetune import SDOptimizer
from polyp_tpu_torch.utils.rng import stream_generator

Params = dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Grids
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DistillGrid:
    """Per-student-step timestep tables for one halving phase (all [N])."""

    ts: torch.Tensor         # student timesteps (descending, trailing)
    ts_mid: torch.Tensor     # teacher midpoint timesteps
    abar_t: torch.Tensor     # ᾱ at ts
    abar_mid: torch.Tensor   # ᾱ at ts_mid
    abar_next: torch.Tensor  # ᾱ at the transition target (endpoint: ᾱ₀)
    num_steps: int = 0

    def to(self, device: torch.device | str) -> "DistillGrid":
        return replace(self, ts=self.ts.to(device),
                       ts_mid=self.ts_mid.to(device),
                       abar_t=self.abar_t.to(device),
                       abar_mid=self.abar_mid.to(device),
                       abar_next=self.abar_next.to(device))


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


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------

def _bc(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-sample array shaped to broadcast over NCHW, in fp32."""
    return a.reshape((-1,) + (1,) * (like.dim() - 1)).float()


def ddim_transition(x0: torch.Tensor, eps: torch.Tensor,
                    abar_next: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM transition from a (x̂₀, ε̂) decomposition:
    x′ = √ᾱ′·x̂₀ + √(1−ᾱ′)·ε̂ (reference :116-121), with ᾱ′ a scalar or one
    value per sample."""
    a = torch.as_tensor(abar_next, dtype=torch.float32, device=x0.device)
    a = a.reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps


def distill_targets(teacher_fn: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor],
                    schedule: DiffusionSchedule, grid: DistillGrid,
                    x_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x̃₀ such that ONE student DDIM step from (x_t, ts[idx]) lands exactly
    on the teacher's TWO-substep result (reference :124-144), in fp32.
    `idx` holds one student step index per sample; the grid and schedule
    are on x_t's device."""
    t, t_mid = grid.ts[idx], grid.ts_mid[idx]
    abar_t, abar_mid, abar_next = (grid.abar_t[idx], grid.abar_mid[idx],
                                   grid.abar_next[idx])

    x0_1, eps_1 = schedule.to_x0_eps(teacher_fn(x_t, t), x_t, t)
    x_mid = ddim_transition(x0_1, eps_1, abar_mid)
    x0_2, eps_2 = schedule.to_x0_eps(teacher_fn(x_mid, t_mid), x_mid, t_mid)
    x_next = ddim_transition(x0_2, eps_2, abar_next)

    alpha_t, sigma_t = torch.sqrt(abar_t), torch.sqrt(1.0 - abar_t)
    alpha_n, sigma_n = torch.sqrt(abar_next), torch.sqrt(1.0 - abar_next)
    ratio = sigma_n / sigma_t
    num = x_next.float() - _bc(ratio, x_next) * x_t.float()
    den = alpha_n - ratio * alpha_t  # > 0: ᾱ strictly increases over the step
    return num / _bc(den, x_next)


def snr_weight(abar_t: torch.Tensor) -> torch.Tensor:
    """Truncated-SNR loss weight max(ᾱ/(1−ᾱ), 1)."""
    return torch.clamp(abar_t / (1.0 - abar_t), min=1.0)


# ---------------------------------------------------------------------------
# One distillation step
# ---------------------------------------------------------------------------

class DistillDraws:
    """The random draws of one distill step, in this order from one
    generator: the student step index of each sample, then ε."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def idx(self, n: int, high: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=self.generator,
                             device=self.generator.device)

    def noise(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device)


def distill_draws(role: str, phase: int, step: int,
                  device: torch.device | str) -> DistillDraws:
    """The draws of step `step` of `role` ("warmup", "probe" or "phase")
    in phase `phase`: a pure function of the four."""
    return DistillDraws(stream_generator(0, "distill", role, phase, step,
                                         device=device))


@dataclass
class DistillState:
    """The student's fp32 master parameters (by the module's state-dict
    names; they require grad), the optimizer and its state, and the count
    of steps taken."""

    step: int
    params: Params
    opt_state: dict
    tx: SDOptimizer


def init_distill_state(params: Params, tx: SDOptimizer) -> DistillState:
    """A state over fp32 COPIES of `params` (never their storage: the
    teacher keeps its own)."""
    masters = {k: v.detach().float().clone().requires_grad_()
               for k, v in params.items()}
    return DistillState(0, masters, tx.init({k: v.detach()
                                             for k, v in masters.items()}),
                        tx)


def make_distill_step(student_apply: Callable[[Params, torch.Tensor,
                                               torch.Tensor], torch.Tensor],
                      teacher_apply: Callable[[Any, torch.Tensor,
                                               torch.Tensor], torch.Tensor],
                      teacher_schedule: DiffusionSchedule,
                      student_schedule: DiffusionSchedule,
                      grid: DistillGrid, reparam: bool = False):
    """The phase train step `step(state, teacher, x0, draws) → (state,
    loss)` (reference :163-222). `student_apply(masters, x, t)` runs the
    student on its fp32 masters under autograd; `teacher_apply(teacher, x,
    t)` runs the teacher, here under `torch.no_grad()`. Both close over
    everything but the weights (the SD path folds CFG into the teacher and
    the cond embedding into both). With `reparam=True` the target is the
    teacher's own x̂₀ at the SAME t (the warmup of a head switch) instead of
    the two-substep x̃₀. The update is in place on `state`."""
    on_device: dict = {}

    def tables(device):
        if device not in on_device:
            on_device[device] = (teacher_schedule.to(device),
                                 student_schedule.to(device),
                                 grid.to(device))
        return on_device[device]

    def step(state: DistillState, teacher: Any, x0: torch.Tensor,
             draws: DistillDraws) -> tuple[DistillState, torch.Tensor]:
        t_sched, s_sched, g = tables(x0.device)
        n = x0.shape[0]
        idx = draws.idx(n, g.num_steps)
        t = g.ts[idx]
        noise = draws.noise(x0.shape)
        x_t = t_sched.add_noise(x0, noise, t)
        with torch.no_grad():
            def teacher_fn(x, tt):
                return teacher_apply(teacher, x, tt)

            if reparam:
                target = t_sched.to_x0_eps(teacher_fn(x_t, t), x_t,
                                           t)[0].float()
            else:
                target = distill_targets(teacher_fn, t_sched, g, x_t, idx)
        w = _bc(snr_weight(g.abar_t[idx]), x0)
        leaves = list(state.params.values())
        with torch.enable_grad():
            out = student_apply(state.params, x_t, t)
            x0_pred = s_sched.to_x0_eps(out, x_t, t)[0]
            loss = torch.mean(w * torch.square(x0_pred.float() - target))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        state.tx.update({k: torch.zeros_like(p) if gr is None else gr
                         for (k, p), gr in zip(state.params.items(), grads)},
                        state.opt_state, state.params)
        state.step += 1
        return state, loss.detach()

    return step


def check_reparam_converged(losses: list[float], min_steps: int = 50,
                            plateau_ratio: float = 0.6,
                            rel_err: float | None = None,
                            rel_err_tol: float = 0.15) -> None:
    """Fail loudly when the ε→v reparam warmup did not close the switch
    (reference :225-284, messages included). Two criteria, active only
    from `min_steps` warmup steps (a smoke budget makes no convergence
    claim): the student's x̂₀ within `rel_err_tol` (relative L2) of the
    teacher's on the phase grid, and the loss no longer dropping steeply
    (the last fifth's mean not below `plateau_ratio` times the fifth
    before it), unless it fell 1000× from its start."""
    if len(losses) < min_steps:
        return
    if rel_err is not None and rel_err > rel_err_tol:
        raise RuntimeError(
            f"reparam warmup did not close the head switch: student x̂₀ vs "
            f"teacher x̂₀ rel L2 {rel_err:.3f} > {rel_err_tol} after the "
            f"warmup (the student has exact capacity for this target, so "
            f"this is an optimization shortfall, not a ceiling). Distilling "
            f"now compounds the error through every phase. Raise "
            f"--reparam_steps / lower the learning rate, or use "
            f"--student_prediction_type epsilon (exact warm start).")
    k = max(len(losses) // 5, 10)
    head = float(np.mean(losses[:k]))
    tail = float(np.mean(losses[-k:]))
    prev = float(np.mean(losses[-2 * k:-k]))
    if tail <= 1e-3 * head:
        return
    if tail < plateau_ratio * prev:
        raise RuntimeError(
            f"reparam warmup has not converged: loss still dropping steeply "
            f"at the end of the budget (last-{k} mean {tail:.3e} vs "
            f"previous-{k} mean {prev:.3e}). Distilling from an un-closed "
            f"head switch compounds through every phase. Raise "
            f"--reparam_steps (or leave it at -1 to auto-scale to "
            f"--steps_per_phase), or use --student_prediction_type epsilon "
            f"(exact warm start, no warmup needed).")


# ---------------------------------------------------------------------------
# The phase loop
# ---------------------------------------------------------------------------

@dataclass
class DistillPhaseResult:
    num_steps: int
    losses: list[float] = field(default_factory=list)


@dataclass
class DistillResult:
    params: Params                   # the final student's fp32 masters
    num_steps: int                   # its sampling steps
    prediction_type: str             # its head parameterization
    phases: list[DistillPhaseResult] = field(default_factory=list)


@dataclass(frozen=True)
class Applies:
    """The model calls of a distillation run (reference :352-367): `cast`
    takes fp32 weights to the model's parameter dtypes; `teacher(weights,
    x, t)` is the phase-0 teacher (the CFG pair at 2× batch, uncond first,
    when guidance is folded), `folded(weights, x, t)` a later phase's
    teacher (the previous student), both on cast weights; `student(masters,
    x, t)` runs the fp32 masters, cast inside the autograd graph."""

    cast: Callable[[Params], Params]
    teacher: Callable[..., torch.Tensor]
    folded: Callable[..., torch.Tensor]
    student: Callable[..., torch.Tensor]


def make_applies(model: nn.Module, guidance_scale: float | None = None,
                 cond: torch.Tensor | None = None,
                 uncond: torch.Tensor | None = None) -> Applies:
    """`model`'s calls on weight dicts (`functional_call`) for a run with
    guidance folded at `guidance_scale` over the [1, L, D] embeddings
    `cond` and `uncond`, or without guidance (an unconditional model)."""
    dtypes = {k: p.dtype for k, p in model.named_parameters()}

    def cast(params: Params) -> Params:
        return {k: v.to(dtypes[k]) for k, v in params.items()}

    def run(weights: Params, *args) -> torch.Tensor:
        return functional_call(model, weights, args)

    def ctx(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        return e.expand(x.shape[0], *e.shape[-2:])

    if guidance_scale is None:
        return Applies(cast, run, run, lambda m, x, t: run(cast(m), x, t))

    def teacher(weights, x, t):
        x2, t2 = torch.cat([x, x]), torch.cat([t, t])
        e2 = torch.cat([ctx(x, uncond), ctx(x, cond)])
        out_u, out_c = run(weights, x2, t2, e2).chunk(2)
        return out_u + guidance_scale * (out_c - out_u)

    return Applies(cast, teacher,
                   lambda w, x, t: run(w, x, t, ctx(x, cond)),
                   lambda m, x, t: run(cast(m), x, t, ctx(x, cond)))


def _phase_optimizer(learning_rate: float, horizon: int) -> SDOptimizer:
    """clip_by_global_norm(1.0) + adamw(weight_decay=1e-2) on
    warmup_cosine_decay_schedule(0, lr, max(h // 20, 1), max(h, 2), 0)
    (reference :384-389)."""
    return SDOptimizer(cosine_warmup_schedule(
        learning_rate, max(horizon // 20, 1), max(horizon, 2)))


def _warmup_optimizer(learning_rate: float, warmup: int) -> SDOptimizer:
    """The reparam warmup's own optimizer: a linear ramp from 0 over
    max(warmup // 20, 1) updates, then the constant rate
    (optax.join_schedules of linear and constant, reference :396-414). A
    decaying rate would flatten the loss by itself and blind
    `check_reparam_converged`."""
    ramp = max(warmup // 20, 1)

    def schedule(count: int) -> float:
        return learning_rate * min(count, ramp) / ramp

    return SDOptimizer(schedule)


def _run(state: DistillState, step, teacher, batches, n_steps: int,
         draws: Callable[[int], DistillDraws]) -> list[float]:
    """`n_steps` steps over `batches()`, cycled; the losses, read from the
    device once at the end."""
    losses, done = [], 0
    while done < n_steps:
        for x0 in batches():
            if done >= n_steps:
                break
            state, loss = step(state, teacher, x0, draws(done))
            losses.append(loss)
            done += 1
    return torch.stack(losses).tolist() if losses else []


def distill_progressive(
    model: nn.Module,
    teacher_params: Params,
    schedule: DiffusionSchedule,
    batches: Callable[[], Iterable[torch.Tensor]],
    start_steps: int,
    end_steps: int,
    steps_per_phase: int,
    learning_rate: float = 1e-4,
    student_prediction_type: str = "epsilon",
    reparam_steps: int = -1,
    guidance_scale: float | None = None,
    cond: torch.Tensor | None = None,
    uncond: torch.Tensor | None = None,
    log: Callable[[str, float, int], None] | None = None,
) -> DistillResult:
    """Run halving phases start_steps → … → end_steps (reference :300-492;
    both powers-of-two multiples of each other, T % (2·start_steps) == 0).

    `model` is the program of teacher and student alike: it runs on weight
    dicts (fp32 `teacher_params`, cast to its parameter dtypes) through
    `functional_call`, so its own parameters are never read or written.
    `batches()` returns an iterable of x₀ batches (NCHW, on the device) in
    model space, consumed once a phase and cycled. With `guidance_scale`,
    `cond` and `uncond` ([1, L, D]) the phase-0 teacher runs CFG while the
    student consumes `cond` only. The student starts from a copy of
    `teacher_params` (the reference's foreign-teacher arguments,
    `teacher_apply_fn` and `student_params`, have no caller and are not
    ported). The student of each phase becomes the next phase's teacher,
    and `reparam_steps` (−1: `steps_per_phase`) applies to phase 0
    only."""
    if start_steps < end_steps or start_steps % end_steps != 0:
        raise ValueError(f"start_steps={start_steps} must be a multiple "
                         f"of end_steps={end_steps}")
    if reparam_steps < 0:
        reparam_steps = steps_per_phase
    applies = make_applies(model, guidance_scale, cond, uncond)
    device = next(model.parameters()).device
    with torch.no_grad():
        teacher = applies.cast(teacher_params)
    result = DistillResult(params=teacher_params, num_steps=start_steps,
                           prediction_type=student_prediction_type)
    teacher_sched = schedule
    student_sched = replace(schedule,
                            prediction_type=student_prediction_type)
    phase_idx, n = 0, start_steps
    while n > end_steps:
        n //= 2
        grid = distill_grid(teacher_sched, n)
        # phase 0's teacher is the original (CFG-folding) model; later
        # phases distill the previous student, which is already folded
        phase_teacher = (applies.teacher if phase_idx == 0
                         else applies.folded)
        phase = DistillPhaseResult(num_steps=n)
        warmup = reparam_steps if (
            phase_idx == 0
            and student_prediction_type != schedule.prediction_type) else 0
        state = init_distill_state(result.params, _phase_optimizer(
            learning_rate, steps_per_phase))
        if warmup:
            wstate = replace(state, tx=_warmup_optimizer(learning_rate,
                                                         warmup))
            wstate.opt_state = wstate.tx.init(
                {k: v.detach() for k, v in wstate.params.items()})
            warm_step = make_distill_step(applies.student, phase_teacher,
                                          teacher_sched, student_sched,
                                          grid, reparam=True)
            wlosses = _run(wstate, warm_step, teacher, batches, warmup,
                           lambda i: distill_draws("warmup", 0, i, device))
            rel_err = _reparam_rel_err(
                applies.student, phase_teacher, wstate.params, teacher,
                teacher_sched, student_sched, grid.to(device),
                next(iter(batches())), distill_draws("probe", 0, 0, device))
            if log:
                log("reparam_loss", float(np.mean(wlosses[-20:])), 0)
                log("reparam_rel_err", rel_err, 0)
            check_reparam_converged(wlosses, rel_err=rel_err)

        step = make_distill_step(applies.student, phase_teacher,
                                 teacher_sched, student_sched, grid)
        phase.losses = _run(state, step, teacher, batches, steps_per_phase,
                            lambda i, p=phase_idx: distill_draws(
                                "phase", p, i, device))
        if log:
            log(f"distill_loss_{n}steps",
                float(np.mean(phase.losses[-20:])), phase_idx)

        result.params = {k: v.detach() for k, v in state.params.items()}
        result.num_steps = n
        result.phases.append(phase)
        with torch.no_grad():
            teacher = applies.cast(result.params)  # the student teaches next
        teacher_sched = student_sched
        phase_idx += 1
    return result


@torch.no_grad()
def _reparam_rel_err(student_apply, teacher_apply, masters: Params,
                     teacher: Any, teacher_sched: DiffusionSchedule,
                     student_sched: DiffusionSchedule, grid: DistillGrid,
                     x0: torch.Tensor, draws: DistillDraws) -> float:
    """The warmup's closure (reference :437-452): ‖x̂₀(student) −
    x̂₀(teacher)‖ / ‖x̂₀(teacher)‖ on one batch over the phase grid."""
    t_sched, s_sched = teacher_sched.to(x0.device), student_sched.to(
        x0.device)
    idx = draws.idx(x0.shape[0], grid.num_steps)
    t = grid.ts[idx]
    x_t = t_sched.add_noise(x0, draws.noise(x0.shape), t)
    t_x0 = t_sched.to_x0_eps(teacher_apply(teacher, x_t, t), x_t,
                             t)[0].float()
    s_x0 = s_sched.to_x0_eps(student_apply(masters, x_t, t), x_t,
                             t)[0].float()
    return float(torch.linalg.vector_norm(s_x0 - t_x0)
                 / (torch.linalg.vector_norm(t_x0) + 1e-8))
