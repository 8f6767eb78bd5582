"""`distill_progressive`'s foreign teacher and weight decay in
polyp_tpu_torch against polyp_tpu's on the CPU.

The reference distills from a teacher that shares no weights with the
student (`teacher_apply_fn`, `student_params`): here the exact E[ε | x_t]
of Gaussian data (tests/test_distill.py::_analytic_eps) teaches a
per-timestep affine v-student from zeros (`_affine_student`), through an
ε→v reparam warmup and two halving phases 8 → 4 → 2, with AdamW's
`weight_decay` set away from its default. The port runs the same teacher
as `teacher_fn(x, t[, ctx])` and the same student as a module whose
parameters `student_params` replaces; its steps take the reference's
draws (test_torch_port_distill.py's `JaxDraws` and keys), so both compute
one function. With guidance the teacher's CFG pair is folded as the
model's would be (the analytic teacher ignores the context, so the fold
returns its output, which both packages must compute alike).

Tolerances: every loss and the logged reparam closure 1e-4 relative (nine
fp32 steps of drift); the final parameters within 1e-2 · lr per update
(Adam divides each gradient by its own RMS, so a relative gradient
difference ε moves an element by ε · lr). A weight decay left at 1e-2
moves the parameters by about lr · 0.04 · |p| an update more than the
reference, and a teacher that is not the foreign one changes every loss
at O(1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.train import distill as jdistill
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.train import distill as tdistill
from _torch_threads import _one_thread  # noqa: F401


T = 64          # 8 → 4 → 2 nests (T % 16 == 0)
MU, S2 = 0.3, 0.05
LR = 0.02
STEPS = 3       # a phase's and the warmup's steps


class Affine(nn.Module):
    """out = a[t]·x + b[t], the reference's `_affine_student`."""

    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(T))
        self.b = nn.Parameter(torch.zeros(T))

    def forward(self, x, t, ctx=None):
        return (self.a[t].reshape(-1, 1, 1, 1) * x
                + self.b[t].reshape(-1, 1, 1, 1))


def _analytic_eps_torch(sched):
    """The port's twin of the reference's `_analytic_eps`: E[ε | x_t] for
    x₀ ~ N(μ, s²I), affine in x_t."""
    abar_all = sched.alphas_cumprod

    def teacher(x, t, ctx=None):
        abar = abar_all[t].reshape(-1, 1, 1, 1)
        a, sig = torch.sqrt(abar), torch.sqrt(1 - abar)
        denom = abar * S2 + (1 - abar)
        x0_post = MU + (a * S2 / denom) * (x - a * MU)
        return (x - a * x0_post) / sig
    return teacher


@pytest.mark.parametrize("guidance, weight_decay",
                         [(None, 0.05), (3.0, 0.0)])
def test_foreign_teacher_matches_jax(monkeypatch, guidance, weight_decay):
    from test_distill import _affine_student, _analytic_eps
    from test_torch_port_distill import JaxDraws, _jax_keys, _nchw

    data = MU + np.sqrt(S2) * np.random.default_rng(5).standard_normal(
        (8, 4, 4, 1)).astype(np.float32)
    ctx = np.random.default_rng(6).standard_normal((2, 1, 3, 8)).astype(
        np.float32)
    kwargs = dict(start_steps=8, end_steps=2, steps_per_phase=STEPS,
                  learning_rate=LR, weight_decay=weight_decay,
                  student_prediction_type="v_prediction",
                  reparam_steps=STEPS, guidance_scale=guidance)
    if guidance is not None:
        cond_uncond = dict(cond=ctx[0], uncond=ctx[1])
    else:
        cond_uncond = {}
    logs = {"jax": {}, "torch": {}}

    js = jsched.DiffusionSchedule.create(T)
    teacher = _analytic_eps(MU, S2)
    teacher.sched = js
    params, apply_fn = _affine_student(T)
    want = jdistill.distill_progressive(
        apply_fn, None, js,
        lambda: [jnp.asarray(data[i:i + 4]) for i in (0, 4)],
        teacher_apply_fn=teacher, student_params=params,
        log=lambda k, v, s: logs["jax"].__setitem__(k, v),
        **{k: jnp.asarray(v) for k, v in cond_uncond.items()}, **kwargs)

    monkeypatch.setattr(tdistill, "distill_draws",
                        lambda role, phase, step, device: JaxDraws(
                            _jax_keys(role, phase, step)))
    ts = tsched.DiffusionSchedule.create(T)
    x0 = _nchw(data)
    start = {"a": torch.zeros(T), "b": torch.zeros(T)}
    got = tdistill.distill_progressive(
        Affine(), None, ts, lambda: [x0[:4], x0[4:]],
        teacher_fn=_analytic_eps_torch(ts), student_params=start,
        log=lambda k, v, s: logs["torch"].__setitem__(k, v),
        **{k: torch.from_numpy(v) for k, v in cond_uncond.items()},
        **kwargs)

    assert all(not v.any() for v in start.values())  # copied, not trained
    assert (got.num_steps, got.prediction_type) == (2, "v_prediction")
    for gp, wp in zip(got.phases, want.phases):
        np.testing.assert_allclose(gp.losses, wp.losses, rtol=1e-4)
    assert set(logs["torch"]) == set(logs["jax"])
    for k, v in logs["jax"].items():
        assert logs["torch"][k] == pytest.approx(v, rel=1e-4), k
    updates = 3 * STEPS
    for k in ("a", "b"):
        w = np.asarray(want.params[k])
        assert np.abs(w).max() > LR  # the student moved
        err = np.abs(got.params[k].numpy() - w).max()
        assert err <= 1e-2 * LR * updates, (k, err)


def test_foreign_teacher_needs_a_start():
    with pytest.raises(ValueError, match="student_params"):
        tdistill.distill_progressive(
            Affine(), None, tsched.DiffusionSchedule.create(T),
            lambda: [torch.zeros(1, 1, 4, 4)], start_steps=8, end_steps=4,
            steps_per_phase=1, teacher_fn=lambda x, t: x)
