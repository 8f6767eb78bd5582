"""polyp_tpu_torch's DDPM, DDIM (η, clip_sample, final_alpha_to_one) and
DPM-Solver++(2M) samplers against their polyp_tpu twins on the CPU.

Both packages run the same numpy-seeded elementwise ε-model from the same
`init`. The stochastic samplers' per-step noise is one fixed numpy array
on both sides: JAX draws it from its key inside `lax.scan`, whose body is
traced once per segment, so the test patches `jax.random.normal` (which
polyp_tpu.diffusion.samplers calls) and the port's `_gaussian` to return
that array. Both trajectories then add the same noise at every step.

Tolerance: max |Δ| <= 1e-5 · max |x|, as UniPC's test: the same fp32
operations in another order (the reference evaluates every branch under
`jnp.where`; the port takes its branch). A wrong coefficient, order,
branch or noise scale gives O(1e-2) or more.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.diffusion import samplers as jsamp
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu_torch.diffusion import samplers as tsamp
from polyp_tpu_torch.diffusion import schedule as tsched
from test_torch_port_pipeline import SD_SCHEDULE, _toy_eps
from _torch_threads import _one_thread  # noqa: F401


SHAPE = (2, 4, 8, 8)
LINEAR = dict(num_train_timesteps=1000, beta_schedule="linear",
              beta_start=1e-4, beta_end=2e-2)


@pytest.fixture
def fixed_noise(monkeypatch):
    """Every noise draw of both packages returns one numpy array."""
    noise = np.random.default_rng(11).standard_normal(SHAPE).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tsamp, "_gaussian",
                        lambda shape, generator, name: torch.from_numpy(
                            noise.copy()))
    return noise


def _pair(name, steps, segments=None, schedule=SD_SCHEDULE, **kw):
    """The same start through polyp_tpu's sampler and the port's:
    `segments` None for one model, else a list of (steps, toy seed)."""
    init = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
    if segments is None:
        j_fn, t_fn = _toy_eps(0)
    else:
        fns = [(n, _toy_eps(seed)) for n, seed in segments]
        j_fn = [(n, f[0]) for n, f in fns]
        t_fn = [(n, f[1]) for n, f in fns]
    want = jsamp.sample(name, j_fn, jsched.DiffusionSchedule.create(
        **schedule), SHAPE, jax.random.PRNGKey(0), steps,
        init=jnp.asarray(init), **kw)
    got = tsamp.sample(name, t_fn, tsched.DiffusionSchedule.create(
        **schedule), SHAPE, torch.Generator().manual_seed(0), steps,
        init=torch.from_numpy(init), **kw)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    return got.numpy(), np.asarray(want)


def _close(got, want):
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("steps", [1, 2, 3, 25])
def test_dpmpp_2m_matches_jax(steps):
    _close(*_pair("dpmpp_2m", steps))


def test_dpmpp_2m_segments_match_jax():
    """A two-segment list, the step index (and the order-2 history)
    continuing across the segments as in the reference; segments of one
    model are the one loop."""
    _close(*_pair("dpmpp_2m", 7, [(4, 0), (3, 1)]))
    one, _ = _pair("dpmpp_2m", 7, [(4, 0), (3, 0)])
    alone, _ = _pair("dpmpp_2m", 7)
    np.testing.assert_array_equal(one, alone)


@pytest.mark.parametrize("clip_sample", [True, False])
@pytest.mark.parametrize("steps", [1, 10, 50])
def test_ddpm_matches_jax(fixed_noise, steps, clip_sample):
    """The scratch path's schedule (linear betas) at the "ddpm" grid."""
    _close(*_pair("ddpm", steps, schedule=LINEAR, clip_sample=clip_sample))


def test_ddpm_every_train_step_matches_jax(fixed_noise):
    """num_steps=None: all 1000 train timesteps, as DDPMPipeline."""
    _close(*_pair("ddpm", None, schedule=LINEAR))


def test_ddpm_segments_match_jax(fixed_noise):
    _close(*_pair("ddpm", 10, [(6, 0), (4, 1)], schedule=LINEAR))


@pytest.mark.parametrize("final_alpha_to_one", [False, True])
@pytest.mark.parametrize("clip_sample", [False, True])
@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_ddim_matches_jax(fixed_noise, eta, clip_sample, final_alpha_to_one):
    _close(*_pair("ddim", 10, eta=eta, clip_sample=clip_sample,
                  final_alpha_to_one=final_alpha_to_one))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_segments_match_jax(fixed_noise, eta):
    _close(*_pair("ddim", 9, [(5, 0), (4, 1)], eta=eta, clip_sample=True))


@pytest.mark.parametrize("name,kw", [("ddpm", {}), ("ddim", {"eta": 0.5})])
def test_stochastic_samplers_draw_from_the_generator(name, kw):
    """With `init` given, the per-step noise still comes from the
    generator: one seed repeats, another differs, none refuses."""
    init = torch.from_numpy(np.random.default_rng(3).standard_normal(
        SHAPE).astype(np.float32))
    sched = tsched.DiffusionSchedule.create(**LINEAR)
    fn = _toy_eps(0)[1]

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return tsamp.sample(name, fn, sched, SHAPE, gen, 5, init=init, **kw)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="generator"):
        run(None)


def test_deterministic_ddim_needs_no_generator():
    init = torch.ones(SHAPE)
    out = tsamp.ddim_sample(_toy_eps(0)[1], tsched.DiffusionSchedule.create(
        **SD_SCHEDULE), SHAPE, None, num_steps=3, init=init)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("name", ["ddpm", "dpmpp_2m"])
def test_visits_the_reference_timesteps(name):
    seen = []

    def spy(x, t):
        seen.append(int(t[0]))
        return torch.zeros_like(x)

    tsamp.sample(name, spy, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
                 (1, 4, 2, 2), torch.Generator().manual_seed(0), 5)
    want = jsamp.sampler_timesteps(name, 1000, 5)
    assert seen == [int(t) for t in np.asarray(want)] == \
        tsamp.sampler_timesteps(name, 1000, 5)


def test_get_sampler_serves_the_reference_four():
    assert set(tsamp.SAMPLERS) == set(jsamp.SAMPLERS) == {
        "ddpm", "ddim", "dpmpp_2m", "unipc"}
    for name in jsamp.SAMPLERS:
        assert tsamp.get_sampler(name) is tsamp.SAMPLERS[name]
