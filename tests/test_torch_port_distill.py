"""Distillation training in polyp_tpu_torch against polyp_tpu's on the CPU:
`distill_targets`, `snr_weight`, one `make_distill_step` (plain and
reparam, folded CFG and unconditional), a two-phase `distill_progressive`
with an ε→v reparam warmup, `check_reparam_converged`,
`synthetic_latents` and `distill_vae_decoder`.

Both packages run the same weights (numpy-seeded values for the
reference's parameter shapes, test_torch_port_lora.py's `_init_like`,
carried by models/importers.py) on the same numpy-seeded inputs, in fp32,
and the port's steps take the reference's draws (`JaxDraws`: the
timestep indices and ε polyp_tpu derives from a step's key by `split`;
for the phase loop, the keys of every role: fold_in(PRNGKey(17), i) for
warmup steps, PRNGKey(41) for the closure probe, fold_in(PRNGKey(23 +
phase), i) for phase steps).

Tolerances: the targets 1e-5 · max |x̃₀| (the same fp32 products summed in
another order, through two teacher forwards); `snr_weight` exact (one
fp32 division and a max); a step's loss 1e-5 relative and the phase
loop's 1e-4 (nine steps of drift); a step's clipped gradient (the first
Adam moment) within 1e-4 of its largest; parameters within 1e-2 · lr of
the reference's per update (Adam divides each gradient by its own RMS,
so a relative gradient difference ε moves an element by ε · lr);
synthetic latents 1e-6 (one bilinear upsample and a mix); the VAE
distiller's losses and holdout rel-L2 1e-4 relative. Two kinds of
gradient are float noise, which Adam scales to up to ±lr in both
packages at random, so the parameter checks leave them out: whole tensors
whose reference gradient is below 1e-4 of the largest (`_noise`: the
tiny UNets' 32-channel levels have GroupNorm groups of one channel, which
cancel the per-channel constants of `time_emb_proj` and the `conv1`
biases before them), and after one step the elements whose gradient is
below 1e-3 of their tensor's largest (`_moving`).
"""

from __future__ import annotations

import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.models import unet2d as junet2d
from polyp_tpu.models import unet_condition as jcond
from polyp_tpu.models import vae as jvae
from polyp_tpu.models.tiny_decoder import TinyDecoder as JTinyDecoder
from polyp_tpu.train import distill as jdistill
from polyp_tpu.train import distill_vae as jdvae
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models.tiny_decoder import TinyDecoder
from polyp_tpu_torch.models.unet2d import tiny_scratch_unet
from polyp_tpu_torch.models.unet_condition import (
    UNet2DCondition, tiny_condition_unet)
from polyp_tpu_torch.models.vae import tiny_vae
from polyp_tpu_torch.train import distill as tdistill
from polyp_tpu_torch.train import distill_vae as tdvae
from polyp_tpu_torch.train.sd_finetune import SDOptimizer
from test_torch_port_lora import _init_like
from _torch_threads import _one_thread  # noqa: F401


LIMIT_S = 600   # each test's own limit: 3.5x its longest on a busy worker

T = 64          # train timesteps: 8 → 4 → 2 nests (T % 16 == 0)
SIZE = 8        # latent / pixel size
LR = 1e-3
GUIDANCE = 3.0
# the phase loop's UNet: tiny_condition_unet cut to its first level (the
# reference compiles four steps of it, each about half as long)
ONE_LEVEL = dict(block_out_channels=(32,), layers_per_block=1,
                 cross_attention_dim=32, attention_num_heads=2,
                 down_block_types=("CrossAttnDownBlock2D",),
                 up_block_types=("CrossAttnUpBlock2D",))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit: SIGALRM raises past LIMIT_S."""
    def expired(signum, frame):
        raise TimeoutError(f"the test ran past its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class JaxDraws(tdistill.DistillDraws):
    """A distill step's draws as polyp_tpu's step makes them from `key`:
    k_noise, k_idx = split(key); ε drawn NHWC, handed over as NCHW."""

    def __init__(self, key):
        self.k_noise, self.k_idx = jax.random.split(key)

    def idx(self, n, high):
        return torch.from_numpy(np.array(
            jax.random.randint(self.k_idx, (n,), 0, high), np.int64))

    def noise(self, shape):
        n, c, h, w = shape
        return _nchw(jax.random.normal(self.k_noise, (n, h, w, c),
                                       jnp.float32))


@pytest.fixture(scope="module")
def models():
    """{"cond": the tiny conditional UNet (latent space, 4 channels, a
    32-wide context), "one_level": its one-level cut, "scratch": the tiny
    scratch UNet (pixels)}: each as (JAX module, JAX params, the port's
    module, its fp32 params, the weight carrier)."""
    out = {}
    latent = (jnp.zeros((1, SIZE, SIZE, 4)), jnp.zeros((1,), jnp.int32),
              jnp.zeros((1, 7, 32)))
    for name, jm, tm, args in (
            ("cond", jcond.tiny_condition_unet(jnp.float32),
             tiny_condition_unet(), latent),
            ("one_level", jcond.UNet2DCondition(**ONE_LEVEL),
             UNet2DCondition(**ONE_LEVEL), latent),
            ("scratch", junet2d.tiny_scratch_unet(), tiny_scratch_unet(),
             (jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,), jnp.int32)))):
        params = _init_like(jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), *args)["params"], seed=3)
        convert = (timp.unet2d_from_jax if name == "scratch"
                   else timp.unet_from_jax)
        weights = convert(params)
        tm.load_state_dict(weights, strict=True)
        out[name] = (jm, jax.tree_util.tree_map(jnp.asarray, params),
                     tm.eval(), weights, convert)
    return out


@pytest.fixture(scope="module")
def context():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((1, 7, 32)).astype(np.float32),
            rng.standard_normal((1, 7, 32)).astype(np.float32))


def _x0(channels: int, n: int = 2, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, channels)).astype(np.float32)


def _moving(grad: torch.Tensor) -> torch.Tensor:
    """The elements whose gradient is at least 1e-3 of their tensor's
    largest. Adam moves an element by lr · g / (|g| + ε): where g is a
    near-cancelling fp32 sum (an absolute error of ~1e-6 of the tensor's
    largest), or about ε = 1e-8, its move is the noise of that sum."""
    return grad.abs() >= 1e-3 * grad.abs().max()


def _noise(grads: dict[str, torch.Tensor]) -> set[str]:
    """Tensors whose gradient is float noise (module docstring)."""
    top = max(g.abs().max().item() for g in grads.values())
    return {k for k, g in grads.items() if g.abs().max().item() < 1e-4 * top}


# ---------------------------------------------------------------------------
# targets and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_distill_targets_match_jax(models, pred):
    """x̃₀ through two substeps of the scratch UNet as an ε or v teacher, at
    each student step of a 4-step grid."""
    jm, jp, tm, _, _ = models["scratch"]
    js = jsched.DiffusionSchedule.create(T, prediction_type=pred)
    ts = tsched.DiffusionSchedule.create(T, prediction_type=pred)
    x_t = _x0(3, 4)
    idx = np.array([0, 1, 2, 3], np.int32)
    grid = jdistill.distill_grid(js, 4)
    want = jax.jit(lambda p, x, i: jdistill.distill_targets(
        lambda xx, t: jm.apply({"params": p}, xx, t), js, grid, x, i))(
            jp, jnp.asarray(x_t), jnp.asarray(idx))
    with torch.no_grad():
        got = tdistill.distill_targets(
            lambda x, t: tm(x, t), ts, tdistill.distill_grid(ts, 4),
            _nchw(x_t), torch.from_numpy(idx).long())
    assert got.dtype == torch.float32
    assert _rel(_nhwc(got), want) <= 1e-5


def test_snr_weight_is_exact():
    abar = tsched.DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                           0.012).alphas_cumprod
    want = jdistill.snr_weight(jnp.asarray(abar.numpy()))
    np.testing.assert_array_equal(tdistill.snr_weight(abar).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

def _jax_applies(jm, cond=None, uncond=None, guidance=None):
    """The reference's closures (polyp_tpu/train/distill.py:357-367)."""
    if guidance is None:
        return (lambda p, x, t: jm.apply({"params": p}, x, t),) * 2

    def ctx(x, e):
        return jnp.broadcast_to(e, (x.shape[0],) + e.shape[-2:])

    def teacher(p, x, t):
        x2, t2 = jnp.concatenate([x, x], 0), jnp.concatenate([t, t], 0)
        e2 = jnp.concatenate([ctx(x, uncond), ctx(x, cond)], 0)
        out_u, out_c = jnp.split(jm.apply({"params": p}, x2, t2, e2), 2, 0)
        return out_u + guidance * (out_c - out_u)

    def student(p, x, t):
        return jm.apply({"params": p}, x, t, ctx(x, cond))

    return teacher, student


@pytest.mark.parametrize("name, reparam", [("cond", False),
                                           ("scratch", True)])
def test_distill_step_matches_jax(models, context, name, reparam):
    """One step at a constant learning rate: folded CFG on the conditional
    UNet with the 2-substep target, and the unconditional scratch UNet
    with the reparam target (an ε teacher, a v student); the phase loop's
    test holds the other two (folded CFG with both targets) step by step.
    The loss; the clipped gradient (the reference's first Adam moment,
    0.1 · g) within 1e-4 of its largest; every parameter after the update
    within 1e-2 · lr where its gradient is at least 1e-3 of its tensor's
    largest (`_moving`)."""
    jm, jp, tm, weights, convert = models[name]
    cond, uncond = context
    guided = name == "cond"
    j_teacher, j_student = _jax_applies(
        jm, *(map(jnp.asarray, context) if guided else ()),
        guidance=GUIDANCE if guided else None)
    applies = tdistill.make_applies(
        tm, guidance_scale=GUIDANCE if guided else None,
        cond=torch.from_numpy(cond) if guided else None,
        uncond=torch.from_numpy(uncond) if guided else None)
    student_pred = "v_prediction" if reparam else "epsilon"
    schedules = [(m.DiffusionSchedule.create(T),
                  m.DiffusionSchedule.create(T, prediction_type=student_pred))
                 for m in (jsched, tsched)]
    jgrid = jdistill.distill_grid(schedules[0][0], 4)
    tgrid = tdistill.distill_grid(schedules[1][0], 4)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(LR, weight_decay=1e-2))
    # the reference's step donates its state: the teacher keeps its own
    # buffers (its :179-186)
    own = jax.tree_util.tree_map(jnp.array, jp)
    jstate = jdistill.DistillState(step=jnp.zeros((), jnp.int32),
                                   params=own, opt_state=tx.init(own), tx=tx)
    jstep = jdistill.make_distill_step(j_student, j_teacher, *schedules[0],
                                       jgrid, reparam=reparam)
    tstate = tdistill.init_distill_state(weights, SDOptimizer(lambda c: LR))
    tstep = tdistill.make_distill_step(applies.student, applies.teacher,
                                       *schedules[1], tgrid, reparam=reparam)
    x0 = _x0(4 if guided else 3)
    key = jax.random.PRNGKey(7)
    jstate, jloss = jstep(jstate, jp, jnp.asarray(x0), key)
    tstate, tloss = tstep(tstate, applies.cast(weights), _nchw(x0),
                          JaxDraws(key))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert tstate.step == 1 and tstate.opt_state["count"] == 1
    mu = convert(jax.tree_util.tree_map(np.asarray,
                                        jstate.opt_state[1][0].mu))
    top = max(m.abs().max().item() for m in mu.values())
    for k, m in mu.items():
        err = (tstate.opt_state["mu"][k] - m).abs().max().item()
        assert err <= 1e-4 * top, (k, err)
    noise = _noise(mu)
    after = convert(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, w in after.items():
        if k in noise:
            continue
        err = (tstate.params[k].detach() - w)[_moving(mu[k])].abs().max()
        assert err.item() <= 1e-2 * LR, (k, err)
    assert len(noise) < len(after) // 4


# ---------------------------------------------------------------------------
# the phase loop
# ---------------------------------------------------------------------------

def _jax_keys(role, phase, step):
    return {"warmup": lambda: jax.random.fold_in(jax.random.PRNGKey(17),
                                                 step),
            "probe": lambda: jax.random.PRNGKey(41),
            "phase": lambda: jax.random.fold_in(
                jax.random.PRNGKey(23 + phase), step)}[role]()


def test_distill_progressive_matches_jax(models, context, monkeypatch):
    """8 → 4 → 2 on the one-level conditional UNet with folded CFG, 3
    steps a phase and an ε→v reparam warmup of 3 steps (the -1 default),
    JAX's draws for every role: every loss, the logged reparam closure,
    the final parameters; and the phase-0 teacher's weights
    bit-unchanged."""
    jm, jp, tm, weights, convert = models["one_level"]
    cond, uncond = context
    x0 = [_x0(4, 2, seed) for seed in (8, 9)]
    logs = {"jax": {}, "torch": {}}
    j_teacher, _ = _jax_applies(jm, guidance=GUIDANCE)

    def jax_apply(p, x, t, ctx=None):
        return jm.apply({"params": p}, x, t, ctx)

    kwargs = dict(start_steps=8, end_steps=2, steps_per_phase=3,
                  learning_rate=LR, student_prediction_type="v_prediction",
                  guidance_scale=GUIDANCE)
    want = jdistill.distill_progressive(
        jax_apply, jp, jsched.DiffusionSchedule.create(T),
        lambda: [jnp.asarray(x) for x in x0], cond=jnp.asarray(cond),
        uncond=jnp.asarray(uncond),
        log=lambda k, v, s: logs["jax"].__setitem__(k, v), **kwargs)
    monkeypatch.setattr(tdistill, "distill_draws",
                        lambda role, phase, step, device: JaxDraws(
                            _jax_keys(role, phase, step)))
    teacher = {k: v.clone() for k, v in weights.items()}
    got = tdistill.distill_progressive(
        tm, teacher, tsched.DiffusionSchedule.create(T),
        lambda: [_nchw(x) for x in x0], cond=torch.from_numpy(cond),
        uncond=torch.from_numpy(uncond),
        log=lambda k, v, s: logs["torch"].__setitem__(k, v), **kwargs)
    for k, v in weights.items():
        assert torch.equal(teacher[k], v), k
    assert (got.num_steps, got.prediction_type) == (2, "v_prediction")
    assert [p.num_steps for p in got.phases] == [4, 2]
    for gp, wp in zip(got.phases, want.phases):
        np.testing.assert_allclose(gp.losses, wp.losses, rtol=1e-4)
    assert set(logs["torch"]) == set(logs["jax"]) == {
        "reparam_loss", "reparam_rel_err", "distill_loss_4steps",
        "distill_loss_2steps"}
    for k, v in logs["jax"].items():
        assert logs["torch"][k] == pytest.approx(v, rel=1e-4), k
    final = convert(jax.tree_util.tree_map(np.asarray, want.params))
    moved = convert(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), want.params, jp))
    # a tensor whose gradients were float noise the whole run moved by
    # noise alone: less than one update's worth in the reference
    still = {k for k, d in moved.items() if d.abs().max() <= 0.5 * LR}
    assert len(still) < len(moved) // 4
    steps = 3 * 3
    for k, w in final.items():
        if k in still:
            continue
        err = (got.params[k] - w).abs().max().item()
        assert err <= 1e-2 * LR * steps, (k, err)


class AffineDenoiser(nn.Module):
    """A per-timestep affine model, out = a[t]·x + b[t]: it holds the
    exact ε and v predictors of Gaussian data (the reference test's
    `_affine_student`)."""

    def __init__(self, T: int):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(T))
        self.b = nn.Parameter(torch.zeros(T))

    def forward(self, x, t):
        return self.a[t].reshape(-1, 1, 1, 1) * x + self.b[t].reshape(
            -1, 1, 1, 1)


class TestReparamGuard:
    """The reference's guard cases (tests/test_distill.py:366-412): the
    three loss histories and the closure criterion, on which both
    packages agree, message included; and the auto-scaled warmup, which
    converges on an analytic teacher in both."""

    CASES = {
        "plateaued": ([1e-1 * (0.8 ** i) for i in range(60)] + [2e-6] * 60,
                      None),
        "still_descending": ([1e-1 * (0.93 ** i) for i in range(100)],
                             None),
        "tiny_budget": ([1e-1 * (0.5 ** i) for i in range(20)], None),
        "not_closed": ([1e-2] * 60, 0.4),
    }

    @pytest.mark.parametrize("case", list(CASES))
    def test_guard_matches_jax(self, case):
        losses, rel_err = self.CASES[case]
        outcome = {}
        for name, fn in (("jax", jdistill.check_reparam_converged),
                         ("torch", tdistill.check_reparam_converged)):
            try:
                fn(losses, rel_err=rel_err)
                outcome[name] = None
            except RuntimeError as e:
                outcome[name] = str(e)
        assert outcome["torch"] == outcome["jax"]
        raises = case in ("still_descending", "not_closed")
        assert (outcome["torch"] is not None) == raises
        if raises:
            assert "reparam warmup" in outcome["torch"]

    def test_auto_reparam_scales_to_phase_budget(self):
        """reparam_steps=-1 gives the ε→v switch the phase's 200 steps
        (past the guard's 50), and the warmup converges without raising:
        the reference as its own test runs it (an analytic ε teacher, an
        affine student from zeros); the port on an affine module whose
        teacher weights are that analytic ε predictor, the student from a
        copy of them."""
        from test_distill import _affine_student, _analytic_eps

        T, mu, s2 = 64, 0.3, 0.05
        jsched_ = jsched.DiffusionSchedule.create(T)
        teacher = _analytic_eps(mu, s2)
        teacher.sched = jsched_
        params, apply_fn = _affine_student(T)
        data = mu + np.sqrt(s2) * np.random.default_rng(5).standard_normal(
            (32, 4, 4, 1)).astype(np.float32)
        logged = {"jax": {}, "torch": {}}
        jdistill.distill_progressive(
            apply_fn, None, jsched_,
            lambda: [jnp.asarray(data[i:i + 16]) for i in (0, 16)],
            start_steps=8, end_steps=4, steps_per_phase=200,
            learning_rate=0.05, weight_decay=0.0,
            student_prediction_type="v_prediction", reparam_steps=-1,
            teacher_apply_fn=teacher, student_params=params,
            log=lambda k, v, s: logged["jax"].setdefault(k, v))
        sched = tsched.DiffusionSchedule.create(T)
        abar = sched.alphas_cumprod
        sigma = torch.sqrt(1 - abar)
        denom = abar * s2 + 1 - abar
        eps = {"a": sigma / denom, "b": -torch.sqrt(abar) * mu * sigma / denom}
        x0 = _nchw(data)
        result = tdistill.distill_progressive(
            AffineDenoiser(T), eps, sched, lambda: [x0[:16], x0[16:]],
            start_steps=8, end_steps=4, steps_per_phase=200,
            learning_rate=0.05, student_prediction_type="v_prediction",
            reparam_steps=-1,
            log=lambda k, v, s: logged["torch"].setdefault(k, v))
        assert result.num_steps == 4
        for name, got in logged.items():
            assert np.isfinite(got["reparam_loss"]), name
            assert got["reparam_rel_err"] <= 0.15, name


# ---------------------------------------------------------------------------
# the VAE decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("latent_size", [8, 7, 3])
def test_synthetic_latents_match_jax(latent_size):
    """The reference's latents against the port's mix of the same draws
    (white, ¼-resolution and the ratio from split(key, 3)), the upsample's
    edges included."""
    key = jax.random.PRNGKey(latent_size)
    want = jdvae.synthetic_latents(key, 3, latent_size)
    k1, k2, k3 = jax.random.split(key, 3)
    coarse = max(latent_size // 4, 1)
    got = tdvae.latents_from_noise(
        _nchw(jax.random.normal(k1, (3, latent_size, latent_size, 4))),
        _nchw(jax.random.normal(k2, (3, coarse, coarse, 4))),
        _nchw(jax.random.uniform(k3, (3, 1, 1, 1), minval=0.2,
                                 maxval=0.9)))
    assert np.abs(_nhwc(got) - np.asarray(want)).max() <= 1e-6


def test_distill_vae_decoder_matches_jax():
    """Three batches of latents through both distillers from the same
    initial weights (the reference's init from PRNGKey(0)) and teacher:
    every loss, the holdout rel-L2 and the meta."""
    vae = jvae.tiny_vae()
    vparams = _init_like(jax.eval_shape(
        vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jax.random.PRNGKey(0))["params"], seed=6)
    decoder = JTinyDecoder(base_channels=8, dtype=jnp.float32)
    init = decoder.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 4, 4, 4), jnp.float32))["params"]
    rng = np.random.default_rng(7)
    batches = [rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
               for _ in range(3)]
    holdout = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = jdvae.distill_vae_decoder(
        vae, {"params": jax.tree_util.tree_map(jnp.asarray, vparams)},
        decoder, [jnp.asarray(b) for b in batches], learning_rate=3e-3,
        holdout=jnp.asarray(holdout), key=jax.random.PRNGKey(0))
    tvae = tiny_vae()
    tvae.load_state_dict(timp.vae_from_jax(vparams), strict=True)
    tdec = TinyDecoder(base_channels=8, dtype=torch.float32)
    tdec.load_state_dict(timp.tiny_decoder_from_jax(init), strict=True)
    got = tdvae.distill_vae_decoder(
        tvae.eval(), tdec, [_nchw(b) for b in batches], learning_rate=3e-3,
        holdout=_nchw(holdout))
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.rel_l2 == pytest.approx(want.rel_l2, rel=1e-4)
    assert set(got.meta) == set(want.meta)
    for k in ("base_channels", "latent_channels", "blocks_per_stage",
              "steps", "learning_rate"):
        assert got.meta[k] == want.meta[k], k
    assert got.meta["steps"] == 3
