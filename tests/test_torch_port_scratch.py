"""The scratch DDPM path of polyp_tpu_torch against polyp_tpu's on the CPU:
the pixel UNets (`UNet2D`, `SimpleUNet`), the train step and its epoch
loop with resume, `PixelDiffusionSampler`, and w8a8_static calibration of
an unconditional pixel model.

Both packages run the same weights (numpy-seeded values for the
reference's parameter shapes, biases and norm scales off their init so
that they matter: test_torch_port_lora.py's `_init_like`; carried by
models/importers.py) on the same numpy-seeded inputs, in fp32. The port's step takes the reference's
random draws (`JaxDraws`: the flip mask, ε and timesteps polyp_tpu
derives from the step's key by `split(key, 3)`); the samplers see one
fixed noise array on both sides (tests/test_torch_port_samplers.py's
patch).

Tolerances: forwards 1e-5 relative L2 (the same fp32 products summed in
another order); the step's loss 1e-5 relative, its first Adam moment 1e-4
of the largest, and the parameters after an update at lr > 0 within
1e-2 · lr of the reference's (Adam divides each gradient by its own RMS,
so a relative gradient difference ε moves an element by ε · lr);
sampler trajectories 1e-5 · max |x|; calibrated scale tables 1e-5
relative (fp32 amaxes along an unguided DDIM trajectory). A wrong
transpose, head split, skip order, resize, padding, draw or schedule
gives O(1) of these. The step's UNet is 64 channels wide: at 16 or 32
channels GroupNorm's 32 groups hold one channel each and cancel every
per-channel constant before it, which leaves `time_emb_proj` and
`conv1.bias` float-noise gradients that Adam scales to ±lr in both
packages at random.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.configs import DiffusionConfig as JConfig
from polyp_tpu.diffusion import calibrate as jcal
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.models import simple_unet as jsimple
from polyp_tpu.models import unet2d as junet
from polyp_tpu.pipeline import PixelDiffusionSampler as JPixelSampler
from polyp_tpu.train import scratch_ddpm as jddpm
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.data import pipeline as tpipe
from polyp_tpu_torch.diffusion import calibrate as tcal
from polyp_tpu_torch.diffusion import samplers as tsamp
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import simple_unet as tsimple
from polyp_tpu_torch.models import unet2d as tunet
from polyp_tpu_torch.models.unet_blocks import QConv2d, QLinear
from polyp_tpu_torch.pipeline import PixelDiffusionSampler
from polyp_tpu_torch.train import resume as tresume
from polyp_tpu_torch.train import scratch_ddpm as tddpm
from polyp_tpu_torch.train.sd_finetune import StepDraws
from test_torch_port_lora import _init_like
from _torch_threads import _one_thread  # noqa: F401


TWO_LEVELS = dict(down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                  up_block_types=("AttnUpBlock2D", "UpBlock2D"),
                  layers_per_block=1)
UNETS = {
    # (UNet2D config, image size, context width)
    "tiny": (dict(block_out_channels=(16, 32), **TWO_LEVELS), 16, None),
    # six levels at 56 px: 56 → 28 → 14 → 7 → 4 → 2, and up to the skips'
    # sizes (4 → 7), not a blind 2× (4 → 8)
    "six_levels_56px": (dict(block_out_channels=(32, 32, 32, 32, 64, 64),
                             layers_per_block=1), 56, None),
    # cross-attention over a clip-vit-base-patch32-shaped context
    "conditioned": (dict(block_out_channels=(32, 64), **TWO_LEVELS,
                         cross_attention_dim=512), 16, 512),
}
WIDE = dict(block_out_channels=(64, 64), **TWO_LEVELS)
# the step's UNet: one 64-wide level with its attention
STEP = dict(block_out_channels=(64,), down_block_types=("AttnDownBlock2D",),
            up_block_types=("AttnUpBlock2D",), layers_per_block=1)
LR = 1e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _params(module, *args, seed=0) -> dict:
    """Seeded values for `module`'s parameter tree, from its shapes alone
    (no eager init)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return _init_like(shapes["params"], seed)


def _pair(config: dict, size: int, ctx_dim: int | None = None, seed=0):
    """The JAX UNet2D with seeded params, and the port's twin."""
    jm = junet.UNet2D(**config)
    args = [jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32)]
    if ctx_dim:
        args.append(jnp.zeros((1, 7, ctx_dim)))
    params = _params(jm, *args, seed=seed + 1)
    tm = tunet.UNet2D(**config)
    tm.load_state_dict(timp.unet2d_from_jax(params), strict=True)
    return jm, params, tm.eval()


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(UNETS))
def test_unet2d_matches_jax(name):
    config, size, ctx_dim = UNETS[name]
    jm, params, tm = _pair(config, size, ctx_dim)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    t = np.array([17, 903], np.int32)
    jargs, targs = [x, t], [_nchw(x), torch.from_numpy(t).long()]
    if ctx_dim:
        ctx = rng.standard_normal((2, 77, ctx_dim)).astype(np.float32)
        jargs.append(ctx)
        targs.append(torch.from_numpy(ctx))
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *jargs)
    with torch.no_grad():
        got = tm(*targs)
    assert got.dtype == torch.float32 and got.shape == (2, 3, size, size)
    assert _rel(_nhwc(got), want) <= 1e-5


def test_simple_unet_matches_jax():
    jm = jsimple.SimpleUNet(features=(16, 32, 64), time_dim=32)
    rng = np.random.default_rng(3)
    # an odd-free size whose stride-2 convs pad (0, 1), as XLA's SAME does
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 500], np.int32)
    params = _params(jm, x, t, seed=4)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, x, t)
    tm = tsimple.SimpleUNet(features=(16, 32, 64), time_dim=32)
    tm.load_state_dict(timp.simple_unet_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(t).long())
    assert _rel(_nhwc(got), want) <= 1e-5


def test_parameter_counts_are_the_references():
    """The reference configuration's counts (jax.eval_shape of
    polyp_tpu's modules): 113,664,003 parameters, 119,964,675 with
    cross-attention to 512-wide text; SimpleUNet 5,965,059."""
    def count(m):
        return sum(p.numel() for p in m.parameters())

    assert count(tunet.polyp_scratch_unet(device="meta")) == 113_664_003
    assert count(tunet.polyp_scratch_unet(cross_attention_dim=512,
                                          device="meta")) == 119_964_675
    assert count(tsimple.SimpleUNet(device="meta")) == 5_965_059
    big = tunet.polyp_scratch_unet(device="meta")
    assert big.dtype == torch.bfloat16
    assert big.conv_out.weight.dtype == torch.float32
    # attention heads are C / 64, not diffusers' default
    assert big.down_blocks[4].attentions[0].attn.heads == 8


def test_dropout_is_refused():
    """A UNet2D with dropout refuses random dropout unless its keep masks
    are handed over: a call without them is deterministic, the dropout-free
    network on the same weights (tests/test_torch_port_parallel.py holds
    the masked call to the reference's)."""
    torch.manual_seed(0)
    net = tunet.UNet2D(**UNETS["tiny"][0], dropout=0.1)
    plain = tunet.UNet2D(**UNETS["tiny"][0])
    plain.load_state_dict(net.state_dict())
    x, t = torch.randn(2, 3, 16, 16), torch.tensor([3, 7])
    with torch.no_grad():
        torch.testing.assert_close(net.train()(x, t), plain(x, t),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step and its epoch loop
# ---------------------------------------------------------------------------

class JaxDraws(StepDraws):
    """The port's step draws as polyp_tpu's ddpm_train_step makes them
    from `key`: split into (flip, noise, timesteps) keys; ε drawn NHWC,
    handed over as NCHW."""

    def __init__(self, key):
        self.keys = jax.random.split(key, 3)

    def flip(self, n):
        return torch.from_numpy(np.array(
            jax.random.bernoulli(self.keys[0], 0.5, (n,))))

    def normal(self, what, shape):
        n, c, h, w = shape
        return _nchw(jax.random.normal(self.keys[1], (n, h, w, c),
                                       jnp.float32))

    def timesteps(self, n, high):
        return torch.from_numpy(np.array(
            jax.random.randint(self.keys[2], (n,), 0, high), np.int64))


def _states(acc: int, steps_per_epoch: int, num_epochs: int = 1):
    """polyp_tpu's DDPMState and the port's over the same nudged weights
    of a one-level 64-wide UNet2D at 8 px, each with its optimizer's state
    fresh for those weights."""
    jm, params, tm = _pair(STEP, 8, seed=5)
    sizes = dict(learning_rate=LR, num_epochs=num_epochs,
                 accumulation_steps=acc, num_train_timesteps=1000)
    jcfg = JConfig(**sizes).with_schedule(steps_per_epoch)
    # create_ddpm_state less its init: the state over the given params
    tx = jddpm.make_ddpm_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jddpm.DDPMState(step=jnp.zeros((), jnp.int32), params=jparams,
                             opt_state=tx.init(jparams), tx=tx,
                             apply_fn=jm.apply)
    tcfg = DiffusionConfig(**sizes).with_schedule(steps_per_epoch)
    tstate = tddpm.create_ddpm_state(tcfg, tm, torch.Generator())
    weights = timp.unet2d_from_jax(params)
    with torch.no_grad():
        for k, p in tstate.params.items():
            p.copy_(weights[k])
    return jcfg, jstate, tcfg, tstate


def _images(n, seed=6, size=8):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("acc", [1, 2])
def test_ddpm_train_step_matches_jax(acc):
    """2·acc micro-steps of both steps with the reference's draws: each
    loss, the first micro-step's gradient (the reference's first Adam
    moment, 0.1 · the clipped gradient; under accumulation its
    accumulated mean), and the parameters after the second update (the
    first is at lr 0)."""
    _, jstate, _, tstate = _states(acc, 2 * acc)
    images = _images(2)
    jschedule = jsched.DiffusionSchedule.create(1000)
    tschedule = tsched.DiffusionSchedule.create(1000)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    for i in range(2 * acc):
        key = jax.random.PRNGKey(200 + i)
        jstate, jloss = jddpm.ddpm_train_step(jstate, jschedule,
                                              jnp.asarray(images), key)
        tstate, tloss = tddpm.ddpm_train_step(
            tstate, tschedule, torch.from_numpy(images), JaxDraws(key))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
        if i == 0:
            if acc > 1:
                want = jstate.opt_state.acc_grads
                got = tstate.opt_state["acc"]
            else:
                want = jstate.opt_state[1][0].mu
                got = tstate.opt_state["mu"]
            want = timp.unet2d_from_jax(jax.tree_util.tree_map(
                np.asarray, want))
            g = torch.cat([got[k].reshape(-1) for k in want])
            w = torch.cat([want[k].reshape(-1) for k in want])
            assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    assert tstate.opt_state["count"] == 2 and tstate.step == 2 * acc
    after = timp.unet2d_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))
    for k, w in after.items():
        moved = (w - before[k]).abs().max().item()
        assert moved > 0.5 * LR, k  # the second update moved it
        err = ((tstate.params[k].detach() - before[k])
               - (w - before[k])).abs().max().item()
        assert err <= 1e-2 * LR, (k, err)


def _port_run(tmp, num_epochs, images, ckpt=None):
    config = DiffusionConfig(learning_rate=LR, num_epochs=2).with_schedule(2)
    config = dataclasses.replace(config, num_epochs=num_epochs)
    state = tddpm.create_ddpm_state(
        config, tunet.UNet2D(**UNETS["tiny"][0]),
        torch.Generator().manual_seed(0))
    loader = tpipe.Loader(images, np.zeros(len(images), np.int32), 2,
                          seed=0, device="cpu")
    return tddpm.train_scratch_ddpm(
        config, state, tsched.DiffusionSchedule.create(1000), loader,
        checkpointer=ckpt)


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """One epoch snapshotted, then a new process's objects (state, loader,
    checkpointer) asked for two: the loss history and every parameter
    bit-equal to two epochs in one run."""
    images = _images(3)
    want_state, want = _port_run(tmp_path, 2, images)
    ckpt = tresume.EpochCheckpointer(tmp_path / "ckpt", every=1)
    _port_run(tmp_path, 1, images, ckpt)
    state, result = _port_run(
        tmp_path, 2, images, tresume.EpochCheckpointer(tmp_path / "ckpt",
                                                       every=1))
    assert result.loss_hist == want.loss_hist and len(want.loss_hist) == 2
    assert state.step == want_state.step == 4
    for k, p in want_state.params.items():
        assert torch.equal(state.params[k], p), k


# ---------------------------------------------------------------------------
# sampling and calibration
# ---------------------------------------------------------------------------

@pytest.fixture
def fixed_noise(monkeypatch):
    """Every noise draw of both packages returns one numpy array (NHWC for
    the reference, NCHW for the port)."""
    noise = np.random.default_rng(11).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=None: jnp.asarray(noise))
    monkeypatch.setattr(tsamp, "_gaussian",
                        lambda shape, generator, name: _nchw(noise))
    return noise


@pytest.mark.parametrize("sampler, steps", [("ddpm", 6), ("ddim", 4)])
def test_pixel_sampler_matches_jax(fixed_noise, sampler, steps):
    jm, params, tm = _pair(UNETS["tiny"][0], 8, seed=7)
    schedule = dict(num_train_timesteps=50)
    want = JPixelSampler(jm, params, jsched.DiffusionSchedule.create(
        **schedule), 8, sampler=sampler, num_steps=steps)(
            2, jax.random.PRNGKey(0))
    got = PixelDiffusionSampler(tm, tsched.DiffusionSchedule.create(
        **schedule), 8, sampler=sampler, num_steps=steps)(2, 0)
    assert got.shape == (2, 3, 8, 8)
    want = np.asarray(want)
    assert np.abs(_nhwc(got) - want).max() <= 1e-5 * np.abs(want).max()


def test_unconditional_calibration_matches_jax():
    """`cond=None`: the reference's tables for a 64-wide UNet2D (every
    resnet conv, 1×1 shortcut, attention projection and resampling conv
    quantizable) from PRNGKey(0) noise over a 3-point trajectory, in fp32
    (the module's dtype; the reference is given it), against the port's
    from the same start, after the key map."""
    jm, params, tm = _pair(WIDE, 8, seed=8)
    schedule = dict(num_train_timesteps=1000)
    shape = (2, 8, 8, 3)
    want = timp.scales_from_jax(jcal.calibrate_unet_scales(
        jm, params, jsched.DiffusionSchedule.create(**schedule), shape,
        key=jax.random.PRNGKey(0), num_steps=3, dtype=jnp.float32))
    init = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32)
    got = tcal.calibrate_unet_scales(
        tm, tsched.DiffusionSchedule.create(**schedule), (2, 3, 8, 8),
        num_steps=3, init=_nchw(init))
    quantizable = {n for n, m in tm.named_modules()
                   if isinstance(m, (QConv2d, QLinear))}
    assert set(got) == set(want) == quantizable
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_static_pixel_sampler_calibrates_without_conditioning(
        tmp_path, monkeypatch):
    """PixelDiffusionSampler(quantize="w8a8_static") on an unconditioned
    UNet2D: calibrated on the unguided trajectory (one cache file under
    the weight fingerprint); a one-step int8 sample differs from the
    full-precision one by about the int8 rounding of one forward (0.6% on
    this model; 2e-2 allowed), never by nothing (int8 ran)."""
    monkeypatch.setenv("POLYP_TORCH_QUANT_CACHE", str(tmp_path))
    _, _, tm = _pair(WIDE, 8, seed=9)
    schedule = tsched.DiffusionSchedule.create(1000)
    q8 = PixelDiffusionSampler(tm, schedule, 8, sampler="ddim", num_steps=1,
                               quantize="w8a8_static")
    assert q8.quant_scales and len(list(tmp_path.iterdir())) == 1
    fp = PixelDiffusionSampler(tm, schedule, 8, sampler="ddim", num_steps=1)
    got, want = q8(2, 0), fp(2, 0)
    assert torch.isfinite(got).all()
    assert 0 < _rel(got.numpy(), want.numpy()) <= 2e-2
