"""The LoRA trainer's input side in polyp_tpu_torch against polyp_tpu on
the CPU: the VAE encoder and its posterior, the forward process, the
losses, the batch augmentation and the Loader.

Weights come from the JAX module's `init` (every leaf nudged, so zero
biases and unit scales are exercised) and reach the port through
`polyp_tpu_torch.models.importers`; inputs come from numpy seeds, NHWC for
JAX and NCHW for the port; random draws are JAX's, handed to the port
(whose functions take their draws as arguments). Everything runs in fp32.
Tolerances are stated with each test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.data import pipeline as jpipe
from polyp_tpu.data import transforms as jtf
from polyp_tpu.diffusion import losses as jloss
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.models import vae as jvae
from polyp_tpu_torch.data import pipeline as tpipe
from polyp_tpu_torch.data import transforms as ttf
from polyp_tpu_torch.diffusion import losses as tloss
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import vae as tvae
from test_torch_port_models import _nchw, _normal, _perturbed, _to_nhwc
from _torch_threads import _one_thread  # noqa: F401


SD_SCHEDULE = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                   beta_start=0.00085, beta_end=0.012)


def _j(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def tiny_vaes():
    jm = jvae.tiny_vae(jnp.float32)
    k = jax.random.PRNGKey(0)
    params = _perturbed(jm.init(k, jnp.zeros((1, 32, 32, 3)), k)["params"])
    tm = tvae.tiny_vae()
    tm.load_state_dict(timp.vae_from_jax(params), strict=True)
    return jm, params, tm.eval()


# a chain of ~12 convolutions and normalisations summed in another order:
# 1e-4 of the moments' scale (O(1)); a wrong padding, layout or key gives
# O(1e-1) (the negative control below)
ENC_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grad", [False, True])
def test_encoder_moments_match_jax(tiny_vaes, grad):
    """The whole encode (encoder + quant_conv), with autograd off (the
    GroupNorm kernel's wrapper, its plain version on the CPU) and on."""
    jm, params, tm = tiny_vaes
    x = _normal(21, (2, 32, 32, 3))
    want = jm.apply({"params": params}, jnp.asarray(x),
                    method=jm.encode_moments)
    with torch.set_grad_enabled(grad):
        got = tm.encode_moments(_nchw(x))
    assert got.shape == (2, 8, 4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(_to_nhwc(got), _j(want), **ENC_TOL)


def test_symmetric_downsample_padding_fails_the_encoder(tiny_vaes):
    """Negative control: the UNet's symmetric padding in the encoder's
    downsamplers moves the moments by O(1e-1), far outside ENC_TOL."""
    jm, params, tm = tiny_vaes
    x = _normal(22, (2, 32, 32, 3))
    want = _j(jm.apply({"params": params}, jnp.asarray(x),
                       method=jm.encode_moments))
    sym = tvae.tiny_vae()
    sym.load_state_dict(tm.state_dict())
    for block in sym.encoder.down_blocks:
        if block.downsamplers is not None:
            down = block.downsamplers[0]
            down.asymmetric = False
            down.conv.padding = (1, 1)
    with torch.no_grad():
        got = _to_nhwc(sym.encode_moments(_nchw(x)))
    assert np.abs(got - want).max() > 100 * ENC_TOL["atol"]


def test_diagonal_gaussian_matches_jax():
    """Split on channels, logvar clipped to [-30, 20] (moments reach ±50
    here), sample = mean + std · (JAX's draw), and the KL; 1e-6 relative:
    the same elementwise fp32 operations."""
    moments = _normal(23, (2, 4, 4, 8), scale=20.0)
    key = jax.random.PRNGKey(3)
    jg = jvae.DiagonalGaussian(jnp.asarray(moments))
    tg = tvae.DiagonalGaussian(_nchw(moments))
    noise = jax.random.normal(key, jg.mean.shape, jg.mean.dtype)
    np.testing.assert_allclose(_to_nhwc(tg.logvar), _j(jg.logvar))
    assert tg.logvar.min() == -30.0 and tg.logvar.max() == 20.0
    np.testing.assert_allclose(_to_nhwc(tg.sample(_nchw(_j(noise)))),
                               _j(jg.sample(key)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.kl().numpy(), _j(jg.kl()), rtol=1e-6)


@pytest.mark.parametrize("prediction", ["epsilon", "v_prediction",
                                        "sample"])
def test_forward_process_and_mse_match_jax(prediction):
    """add_noise, velocity and the ε-MSE for each prediction type, per
    sample timesteps 0..999 (incl. both ends); 1e-6 relative: the same fp32
    tables and elementwise operations."""
    js = jsched.DiffusionSchedule.create(**SD_SCHEDULE,
                                         prediction_type=prediction)
    ts = tsched.DiffusionSchedule.create(**SD_SCHEDULE,
                                         prediction_type=prediction)
    x0, noise = _normal(24, (4, 4, 4, 4)), _normal(25, (4, 4, 4, 4))
    out = _normal(26, (4, 4, 4, 4))
    t = np.array([0, 1, 500, 999], np.int32)
    args_j = (jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    args_t = (_nchw(x0), _nchw(noise), _t(t).long())
    np.testing.assert_allclose(_to_nhwc(ts.add_noise(*args_t)),
                               _j(js.add_noise(*args_j)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_to_nhwc(ts.velocity(*args_t)),
                               _j(js.velocity(*args_j)), rtol=1e-6,
                               atol=1e-6)
    want = jloss.epsilon_mse_loss(js, jnp.asarray(out), *args_j)
    got = tloss.epsilon_mse_loss(ts, _nchw(out), *args_t)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_visual_influence_loss_matches_jax():
    """1 − cos(pooled text, Linear(4→768) of the pooled latent), latents
    NCHW in the port; 1e-6 relative."""
    hidden = _normal(27, (3, 77, 768))
    latents = _normal(28, (3, 8, 8, 4))
    kernel, bias = _normal(29, (4, 768), 0.5), _normal(30, (768,), 0.1)
    want = jloss.visual_influence_loss(jnp.asarray(hidden),
                                       jnp.asarray(latents),
                                       jnp.asarray(kernel), jnp.asarray(bias))
    got = tloss.visual_influence_loss(_t(hidden), _nchw(latents), _t(kernel),
                                      _t(bias))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_augment_diffusion_batch_matches_jax():
    """uint8 NHWC → fp32 NCHW in [-1, 1], flipped where JAX's key flips
    (the mask drawn as polyp_tpu's random_hflip draws it); to one fp32 ulp
    of 1 (XLA fuses the two divisions into other roundings)."""
    images = np.random.default_rng(31).integers(0, 256, (8, 6, 5, 3),
                                                dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    flip = _j(jax.random.bernoulli(key, 0.5, (8,)))
    assert 0 < flip.sum() < 8
    want = _j(jtf.augment_diffusion_batch(jnp.asarray(images), key))
    got = ttf.augment_diffusion_batch(_t(images), _t(flip))
    assert got.dtype == torch.float32 and got.shape == (8, 3, 6, 5)
    np.testing.assert_allclose(_to_nhwc(got), want, rtol=0, atol=2 ** -23)
    assert got.min() >= -1.0 and got.max() <= 1.0
    plain = _j(jtf.augment_diffusion_batch(jnp.asarray(images), key,
                                           train=False))
    np.testing.assert_allclose(
        _to_nhwc(ttf.augment_diffusion_batch(_t(images))), plain, rtol=0,
        atol=2 ** -23)


@pytest.mark.parametrize("drop_last,weighted", [(False, False),
                                                (True, False),
                                                (False, True)])
def test_loader_batches_match_jax(drop_last, weighted):
    """The same seed gives the same batches as polyp_tpu's Loader for 3
    epochs (padded tail and its `valid` mask included), and again after
    `skip_epochs(2)`; exact."""
    rng = np.random.default_rng(32)
    images = rng.integers(0, 256, (11, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, 11)
    weights = rng.random(11) + 0.1 if weighted else None
    kw = dict(seed=5, drop_last=drop_last, weights=weights)
    jl = jpipe.Loader(images, labels, 4, **kw)
    tl = tpipe.Loader(images, labels, 4, device="cpu", **kw)
    assert len(tl) == len(jl)
    for _ in range(3):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl)
        for j, t in zip(jb, tb):
            for a, b in zip(j, t):
                np.testing.assert_array_equal(b.numpy(), _j(a))
    jl2 = jpipe.Loader(images, labels, 4, **kw)
    tl2 = tpipe.Loader(images, labels, 4, device="cpu", **kw)
    jl2.skip_epochs(2)
    tl2.skip_epochs(2)
    for j, t in zip(list(jl2), list(tl2)):
        np.testing.assert_array_equal(t[0].numpy(), _j(j[0]))
        np.testing.assert_array_equal(t[2].numpy(), _j(j[2]))


def test_loader_pads_the_tail_by_wrapping():
    images = np.arange(5, dtype=np.uint8).reshape(5, 1, 1, 1)
    tl = tpipe.Loader(images, np.arange(5), 4, shuffle=False, device="cpu")
    batches = list(tl)
    assert [b[2].tolist() for b in batches] == [[True] * 4,
                                               [True, False, False, False]]
    assert batches[1][1].tolist() == [4, 0, 1, 2]
    assert batches[0][0].dtype == torch.uint8
