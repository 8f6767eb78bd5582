"""polyp_tpu_torch's schedule, DDIM + CFG sampler and SD pipeline against
their polyp_tpu twins on the CPU, plus the port's quota/seed contract.

The noise is made with numpy and handed to both packages as `init`: JAX's
threefry and torch's Philox draw different numbers from one seed.
Tolerances are stated per test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.diffusion import samplers as jsamp
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.models.clip_text import CLIPTextModel as JCLIP
from polyp_tpu.models.clip_text import TINY_TEXT_CONFIG as J_TINY_TEXT
from polyp_tpu.models.clip_tokenizer import HashTokenizer as JHashTokenizer
from polyp_tpu.models.unet_condition import tiny_condition_unet as j_tiny_unet
from polyp_tpu.models.vae import tiny_vae as j_tiny_vae
from polyp_tpu.pipeline import StableDiffusionSampler as JSampler
from polyp_tpu_torch.cli.common import load_sd_stack
from polyp_tpu_torch.diffusion import samplers as tsamp
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models.clip_text import TINY_TEXT_CONFIG, CLIPTextModel
from polyp_tpu_torch.models.clip_tokenizer import HashTokenizer
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.models.vae import tiny_vae
from polyp_tpu_torch import pipeline as tpipe

SD_SCHEDULE = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                   beta_start=0.00085, beta_end=0.012)


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,start,end", [
    ("scaled_linear", 0.00085, 0.012), ("linear", 1e-4, 2e-2),
    ("squaredcos_cap_v2", 1e-4, 2e-2)])
def test_schedule_tables_match_float32_reference(kind, start, end):
    """Both sides compute in float32 (JAX runs without x64); they differ
    only in rounding order (linspace, cumprod): rtol 1e-5, atol 1e-6."""
    want = jsched.DiffusionSchedule.create(1000, kind, start, end)
    got = tsched.DiffusionSchedule.create(1000, kind, start, end)
    for field in ("betas", "alphas_cumprod"):
        g = getattr(got, field)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spacing,offset", [("leading", 1), ("leading", 0),
                                            ("linspace", 0), ("trailing", 0)])
@pytest.mark.parametrize("steps", [1, 4, 20, 25, 50])
def test_inference_timesteps_exact(spacing, offset, steps):
    want = jsched.inference_timesteps(1000, steps, spacing, offset)
    assert tsched.inference_timesteps(1000, steps, spacing, offset) == \
        [int(t) for t in np.asarray(want)]


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction", "sample"])
def test_to_x0_eps(pred):
    rng = np.random.default_rng(0)
    out, x = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
              for _ in range(2))
    j = jsched.DiffusionSchedule.create(**SD_SCHEDULE, prediction_type=pred)
    t = tsched.DiffusionSchedule.create(**SD_SCHEDULE, prediction_type=pred)
    want = j.to_x0_eps(jnp.asarray(out), jnp.asarray(x), jnp.int32(321))
    got = t.to_x0_eps(torch.from_numpy(out), torch.from_numpy(x), 321)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# DDIM + CFG and the whole slice on the tiny stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_stacks():
    """The JAX tiny stack (fp32, random init) and the port's twin carrying
    the same weights via importers.*_from_jax."""
    unet, vae = j_tiny_unet(jnp.float32), j_tiny_vae(jnp.float32)
    text = JCLIP(J_TINY_TEXT, dtype=jnp.float32)
    k = jax.random.PRNGKey(0)
    up = unet.init(k, jnp.zeros((1, 4, 4, 4)), jnp.zeros((1,), jnp.int32),
                   jnp.zeros((1, 16, 32)))["params"]
    vp = vae.init(k, jnp.zeros((1, 32, 32, 3)), k)
    tp = text.init(k, jnp.zeros((1, 16), jnp.int32))
    tok = JHashTokenizer(vocab_size=512, max_length=16)

    t_unet = tiny_condition_unet()
    t_unet.load_state_dict(timp.unet_from_jax(up), strict=True)
    t_vae = tiny_vae()
    t_vae.load_state_dict(timp.vae_from_jax(vp), strict=True)
    t_text = CLIPTextModel(TINY_TEXT_CONFIG)
    t_text.load_state_dict(timp.clip_text_from_jax(tp), strict=True)
    return {"jax": (unet, up, vae, vp, text, tp, tok),
            "torch": (t_unet.eval(), t_vae.eval(), t_text.eval(),
                      HashTokenizer(vocab_size=512, max_length=16))}


def _init_latents(seed, batch, size):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 4)).astype(np.float32)


def test_ddim_cfg_with_init_matches_jax(tiny_stacks):
    """3 DDIM steps, CFG 7.5, the tiny UNet: guidance multiplies the
    cond−uncond difference by 7.5, so the tolerance is 2e-3."""
    unet, up, *_ = tiny_stacks["jax"]
    t_unet = tiny_stacks["torch"][0]
    rng = np.random.default_rng(1)
    cond, uncond = (rng.standard_normal((1, 16, 32)).astype(np.float32)
                    for _ in range(2))
    init = _init_latents(2, 2, 8)
    j_fn = jsamp.with_cfg(
        lambda x, t, e: unet.apply({"params": up}, x, t, e),
        jnp.asarray(cond), jnp.asarray(uncond), 7.5)
    want = jsamp.ddim_sample(j_fn, jsched.DiffusionSchedule.create(
        **SD_SCHEDULE), init.shape, jax.random.PRNGKey(0), num_steps=3,
        init=jnp.asarray(init))
    t_fn = tsamp.with_cfg(t_unet, torch.from_numpy(cond),
                          torch.from_numpy(uncond), 7.5)
    got = tsamp.ddim_sample(t_fn, tsched.DiffusionSchedule.create(
        **SD_SCHEDULE), None, num_steps=3,
        init=torch.from_numpy(init.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=2e-3, atol=2e-3)


def test_whole_slice_matches_jax(tiny_stacks):
    """Prompt → tiny CLIP → 2-step DDIM + CFG 7.5 → tiny VAE decode at 32px:
    JAX StableDiffusionSampler._generate_impl vs the port's generate, with
    the same weights and the same initial latents. Tolerance 5e-3 on
    images in [-1, 1] (CFG amplifies rounding, then the VAE decodes)."""
    unet, up, vae, vp, text, tp, tok = tiny_stacks["jax"]
    t_unet, t_vae, t_text, t_tok = tiny_stacks["torch"]
    prompt = "a colonoscopy image of an adenomatous polyp"
    j = JSampler(unet, up, vae, vp, text, tp, tok,
                 jsched.DiffusionSchedule.create(**SD_SCHEDULE),
                 image_size=32, num_steps=2, guidance_scale=7.5,
                 sampler="ddim")
    t = tpipe.StableDiffusionSampler(
        t_unet, t_vae, t_text, t_tok,
        tsched.DiffusionSchedule.create(**SD_SCHEDULE), image_size=32,
        num_steps=2, guidance_scale=7.5, sampler="ddim")
    j_cond, j_uncond = j.encode_prompt(prompt), j.encode_prompt("")
    t_cond, t_uncond = t.encode_prompt(prompt), t.encode_prompt("")
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond),
                               rtol=1e-3, atol=1e-3)
    init = _init_latents(3, 2, 4)
    want = j._generate_impl(up, vp, j_cond, j_uncond, jax.random.PRNGKey(0),
                            2, init=jnp.asarray(init))
    got = t.generate(t_cond, t_uncond, 2,
                     init=torch.from_numpy(init.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(
        tpipe.to_uint8(got).shape, (2, 32, 32, 3))


def test_unported_samplers_refuse_naming_the_roadmap():
    """All four of the reference's samplers are ported, so what is refused
    now is a name neither package knows, in `sample` and in
    StableDiffusionSampler before any work; the message lists the four."""
    sched = tsched.DiffusionSchedule.create(**SD_SCHEDULE)
    assert "euler" not in jsamp.SAMPLERS
    with pytest.raises(ValueError, match="unknown sampler 'euler'.*dpmpp_2m"):
        tsamp.sample("euler", lambda x, t: x, sched, (1, 4, 2, 2),
                     torch.Generator().manual_seed(0), 2)
    with pytest.raises(ValueError, match="unknown sampler 'euler'"):
        tpipe.StableDiffusionSampler(tiny_condition_unet(), tiny_vae(), None,
                                     None, sched, sampler="euler")


# ---------------------------------------------------------------------------
# UniPC, the reference's and the port's default sampler
# ---------------------------------------------------------------------------

def _toy_eps(seed):
    """A numpy-seeded elementwise ε-model, written once for each framework:
    eps = a·tanh(b·x + c·t/1000) + d·x with per-channel a, b, c, d. It is
    elementwise, so the same arrays are NCHW for the port and anything for
    JAX."""
    rng = np.random.default_rng(seed)
    a, b, c, d = (rng.uniform(0.2, 1.0, (1, 4, 1, 1)).astype(np.float32)
                  for _ in range(4))

    def j_fn(x, t):
        tt = t.astype(jnp.float32).reshape(-1, 1, 1, 1) / 1000.0
        return jnp.asarray(a) * jnp.tanh(jnp.asarray(b) * x
                                         + jnp.asarray(c) * tt) \
            + jnp.asarray(d) * x

    def t_fn(x, t):
        tt = t.float().reshape(-1, 1, 1, 1) / 1000.0
        return torch.from_numpy(a) * torch.tanh(torch.from_numpy(b) * x
                                                + torch.from_numpy(c) * tt) \
            + torch.from_numpy(d) * x

    return j_fn, t_fn


def _unipc_pair(steps, segments, **kw):
    """The same start through polyp_tpu's unipc_sample and the port's:
    `segments` None for one model, else a list of (steps, toy seed)."""
    init = np.random.default_rng(7).standard_normal((2, 4, 8, 8)
                                                    ).astype(np.float32)
    if segments is None:
        j_fn, t_fn = _toy_eps(0)
    else:
        pairs = [(n, _toy_eps(seed)) for n, seed in segments]
        j_fn = [(n, f[0]) for n, f in pairs]
        t_fn = [(n, f[1]) for n, f in pairs]
    want = jsamp.sample("unipc", j_fn,
                        jsched.DiffusionSchedule.create(**SD_SCHEDULE),
                        init.shape, jax.random.PRNGKey(0), steps,
                        init=jnp.asarray(init), **kw)
    got = tsamp.sample("unipc", t_fn,
                       tsched.DiffusionSchedule.create(**SD_SCHEDULE),
                       init.shape, None, steps, init=torch.from_numpy(init),
                       **kw)
    return got, np.asarray(want)


# The same operations in fp32 on both sides, in another order (the
# reference evaluates every branch under jnp.where and XLA fuses the
# elementwise chain; the port takes its branch and computes the step
# coefficients as scalars): max |Δ| <= 1e-5 · max |x|. A wrong coefficient,
# order or branch gives O(1e-2) or more.
@pytest.mark.parametrize("steps", [1, 2, 3, 25])
@pytest.mark.parametrize("use_corrector", [True, False])
def test_unipc_matches_jax(steps, use_corrector):
    got, want = _unipc_pair(steps, None, use_corrector=use_corrector)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_unipc_segments_match_jax():
    """A two-segment list (a different model for the last 3 of 7 steps),
    the step index continuing across the segments as in the reference."""
    got, want = _unipc_pair(7, [(4, 0), (3, 1)])
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    one, _ = _unipc_pair(7, [(4, 0), (3, 0)])
    alone, _ = _unipc_pair(7, None)
    assert torch.equal(one, alone)  # segments of one fn == one loop


def test_unipc_visits_the_reference_timesteps():
    seen = []

    def spy(x, t):
        seen.append(int(t[0]))
        return torch.zeros_like(x)

    tsamp.unipc_sample(spy, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
                       (1, 4, 2, 2), torch.Generator().manual_seed(0),
                       num_steps=5)
    want = jsamp.sampler_timesteps("unipc", 1000, 5)
    assert seen == [int(t) for t in np.asarray(want)] == \
        tsamp.sampler_timesteps("unipc", 1000, 5)
    with pytest.raises(ValueError, match="generator or init"):
        tsamp.unipc_sample(spy, tsched.DiffusionSchedule.create(
            **SD_SCHEDULE), (1, 4, 2, 2), None, num_steps=2)


def test_default_sampler_matches_jax_defaults(tiny_stacks):
    """Both StableDiffusionSamplers at their defaults (UniPC, 25 steps, CFG
    7.5, 256px) over the same carried weights and the same numpy latents:
    the reference's _generate_impl vs the port's generate. Tolerance 5e-3
    on images in [-1, 1], as the DDIM slice (CFG amplifies fp32 rounding,
    then the VAE decodes)."""
    unet, up, vae, vp, text, tp, tok = tiny_stacks["jax"]
    t_unet, t_vae, t_text, t_tok = tiny_stacks["torch"]
    prompt = "a colonoscopy image of an adenomatous polyp"
    j = JSampler(unet, up, vae, vp, text, tp, tok,
                 jsched.DiffusionSchedule.create(**SD_SCHEDULE))
    t = tpipe.StableDiffusionSampler(
        t_unet, t_vae, t_text, t_tok,
        tsched.DiffusionSchedule.create(**SD_SCHEDULE))
    assert t.sampler == j.sampler == "unipc"
    assert (t.num_steps, t.guidance_scale, t.image_size) == \
        (j.num_steps, j.guidance_scale, j.image_size)
    init = _init_latents(4, 1, 32)
    want = j._generate_impl(up, vp, j.encode_prompt(prompt),
                            j.encode_prompt(""), jax.random.PRNGKey(0), 1,
                            init=jnp.asarray(init))
    got = t.generate(t.encode_prompt(prompt), t.encode_prompt(""), 1,
                     init=torch.from_numpy(init.transpose(0, 3, 1, 2).copy()))
    assert got.shape == (1, 3, 256, 256)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# quota loop, seeds, uint8, stack loading
# ---------------------------------------------------------------------------

def _stub_sampler(batch_size, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(batch_size, 3, 8, 8, generator=g) * 2 - 1


def test_to_uint8_matches_reference():
    from polyp_tpu.pipeline import to_uint8 as j_to_uint8

    imgs = torch.linspace(-1.2, 1.2, 2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    want = j_to_uint8(jnp.asarray(imgs.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(tpipe.to_uint8(imgs), want)


def test_generate_to_dir_names_and_seeds(tmp_path):
    seen = []

    def spy(bs, seed):
        seen.append((bs, seed))
        return _stub_sampler(bs, seed)

    assert tpipe.generate_to_dir(spy, 5, tmp_path, eval_batch_size=2,
                                 seed=10) == 5
    assert seen == [(2, 10), (2, 11), (1, 12)]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [f"{i}.png" for i in range(1, 6)]


def test_top_up_regenerates_identical_batches(tmp_path):
    from PIL import Image

    full = tmp_path / "full"
    tpipe.generate_to_dir(_stub_sampler, 6, full, eval_batch_size=2, seed=3)
    part = tmp_path / "part"
    tpipe.generate_to_dir(_stub_sampler, 3, part, eval_batch_size=2, seed=3)
    (part / "3.png").unlink()  # an interrupted batch
    assert tpipe.top_up_samples(_stub_sampler, 6, part, 2, 3) == 4
    for i in range(1, 7):
        a = np.asarray(Image.open(full / f"{i}.png"))
        b = np.asarray(Image.open(part / f"{i}.png"))
        np.testing.assert_array_equal(a, b)
    assert tpipe.top_up_samples(_stub_sampler, 6, part, 2, 3) == 0


def test_load_sd_stack_tiny_is_seeded_and_samples(tmp_path):
    a = load_sd_stack(None, dtype=torch.float32, tiny=True, device="cpu",
                      seed=0)
    b = load_sd_stack(None, dtype=torch.float32, tiny=True, device="cpu",
                      seed=0)
    c = load_sd_stack(None, dtype=torch.float32, tiny=True, device="cpu",
                      seed=1)
    for key, val in a.unet.state_dict().items():
        assert torch.equal(val, b.unet.state_dict()[key]), key
    assert not torch.equal(a.unet.conv_in.weight, c.unet.conv_in.weight)
    sampler = tpipe.StableDiffusionSampler(
        a.unet, a.vae, a.text, a.tokenizer,
        tsched.DiffusionSchedule.create(**SD_SCHEDULE), image_size=16,
        num_steps=2, sampler="ddim")
    fn = sampler.for_prompt("a polyp")
    first, again = fn(2, 7), fn(2, 7)
    assert first.shape == (2, 3, 16, 16) and torch.isfinite(first).all()
    assert torch.equal(first, again)  # batch i uses seed + i: reproducible
    assert not torch.equal(first, fn(2, 8))
    with pytest.raises(FileNotFoundError):  # a directory with no weights
        load_sd_stack(str(tmp_path), tiny=True, device="cpu")
