"""polyp_tpu_torch's distilled few-step path against its polyp_tpu twins on
the CPU: the trailing DDIM grid with folded guidance, the distillation
grids, the tiny decoder (module, weight carrier, the committed converted
weights) and the whole slice through StableDiffusionSampler; plus the
entry points' device default.

Inputs and weights are made with numpy from a seed and handed to both
packages (JAX's threefry and torch's Philox draw different numbers).
Everything runs in fp32; tolerances are stated per test.
"""

from __future__ import annotations

import json
from pathlib import Path

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
from polyp_tpu.models.tiny_decoder import TinyDecoder as JTinyDecoder
from polyp_tpu.models.tiny_decoder import load_tiny_decoder as j_load_tiny
from polyp_tpu.models.unet_condition import tiny_condition_unet as j_tiny_unet
from polyp_tpu.models.vae import tiny_vae as j_tiny_vae
from polyp_tpu.pipeline import StableDiffusionSampler as JSampler
from polyp_tpu.train import distill as jdistill
from polyp_tpu_torch.cli import common as tcommon
from polyp_tpu_torch.cli.distill_sd import make_student_sampler
from polyp_tpu_torch.diffusion import samplers as tsamp
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import tiny_decoder as ttd
from polyp_tpu_torch.models.clip_text import TINY_TEXT_CONFIG, CLIPTextModel
from polyp_tpu_torch.models.clip_tokenizer import HashTokenizer
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.models.vae import tiny_vae
from polyp_tpu_torch.train import distill as tdistill
from test_torch_port_fused_mha import numpy_params
from _torch_threads import _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
SD_SCHEDULE = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                   beta_start=0.00085, beta_end=0.012)
TRAILING = {"spacing": "trailing", "steps_offset": 0}


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def unets():
    """The JAX tiny UNet with numpy-filled params and the port's twin."""
    unet = j_tiny_unet(jnp.float32)
    params = numpy_params(jax.eval_shape(
        unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 32)))["params"],
        seed=11)
    t_unet = tiny_condition_unet().eval()
    t_unet.load_state_dict(timp.unet_from_jax(params), strict=True)
    return unet, params, t_unet


# ---------------------------------------------------------------------------
# sampler: trailing grid, folded guidance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_trailing_ddim_with_folded_guidance_matches_jax(unets, pred):
    """4 trailing DDIM steps (steps_offset 0), cond-only forwards at 1×
    batch, the same init: 1e-4 absolute on latents of O(1)."""
    unet, params, t_unet = unets
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((1, 16, 32)).astype(np.float32)
    init = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    j_fn = jsamp.with_cfg(
        lambda x, t, e: unet.apply({"params": params}, x, t, e),
        jnp.asarray(cond), None, None)
    want = jsamp.ddim_sample(
        j_fn, jsched.DiffusionSchedule.create(**SD_SCHEDULE,
                                              prediction_type=pred),
        init.shape, jax.random.PRNGKey(0), num_steps=4,
        init=jnp.asarray(init), **TRAILING)
    seen = []

    def raw(x, t, emb):
        seen.append((x.shape[0], emb.shape[0], int(t[0])))
        return t_unet(x, t, emb)

    t_fn = tsamp.with_cfg(raw, torch.from_numpy(cond), None, None)
    got = tsamp.ddim_sample(
        t_fn, tsched.DiffusionSchedule.create(**SD_SCHEDULE,
                                              prediction_type=pred),
        None, num_steps=4, init=_nchw(init), **TRAILING)
    assert seen == [(2, 2, t) for t in (999, 749, 499, 249)]
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# distillation grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 5, 25])
@pytest.mark.parametrize("alpha_to_one", [False, True])
def test_distill_grid_matches_jax(n, alpha_to_one):
    """Timesteps exactly; ᾱ tables to 1e-6 (both float32, from tables that
    agree to that, test_torch_port_pipeline)."""
    want = jdistill.distill_grid(jsched.DiffusionSchedule.create(
        **SD_SCHEDULE), n, alpha_to_one)
    got = tdistill.distill_grid(tsched.DiffusionSchedule.create(
        **SD_SCHEDULE), n, alpha_to_one)
    assert got.num_steps == want.num_steps == n
    for name in ("ts", "ts_mid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("abar_t", "abar_mid", "abar_next"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6)
    # the nesting invariant: the student grid is the even elements of the
    # 2N trailing grid, the midpoints its odd ones
    ts_2 = tsched.inference_timesteps(1000, 2 * n, "trailing")
    assert got.ts.tolist() == ts_2[0::2]
    assert got.ts_mid.tolist() == ts_2[1::2]


# T = 1000: 8 steps sample fine on the trailing grid but cannot be
# distilled from 16 (1000 % 16 != 0)
@pytest.mark.parametrize("n", [3, 0, 8])
def test_distill_grid_refuses_grids_that_do_not_nest(n):
    sched = tsched.DiffusionSchedule.create(**SD_SCHEDULE)
    with pytest.raises(ValueError, match="T % \\(2\\*N\\)"):
        tdistill.distill_grid(sched, n)
    with pytest.raises(ValueError, match="T % \\(2\\*N\\)"):
        jdistill.distill_grid(jsched.DiffusionSchedule.create(
            **SD_SCHEDULE), n)


def test_ddim_transition_matches_jax():
    """Per-sample ᾱ′ broadcast over NCHW / NHWC: 1e-6 absolute."""
    rng = np.random.default_rng(2)
    x0, eps = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
               for _ in range(2))
    abar = np.array([0.05, 0.5, 0.999], np.float32)
    want = jdistill.ddim_transition(jnp.asarray(x0), jnp.asarray(eps),
                                    jnp.asarray(abar))
    got = tdistill.ddim_transition(_nchw(x0), _nchw(eps),
                                   torch.from_numpy(abar))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# tiny decoder
# ---------------------------------------------------------------------------

def test_tiny_decoder_matches_flax_module():
    """Weights through importers.tiny_decoder_from_jax into the port's
    TinyDecoder; a 4×4 latent (so nearest ×2 three times and "SAME"
    padding at every size are pinned), fp32 both sides: 1e-5 absolute on
    outputs of O(1). Latent outliers pass the tanh bound on both sides."""
    dec = JTinyDecoder(base_channels=8, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((2, 4, 4, 4)) * 3).astype(np.float32)
    z[0, 0, 0, 0] = 1e4
    params = numpy_params(jax.eval_shape(
        dec.init, jax.random.PRNGKey(0), jnp.asarray(z))["params"], seed=4)
    want = dec.apply({"params": params}, jnp.asarray(z))
    t_dec = ttd.TinyDecoder(base_channels=8, dtype=torch.float32).eval()
    t_dec.load_state_dict(timp.tiny_decoder_from_jax(params), strict=True)
    with torch.no_grad():
        got = t_dec(_nchw(z))
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def committed_decoder():
    """polyp_tpu's own loader on the committed orbax artifact."""
    return j_load_tiny(ROOT / "models" / "tiny_decoder", dtype=jnp.float32)


def test_committed_npz_is_the_orbax_artifact_bit_for_bit(committed_decoder):
    _, params, meta = committed_decoder
    want = timp.tiny_decoder_from_jax(jax.device_get(params))
    port_dir = ROOT / "polyp_tpu_torch" / "weights" / "tiny_decoder"
    with np.load(port_dir / "params.npz") as npz:
        assert sorted(npz.files) == sorted(want)
        for key, val in want.items():
            got = npz[key]
            assert got.dtype == np.float32, key
            np.testing.assert_array_equal(got, val.numpy(), err_msg=key)
    assert json.loads((port_dir / "meta.json").read_text()) == meta


def test_load_tiny_decoder_warns_and_decodes_like_jax(committed_decoder):
    """The port's loader on the converted artifact warns that it was
    distilled on synthetic latents, and decodes like the reference's
    module on the orbax weights: fp32, 1e-4 absolute."""
    module, params, _ = committed_decoder
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        t_dec, meta = ttd.load_tiny_decoder(dtype=torch.float32,
                                            device="cpu")
    assert meta["latent_source"] == "synthetic"
    z = np.random.default_rng(5).standard_normal((1, 4, 4, 4)).astype(
        np.float32)
    want = module.apply({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        got = t_dec(_nchw(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def test_distilled_slice_matches_jax_sampler(unets):
    """Prompt → tiny CLIP → 2 trailing DDIM steps with folded guidance →
    tiny decoder at 32px: JAX StableDiffusionSampler(guidance_scale=None,
    sampler_kwargs=trailing, decoder=...) vs the port's
    make_student_sampler, same weights, same init. 1e-4 absolute on images
    in about [-1, 1]."""
    unet, up, t_unet = unets
    text = JCLIP(J_TINY_TEXT, dtype=jnp.float32)
    tp = {"params": numpy_params(jax.eval_shape(
        text.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16), jnp.int32))["params"], seed=12)}
    vae = j_tiny_vae(jnp.float32)
    vp = numpy_params(jax.eval_shape(
        vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jax.random.PRNGKey(1)), seed=13)
    dec = JTinyDecoder(base_channels=8, dtype=jnp.float32)
    dp = numpy_params(jax.eval_shape(
        dec.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)))["params"],
        seed=14)
    prompt = "a colonoscopy image of an adenomatous polyp"
    j = JSampler(unet, up, vae, vp, text, tp,
                 JHashTokenizer(vocab_size=512, max_length=16),
                 jsched.DiffusionSchedule.create(**SD_SCHEDULE),
                 image_size=32, num_steps=2, guidance_scale=None,
                 sampler="ddim", sampler_kwargs=TRAILING,
                 decoder=(dec, dp))

    t_text = CLIPTextModel(TINY_TEXT_CONFIG).eval()
    t_text.load_state_dict(timp.clip_text_from_jax(tp), strict=True)
    t_dec = ttd.TinyDecoder(base_channels=8, dtype=torch.float32).eval()
    t_dec.load_state_dict(timp.tiny_decoder_from_jax(dp), strict=True)
    stack = tcommon.SDStack(t_unet, tiny_vae(), t_text,
                            HashTokenizer(vocab_size=512, max_length=16))
    t = make_student_sampler(stack, t_unet, num_steps=2, image_size=32,
                             decoder=t_dec)
    assert t.guidance_scale is None and t.sampler_kwargs == TRAILING

    j_cond, j_uncond = j.encode_prompt(prompt), j.encode_prompt("")
    t_cond = t.encode_prompt(prompt)
    init = np.random.default_rng(6).standard_normal(
        (2, 4, 4, 4)).astype(np.float32)
    want = j._generate_impl(up, j.decode_params, j_cond, j_uncond,
                            jax.random.PRNGKey(0), 2, init=jnp.asarray(init))
    got = t.generate(t_cond, None, 2, init=_nchw(init))
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-4)

    # a registered embedding stands in for the prompt's encoding
    t.register_prompt_embedding("<sks> polyp", t_cond.numpy())
    assert torch.equal(t.encode_prompt("<sks> polyp"), t_cond)


def test_folded_calibration_is_cached_apart_from_cfg(unets, tmp_path,
                                                     monkeypatch):
    """w8a8_static on a folded sampler calibrates the cond-only trajectory
    (no uncond branch) and caches it under another fingerprint than a CFG
    sampler of the same weights, and another than a sampler with fewer
    calibration points."""
    monkeypatch.setenv("POLYP_TORCH_QUANT_CACHE", str(tmp_path))
    t_unet = unets[2]
    cond = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 16, 32)).astype(np.float32))
    sched = tsched.DiffusionSchedule.create(**SD_SCHEDULE)
    stack = tcommon.SDStack(t_unet, tiny_vae(), None, None)
    for steps in (4, 2):
        s = make_student_sampler(stack, t_unet, num_steps=steps,
                                 image_size=32, quantize="w8a8_static")
        s._ensure_calibrated(cond, None)
        assert s.quant_scales is not None
    from polyp_tpu_torch.pipeline import StableDiffusionSampler
    cfg = StableDiffusionSampler(t_unet, tiny_vae(), None, None, sched,
                                 image_size=32, num_steps=4,
                                 guidance_scale=7.5, quantize="w8a8_static")
    cfg._ensure_calibrated(cond, cond)
    assert len(list(tmp_path.glob("quant_scales_*.json"))) == 3


# ---------------------------------------------------------------------------
# entry points run on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcommon.load_sd_stack(None, dtype=torch.float32, tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttd.load_tiny_decoder()
    stack = tcommon.load_sd_stack(None, dtype=torch.float32, tiny=True,
                                  device="cpu")
    assert next(stack.unet.parameters()).device.type == "cpu"
