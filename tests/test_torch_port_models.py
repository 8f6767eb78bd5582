"""polyp_tpu_torch models against their polyp_tpu twins on the CPU.

Weights come from the JAX module's `init` and reach the port through
`polyp_tpu_torch.models.importers`; inputs come from numpy seeds, NHWC for
JAX and NCHW for the port. Everything runs in fp32. Tolerance: 1e-3
(absolute and relative) for blocks and the tiny models — the two sides sum
in different orders through several convolutions and normalisations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.models import clip_tokenizer as jtok
from polyp_tpu.models import unet_blocks as jb
from polyp_tpu.models.clip_text import CLIPTextModel as JCLIP
from polyp_tpu.models.clip_text import TINY_TEXT_CONFIG as J_TINY_TEXT
from polyp_tpu.models.unet_condition import tiny_condition_unet as j_tiny_unet
from polyp_tpu.models.vae import tiny_vae as j_tiny_vae
from polyp_tpu_torch.models import clip_tokenizer as ttok
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import unet_blocks as tb
from polyp_tpu_torch.models.clip_text import TINY_TEXT_CONFIG, CLIPTextModel
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.models.vae import tiny_vae

TOL = dict(rtol=1e-3, atol=1e-3)


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturbed(params, seed=0):
    """Init params with every leaf nudged, so zero-init biases and unit
    norm scales are exercised too (a swapped bias would otherwise hide)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape
                                                             ).astype(np.float32),
        params)


def _port(module, jparams):
    module.load_state_dict(timp.unet_from_jax(jparams), strict=True)
    return module.eval()


def _init(module, *args):
    return _perturbed(module.init(jax.random.PRNGKey(0), *args)["params"])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_sinusoidal_time_embedding():
    t = np.array([0, 5, 999], np.int32)
    want = jb.sinusoidal_time_embedding(jnp.asarray(t), 33)
    got = tb.sinusoidal_time_embedding(torch.from_numpy(t), 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_timestep_embedding():
    t = np.array([3, 700], np.int32)
    jm = jb.TimestepEmbedding(32, 128)
    p = _init(jm, jnp.asarray(t))
    got = _port(tb.TimestepEmbedding(32, 128), p)(torch.from_numpy(t))
    want = jm.apply({"params": p}, jnp.asarray(t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cin,cout,temb,eps", [(32, 32, 64, 1e-5),
                                               (32, 64, 64, 1e-5),
                                               (48, 16, None, 1e-6)])
@pytest.mark.parametrize("grad", [False, True])
def test_resnet_block(cin, cout, temb, eps, grad):
    """Also under autograd, where GroupNorm takes the plain version."""
    x = _normal(1, (2, 8, 8, cin))
    te = _normal(2, (2, temb)) if temb else None
    jm = jb.ResnetBlock2D(cout, use_time_emb=temb is not None, eps=eps)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(te),) if temb else ())
    p = _init(jm, *jargs)
    want = jm.apply({"params": p}, *jargs)
    tm = _port(tb.ResnetBlock2D(cin, cout, temb, eps=eps), p)
    with torch.set_grad_enabled(grad):
        got = tm(_nchw(x), None if te is None else torch.from_numpy(te))
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("grad", [False, True])
def test_transformer2d(grad):
    """GN → proj_in → self-attn, cross-attn, GEGLU FF → proj_out; under
    autograd the FF takes the plain GEGLU."""
    x = _normal(3, (2, 4, 4, 64))
    ctx = _normal(4, (2, 7, 32))
    jm = jb.Transformer2D(2, 32, depth=1, cross_attention_dim=32)
    p = _init(jm, jnp.asarray(x), jnp.asarray(ctx))
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx))
    tm = _port(tb.Transformer2D(64, 2, 32, context_dim=32), p)
    with torch.set_grad_enabled(grad):
        got = tm(_nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


def test_vae_spatial_self_attention():
    """Single-head attention with q/k/v biases (the VAE mid block)."""
    x = _normal(5, (1, 4, 4, 32))
    jm = jb.SpatialSelfAttention(num_heads=1, eps=1e-6, qkv_bias=True)
    p = _init(jm, jnp.asarray(x))
    want = jm.apply({"params": p}, jnp.asarray(x))
    tm = _port(tb.SpatialSelfAttention(32, num_heads=1, eps=1e-6,
                                       qkv_bias=True), p)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


def test_downsample_symmetric_padding():
    x = _normal(6, (1, 9, 9, 16))
    jm = jb.Downsample2D(16)
    p = _init(jm, jnp.asarray(x))
    want = jm.apply({"params": p}, jnp.asarray(x))
    got = _port(tb.Downsample2D(16, 16), p)(_nchw(x))
    assert want.shape == (1, 5, 5, 16)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("size,out_size", [(4, None), (4, (7, 7)),
                                           (3, (5, 6))])
def test_upsample_nearest_half_pixel(size, out_size):
    """jax.image.resize 'nearest' uses half-pixel centres: torch's
    'nearest-exact', which differs from 'nearest' off exact 2×."""
    x = _normal(7, (1, size, size, 16))
    jm = jb.Upsample2D(16)
    p = _init(jm, jnp.asarray(x), out_size)
    want = jm.apply({"params": p}, jnp.asarray(x), out_size)
    got = _port(tb.Upsample2D(16, 16), p)(_nchw(x), out_size)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------------

def test_tiny_unet():
    x = _normal(8, (2, 8, 8, 4))
    t = np.array([5, 700], np.int32)
    ctx = _normal(9, (2, 7, 32))
    jm = j_tiny_unet(jnp.float32)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    p = _init(jm, *jargs)
    want = jm.apply({"params": p}, *jargs)
    tm = _port(tiny_condition_unet(), p)
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


def test_tiny_unet_odd_latent_size():
    """Up path resizes to the skip's size (7 → 4 → 7)."""
    x = _normal(10, (1, 7, 7, 4))
    t = np.array([500], np.int32)
    ctx = _normal(11, (1, 5, 32))
    jm = j_tiny_unet(jnp.float32)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    p = _init(jm, *jargs)
    want = jm.apply({"params": p}, *jargs)
    with torch.no_grad():
        got = _port(tiny_condition_unet(), p)(
            _nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


def test_tiny_vae_decode():
    z = _normal(12, (2, 4, 4, 4))
    jm = j_tiny_vae(jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        jax.random.PRNGKey(1))
    p = _perturbed(variables["params"])
    want = jm.apply({"params": p}, jnp.asarray(z), method=jm.decode)
    tm = tiny_vae()
    tm.load_state_dict(timp.vae_from_jax(p), strict=True)
    with torch.no_grad():
        got = tm.decode(_nchw(z))
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)


def test_tiny_clip_text():
    ids = np.random.default_rng(13).integers(0, 512, (2, 16)).astype(np.int32)
    jm = JCLIP(J_TINY_TEXT, dtype=jnp.float32)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    want = jm.apply({"params": p}, jnp.asarray(ids))
    tm = CLIPTextModel(TINY_TEXT_CONFIG)
    tm.load_state_dict(timp.clip_text_from_jax(p), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_models_keep_fp32_islands():
    """Precision placement: GroupNorm affine fp32, LayerNorm fp32, UNet
    conv_out / VAE conv_out / post_quant_conv fp32, the rest bf16; the
    UNet returns fp32."""
    unet = tiny_condition_unet(torch.bfloat16)
    vae = tiny_vae(torch.bfloat16)
    assert unet.conv_out.weight.dtype == torch.float32
    assert unet.conv_in.weight.dtype == torch.bfloat16
    assert unet.conv_norm_out.weight.dtype == torch.float32
    assert vae.post_quant_conv.weight.dtype == torch.float32
    assert vae.decoder.conv_out.weight.dtype == torch.float32
    assert vae.decoder.conv_in.weight.dtype == torch.bfloat16
    with torch.no_grad():
        out = unet(torch.randn(1, 4, 8, 8), torch.tensor([10]),
                   torch.randn(1, 3, 32))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_hash_tokenizer_matches_reference():
    prompts = ["a colonoscopy image of an adenomatous polyp", "",
               "sks   POLYP  hyperplastic"]
    want = jtok.HashTokenizer(vocab_size=512, max_length=16)(prompts)
    got = ttok.HashTokenizer(vocab_size=512, max_length=16)(prompts)
    np.testing.assert_array_equal(got, want)
    assert type(ttok.load_tokenizer(None)).__name__ == "HashTokenizer"
