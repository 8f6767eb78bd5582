"""polyp_tpu_torch's int8 (W8A8) path against polyp_tpu's on the CPU.

Op level: each kernel's plain version (what a CPU tensor runs) against the
JAX kernel run as the JAX package's tests run it, under a patched
`pl.pallas_call(interpret=True)`, or against the JAX function it mirrors.
Model level: a small conditional UNet whose attention levels are 64 and 128
wide (`MIN_QUANT_CHANNELS` = 64 leaves the repo's tiny UNet almost
unquantized), with weights carried by importers.unet_from_jax and scales by
importers.scales_from_jax, under w8a8_static (JAX with POLYP_GN_Q8=1, its
producer-side handoff) and dynamic w8a8 (JAX with POLYP_GEGLU_PT=1 and the
per-token kernel's TPU gate patched open). Everything is fp32; inputs come
from numpy seeds. Each test states its tolerance.

int8 codes are exact integers on both sides, so wherever both sides
quantize the same fp32 values the results agree to fp32 rounding. Where a
quantized value is computed (h of the GEGLU, a whole network's
activations), the two frameworks' last-bit differences can move a value
across a rounding boundary and flip one code; those tests bound the share
of flipped codes or the relative L2 the flips cause.
"""

from __future__ import annotations

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from polyp_tpu.diffusion import calibrate as jcal
from polyp_tpu.diffusion import schedule as jsched
from polyp_tpu.models.unet_condition import UNet2DCondition as JUNet
from polyp_tpu.models.vae import tiny_vae as j_tiny_vae
from polyp_tpu.ops import dispatch as jdispatch
from polyp_tpu.ops import fused_dense as jfd
from polyp_tpu.ops import fused_geglu as jfg
from polyp_tpu.ops import fused_gn as jgn
from polyp_tpu.ops import quant as jq
from polyp_tpu.pipeline import StableDiffusionSampler as JSampler
from polyp_tpu.pipeline import _precision_split as j_precision_split
from polyp_tpu_torch import pipeline as tpipe
from polyp_tpu_torch.diffusion import calibrate as tcal
from polyp_tpu_torch.diffusion import samplers as tsamp
from polyp_tpu_torch.diffusion import schedule as tsched
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import unet_blocks as tb
from polyp_tpu_torch.models.unet_condition import UNet2DCondition as TUNet
from polyp_tpu_torch.models.vae import tiny_vae
from polyp_tpu_torch.ops import fused_dense as tfd
from polyp_tpu_torch.ops import fused_geglu as tfg
from polyp_tpu_torch.ops import fused_gn as tgn
from polyp_tpu_torch.ops import quant as tq
from _torch_threads import _one_thread  # noqa: F401


SD_SCHEDULE = dict(num_train_timesteps=1000, beta_schedule="scaled_linear",
                   beta_start=0.00085, beta_end=0.012)
# attention levels 64 and 128 wide: every resnet conv, 1×1 projection,
# attention projection and FF is quantizable
QUANT_UNET = dict(in_channels=4, out_channels=4, block_out_channels=(64, 128),
                  layers_per_block=1, cross_attention_dim=64,
                  attention_num_heads=2,
                  down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                  up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))

interpret = mock.patch.object(
    pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _scale(a, margin=1.05):
    """A calibrated-style static scale: amax · margin / 127, as fp32."""
    return np.float32(np.abs(a).max() * margin / 127.0)


# ---------------------------------------------------------------------------
# quantize, w8a8_dense, w8a8_conv (ops/quant.py)
# ---------------------------------------------------------------------------

def test_quantize_weight_matches_jax_exactly():
    dense = _normal(0, (96, 80), 0.1)               # JAX [in, out]
    conv = _normal(1, (3, 3, 64, 72), 0.05)         # JAX HWIO
    wq, sw = jq.quantize_weight(jnp.asarray(dense), (0,))
    got_q, got_s = tq.quantize_weight(_t(dense.T), (1,))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(got_s.numpy()[:, 0], np.asarray(sw)[0])
    wq, sw = jq.quantize_weight(jnp.asarray(conv), (0, 1, 2))
    got_q, got_s = tq.quantize_weight(_t(conv.transpose(3, 2, 0, 1)),
                                      (1, 2, 3))
    np.testing.assert_array_equal(got_q.numpy(),
                                  np.asarray(wq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got_s.numpy().reshape(-1),
                                  np.asarray(sw).reshape(-1))


@pytest.mark.parametrize("static", [True, False])
def test_quantize_activation_matches_jax_exactly(static):
    x = _normal(2, (4, 33), 3.0)
    x[0, :4] = [0.5, 1.5, -2.5, 2.5]  # exact halves: round half to even
    s = np.float32(1.0) if static else None
    want, want_s = jq._quantize_activation(
        jnp.asarray(x), None if s is None else jnp.float32(s))
    got, got_s = tq.quantize_activation(
        _t(x), None if s is None else torch.tensor(s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got_s) == float(want_s)


@pytest.mark.parametrize("static", [True, False])
def test_w8a8_dense_matches_jax(static):
    """Same int8 codes and int32 sums; the dequantize is the same fp32
    product: rtol 1e-6."""
    x, w = _normal(3, (2, 50, 96)), _normal(4, (96, 72), 0.1)
    s = _scale(x) if static else None
    want = jq.w8a8_dense(jnp.asarray(x), jnp.asarray(w), jnp.float32,
                         None if s is None else jnp.float32(s))
    got = tq.w8a8_dense(_t(x), _t(w.T), torch.float32,
                        None if s is None else torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k,stride,pad,int8_in", [
    (3, 1, 1, False), (3, 2, 1, False), (3, 1, 1, True), (1, 1, 0, False),
    (3, 2, 1, True)])
def test_w8a8_conv_matches_jax(k, stride, pad, int8_in):
    """3×3 SAME, the Downsample's stride 2 with symmetric padding, the
    pre-quantized int8 input of the GroupNorm handoff, and 1×1: the patch
    matrix and `_int_mm` give lax.conv's int32 sums. rtol 1e-6."""
    x = _normal(5, (2, 9, 7, 64), 2.0)              # NHWC, odd sizes
    w = _normal(6, (k, k, 64, 80), 0.05)            # HWIO
    s = _scale(x)
    padding = [(pad, pad), (pad, pad)]
    if int8_in:
        xq = np.asarray(jq._quantize_activation(jnp.asarray(x),
                                                jnp.float32(s))[0])
        jx, tx = jnp.asarray(xq), _nchw(xq)
    else:
        jx, tx = jnp.asarray(x), _nchw(x)
    want = jq.w8a8_conv(jx, jnp.asarray(w), (stride, stride), padding,
                        jnp.float32, jnp.float32(s))
    got = tq.w8a8_conv(tx, _t(w.transpose(3, 2, 0, 1)), (stride, stride),
                       (pad, pad), torch.float32, torch.tensor(s))
    assert got.shape == (2, 80, *np.asarray(want).shape[1:3])
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_int_mm_refuses_cuda_shapes_it_cannot_take():
    """`torch._int_mm` on CUDA takes M > 16 and K, N multiples of 8. On a
    (mocked) CUDA tensor int_mm pads an M of 1 or 16 with zero rows to 17
    and cuts the product back, equal to the CPU product; K or N that is no
    multiple of 8 raises."""
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.integers(-127, 128, (24, 32), dtype=np.int8))
    for m in (1, 16):
        a = torch.from_numpy(rng.integers(-127, 128, (m, 32), dtype=np.int8))
        want = tq.int_mm(a, b)  # the CPU path takes any M
        assert want.shape == (m, 24)
        real = torch._int_mm
        with mock.patch.object(torch.Tensor, "is_cuda", True), \
                mock.patch.object(torch, "_int_mm", side_effect=real) as spy:
            got = tq.int_mm(a, b)
        assert spy.call_args[0][0].shape == (17, 32)
        assert torch.equal(got, want)
        assert torch.equal(want, (a.int() @ b.int().t()))
    with mock.patch.object(torch.Tensor, "is_cuda", True):
        with pytest.raises(ValueError, match="multiples of 8"):
            tq.int_mm(torch.zeros(20, 12, dtype=torch.int8),
                      torch.zeros(16, 12, dtype=torch.int8))
        with pytest.raises(ValueError, match="multiples of 8"):
            tq.int_mm(torch.zeros(20, 16, dtype=torch.int8),
                      torch.zeros(12, 16, dtype=torch.int8))


def test_scale_tables_match_jax():
    """The same per-point stats folded by both packages (float64 numpy
    interpolation on both sides): equal."""
    rng = np.random.default_rng(7)
    stats = [(t, [{"a": float(rng.uniform(1, 5)), "b": float(rng.uniform())}])
             for t in (999, 500, 0)]
    stats[1][1][0].pop("b")  # a layer missing at one point
    jstats = [(t, [{k.replace("a", "a/x").replace("b", "b/y"): {
        "act_amax": jnp.float32(v)} for k, v in s[0].items()}])
        for t, s in stats]
    want = jq.scale_tables_from_stats(jstats, 1000, 1.05)
    got = tq.scale_tables_from_stats(
        [(t, [{k: torch.tensor(v, dtype=torch.float32) for k, v in
               s[0].items()}]) for t, s in stats], 1000, 1.05)
    assert set(got) == {"a", "b"} and set(want) == {"a/x", "b/y"}
    np.testing.assert_array_equal(got["a"], want["a/x"])
    np.testing.assert_array_equal(got["b"], want["b/y"])


def test_static_scale_gathers_per_timestep_on_the_device():
    table = list(np.linspace(0.1, 1.0, 1000))
    with tq.override("w8a8_static", {"x": table, "y": 0.5},
                     t=torch.tensor([999, 999])) as state:
        s = tq.static_scale("x")
        assert s.dtype == torch.float32 and s.ndim == 0
        assert float(s) == np.float32(table[999])
        assert float(tq.static_scale("y")) == 0.5
        assert tq.static_scale("missing") is None
        assert len(state._at_t) == 1  # one gather for all layers
    with tq.override("w8a8_static", {"x": table}):
        with pytest.raises(ValueError, match="timestep"):
            tq.static_scale("x")
    with pytest.raises(ValueError, match="calibrated scales"):
        with tq.override("w8a8_static"):
            pass


def test_layer_selection_skip_and_only():
    with tq.override("w8a8", skip=["attn2"]):
        assert tq.quantizable(64, 64, "mid.attn1.to_q")
        assert not tq.quantizable(64, 64, "mid.attn2.to_q")
        assert not tq.quantizable(32, 64, "mid.attn1.to_q")  # too thin
    with tq.override("w8a8", only=["ff."]):
        assert tq.quantizable(64, 256, "a.ff.net.2")
        assert not tq.quantizable(64, 64, "a.attn1.to_q")
    with tq.override("w8a8_static", {"p": 1.0}):
        assert tq.quantizable(64, 64, "p") and not tq.quantizable(64, 64, "q")
    assert not tq.quantizable(64, 64, "p")  # no mode: full precision


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _near_ties(seed, shape, s):
    """fp32 values at (k + 0.5)·s and one ulp either side of it (k from -130
    to 129, past the clip too): the quantize's tie path, which an fp32 x
    meets far more often than a bf16 one."""
    rng = np.random.default_rng(seed)
    v = ((rng.integers(-130, 130, shape) + 0.5) * np.float64(s)).astype(
        np.float32)
    nudge = rng.integers(-1, 2, shape)
    up, down = (np.nextafter(v, np.float32(d)) for d in (np.inf, -np.inf))
    return np.where(nudge > 0, up, np.where(nudge < 0, down, v))


@pytest.mark.parametrize("bias,m,ties", [
    (True, 256, False), (True, 200, False), (False, 256, False),
    (False, 200, False), (True, 200, True)],
    ids=["True-256", "True-200", "False-256", "False-200", "fp32-ties"])
def test_w8a8_dense_plain_matches_pallas_interpret(bias, m, ties):
    """Kernel 5, ragged M included. Same codes, same int32 sums, the same
    fp32 dequantize + bias: rtol 1e-6. The fp32-output case (the fp32
    form's contract: fp32 x, fp32 bias, `out_dtype=torch.float32`) draws x
    at and one ulp beside the quantize's ties, holds its codes equal to
    JAX's, and its int8 hand-off (the codes with an fp32 output) to the
    same Pallas output."""
    w = _normal(9, (64, 96), 0.1)
    if ties:
        s = np.float32(0.03)
        x = _near_ties(8, (m, 64), s)
    else:
        x = _normal(8, (m, 64))
        s = _scale(x)
    b = _normal(10, (96,), 0.05) if bias else None
    with interpret:
        want = jfd.fused_w8a8_dense.__wrapped__(
            jnp.asarray(x), jnp.asarray(w), None if b is None else
            jnp.asarray(b), jnp.float32(s), block_m=128)
    assert np.asarray(want).dtype == np.float32
    wq, sw = tq.weight_q8_matrix(_t(w.T))
    before = tfd.fused_w8a8_dense.launches, tfd.fused_w8a8_dense.f32_launches
    args = (wq, sw, None if b is None else _t(b), torch.tensor(s))
    got = tfd.fused_w8a8_dense(_t(x), *args,
                               out_dtype=torch.float32 if ties else None)
    # CPU: plain version
    assert (tfd.fused_w8a8_dense.launches,
            tfd.fused_w8a8_dense.f32_launches) == before
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if ties:
        codes = tq.quantize_activation(_t(x), torch.tensor(s))[0]
        jcodes = jq._quantize_activation(jnp.asarray(x), jnp.float32(s))[0]
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        handoff = tfd.fused_w8a8_dense(codes, *args, out_dtype=torch.float32)
        np.testing.assert_allclose(handoff.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_w8a8_dense_plain_takes_prequantized_int8():
    x = _normal(11, (40, 64))
    s = torch.tensor(_scale(x))
    wq, sw = tq.weight_q8_matrix(_t(_normal(12, (48, 64), 0.1)))
    xq = tq.quantize_activation(_t(x), s)[0]
    got = tfd.fused_w8a8_dense(xq, wq, sw, None, s, out_dtype=torch.float32)
    torch.testing.assert_close(got, tfd.fused_w8a8_dense(_t(x), wq, sw, None,
                                                         s), rtol=0, atol=0)
    with pytest.raises(ValueError, match="out_dtype"):
        tfd.reference_w8a8_dense(xq, wq, sw, None, s)


def _geglu_weights(c, h, seed):
    w1 = _normal(seed, (c, 2 * h), c ** -0.5)            # JAX [C, 2H]
    b1 = _normal(seed + 1, (2 * h,), 0.1)
    w2 = _normal(seed + 2, (h, c), h ** -0.5)            # JAX [H, C]
    b2 = _normal(seed + 3, (c,), 0.1)
    return w1, b1, w2, b2


def _port_q8(w1, b1, w2, b2):
    wq1, sw1 = tq.weight_q8_matrix(_t(w1.T))
    wq2, sw2 = tq.weight_q8_matrix(_t(w2.T))
    return wq1, sw1, _t(b1), wq2, sw2, _t(b2)


def _pallas_h_codes(kernel, x, w1, b1, group, sh=None):
    """The h codes a Pallas int8 GEGLU makes inside it, read through its own
    output: with W2 = I (C = H) its weight quantizes to 127·I at scales
    1/127, so out[t, j] = hq[t, j] · sh to fp32 rounding and round(out /
    sh) is hq. `sh` is h's static scale; without it, the per-token form's
    scale of each row's group of `group` hidden units is read as the
    group's largest |out| / 127 (its code of ±127). Returns (codes [T, H],
    scales [T, H / group])."""
    c = x.shape[-1]
    out = np.asarray(kernel(*map(jnp.asarray, (
        x, w1, b1, np.eye(c, dtype=np.float32), np.zeros(c, np.float32)))))
    out = out.reshape(-1, c // group, group)
    if sh is None:
        sh = np.abs(out).max(axis=2) / np.float32(127)
    sh = np.broadcast_to(np.float32(sh), out.shape[:2])
    codes = np.round(out / sh[..., None]).astype(np.int8)
    return codes.reshape(-1, c), np.ascontiguousarray(sh)


def _h_codes_close(got, want):
    """h codes computed apart agree but at ties (the two erf
    implementations): at most one code apart, in at most 2e-3 of them."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3


@pytest.mark.parametrize("block_h,fp32", [(128, False), (64, False),
                                          (128, True)],
                         ids=["128", "64", "fp32-codes"])
def test_geglu_w8a8_plain_matches_pallas_interpret(block_h, fp32):
    """Kernel 4 (int32 accumulation across hidden tiles). The TPU kernel's
    GELU uses an erf polynomial (|err| ≤ 1.5e-7) where torch uses erf, so h
    can differ in its last bits and a code can flip at a tie: relative L2
    ≤ 2e-3, and most outputs agree to 1e-5. The fp32-output case (C = H, so
    that the Pallas kernel's own h codes read back through W2 = I) holds
    the x codes equal to JAX's, the h codes one apart at most at ties, and
    the plain second half fed the Pallas kernel's codes to its output at
    rel 1e-6."""
    c, h = (128, 128) if fp32 else (64, 128)
    x = _normal(13, (1, 256, c))
    w1, b1, w2, b2 = _geglu_weights(c, h, 14)
    s1 = _scale(x)
    a, g = np.split(x @ w1 + b1, 2, axis=-1)
    s2 = _scale(np.asarray(a * jax.nn.gelu(g, approximate=False)))
    kernel = functools.partial(jfg.fused_geglu_w8a8.__wrapped__,
                               act_scale1=s1, act_scale2=s2, block_t=128,
                               block_h=block_h)
    with interpret:
        want = np.asarray(kernel(*map(jnp.asarray, (x, w1, b1, w2, b2))))
        jcodes = _pallas_h_codes(kernel, x, w1, b1, c, s2)[0] if fp32 else None
    assert want.dtype == np.float32
    weights = _port_q8(w1, b1, w2, b2)
    ts1, ts2 = torch.tensor(s1), torch.tensor(s2)
    before = tfg.fused_geglu_w8a8.launches, tfg.fused_geglu_w8a8.f32_launches
    got = tfg.fused_geglu_w8a8(_t(x), *weights, ts1, ts2)
    assert (tfg.fused_geglu_w8a8.launches,
            tfg.fused_geglu_w8a8.f32_launches) == before
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 2e-3
    close = np.isclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert close.mean() >= 0.95
    if fp32:
        np.testing.assert_array_equal(
            tq.quantize_activation(_t(x), ts1)[0].numpy(),
            np.asarray(jq._quantize_activation(jnp.asarray(x),
                                               jnp.float32(s1))[0]))
        wq1, sw1, tb1, wq2, sw2, tb2 = weights
        _h_codes_close(tfg.reference_geglu_w8a8_codes(
            _t(x), wq1, sw1, tb1, ts1, ts2), jcodes)
        forced = tfd.reference_w8a8_dense(_t(jcodes), wq2, sw2, tb2, ts2,
                                          out_dtype=torch.float32)
        np.testing.assert_allclose(forced.numpy(), want.reshape(-1, c),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,tokens,out_dtype", [
    (64, 256, torch.float32), (320, 77, torch.float32),
    (64, 130, torch.bfloat16)])
def test_static_geglu_split_is_the_dense_over_h_codes(c, tokens, out_dtype):
    """The static int8 GEGLU's CUDA path is two launches: h's int8 codes
    (plain version reference_geglu_w8a8_codes), then the W8A8 dense's
    int8-input path with act_scale = sh. Their plain versions composed equal
    the whole FF's plain version bit for bit: the same int32 products, the
    same dequantize order, one rounding."""
    h = 4 * c
    x = _normal(17, (2, tokens, c))
    w1, b1, w2, b2 = _geglu_weights(c, h, 18)
    wq1, sw1, tb1, wq2, sw2, tb2 = _port_q8(w1, b1, w2, b2)
    a, g = np.split(x @ w1 + b1, 2, axis=-1)
    s1 = torch.tensor(_scale(x))
    s2 = torch.tensor(_scale(np.asarray(a * jax.nn.gelu(g,
                                                        approximate=False))))
    x = _t(x)
    b1, b2 = tb1, tb2
    codes = tfg.reference_geglu_w8a8_codes(x, wq1, sw1, b1, s1, s2)
    assert codes.dtype == torch.int8 and codes.shape == (2 * tokens, h)
    split = tfd.reference_w8a8_dense(codes, wq2, sw2, b2, s2,
                                     out_dtype=out_dtype)
    whole = tfg.reference_geglu_w8a8(x, wq1, sw1, b1, wq2, sw2, b2, s1, s2,
                                     out_dtype=out_dtype)
    assert torch.equal(split.reshape(whole.shape), whole)


@pytest.mark.parametrize("c,tokens,fp32", [(64, 256, False),
                                            (320, 128, False),
                                            (1280, 128, True)],
                         ids=["64-256", "320-128", "fp32-codes"])
def test_geglu_w8a8_pt_plain_matches_pallas_interpret(c, tokens, fp32):
    """Kernel 6 with the reference's block_h (C=320: hidden 1280 in two
    groups of 640, so h is quantized per (row, group)). Row scales and
    group scales come from the same fp32 values; the erf polynomial can
    flip a code at a tie: relative L2 ≤ 2e-3. The fp32-output case (C = H
    = 1280: five groups of 256, so that the Pallas kernel's own h codes
    and group scales read back through W2 = I) holds the row codes of x
    equal to JAX's, the h codes one apart at most at ties, and the plain
    second half fed the Pallas kernel's codes and scales to its output at
    rel 1e-6. (The kernel's erf polynomial moves a group's scale from the
    plain version's by up to ~3e-4, so the scales are its own.)"""
    h = c if fp32 else 4 * c
    x = _normal(15, (1, tokens, c))
    w1, b1, w2, b2 = _geglu_weights(c, h, 16)
    bt, bh = jfg._BLOCKS.get(c, (jfg.DEFAULT_BLOCK_T, jfg.DEFAULT_BLOCK_H))
    assert tfg.block_h(c, h) == jfg._tile(h, bh, 128)
    kernel = functools.partial(jfg.fused_geglu_w8a8_pt.__wrapped__,
                               block_t=bt, block_h=bh)
    weights = _port_q8(w1, b1, w2, b2)
    wq1, sw1, tb1, wq2, sw2, tb2 = weights
    with interpret:
        want = np.asarray(kernel(*map(jnp.asarray, (x, w1, b1, w2, b2))))
        if fp32:
            jcodes, jsh = _pallas_h_codes(kernel, x, w1, b1,
                                          tfg.block_h(c, h))
    assert want.dtype == np.float32
    oracle = jfg.reference_geglu_w8a8_pt(*map(jnp.asarray, (x, w1, b1, w2,
                                                            b2)))
    before = (tfg.fused_geglu_w8a8_pt.launches,
              tfg.fused_geglu_w8a8_pt.f32_launches)
    got = tfg.fused_geglu_w8a8_pt(_t(x), *weights)
    assert (tfg.fused_geglu_w8a8_pt.launches,
            tfg.fused_geglu_w8a8_pt.f32_launches) == before
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 2e-3
    assert _rel(got.numpy(), oracle) <= 2e-3
    if fp32:
        x32 = jnp.asarray(x).reshape(-1, c)
        sxr = jnp.maximum(jnp.max(jnp.abs(x32), axis=1, keepdims=True),
                          1e-12) / 127.0
        np.testing.assert_array_equal(
            tfg.row_codes(_t(x))[0].numpy(),
            np.asarray(jnp.clip(jnp.round(x32 / sxr), -127, 127)
                       .astype(jnp.int8)))
        _h_codes_close(tfg.reference_geglu_w8a8_pt_codes(_t(x), wq1, sw1,
                                                         tb1)[0], jcodes)
        forced = tfg.reference_geglu_w8a8_pt_down(_t(jcodes), _t(jsh), wq2,
                                                  sw2, tb2, torch.float32)
        np.testing.assert_allclose(forced.numpy(), want.reshape(-1, c),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,tokens,out_dtype", [
    (64, 256, torch.float32), (320, 77, torch.float32),
    (64, 130, torch.bfloat16)])
def test_pt_geglu_split_is_the_codes_then_grouped_product(c, tokens,
                                                          out_dtype):
    """The per-token int8 GEGLU's CUDA path is two launches: h's int8 codes
    and group scales (plain version reference_geglu_w8a8_pt_codes), then
    the groups' products added in fp32 in order (reference_geglu_w8a8_pt_
    down). Composed, they are reference_geglu_w8a8_pt, and equal bit for
    bit the whole FF written out in one piece, group by group."""
    h = 4 * c
    x = _t(_normal(19, (2, tokens, c)))
    wq1, sw1, b1, wq2, sw2, b2 = _port_q8(*_geglu_weights(c, h, 20))
    codes, sh = tfg.reference_geglu_w8a8_pt_codes(x, wq1, sw1, b1)
    bh = tfg.block_h(c, h)
    assert codes.dtype == torch.int8 and codes.shape == (2 * tokens, h)
    assert sh.dtype == torch.float32 and sh.shape == (2 * tokens, h // bh)
    split = tfg.reference_geglu_w8a8_pt_down(codes, sh, wq2, sw2, b2,
                                             out_dtype)
    whole = tfg.reference_geglu_w8a8_pt(x, wq1, sw1, b1, wq2, sw2, b2,
                                        out_dtype=out_dtype)
    assert torch.equal(split.reshape(whole.shape), whole)
    # the FF in one piece: quantize each group of h and add its product
    x32 = x.reshape(-1, c)
    sxr = x32.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
    xq = torch.clamp(torch.round(x32 / sxr), -127, 127).to(torch.int8)
    a, gate = (tq.int_mm(xq, wq1).float() * (sxr * sw1) + b1).chunk(2, -1)
    hf = a * torch.nn.functional.gelu(gate)
    out = torch.zeros(2 * tokens, c)
    for j0 in range(0, h, bh):
        ht = hf[:, j0:j0 + bh]
        shr = ht.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
        hq = torch.clamp(torch.round(ht / shr), -127, 127).to(torch.int8)
        out = out + tq.int_mm(hq, wq2[:, j0:j0 + bh]).float() * (shr * sw2)
    assert torch.equal(whole.reshape(out.shape), (out + b2).to(out_dtype))


def _jax_pt_codes(x, w1, b1, c, h):
    """h's int8 codes and group scales as the JAX oracle
    (reference_geglu_w8a8_pt) makes them, step by step, with its grouped
    product on top (which must equal the oracle's output)."""
    bh = jfg._tile(h, jfg._BLOCKS.get(c, (0, jfg.DEFAULT_BLOCK_H))[1], 128)
    wq1, sw1 = jq.quantize_weight(jnp.asarray(w1), (0,))
    x32 = jnp.asarray(x).reshape(-1, c)
    sxr = jnp.maximum(jnp.max(jnp.abs(x32), axis=1, keepdims=True),
                      1e-12) / 127.0
    xq = jnp.clip(jnp.round(x32 / sxr), -127, 127).astype(jnp.int8)
    h1 = jax.lax.dot_general(xq, wq1, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    h1 = h1.astype(jnp.float32) * (sxr * sw1) + jnp.asarray(b1)
    a, gate = jnp.split(h1, 2, axis=-1)
    hf = a * jax.nn.gelu(gate, approximate=False)
    codes, scales = [], []
    for j0 in range(0, h, bh):
        ht = hf[:, j0:j0 + bh]
        shr = jnp.maximum(jnp.max(jnp.abs(ht), axis=1, keepdims=True),
                          1e-12) / 127.0
        codes.append(jnp.clip(jnp.round(ht / shr), -127, 127
                              ).astype(jnp.int8))
        scales.append(shr)
    return (np.asarray(jnp.concatenate(codes, axis=1)),
            np.asarray(jnp.concatenate(scales, axis=1)), bh)


@pytest.mark.parametrize("c,tokens", [(64, 256), (320, 128)])
def test_pt_geglu_codes_match_the_jax_oracle(c, tokens):
    """Launch 1's plain version against the codes the JAX oracle implies, on
    the same numpy inputs. The int32 products are exact on both sides; h
    differs in its last bits only where the two frameworks' erf do, so the
    group scales agree to 1e-6 relative and a code flips only at a tie (at
    most one apart, in at most 0.1% of them). With JAX's codes and scales
    forced into launch 2's plain version (as ForcedCodes does for a whole
    network), the output is the JAX oracle's to fp32 rounding (1e-6)."""
    h = 4 * c
    x = _normal(21, (1, tokens, c))
    w1, b1, w2, b2 = _geglu_weights(c, h, 22)
    want_q, want_s, bh = _jax_pt_codes(x, w1, b1, c, h)
    wq2, sw2 = jq.quantize_weight(jnp.asarray(w2), (0,))
    oracle = np.asarray(jfg.reference_geglu_w8a8_pt(
        *map(jnp.asarray, (x, w1, b1, w2, b2)))).reshape(tokens, c)
    down = sum(np.asarray(jax.lax.dot_general(
        jnp.asarray(want_q[:, j0:j0 + bh]), wq2[j0:j0 + bh],
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32),
        np.float32) * (want_s[:, g:g + 1] * np.asarray(sw2))
        for g, j0 in enumerate(range(0, h, bh)))
    np.testing.assert_allclose(down + b2, oracle, rtol=1e-6, atol=1e-6)

    wq1, sw1, tb1, twq2, tsw2, tb2 = _port_q8(w1, b1, w2, b2)
    codes, sh = tfg.reference_geglu_w8a8_pt_codes(_t(x), wq1, sw1, tb1)
    np.testing.assert_allclose(sh.numpy(), want_s, rtol=1e-6, atol=0)
    diff = np.abs(codes.numpy().astype(np.int32) - want_q.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    forced = tfg.reference_geglu_w8a8_pt_down(
        _t(want_q), _t(want_s), twq2, tsw2, tb2, torch.float32)
    np.testing.assert_allclose(forced.numpy(), oracle, rtol=1e-6, atol=1e-6)


def test_block_h_is_the_reference_tile():
    for c in (320, 640, 1280, 64, 128):
        h = 4 * c
        want = jfg._tile(h, jfg._BLOCKS.get(c, (0, jfg.DEFAULT_BLOCK_H))[1],
                         128)
        assert tfg.block_h(c, h) == want
    assert [tfg.block_h(c, 4 * c) for c in (320, 640, 1280)] == [640, 512, 512]


@pytest.mark.parametrize("c,hw", [(64, 8), (96, 5)])
def test_gn_q8_plain_matches_jax(c, hw):
    """GN+SiLU → int8 codes: the JAX oracle (reference_gn_q8) and the
    Pallas kernel in interpret mode. Codes are equal except where y / s
    lies within rounding of a half: at most one code apart, in at most
    0.1% of the elements."""
    x = _normal(17, (2, hw, hw, c), 2.0) + 0.3
    gamma, beta = 1 + _normal(18, (c,), 0.1), _normal(19, (c,), 0.1)
    s = np.float32(4.0 / 127)
    oracle = np.asarray(jgn.reference_gn_q8(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), s, 32, 1e-5,
        "silu"))
    kernel = np.asarray(jgn.fused_group_norm(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), s,
        num_groups=32, eps=1e-5, act="silu", interpret=True))
    assert oracle.dtype == kernel.dtype == np.int8
    before = tgn.fused_group_norm.launches
    got = tgn.fused_group_norm(_nchw(x), _t(gamma), _t(beta), 32, 1e-5,
                               "silu", act_scale=torch.tensor(s))
    assert tgn.fused_group_norm.launches == before
    assert got.dtype == torch.int8
    got = _nhwc(got).astype(np.int32)
    for want in (oracle, kernel):
        diff = np.abs(got - want.astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# inference only; weights quantized once
# ---------------------------------------------------------------------------

def test_quantized_paths_refuse_gradients():
    w = torch.randn(64, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        tq.quantize_weight(w, (1,))
    with pytest.raises(RuntimeError, match="inference-only"):
        tq.quantize_activation(torch.randn(4, 64, requires_grad=True))
    lin = tb.QLinear(64, 64)
    lin.path = "p"
    x = torch.randn(2, 64)
    with tq.override("w8a8"):
        with pytest.raises(RuntimeError, match="inference-only"):
            lin(x)
        with torch.no_grad():
            assert lin(x).shape == (2, 64)
    wq, sw = tq.weight_q8_matrix(w.detach())
    for fn, args in (
            (tfd.fused_w8a8_dense, (x.requires_grad_(), wq, sw, None,
                                    torch.tensor(0.1))),
            (tgn.fused_group_norm, (torch.randn(1, 64, 2, 2), w[0], w[1],
                                    32, 1e-5, None, torch.tensor(0.1)))):
        with pytest.raises(RuntimeError, match="inference-only"):
            fn(*args)


@torch.no_grad()
def test_cached_int8_weights_equal_quantize_weight():
    conv = tb.QConv2d(64, 72, 3, padding=1)
    lin = tb.QLinear(64, 96)
    for module in (conv, lin):
        w = module.weight.detach()
        wq, sw = tq.module_weight_q8(module)
        want_q, want_s = tq.quantize_weight(w, tuple(range(1, w.ndim)))
        if w.ndim == 4:
            want_q = want_q.permute(0, 2, 3, 1)
        assert torch.equal(wq, want_q.reshape(w.shape[0], -1))
        assert torch.equal(sw, want_s.reshape(-1))
        assert tq.module_weight_q8(module)[0] is wq  # quantized once
        module.weight.mul_(2.0)  # changed weights are re-quantized
        wq2, sw2 = tq.module_weight_q8(module)
        assert wq2 is not wq
        assert torch.equal(sw2, tq.quantize_weight(
            module.weight.detach(), tuple(range(1, w.ndim)))[1].reshape(-1))


def test_nearest_exact_gather_matches_interpolate():
    x = torch.randn(1, 3, 5, 4)
    for size in ((10, 8), (9, 7), (5, 4), (7, 13)):
        want = torch.nn.functional.interpolate(x, size=size,
                                               mode="nearest-exact")
        assert torch.equal(tb._nearest_exact(x, size), want)
    xi = torch.randint(-127, 127, (1, 3, 5, 4), dtype=torch.int8)
    assert tb._nearest_exact(xi, (9, 7)).dtype == torch.int8


# ---------------------------------------------------------------------------
# the quantized UNet against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quant_unets():
    """The JAX UNet (fp32, init params nudged so biases and norm scales
    are exercised) and the port's twin with the same weights."""
    unet = JUNet(**QUANT_UNET, dtype=jnp.float32)
    params = unet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 8, 64)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape
                                                             ).astype(np.float32),
        params)
    t_unet = TUNet(**QUANT_UNET)
    t_unet.load_state_dict(timp.unet_from_jax(params), strict=True)
    return unet, params, t_unet.eval()


@pytest.fixture(scope="module")
def jax_scales(quant_unets):
    """JAX calibration on a 3-point CFG trajectory from PRNGKey(0) noise,
    with the JAX latents it starts from."""
    unet, params, _ = quant_unets
    cond, uncond = _normal(20, (1, 8, 64)), _normal(21, (1, 8, 64))
    shape = (2, 16, 16, 4)
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape,
                                        jnp.float32))
    scales = jcal.calibrate_unet_scales(
        unet, params, jsched.DiffusionSchedule.create(**SD_SCHEDULE), shape,
        jnp.asarray(cond), jnp.asarray(uncond), key=jax.random.PRNGKey(0),
        num_steps=3, guidance_scale=7.5)
    return scales, cond, uncond, init


def test_calibration_tables_match_jax(quant_unets, jax_scales):
    """Same weights, same starting latents, same 3-point trajectory: the
    tables agree after the key map. Every quantizable layer is there; the
    amaxes come from fp32 forwards that differ in summation order, carried
    through two DDIM moves under CFG 7.5: rtol 1e-3."""
    _, _, t_unet = quant_unets
    scales, cond, uncond, init = jax_scales
    got = tcal.calibrate_unet_scales(
        t_unet, tsched.DiffusionSchedule.create(**SD_SCHEDULE),
        (2, 4, 16, 16), _t(cond), _t(uncond), num_steps=3,
        guidance_scale=7.5, init=_nchw(init))
    want = timp.scales_from_jax(scales)
    quantizable = {name for name, m in t_unet.named_modules()
                   if isinstance(m, (tb.QConv2d, tb.QLinear))}
    assert set(got) == set(want) == quantizable
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)


def _unet_inputs(seed):
    x = _normal(seed, (2, 16, 16, 4))
    ctx = _normal(seed + 1, (2, 8, 64))
    return x, ctx


class ForcedCodes:
    """Teacher forcing at the int8 codes, for whole-network comparisons.

    A quantized network does not agree with its twin to fp32 rounding: a
    value that lands within rounding of a .5 code boundary rounds one way
    on one side and the other way on the other, and that one-code change
    moves the next layer's inputs by far more than rounding, so more ties
    break differently downstream. On the quantized UNet here a 1e-6
    relative nudge of the input alone moves the output by about as much as
    int8 moves it from full precision. So the JAX run records every
    activation quantize (its codes and scale, in call order), and the
    port's run checks each of its own quantize calls against the next
    record — the same elements in the same order, the same scale, codes at
    most one apart, in a small share — and then continues with JAX's codes.
    The outputs must then agree to fp32 rounding. `ff` does the same for
    the per-token GEGLU kernel, which quantizes inside: the port's FF,
    given its own input, must agree with JAX's within the op-level
    tolerance, and continues with JAX's output."""

    def __init__(self):
        self.codes, self.ffs = [], []
        self.i = self.j = 0
        self.n = self.flipped = 0

    def record(self, orig):
        def quantize(x, scale=None):
            q, s = orig(x, scale)
            self.codes.append((np.asarray(q), float(s)))
            return q, s
        return quantize

    def record_ff(self, orig):
        def ff(x, *args):
            out = orig(x, *args)
            self.ffs.append((np.asarray(x), np.asarray(out)))
            return out
        return ff

    @staticmethod
    def _to_jax(t, shape):
        a = t.numpy()
        return (a.transpose(0, 2, 3, 1) if a.ndim == 4 else a).reshape(shape)

    @staticmethod
    def _to_port(a, like):
        if like.ndim == 4:
            n, c, h, w = like.shape
            return _t(a.reshape(n, h, w, c).transpose(0, 3, 1, 2))
        return _t(a.reshape(like.shape))

    def force(self, orig):
        def quantize(x, scale=None):
            q, s = orig(x, scale)
            want, want_s = self.codes[self.i]
            self.i += 1
            assert abs(float(s) - want_s) <= 1e-5 * want_s, (float(s), want_s)
            diff = np.abs(self._to_jax(q, want.shape).astype(np.int32)
                          - want.astype(np.int32))
            assert diff.max() <= 1, f"quantize call {self.i}: codes differ"
            self.n += diff.size
            self.flipped += int((diff > 0).sum())
            return self._to_port(want, q), s
        return quantize

    def force_ff(self, orig):
        def ff(x, *args):
            want_x, want = self.ffs[self.j]
            self.j += 1
            assert _rel(x.numpy().reshape(want_x.shape), want_x) <= 1e-4
            assert _rel(orig(x, *args).numpy(), want.reshape(x.shape)) <= 2e-3
            return _t(want.reshape(x.shape))
        return ff

    def check_all_used(self):
        assert self.i == len(self.codes) > 0 and self.j == len(self.ffs)
        assert self.flipped <= 1e-3 * self.n, (self.flipped, self.n)


@pytest.mark.parametrize("t", [900, 300])
def test_static_unet_matches_jax(quant_unets, jax_scales, monkeypatch, t):
    """w8a8_static with per-timestep tables; JAX with POLYP_GN_Q8=1 (its
    producer-side handoff, which the port always takes). With the codes
    forced (ForcedCodes): every quantize call matches, and the outputs
    agree to relative L2 1e-5, far inside the int8 noise."""
    unet, params, t_unet = quant_unets
    scales = jax_scales[0]
    monkeypatch.setenv("POLYP_GN_Q8", "1")
    x, ctx = _unet_inputs(22)
    tt = jnp.full((2,), t, jnp.int32)
    full = np.asarray(unet.apply({"params": params}, jnp.asarray(x), tt,
                                 jnp.asarray(ctx)))
    codes = ForcedCodes()
    with mock.patch.object(jq, "_quantize_activation",
                           codes.record(jq._quantize_activation)), \
            jq.override("w8a8_static", scales=scales, t=tt):
        want = np.asarray(unet.apply({"params": params}, jnp.asarray(x), tt,
                                     jnp.asarray(ctx)))
    t_t = torch.full((2,), t)
    with mock.patch.object(tq, "quantize_activation",
                           codes.force(tq.quantize_activation)), \
            torch.no_grad(), tq.override(
                "w8a8_static", scales=timp.scales_from_jax(scales), t=t_t):
        got = _nhwc(t_unet(_nchw(x), t_t, _t(ctx)))
    codes.check_all_used()
    assert len(codes.codes) >= 40  # every quantized layer of the UNet
    assert _rel(want, full) > 1e-3  # the int8 path really ran
    assert _rel(got, want) <= 1e-5


def test_dynamic_unet_matches_jax(quant_unets, monkeypatch):
    """Dynamic w8a8; JAX with POLYP_GEGLU_PT=1 and its TPU gate patched
    open, so its FF runs the per-token kernel (interpret mode) as the
    port's does. Codes and FF outputs forced (ForcedCodes): the outputs
    agree to relative L2 1e-5."""
    unet, params, t_unet = quant_unets
    monkeypatch.setenv("POLYP_GEGLU_PT", "1")
    monkeypatch.setattr(jfg, "supported", lambda x, w1, w2: True)
    x, ctx = _unet_inputs(23)
    tt = jnp.full((2,), 500, jnp.int32)
    full = np.asarray(unet.apply({"params": params}, jnp.asarray(x), tt,
                                 jnp.asarray(ctx)))
    codes = ForcedCodes()
    with mock.patch.object(jq, "_quantize_activation",
                           codes.record(jq._quantize_activation)), \
            mock.patch.object(jfg, "geglu_w8a8_pt",
                              codes.record_ff(jfg.geglu_w8a8_pt)), \
            interpret, jdispatch.inference(), jq.override("w8a8"):
        want = np.asarray(unet.apply({"params": params}, jnp.asarray(x), tt,
                                     jnp.asarray(ctx)))
    with mock.patch.object(tq, "quantize_activation",
                           codes.force(tq.quantize_activation)), \
            mock.patch.object(tb, "fused_geglu_w8a8_pt",
                              codes.force_ff(tb.fused_geglu_w8a8_pt)), \
            torch.no_grad(), tq.override("w8a8"):
        got = _nhwc(t_unet(_nchw(x), torch.full((2,), 500), _t(ctx)))
    codes.check_all_used()
    assert len(codes.ffs) == 4  # the four transformer FFs
    assert _rel(want, full) > 1e-3
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the hybrid-precision trajectory and the slice as a whole
# ---------------------------------------------------------------------------

def test_segments_are_bit_identical_to_one_loop(quant_unets):
    _, _, t_unet = quant_unets
    x, ctx = _unet_inputs(24)
    init = _nchw(x)
    fn = tsamp.with_cfg(t_unet, _t(ctx[:1]), _t(ctx[1:]), 7.5)
    sched = tsched.DiffusionSchedule.create(**SD_SCHEDULE)
    one = tsamp.ddim_sample(fn, sched, None, num_steps=4, init=init)
    seg = tsamp.ddim_sample([(1, fn), (0, fn), (2, fn), (1, fn)], sched, None,
                            num_steps=4, init=init)
    assert torch.equal(one, seg)
    with pytest.raises(ValueError, match="cover 3 steps"):
        tsamp.ddim_sample([(1, fn), (2, fn)], sched, None, num_steps=4,
                          init=init)


@pytest.mark.parametrize("steps,head,tail", [
    (20, 5, 0), (4, 4, 0), (4, 5, 0), (4, 2, 2), (6, 0, 2), (6, 0, 0)])
def test_precision_split_matches_jax(steps, head, tail):
    for mode in ("w8a8_static", "w8a8", None):
        assert tpipe._precision_split(steps, mode, head, tail) == \
            j_precision_split(steps, mode, head, tail)
    fns = tpipe._precision_segments("q", "fp", 20, (5, 0))
    assert fns == [(5, "fp"), (15, "q"), (0, "fp")]


def test_head_over_every_step_drops_the_mode(quant_unets):
    _, _, t_unet = quant_unets
    sched = tsched.DiffusionSchedule.create(**SD_SCHEDULE)
    s = tpipe.StableDiffusionSampler(t_unet, tiny_vae(), None, None, sched,
                                     num_steps=4, sampler="ddim",
                                     quantize="w8a8_static", quant_fp_head=4)
    assert s.quantize is None and s._split is None
    s = tpipe.StableDiffusionSampler(t_unet, tiny_vae(), None, None, sched,
                                     num_steps=4, sampler="ddim",
                                     quantize="w8a8", quant_fp_head=1)
    assert s.quantize == "w8a8" and s._split == (1, 0)
    with pytest.raises(ValueError, match="quantization mode"):
        tpipe.StableDiffusionSampler(t_unet, tiny_vae(), None, None, sched,
                                     quantize="int4")


def test_static_calibration_is_sampler_agnostic(quant_unets, tmp_path,
                                               monkeypatch):
    """w8a8_static calibrates on its own DDIM trajectory and ScaleBank
    interpolates the tables over all 1000 timesteps, so a UniPC sampler (the
    default) gets the same tables as a DDIM one, and a finite positive scale
    at every timestep its linspace grid visits (999 first), each within the
    calibrated points' range."""
    _, _, t_unet = quant_unets
    sched = tsched.DiffusionSchedule.create(**SD_SCHEDULE)
    cond, uncond = _t(_normal(20, (1, 8, 64))), _t(_normal(21, (1, 8, 64)))
    tables = {}
    for name in ("unipc", "ddim"):
        # a cache of its own each, so each sampler calibrates afresh
        monkeypatch.setenv("POLYP_TORCH_QUANT_CACHE", str(tmp_path / name))
        s = tpipe.StableDiffusionSampler(t_unet, tiny_vae(), None, None,
                                         sched, image_size=64, num_steps=4,
                                         sampler=name,
                                         quantize="w8a8_static")
        s._ensure_calibrated(cond, uncond)
        tables[name] = s.quant_scales
    assert tables["unipc"] == tables["ddim"]
    bank = tq.ScaleBank(tables["unipc"])
    values = bank.values.numpy()
    assert values.shape == (len(tables["unipc"]), 1000)
    for t in tsamp.sampler_timesteps("unipc", 1000, 25):
        got = bank.at(torch.tensor([t]), torch.device("cpu")).numpy()
        assert np.isfinite(got).all() and (got > 0).all()
        assert (got <= values.max(axis=1) + 1e-12).all()
        assert (got >= values.min(axis=1) - 1e-12).all()


def test_int8_slice_matches_jax(quant_unets, jax_scales, monkeypatch):
    """The slice end to end: 3 DDIM steps under CFG 7.5, w8a8_static with a
    1-step full-precision head, then the tiny VAE decode at 64px; JAX's
    StableDiffusionSampler._generate_impl (run eagerly, so its quantize
    calls can be recorded) against the port's generate, with the same
    weights, scales and starting latents, codes forced (ForcedCodes).
    Images in [-1, 1]: relative L2 1e-4 (fp32 rounding through three CFG
    steps and the decoder)."""
    unet, params, t_unet = quant_unets
    scales, cond, uncond, _ = jax_scales
    monkeypatch.setenv("POLYP_GN_Q8", "1")
    vae = j_tiny_vae(jnp.float32)
    k = jax.random.PRNGKey(1)
    vp = vae.init(k, jnp.zeros((1, 32, 32, 3)), k)
    t_vae = tiny_vae()
    t_vae.load_state_dict(timp.vae_from_jax(vp), strict=True)
    kw = dict(image_size=64, num_steps=3, guidance_scale=7.5,
              sampler="ddim", quantize="w8a8_static", quant_fp_head=1)
    j = JSampler(unet, params, vae, vp, None, None, None,
                 jsched.DiffusionSchedule.create(**SD_SCHEDULE), **kw)
    j._quant_scales = scales
    t = tpipe.StableDiffusionSampler(
        t_unet, t_vae.eval(), None, None,
        tsched.DiffusionSchedule.create(**SD_SCHEDULE), **kw)
    t.quant_scales = timp.scales_from_jax(scales)
    t._scale_bank = tq.ScaleBank(t.quant_scales)
    init = _normal(25, (2, 8, 8, 4))
    codes = ForcedCodes()
    with mock.patch.object(jq, "_quantize_activation",
                           codes.record(jq._quantize_activation)), \
            jax.disable_jit():
        want = np.asarray(j._generate_impl(
            params, vp, jnp.asarray(cond), jnp.asarray(uncond),
            jax.random.PRNGKey(0), 2, init=jnp.asarray(init)))
    with mock.patch.object(tq, "quantize_activation",
                           codes.force(tq.quantize_activation)):
        got = t.generate(_t(cond), _t(uncond), 2, init=_nchw(init))
    codes.check_all_used()
    assert got.shape == (2, 3, 64, 64) and torch.isfinite(got).all()
    assert _rel(_nhwc(got), want) <= 1e-4
