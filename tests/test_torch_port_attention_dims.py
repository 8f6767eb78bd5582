"""The attention kernels' head dims and the fused MHA's fp32 form: the
port against the JAX package on the CPU.

The reference admits every head dim up to 128 to both Pallas kernels
(polyp_tpu/ops/flash_attention.py:39-56, polyp_tpu/ops/fused_mha.py:63-75)
and zero-pads it to a multiple of 64 inside them (flash_attention.py
:167-176, fused_mha.py:196-223); its fused MHA computes in x's dtype, fp32
for fp32 x. Here, with inputs made with numpy from a seed:

* the JAX kernels in interpret mode at head dims that are no multiple of
  64 (so their padding runs) against the port's wrappers, which run their
  plain versions on CPU tensors; fp32 on both sides, so they differ by
  summation order only: 1e-5 absolute on outputs of about 0.1-1;
* the fused MHA wrapper's per-head zero padding of the weights (what it
  does on the card for a head dim that is no multiple of 8) against the
  unpadded block, in float64;
* the port's dispatch policies against the reference's at every head dim
  tested, the reference's TPU-backend test answered yes;
* the tiny UNet (2 heads of 16 at level 0) in bf16 through the fused
  branch against the JAX UNet in bf16.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.models.unet_condition import tiny_condition_unet as j_tiny_unet
from polyp_tpu.ops import attention as jatt
from polyp_tpu.ops import flash_attention as jfa
from polyp_tpu.ops import fused_mha as jfm
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import unet_blocks
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.ops import attention as tatt
from polyp_tpu_torch.ops import flash_attention as tfa
from polyp_tpu_torch.ops import fused_mha as tfm
from test_torch_port_fused_mha import numpy_params
from _torch_threads import _one_thread  # noqa: F401


def _normal(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _mha_case(seed, tq, tk, c, ckv, h, d, co):
    """x [2, tq, c], ctx (x itself when tk is None) and the reference's
    [in, out] weights."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, 2, tq, c, s=0.3)
    ctx = x if tk is None else _normal(rng, 2, tk, ckv, s=0.3)
    ckv = c if tk is None else ckv
    return (x, ctx, _normal(rng, c, h * d, s=0.1),
            _normal(rng, ckv, h * d, s=0.1), _normal(rng, ckv, h * d, s=0.1),
            _normal(rng, h * d, co, s=0.1))


# Tq = 256 (two of the reference's 128-row q blocks at block_q 128); Tk 77
# (cross-attention, which the reference pads to 128 and masks) or 256
# (self-attention)
@pytest.mark.parametrize("d", (16, 32, 96, 128))
@pytest.mark.parametrize("tk", (77, 256))
def test_fused_mha_fp32_matches_jax_interpret_kernel(d, tk):
    args = _mha_case(d + tk, 256, None if tk == 256 else tk, 64, 48, 2, d, 64)
    want = jfm.fused_mha(*map(jnp.asarray, args), num_heads=2, head_dim=d,
                         block_q=128, block_k=128, interpret=True)
    assert want.dtype == jnp.float32
    got = tfm.fused_mha(*map(torch.from_numpy, args), num_heads=2,
                        head_dim=d)
    assert got.dtype == torch.float32 and got.shape == (2, 256, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# head dims whose reference padding to 64 runs (16 → 64, 48 → 64, 96 → 128,
# 112 → 128)
@pytest.mark.parametrize("d", (16, 48, 96, 112))
def test_flash_matches_jax_interpret_kernel(d):
    rng = np.random.default_rng(d)
    q, k, v = (_normal(rng, 1, 256, 2, d) for _ in range(3))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=128,
                               block_k=128, interpret=True)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (1, 256, 2, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("d", (1, 12, 33, 100))
def test_fused_mha_head_padding_is_exact(d):
    """What the wrapper does on the card for a head dim that is no
    multiple of 8: each head's weights followed by zero rows (wq, wk, wv)
    or zero columns (wo) up to the next multiple of 8. With the softmax
    scale the true d's (the kernel's `scale` argument; here folded into
    wq), the padded block is the block: float64 weights and activations,
    the plain version's logits in fp32, so 1e-6 of max |y|."""
    h, d8 = 3, -(-d // 8) * 8
    args = [torch.from_numpy(a).double()
            for a in _mha_case(d, 64, 40, 24, 16, h, d, 32)]
    x, ctx, wq, wk, wv, wo = args
    want = tfm.fused_mha(*args, num_heads=h, head_dim=d)
    pq, pk, pv = (tfm._pad_heads(w.t(), h, d, d8, 0) for w in (wq, wk, wv))
    po = tfm._pad_heads(wo.t(), h, d, d8, 1)
    assert pq.shape == (h * d8, 24) and po.shape == (32, h * d8)
    for w, p in ((wq.t(), pq), (wo, po.t())):
        heads = p.reshape(h, d8, -1)
        assert torch.equal(heads[:, :d], w.reshape(h, d, -1))
        assert not heads[:, d:].any()
    got = tfm.reference_mha_linear(x, ctx, pq * math.sqrt(d8 / d), pk, pv,
                                   po, num_heads=h, head_dim=d8)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * want.abs().max().item())


HEAD_DIMS = (16, 32, 40, 96, 128, 160)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_use_flash_matches_jax_policy(d, monkeypatch):
    """use_flash against the reference's supported ∧ profitable at 1,024
    tokens (its dispatch, attention.py:98-104), its TPU-backend test
    answered yes: the kernel takes every d ≤ 128, the plain version the
    rest."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    q = np.zeros((2, 1024, 8, d), np.float32)
    want = (jfa.supported(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                          None, False)
            and jfa.profitable(jnp.asarray(q), jnp.asarray(q),
                               jnp.asarray(q)))
    got = tatt.use_flash(torch.from_numpy(q), torch.from_numpy(q), None,
                         False)
    assert got == want == (d <= 128)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_use_fused_mha_matches_jax_policy_at_every_head_dim(d, monkeypatch):
    """use_fused_mha inside fused_mha_region(True) against the reference's
    gate under POLYP_FUSED_MHA=1, at 1,024 tokens of 8 heads."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("POLYP_FUSED_MHA", "1")
    x = np.zeros((2, 1024, 8 * d), np.float32)
    want = jatt.use_fused_mha(jnp.asarray(x), jnp.asarray(x), 8, d, False,
                              is_self=True)
    with tatt.fused_mha_region(True):
        got = tatt.use_fused_mha(torch.from_numpy(x), torch.from_numpy(x),
                                 8, d, False, is_self=True)
    assert got == want == (d <= 128)


def test_tiny_unet_bf16_with_fused_mha_matches_jax():
    """The tiny UNet at 32×32 latents in bf16 inside fused_mha_region(True)
    (its three level-0 self-attentions, 2 heads of 16 at T = 1,024, take
    the fused branch) against the JAX UNet in bf16 with the same weights.
    Both round activations to bf16 at every layer, in other orders: held
    to 3e-2 relative L2 (bf16's unit roundoff is 3.9e-3)."""
    unet = j_tiny_unet(jnp.bfloat16)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 32)).astype(np.float32)
    t = np.array([500], np.int32)
    params = numpy_params(jax.eval_shape(
        unet.init, jax.random.PRNGKey(0), jnp.asarray(x[:, :4, :4]),
        jnp.asarray(t), jnp.asarray(ctx))["params"], seed=8)
    want = np.asarray(jax.jit(unet.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx)).astype(jnp.float32))

    t_unet = tiny_condition_unet(torch.bfloat16).eval()
    t_unet.load_state_dict(timp.unet_from_jax(params), strict=True)
    calls = []

    def spy(x, ctx, *weights, num_heads, head_dim):
        calls.append((tuple(x.shape), x.dtype, num_heads, head_dim))
        return tfm.fused_mha_linear(x, ctx, *weights, num_heads=num_heads,
                                    head_dim=head_dim)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp, \
            tatt.fused_mha_region(True):
        mp.setattr(unet_blocks, "fused_mha_linear", spy)
        got = t_unet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                     torch.from_numpy(t).long(), torch.from_numpy(ctx))
    assert calls == [((1, 1024, 32), torch.bfloat16, 2, 16)] * 3
    got = got.float().numpy().transpose(0, 2, 3, 1)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"tiny UNet bf16, fused branch vs JAX bf16: rel L2 {rel:.3e}")
    assert np.isfinite(got).all() and rel <= 3e-2
