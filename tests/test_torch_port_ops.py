"""polyp_tpu_torch ops against their polyp_tpu twins on the CPU.

Each kernel's JAX side runs as the JAX package's own tests run it: the
Pallas kernels in interpret mode (flash attention, GroupNorm) or under a
patched `pallas_call(interpret=True)` (GEGLU). The port's wrappers get CPU
tensors, so they run their plain PyTorch versions: these tests hold that
plain version to the TPU kernel's semantics; tests/test_torch_port_cuda.py
holds the CUDA kernels to the plain version on the card.

Inputs come from numpy seeds and are handed to both packages. Tolerance
1e-4 (fp32; the two sides sum in different orders) unless a test says
otherwise.
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

from polyp_tpu.ops import flash_attention as jfa
from polyp_tpu.ops import fused_geglu as jfg
from polyp_tpu.ops import fused_gn as jgn
from polyp_tpu.ops import group_norm as j_group_norm
from polyp_tpu_torch.ops import attention as tattn
from polyp_tpu_torch.ops import fused_geglu as tfg
from polyp_tpu_torch.ops import fused_gn as tgn
from polyp_tpu_torch.ops import flash_attention as tfa
from _torch_threads import _one_thread  # noqa: F401


TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash attention and its dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tq,tk,d", [(256, 256, 40), (256, 128, 64),
                                     (128, 256, 80)])
def test_flash_matches_pallas_interpret(tq, tk, d):
    rng = _rng(0)
    q, k, v = (_normal(rng, (2, t, 2, d)) for t in (tq, tk, tk))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=128, block_k=128, interpret=True)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(_t(q), _t(k), _t(v))
    assert tfa.flash_attention.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,tk", [(True, 77), (False, 77)])
def test_plain_attention_matches_xla(causal, tk):
    """The plain version covers what the dispatch keeps off the kernel:
    CLIP's causal attention and the 77-token cross-attention."""
    rng = _rng(1)
    q = _normal(rng, (2, 77, 3, 16))
    k, v = _normal(rng, (2, tk, 3, 16)), _normal(rng, (2, tk, 3, 16))
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), is_causal=causal)
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_gradients_match_jax():
    """The autograd Function's backward recomputes through the plain
    version, as the reference's custom_vjp does through XLA."""
    rng = _rng(2)
    q, k, v = (_normal(rng, (1, 128, 2, 64)) for _ in range(3))
    w = _normal(rng, (1, 128, 2, 64))

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, block_q=128, block_k=128,
                                  interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    (tfa.flash_attention(*leaves) * _t(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("shape_q,shape_k,causal,flash", [
    ((2, 1024, 8, 40), (2, 1024, 8, 40), False, True),   # SD level-0 self
    ((2, 1024, 8, 40), (2, 77, 8, 40), False, False),    # cross-attention
    ((2, 256, 8, 80), (2, 256, 8, 80), False, False),    # level-1 self
    ((2, 77, 12, 64), (2, 77, 12, 64), True, False),     # CLIP
    ((1, 1024, 1, 512), (1, 1024, 1, 512), False, False),  # VAE mid, d=512
    ((2, 4096, 8, 160), (2, 4096, 8, 160), False, False),  # d > 128
    ((2, 1024, 2, 16), (2, 1024, 2, 16), False, True),   # tiny level-0 self
    ((2, 1024, 8, 32), (2, 1024, 8, 32), False, True),   # 32-wide heads
    ((2, 4096, 4, 96), (2, 4096, 4, 96), False, True),   # 96-wide heads
])
def test_dispatch_policy(shape_q, shape_k, causal, flash):
    q = torch.empty(shape_q, device="meta")
    k = torch.empty(shape_k, device="meta")
    assert tattn.use_flash(q, k, None, causal) == flash


def test_flash_wrapper_refuses_mask_causal_and_head_dim():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, is_causal=True)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, mask=torch.ones(1, 1, 8, 8, dtype=bool))
    with pytest.raises(ValueError, match="up to 128"):
        tfa.flash_attention(*(torch.zeros(1, 8, 1, 136),) * 3)


# ---------------------------------------------------------------------------
# fused GEGLU
# ---------------------------------------------------------------------------

def _geglu_case(seed, t=256, c=64, h=128):
    rng = _rng(seed)
    x = _normal(rng, (1, t, c))
    w1 = _normal(rng, (c, 2 * h), 0.05)   # JAX layout [C, 2H]
    b1 = _normal(rng, (2 * h,), 0.05)
    w2 = _normal(rng, (h, c), 0.05)       # JAX layout [H, C]
    b2 = _normal(rng, (c,), 0.05)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("block_h", [128, 64])
def test_geglu_matches_pallas_interpret(block_h):
    x, w1, b1, w2, b2 = _geglu_case(3)
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        want = jfg.fused_geglu.__wrapped__(
            *map(jnp.asarray, (x, w1, b1, w2, b2)), block_t=128,
            block_h=block_h)
    before = tfg.fused_geglu.launches
    with torch.no_grad():
        got = tfg.fused_geglu(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    assert tfg.fused_geglu.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_geglu_bf16_rounds_h_as_the_pallas_kernel():
    """bf16 inputs: the plain version makes a and gate in fp32, rounds h to
    bf16 before the second product and rounds once at the end, as the TPU
    kernel (interpret mode) and the CUDA kernel do. Tolerance 2^-9 of max
    |y|, half a bf16 ulp of the largest outputs: those agree to the bit, and
    a smaller output may differ by one ulp of its own where the TPU
    kernel's polynomial erf (|err| ~3e-6) rounds an h to the neighbouring
    bf16 value. Keeping h in fp32 misses by more than that (0.27% of max
    |y| at this seed: the second assertion)."""
    x, w1, b1, w2, b2 = _geglu_case(8, t=256, c=64, h=256)
    x = x * 4.0  # h of O(1), where its bf16 rounding matters
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (x, w1, b1, w2, b2)]
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        want = np.asarray(jfg.fused_geglu.__wrapped__(
            *bf, block_t=128, block_h=128).astype(jnp.float32))
    tx, tw1, tb1, tw2, tb2 = (torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16) for a in bf)
    with torch.no_grad():
        got = tfg.fused_geglu(tx, tw1.T, tb1, tw2.T, tb2)
    assert got.dtype == torch.bfloat16
    tol = 2 ** -9 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    a, gate = torch.nn.functional.linear(
        tx.float(), tw1.T.float(), tb1.float()).chunk(2, dim=-1)
    unrounded = torch.nn.functional.linear(
        a * torch.nn.functional.gelu(gate), tw2.T.float(), tb2.float())
    assert np.abs(unrounded.numpy() - want).max() > tol


def test_reference_geglu_matches_jax_reference():
    """a = first half, gate = second half of W1's outputs, erf gelu."""
    x, w1, b1, w2, b2 = _geglu_case(4, t=77, c=32, h=64)
    want = jfg.reference_geglu(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    got = tfg.reference_geglu(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_geglu_wrapper_refuses_grad():
    x, w1, b1, w2, b2 = (_t(a) for a in _geglu_case(5, t=8, c=16, h=16))
    w1.requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        tfg.fused_geglu(x, w1.T, b1, w2.T, b2)
    with torch.no_grad():  # the same call without autograd runs
        tfg.fused_geglu(x, w1.T, b1, w2.T, b2)


# ---------------------------------------------------------------------------
# GroupNorm(+SiLU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,c,eps,act", [
    (8, 8, 128, 1e-5, "silu"),   # lane-aligned
    (4, 4, 320, 1e-5, None),     # SD level-0 width
    (8, 8, 64, 1e-6, "silu"),    # gcd(64, 32) = 32 groups of 2
    (2, 8, 48, 1e-5, "silu"),    # gcd(48, 32) = 16 groups (tiny widths)
])
def test_group_norm_matches_pallas_interpret(h, w, c, eps, act):
    rng = _rng(6)
    x = _normal(rng, (3, h, w, c), 2.0, 0.3)
    gamma = _normal(rng, (c,), 0.5, 1.0)
    beta = _normal(rng, (c,), 0.2)
    want = jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(gamma),
                                jnp.asarray(beta), None, num_groups=32,
                                eps=eps, act=act, interpret=True)
    before = tgn.fused_group_norm.launches
    with torch.no_grad():
        got = tgn.fused_group_norm(_t(x.transpose(0, 3, 1, 2)), _t(gamma),
                                   _t(beta), 32, eps, act)
    assert tgn.fused_group_norm.launches == before
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **TOL)


def test_group_norm_plain_matches_jax_plain_on_large_mean():
    """E[x²]−E[x]² in fp32, clamped at 0, like the reference (not torch's
    two-pass F.group_norm); a mean far from zero exercises the clamp path
    both sides share. Tolerance 2e-3: cancellation at |mean|/std = 50."""
    rng = _rng(7)
    x = _normal(rng, (2, 4, 4, 64), 1.0, 50.0)
    gamma, beta = np.ones(64, np.float32), np.zeros(64, np.float32)
    want = j_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                        32, 1e-5, "silu")
    got = tgn.group_norm(_t(x.transpose(0, 3, 1, 2)), _t(gamma), _t(beta),
                         32, 1e-5, "silu")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=2e-3, atol=2e-3)


def test_group_norm_keeps_bf16_and_refuses_grad():
    x = torch.randn(1, 32, 4, 4, dtype=torch.bfloat16)
    w = torch.ones(32, requires_grad=True)
    b = torch.zeros(32)
    with torch.no_grad():
        assert tgn.fused_group_norm(x, w, b, act="silu").dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="inference-only"):
        tgn.fused_group_norm(x, w, b)
    with pytest.raises(ValueError):
        tgn.fused_group_norm(x, w.detach(), b, act="gelu")
