"""The two orders polyp_tpu_torch's attention kernels compute in, written in
plain torch (fp32, on the CPU) and held against the JAX package.

* The attention core (csrc/attention_core.cuh): keys in steps of 32 (the
  halves of the kernels' 64-key shared tiles, which the masked loads fill
  with zeros past Tk), an online softmax whose row max is kept in raw
  scores with the scale and log2 e folded into one exponent, key columns at
  or past Tk set to -inf before the max, and steps wholly past Tk skipped.
  Masked columns add exactly 0, and a row that has seen no valid key yet
  stays 0 rather than NaN. Held against jax.nn.dot_product_attention.
* The fused MHA's sum over heads (csrc/fused_mha.cu): a cluster of
  min(H, 8) blocks, ceil(H / 8) heads a block, block j writing the output
  columns [j * n, (j + 1) * n) with n = Co / cluster rounded up to 8, each
  column the sum over h = 0 .. H-1 in order of o_h Wo_h^T. Held against
  polyp_tpu.ops.fused_mha.reference_mha.

These pin the orders, not the kernels (which run only on a card, in
tests/test_torch_port_cuda.py). fp32 on both sides: they differ in
summation order only, so tolerances are 2e-6 relative to the output's
largest entry.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.ops import fused_mha as jfm

STEP = 32  # keys a step of the core
TILE = 64  # keys a shared tile of the kernels
LOG2E = 1.4426950408889634


class OnlineSoftmax:
    """One query block's state in the core's order (fp32)."""

    def __init__(self, tq: int, d: int, score_log2: float):
        self.c = score_log2
        self.m = torch.full((tq, 1), -math.inf)
        self.l = torch.zeros(tq, 1)
        self.o = torch.zeros(tq, d)
        self.probs = []  # every step's probabilities, for the tests

    def step(self, q, k, v, kvalid: int) -> None:
        """k, v: one step of STEP keys (zero rows past the data, as the
        masked tile loads leave them); keys at or past kvalid are masked."""
        s = q @ k.T
        s[:, max(kvalid, 0):] = -math.inf
        mn = torch.maximum(self.m, s.amax(dim=1, keepdim=True))
        base = torch.where(mn == -math.inf, torch.zeros_like(mn), mn * self.c)
        alpha = torch.exp2(self.m * self.c - base)
        p = torch.exp2(s * self.c - base)
        self.probs.append(p)
        self.m = mn
        self.l = self.l * alpha + p.sum(dim=1, keepdim=True)
        self.o = self.o * alpha + p @ v


def blockwise_attention(q, k, v):
    """softmax(q kᵀ / √d) v for q [Tq, d], k and v [Tk, d], in 64-key tiles
    of two 32-key steps; steps wholly past Tk are skipped."""
    tk, d = k.shape
    state = OnlineSoftmax(q.shape[0], d, LOG2E / math.sqrt(d))
    n_tiles = -(-tk // TILE)
    pad = n_tiles * TILE - tk
    k = torch.cat([k, torch.zeros(pad, d)])
    v = torch.cat([v, torch.zeros(pad, d)])
    for k0 in range(0, n_tiles * TILE, STEP):
        if k0 < tk:
            state.step(q, k[k0:k0 + STEP], v[k0:k0 + STEP], tk - k0)
    return state.o / state.l, state


def _qkv(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((tq, d)).astype(np.float32),
            rng.standard_normal((tk, d)).astype(np.float32),
            rng.standard_normal((tk, d)).astype(np.float32))


# Tk = 1 (one valid key in a tile), 65 (one past a tile: its second tile's
# first step holds one valid key, the next step is skipped), 77 (the
# cross-attention length: 13 valid keys in the last tile) and 1024
@pytest.mark.parametrize("tk", [1, 65, 77, 1024])
def test_blockwise_online_softmax_matches_jax(tk):
    q, k, v = _qkv(tk, 7, tk, 40)
    got, state = blockwise_attention(*map(torch.from_numpy, (q, k, v)))
    want = jax.nn.dot_product_attention(
        *(jnp.asarray(a)[None, :, None, :] for a in (q, k, v)))[0, :, 0]
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    # masked columns added exactly 0: every probability of a key at or
    # past Tk, in every step that ran
    steps = [k0 for k0 in range(0, -(-tk // TILE) * TILE, STEP) if k0 < tk]
    for k0, p in zip(steps, state.probs):
        assert torch.all(p[:, max(tk - k0, 0):] == 0)
        assert torch.isfinite(p).all()


def test_a_row_with_no_valid_key_yet_stays_zero():
    """A step whose keys are all masked, before any valid key, leaves the
    state at 0 (no NaN from -inf - (-inf)); the steps after it give the
    same answer as without it."""
    q, k, v = map(torch.from_numpy, _qkv(5, 4, STEP, 16))
    state = OnlineSoftmax(4, 16, LOG2E / 4.0)
    state.step(q, k, v, kvalid=0)
    assert torch.all(state.o == 0) and torch.all(state.l == 0)
    assert torch.all(state.probs[0] == 0)
    state.step(q, k, v, kvalid=STEP)
    fresh = OnlineSoftmax(4, 16, LOG2E / 4.0)
    fresh.step(q, k, v, kvalid=STEP)
    assert torch.equal(state.o / state.l, fresh.o / fresh.l)


def head_split(h: int, co: int) -> tuple[int, int, int]:
    """(heads a block, blocks a cluster, output columns a block) as
    csrc/fused_mha.cu::head_split computes them."""
    per_block = -(-h // 8)
    cluster = -(-h // per_block)
    cols = -(-(-(-co // cluster)) // 8) * 8
    return per_block, cluster, cols


def column_split_out_projection(o_heads, wo, co: int) -> torch.Tensor:
    """out[:, cols of block j] = Σ_h in order o_h @ Wo[h·D:(h+1)·D, cols],
    block by block; o_heads [H, T, D], wo [H·D, Co] (the reference's
    layout). Every column is written by exactly one block."""
    h, t, d = o_heads.shape
    _, cluster, cols = head_split(h, co)
    out = torch.full((t, co), math.nan)
    for j in range(cluster):
        c0, c1 = j * cols, min(co, (j + 1) * cols)
        if c0 >= c1:
            continue
        assert torch.isnan(out[:, c0:c1]).all()  # not written before
        acc = torch.zeros(t, c1 - c0)
        for hh in range(h):
            acc = acc + o_heads[hh] @ wo[hh * d:(hh + 1) * d, c0:c1]
        out[:, c0:c1] = acc
    assert not torch.isnan(out).any()  # every column written
    return out


# H = 3 (one head a block, a cluster of 3), 8 (the UNet's), 10 (two heads a
# block, a cluster of 5); Co no multiple of 8 x the cluster, and odd
@pytest.mark.parametrize("h,co", [(3, 72), (8, 36), (10, 101)])
def test_column_split_out_projection_matches_jax_reference(h, co):
    b, tq, c, d = 1, 24, 32, 8
    rng = np.random.default_rng(h)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x, wq, wk, wv, wo = (n(b, tq, c, s=0.3), n(c, h * d, s=0.2),
                         n(c, h * d, s=0.2), n(c, h * d, s=0.2),
                         n(h * d, co, s=0.2))
    want = np.asarray(jfm.reference_mha(
        *map(jnp.asarray, (x, x, wq, wk, wv, wo)), num_heads=h,
        head_dim=d))[0]
    xt = torch.from_numpy(x[0])
    q, k, v = (xt @ torch.from_numpy(w) for w in (wq, wk, wv))
    o_heads = torch.stack([
        blockwise_attention(q[:, i * d:(i + 1) * d], k[:, i * d:(i + 1) * d],
                            v[:, i * d:(i + 1) * d])[0] for i in range(h)])
    got = column_split_out_projection(o_heads, torch.from_numpy(wo), co)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
