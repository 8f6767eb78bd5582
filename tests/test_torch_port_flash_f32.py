"""The order flash attention's fp32 form computes in (its core,
polyp_tpu_torch/csrc/attention_core.cuh, namespace f32, which the fused
MHA's fp32 form runs too), written out on the CPU and held against the JAX
package's attention and float64.

* Its index algebra, lane by lane in float64: one warp's m16n8k8 TF32
  fragments (PTX's layout) for QK^T with the K rows each lane reads
  (`key_of_lane`: lanes g = 0..7 take keys 0, 4, 1, 5, 2, 6, 3, 7 of an
  8-key tile) and the head dims each k8 step takes (pairs of steps one
  float4 a row, a last step of 8 a float2), so that lane (g, t) ends
  with the scores of keys t and t + 4, which is where P V's A fragment
  wants them: P is reused from the registers, V's rows read in order, its
  columns in the lanes' float4 groups (`vgroup_of_lane`), and each output
  column written once.
* Its arithmetic in fp32: every product in 3xTF32 (each operand rounded to
  tf32 as cvt.rna does, half away from zero to 10 mantissa bits, plus its
  rounded remainder; small terms first, one k8 step at a time), key tiles
  of 64 split between the plan's key groups (two at d >= 128), the online
  softmax in exp2 of log2-scaled scores with the max kept in raw scores,
  and the groups' states added at the end.

The kernel itself runs only on a card (tests/test_torch_port_cuda.py).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_thread  # noqa: F401

LOG2E = 1.4426950408889634
# the padded widths the kernel is built for
HEAD_DIMS = (16, 32, 40, 48, 64, 80, 96, 112, 128, 160)


KEY_GROUPS = 2  # key groups a row tile (the kernel's Chosen<D>::KS)


KEY_TILE = 64  # keys a tile (Plan<D>::BK)


def key_of_lane(g):
    return 4 * (g & 1) + (g >> 1)


def vgroup_of_lane(g):
    return (g >> 1) + 4 * (g & 1)


def step_dims(d: int) -> list[np.ndarray]:
    """The head dims of each k8 step of QK^T in the kernel's order, as
    [8] arrays whose entry k is the dim of the mma's k index k: step s <
    2 (d // 16) takes 16 (s // 2) + 4t + 2 (s % 2) + {0, 1} as k = t, t + 4;
    d = 40's last step 32 + 2t + {0, 1}."""
    t = np.arange(4)
    pairs = d // 16
    out = []
    for s in range(d // 8):
        base = (16 * (s // 2) + 4 * t + 2 * (s % 2) if s < 2 * pairs
                else 16 * pairs + 2 * t)
        out.append(np.concatenate([base, base + 1]))
    return out


# --- lane by lane, float64 ------------------------------------------------

LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def mma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """m16n8k8 from fragments (PTX ISA, .tf32): a [32, 4], b [32, 2] -> c
    [32, 4]: A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; B[t][g],
    B[t+4][g]; C[g][2t, 2t+1], C[g+8][2t, 2t+1]."""
    A, B = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
    A[G, T], A[G + 8, T], A[G, T + 4], A[G + 8, T + 4] = a.T
    B[T, G], B[T + 4, G] = b.T
    C = A @ B
    return np.stack([C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T],
                     C[G + 8, 2 * T + 1]], 1)


def warp_lanes(q16: np.ndarray, k: np.ndarray, v: np.ndarray, c: float
               ) -> np.ndarray:
    """One warp's 16 query rows over all keys, 8 keys at a time, with the
    kernel's reads, fragments and stores; returns the [16, d] output
    assembled from the lanes' stores (each column written once)."""
    tk, d = k.shape
    pad = -tk % 8
    k = np.concatenate([k, np.zeros((pad, d))])
    v = np.concatenate([v, np.zeros((pad, d))])
    dims = [(s[:4][T], s[4:][T]) for s in step_dims(d)]  # per lane
    qa = [np.stack([q16[G, d0], q16[G + 8, d0], q16[G, d1], q16[G + 8, d1]],
                   1) for d0, d1 in dims]
    g4, rest = d // 32, d % 32
    m = np.full((32, 2), -np.inf)
    l = np.zeros((32, 2))
    acc = np.zeros((d // 8, 32, 4))
    for j0 in range(0, tk + pad, 8):
        key = j0 + key_of_lane(G)
        s = np.zeros((32, 4))
        for qf, (d0, d1) in zip(qa, dims):
            s = s + mma(qf, np.stack([k[key, d0], k[key, d1]], 1))
        # lane (g, t) holds keys t (e = 0, 2) and t + 4 (e = 1, 3)
        keys = j0 + T[:, None] + 4 * (np.arange(4) & 1)
        s = np.where(keys < tk, s, -np.inf)
        mx = np.stack([s[:, :2].max(1), s[:, 2:].max(1)], 1)
        mx = mx.reshape(8, 4, 2).max(1)[G]  # the quad's max
        mn = np.maximum(m, mx)
        base = np.where(mn == -np.inf, 0.0, mn * c)
        with np.errstate(invalid="ignore"):
            alpha = np.exp2(m * c - base)
        m = mn
        p = np.exp2(s * c - np.repeat(base, 2, axis=1))
        l = l * alpha + np.stack([p[:, :2].sum(1), p[:, 2:].sum(1)], 1)
        acc *= np.repeat(alpha, 2, axis=1)[None]
        pa = np.stack([p[:, 0], p[:, 2], p[:, 1], p[:, 3]], 1)
        r0, r1 = j0 + T, j0 + T + 4
        for ci in range(g4):
            col = 32 * ci + 4 * vgroup_of_lane(G)
            for u in range(4):
                acc[4 * ci + u] += mma(pa, np.stack([v[r0, col + u],
                                                     v[r1, col + u]], 1))
        if rest == 16:
            for u in range(2):
                col = 32 * g4 + 2 * G + u
                acc[4 * g4 + u] += mma(pa, np.stack([v[r0, col], v[r1, col]],
                                                    1))
        elif rest == 8:
            col = 32 * g4 + G
            acc[4 * g4] += mma(pa, np.stack([v[r0, col], v[r1, col]], 1))
    out = np.full((16, d), np.nan)
    written = np.zeros((16, d), int)

    def store(rows, cols, vals):
        out[rows, cols] = vals
        np.add.at(written, (rows, cols), 1)

    for r, (e0, e1) in ((G, (0, 1)), (G + 8, (2, 3))):
        for ci in range(g4):
            for u in range(4):
                store(r, 32 * ci + 4 * T + u, acc[4 * ci + u][:, e0])
                store(r, 32 * ci + 16 + 4 * T + u, acc[4 * ci + u][:, e1])
        if rest == 16:
            for u in range(2):
                store(r, 32 * g4 + 4 * T + u, acc[4 * g4 + u][:, e0])
                store(r, 32 * g4 + 4 * T + 2 + u, acc[4 * g4 + u][:, e1])
        elif rest == 8:
            store(r, 32 * g4 + 2 * T, acc[4 * g4][:, e0])
            store(r, 32 * g4 + 2 * T + 1, acc[4 * g4][:, e1])
    assert (written == 1).all()
    rowsum = l.reshape(8, 4, 2).sum(1)  # [g, (row g, row g + 8)]
    return out / np.concatenate([rowsum[:, 0], rowsum[:, 1]])[:, None]


def softmax_attention(q, k, v):
    """softmax(q kᵀ / √d) v in float64."""
    s = q @ k.T / math.sqrt(q.shape[1])
    p = np.exp(s - s.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True) @ v


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("tk", [8, 13, 40])
def test_lanes_hold_the_fragments_the_kernel_reads_and_writes(d, tk):
    """The fragment algebra: scores of keys t and t + 4 in lane (g, t),
    reused as P V's A fragment, V's columns in float4 groups, every output
    column stored once, equal to softmax attention in float64."""
    rng = np.random.default_rng(d + tk)
    q, k, v = (rng.standard_normal((n, d)) for n in (16, tk, tk))
    got = warp_lanes(q, k, v, LOG2E / math.sqrt(d))
    np.testing.assert_allclose(got, softmax_attention(q, k, v), rtol=1e-12,
                               atol=1e-12)


def test_the_lane_orders_pair_up():
    """key_of_lane puts keys t and t + 4 in columns 2t and 2t + 1 of lane
    t's score fragment; the k8 steps cover every head dim once; a half
    warp's float4 reads of K rows and of V columns fall in distinct banks
    at the kernel's row stride d + 4."""
    t = np.arange(4)
    assert (key_of_lane(2 * t) == t).all()
    assert (key_of_lane(2 * t + 1) == t + 4).all()
    for d in HEAD_DIMS:
        assert sorted(np.concatenate(step_dims(d))) == list(range(d))
        ld = d + 4
        for half in (0, 1):  # lanes 16 half .. 16 half + 15, 8 a phase
            for phase in (0, 1):
                lanes = 16 * half + 8 * phase + np.arange(8)
                g, tt = lanes >> 2, lanes & 3
                k_banks = ((key_of_lane(g) * ld + 4 * tt) // 4) % 8
                v_banks = ((tt * ld + 4 * vgroup_of_lane(g)) // 4) % 8
                assert len(set(k_banks)) == 8 and len(set(v_banks)) == 8


# --- the arithmetic, fp32 -------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, at 10 mantissa bits (the low 13 bits of the fp32 pattern
    zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma3(c, a, b):
    """c + a @ b over one k8 step in 3xTF32, small terms first."""
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    return c + as_ @ bb + ab @ bs + ab @ bb


def mma1(c, a, b):
    """... in one TF32 product (what the split avoids)."""
    return c + tf32(a) @ tf32(b)


def flash_f32(q, k, v, product=mma3):
    """softmax(q kᵀ / √d) v for q [Tq, d], k and v [Tk, d] (fp32) in the
    kernel's order: each key group's keys of every tile, k8 steps of QK^T
    in step_dims order, 8-key steps of P V, the online softmax, the
    groups added."""
    tq, d = q.shape
    tk = k.shape[0]
    c = LOG2E / math.sqrt(d)
    bk = KEY_TILE
    kw = bk // KEY_GROUPS
    dims = [torch.from_numpy(s) for s in step_dims(d)]
    states = []
    for k0 in range(0, bk, kw):
        m = torch.full((tq, 1), -math.inf)
        l = torch.zeros(tq, 1)
        o = torch.zeros(tq, d)
        for t0 in range(k0, tk, bk):  # this group's keys of each tile
            kv = min(kw, tk - t0)
            if kv <= 0:
                continue
            kt = torch.zeros(kw, d)
            vt = torch.zeros(kw, d)
            kt[:kv], vt[:kv] = k[t0:t0 + kv], v[t0:t0 + kv]
            s = torch.zeros(tq, kw)
            for dd in dims:
                s = product(s, q[:, dd], kt[:, dd].T)
            s[:, kv:] = -math.inf
            mn = torch.maximum(m, s.amax(1, keepdim=True))
            base = torch.where(mn == -math.inf, torch.zeros_like(mn), mn * c)
            alpha = torch.exp2(m * c - base)
            p = torch.exp2(s * c - base)
            m = mn
            l = l * alpha + p.sum(1, keepdim=True)
            o = o * alpha
            for j in range(0, kw, 8):
                o = product(o, p[:, j:j + 8], vt[j:j + 8])
        states.append((m, l, o))
    m, l, o = states[0]
    for m1, l1, o1 in states[1:]:
        mn = torch.maximum(m, m1)
        base = torch.where(mn == -math.inf, torch.zeros_like(mn), mn * c)
        a, b = torch.exp2(m * c - base), torch.exp2(m1 * c - base)
        m, l, o = mn, l * a + l1 * b, o * a + o1 * b
    return o / l


def _qkv(seed, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((tq, d)).astype(np.float32),
            rng.standard_normal((tk, d)).astype(np.float32),
            rng.standard_normal((tk, d)).astype(np.float32))


def test_tf32_rounds_half_away_from_zero():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    y = torch.randn(1000)
    assert (tf32(y).view(torch.int32) & 0x1FFF == 0).all()
    assert ((tf32(y) - y).abs() <= y.abs() * 2.0 ** -11).all()


# Tq/Tk ragged against the 64-row query tiles, the 64-key tiles and their
# two groups' halves at d = 128; Tk = 17 leaves the second group with no
# valid key
@pytest.mark.parametrize("d", (16, 40, 48, 64, 80, 112, 128))
@pytest.mark.parametrize("tq,tk", [(63, 65), (129, 127), (31, 17)])
def test_3xtf32_order_matches_jax_and_float64(d, tq, tk):
    q, k, v = _qkv(d + tq, tq, tk, d)
    got = flash_f32(*map(torch.from_numpy, (q, k, v))).numpy()
    exact = softmax_attention(*(a.astype(np.float64) for a in (q, k, v)))
    jx = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(a)[None, :, None, :] for a in (q, k, v))))[0, :, 0]
    top = np.abs(exact).max()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4 * top)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-4 * top)


def test_one_tf32_product_is_what_the_split_avoids():
    """The error against float64 of one TF32 product a product beside
    3xTF32's, at the SD level-0 head dim: the split is the smaller."""
    q, k, v = _qkv(1, 128, 256, 40)
    exact = softmax_attention(*(a.astype(np.float64) for a in (q, k, v)))
    err = {name: np.abs(flash_f32(*map(torch.from_numpy, (q, k, v)),
                                  product=fn).numpy() - exact).max()
           / np.abs(exact).max()
           for name, fn in (("3xtf32", mma3), ("1xtf32", mma1))}
    print(f"error / max |y| against float64: {err}")
    assert err["3xtf32"] < err["1xtf32"]
