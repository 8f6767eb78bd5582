"""polyp_tpu_torch's fused MHA (ops/fused_mha.py), its dispatch policy
(ops/attention.py::use_fused_mha) and the UNet's fused branch against their
polyp_tpu twins on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernel runs in interpret mode (the TPU grid and scratch flow, on the
CPU); on CPU tensors the port runs the kernel's plain version. Both sides
compute in fp32, so they differ only in summation order and the order of
the online softmax: tolerances are stated per test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyp_tpu.ops import attention as jatt
from polyp_tpu.ops import fused_mha as jfm
from polyp_tpu.ops import quant as jquant
from polyp_tpu.models.unet_condition import tiny_condition_unet as j_tiny_unet
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import unet_blocks
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
from polyp_tpu_torch.ops import attention as tatt
from polyp_tpu_torch.ops import fused_mha as tfm
from polyp_tpu_torch.ops import quant as tquant
from _torch_threads import _one_thread  # noqa: F401


def _case(seed, b, tq, tk, c, ckv, h, d, co, self_attn=False):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = n(b, tq, c, s=0.3)
    ctx = x if self_attn else n(b, tk, ckv, s=0.3)
    return (x, ctx, n(c, h * d, s=0.1), n(ckv, h * d, s=0.1),
            n(ckv, h * d, s=0.1), n(h * d, co, s=0.1))


def numpy_params(shapes, seed: int):
    """A flax parameter tree of `shapes` filled from numpy: kernels normal
    with std 1/√fan_in, norm scales 1 + N(0, 0.1), biases N(0, 0.1). Much
    cheaper than tracing `init` of a UNet on the CPU."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.standard_normal(leaf.shape).astype(
                np.float32) / np.sqrt(fan_in)
        val = rng.standard_normal(leaf.shape).astype(np.float32) * 0.1
        return val + 1.0 if name == "scale" else val

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# d = 40 (SD level 0) and ragged Tk = 77 (the cross-attention shape, which
# JAX pads to 128 and masks); block sizes of 128 and 256 give the JAX grid
# two q-blocks and one or two k-blocks
@pytest.mark.parametrize("tk,ckv,block,self_attn", [
    (256, 64, 128, True), (77, 48, 256, False), (256, 48, 256, False)])
def test_reference_mha_matches_jax_interpret_kernel(tk, ckv, block,
                                                    self_attn):
    """fp32 on both sides: agreement to 2e-5 absolute on outputs of
    about 0.1 (summation and softmax order only)."""
    args = _case(0, 2, 256, tk, 64, ckv, 2, 40, 64, self_attn=self_attn)
    want = jfm.fused_mha(*map(jnp.asarray, args), num_heads=2, head_dim=40,
                         block_q=block, block_k=block, interpret=True)
    got = tfm.fused_mha(*_t(*args), num_heads=2, head_dim=40)
    assert got.shape == (2, 256, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_fused_mha_linear_is_the_same_function_on_linear_weights():
    """The inner entry on nn.Linear's [out, in] weights equals the public
    one on the reference's [in, out] layout, bit for bit."""
    args = _t(*_case(1, 1, 128, 77, 32, 24, 2, 16, 40))
    x, ctx, wq, wk, wv, wo = args
    a = tfm.fused_mha(*args, num_heads=2, head_dim=16)
    b = tfm.fused_mha_linear(x, ctx, wq.t().contiguous(),
                             wk.t().contiguous(), wv.t().contiguous(),
                             wo.t().contiguous(), num_heads=2, head_dim=16)
    assert torch.equal(a, b)


def test_fused_mha_grads_match_jax_custom_vjp():
    """Gradients to x, ctx and all four weights (the backward recomputes
    through the plain version on both sides): 1e-4 relative to each
    gradient's largest entry."""
    args = _case(2, 1, 256, 77, 32, 24, 2, 16, 32)
    g = np.random.default_rng(3).standard_normal((1, 256, 32)).astype(
        np.float32)

    def jloss(*a):
        out = jfm.fused_mha(*a, num_heads=2, head_dim=16, block_q=128,
                            block_k=128, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [t.requires_grad_() for t in _t(*args)]
    out = tfm.fused_mha(*leaves, num_heads=2, head_dim=16)
    (out * torch.from_numpy(g)).sum().backward()
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


# (name, x tokens, ctx tokens or None for self-attention, head_dim,
# qkv_bias, quant mode, enabled)
POLICY_CASES = [
    ("level0_self", 1024, None, 40, False, None, True),
    ("not_enabled", 1024, None, 40, False, None, False),
    ("cross_attention", 1024, 77, 40, False, None, True),
    ("qkv_bias", 1024, None, 40, True, None, True),
    ("w8a8_static", 1024, None, 40, False, "w8a8_static", True),
    ("w8a8", 1024, None, 40, False, "w8a8", True),
    ("short_t", 256, None, 40, False, None, True),
    ("t_not_multiple_of_128", 1088, None, 40, False, None, True),
    ("t_4096_d80", 4096, None, 80, False, None, True),
    ("head_dim_over_128", 1024, None, 160, False, None, True),
]


@pytest.mark.parametrize("case", POLICY_CASES, ids=[c[0] for c in
                                                    POLICY_CASES])
def test_use_fused_mha_matches_jax_policy(case, monkeypatch):
    """The port's policy against the reference's, with the reference's
    environment opt-in standing for the port's `fused_mha_region` and its
    TPU-backend test answered yes (the port's policy looks at shapes, never
    the device)."""
    _, tq, tk, d, bias, mode, enabled = case
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    if enabled:
        monkeypatch.setenv("POLYP_FUSED_MHA", "1")
    else:
        monkeypatch.delenv("POLYP_FUSED_MHA", raising=False)
    x = np.zeros((2, tq, 320), np.float32)
    ctx = x if tk is None else np.zeros((2, tk, 768), np.float32)
    scales = {} if mode == "w8a8_static" else None
    with jquant.override(mode, scales=scales):
        want = jatt.use_fused_mha(jnp.asarray(x), jnp.asarray(ctx), 8, d,
                                  bias, is_self=tk is None)
    with tquant.override(mode, scales=scales), \
            tatt.fused_mha_region(enabled):
        got = tatt.use_fused_mha(torch.from_numpy(x), torch.from_numpy(ctx),
                                 8, d, bias, is_self=tk is None)
    assert got == want


def test_tiny_unet_with_fused_mha_matches_jax():
    """The tiny UNet at 32×32 latents (T = 1024 at level 0, 2 heads of 16)
    inside fused_mha_region(True), on the CPU, against the JAX UNet with the
    same weights (whose CPU path is the unfused math): fp32, 2e-4 absolute on
    outputs of O(1). A spy shows the three level-0 self-attentions took
    the fused branch and nothing else did."""
    unet = j_tiny_unet(jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 32)).astype(np.float32)
    t = np.array([500], np.int32)
    params = numpy_params(jax.eval_shape(
        unet.init, jax.random.PRNGKey(0), jnp.asarray(x[:, :4, :4]),
        jnp.asarray(t), jnp.asarray(ctx))["params"], seed=5)
    want = jax.jit(unet.apply)({"params": params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(ctx))

    t_unet = tiny_condition_unet().eval()
    t_unet.load_state_dict(timp.unet_from_jax(params), strict=True)
    calls = []

    def spy(x, ctx, *weights, num_heads, head_dim):
        calls.append((tuple(x.shape), ctx is x))
        return tfm.fused_mha_linear(x, ctx, *weights, num_heads=num_heads,
                                    head_dim=head_dim)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp, \
            tatt.fused_mha_region(True):
        mp.setattr(unet_blocks, "fused_mha_linear", spy)
        got = t_unet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                     torch.from_numpy(t).long(), torch.from_numpy(ctx))
    assert calls == [((1, 1024, 32), True)] * 3
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=2e-4)


def test_sampler_opt_in_is_scoped_to_its_unet_calls():
    """A sampler built with fused_mha=True takes the fused branch inside
    its own sampling loop only: the UNet it shares, called directly
    afterwards, and a sampler over it built without the opt-in stay
    unfused (the opt-in is a context variable, not module state). Tiny
    UNet, 32×32 latents (level 0 at T = 1024), one folded DDIM step."""
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.pipeline import StableDiffusionSampler

    torch.manual_seed(0)
    unet = tiny_condition_unet().eval()
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)
    cond = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 16, 32)).astype(np.float32))
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return tfm.fused_mha_linear(*args, **kwargs)

    def run(fused):
        calls.clear()
        sampler = StableDiffusionSampler(
            unet, None, None, None, schedule, image_size=256, num_steps=1,
            guidance_scale=None, fused_mha=fused)
        sampler.denoise(cond, None, 1, torch.Generator().manual_seed(0))
        in_loop = len(calls)
        with torch.no_grad():
            unet(torch.zeros(1, 4, 32, 32), torch.tensor([500]), cond)
        return in_loop, len(calls) - in_loop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet_blocks, "fused_mha_linear", spy)
        assert run(True) == (3, 0)
        assert run(False) == (0, 0)
