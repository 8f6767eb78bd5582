"""polyp_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card, at shapes the main path does not reach: every head dim, ragged
token counts, narrow widths, odd spatial sizes, fp32 GroupNorm, the int8
kernels (W8A8 dense, static and per-token GEGLU, the GroupNorm int8
epilogue) at main-path and ragged shapes, and the fused MHA block at
chip_smoke.py's shapes, ragged ones and every head dim it was built for;
and the EfficientNet classifier's forward and train step against the CPU.

These tests need an NVIDIA card and nvcc; elsewhere they skip. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: bf16 outputs of O(1) values round at ~2^-8 relative, so the
bf16 kernels are held to 2e-2 (attention) and 3e-2 (GEGLU, which also
rounds its hidden activation to bf16) absolute against the plain version
in fp32 on the same bf16 inputs. GroupNorm's outputs reach |y| ≈ 10 with
these affine parameters, so it is held relative to max|y|: 2^-7 (two bf16
ulps) in bf16, 1e-5 in fp32 (summation order only). TF32 is off.
"""

from __future__ import annotations

import ctypes

import pytest
import torch

from polyp_tpu_torch import _build
from polyp_tpu_torch.ops import fused_dense as fd
from polyp_tpu_torch.ops import fused_geglu as fg
from polyp_tpu_torch.ops import fused_gn, quant
from polyp_tpu_torch.ops import fused_mha as fm
from polyp_tpu_torch.ops.attention import dot_product_attention
from polyp_tpu_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS,
    flash_attention,
    reference_attention,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_port_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, scale=1.0, shift=0.0, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale
            + shift).to(dtype)


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk", [(1024, 1024), (200, 130), (64, 77)])
def test_flash_matches_plain(dev, d, tq, tk):
    q = _randn(dev, 2, tq, 3, d, seed=1)
    k = _randn(dev, 2, tk, 3, d, seed=2)
    v = _randn(dev, 2, tk, 3, d, seed=3)
    before = flash_attention.launches
    with torch.no_grad():
        got = flash_attention(q, k, v)
    want = reference_attention(q.float(), k.float(), v.float())
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _max_err(got, want) < 2e-2


# token counts that cut the 128-row query tiles and the 64-key tiles
# raggedly: one token, one past a tile, one short of one, and the
# cross-attention length 77 (its last key tile holds 13 valid keys)
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("tq,tk", [(1, 1), (63, 65), (129, 127), (1000, 1024),
                                   (1024, 77)])
def test_flash_ragged_tiles(dev, d, tq, tk):
    q = _randn(dev, 1, tq, 2, d, seed=7)
    k = _randn(dev, 1, tk, 2, d, seed=8)
    v = _randn(dev, 1, tk, 2, d, seed=9)
    with torch.no_grad():
        got = flash_attention(q, k, v)
    want = reference_attention(q.float(), k.float(), v.float())
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _max_err(got, want) < 2e-2


def test_flash_distilled_batch_repeats_bit_for_bit(dev):
    """The unfused distilled shape [16, 1024, 8, 40] against the plain
    version, and two runs give the same bits (no atomics, fixed order)."""
    q, k, v = (_randn(dev, 16, 1024, 8, 40, seed=s) for s in (10, 11, 12))
    with torch.no_grad():
        a = flash_attention(q, k, v)
        b = flash_attention(q, k, v)
    want = reference_attention(q.float(), k.float(), v.float())
    assert _max_err(a, want) < 2e-2
    assert torch.equal(a, b)


def test_flash_backward_recomputes_plain(dev):
    q, k, v = (_randn(dev, 1, 128, 2, 64, seed=s).requires_grad_()
               for s in (4, 5, 6))
    flash_attention(q, k, v).float().square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    reference_attention(q, k, v).float().square().sum().backward()
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        # same plain backward; only the saved forward output differs
        assert _max_err(a, b) < 2e-2 * b.float().abs().max().item()


def test_flash_at_the_train_batch_forward_and_backward(dev):
    """The LoRA train step's level-0 self-attention, [8, 1024, 8, 40]: the
    forward kernel against the plain version in fp32, and its backward
    (the plain version recomputed) against the plain version's own
    backward on the same bf16 inputs."""
    q, k, v = (_randn(dev, 8, 1024, 8, 40, seed=s).requires_grad_()
               for s in (7, 8, 9))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    want = reference_attention(q.float(), k.float(), v.float())
    assert _max_err(out, want) < 2e-2
    grad = _randn(dev, 8, 1024, 8, 40, seed=10)
    got = torch.autograd.grad(out, (q, k, v), grad)
    plain = torch.autograd.grad(reference_attention(q, k, v), (q, k, v),
                                grad)
    assert flash_attention.launches == before + 1  # no kernel backward
    for a, b in zip(got, plain):
        assert torch.isfinite(a).all()
        assert _max_err(a, b) < 2e-2 * b.float().abs().max().item()


def test_flash_refuses_what_it_cannot_do(dev):
    q = _randn(dev, 1, 1024, 2, 64)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, is_causal=True)
    with pytest.raises(ValueError):
        flash_attention(q.float(), q.float(), q.float())  # kernel is bf16
    with pytest.raises(ValueError):
        flash_attention(*(_randn(dev, 1, 1024, 2, 32),) * 3)  # head dim


def test_dispatch_sends_level0_self_attention_to_the_kernel(dev):
    q = _randn(dev, 2, 1024, 8, 40)
    ctx = _randn(dev, 2, 77, 8, 40)
    before = flash_attention.launches
    with torch.no_grad():
        dot_product_attention(q, q, q)
        dot_product_attention(q, ctx, ctx)  # cross-attention stays plain
        dot_product_attention(q, q, q, is_causal=True)
    assert flash_attention.launches == before + 1


def _geglu_args(dev, t, c, h):
    x = _randn(dev, 1, t, c, seed=1)
    w1 = _randn(dev, 2 * h, c, scale=c ** -0.5, seed=2)
    b1 = _randn(dev, 2 * h, scale=0.1, seed=3)
    w2 = _randn(dev, c, h, scale=h ** -0.5, seed=4)
    b2 = _randn(dev, c, scale=0.1, seed=5)
    return x, w1, b1, w2, b2


# The GEMM core's tile plans (gemm_core.cuh::plan, fused_geglu.cu): blocks
# of 128 rows (two warpgroups) where T has them and the tiles are many (T >=
# 308 in the first launch; T = 1024 at C = 1280 and T = 4096 in the second),
# else 64; the first launch takes 128 hidden units a block, or 64 where
# that leaves SMs idle; the second takes 160, 128 or 64 output columns (C =
# 320/640/1280, 768, 64/40) and splits H over a cluster of 2, 4 or 8 blocks
# where the tiles are few (T = 77 at C = 64: 2; T = 308 at C = 640: 4; T =
# 64 or 16 at C = 1280: 8; T = 1024 at C = 1280: 2 of 128 rows), with rings
# that wrap (more K chunks than stages) and persistent blocks walking
# several tiles (T = 4096); T ragged (1, 5, 77, 308, 1000) and aligned.
@pytest.mark.parametrize("t,c,h", [(77, 64, 256), (1000, 320, 1280),
                                   (2000, 320, 1280), (64, 1280, 5120),
                                   (5, 40, 80), (1, 320, 1280),
                                   (308, 640, 2560), (16, 1280, 5120),
                                   (300, 768, 3072), (4096, 320, 1280),
                                   (1024, 1280, 5120)])
def test_geglu_matches_plain(dev, t, c, h):
    args = _geglu_args(dev, t, c, h)
    before = fg.fused_geglu.launches
    with torch.no_grad():
        got = fg.fused_geglu(*args)
    want = fg.reference_geglu(*(a.float() for a in args))
    assert fg.fused_geglu.launches == before + 1
    assert got.shape == args[0].shape
    assert _max_err(got, want) < 3e-2
    # against the plain version on the same bf16 inputs, which rounds h to
    # bf16 where the kernel does: two bf16 ulps of max |y| (sum order, erff,
    # and a rare h rounded the other way)
    same = fg.reference_geglu(*args)
    assert _max_err(got, same) <= 2 ** -7 * same.float().abs().max().item()


@pytest.mark.parametrize("t,c,h", [(16384, 320, 1280), (64, 1280, 5120)])
def test_geglu_repeats_bit_for_bit(dev, t, c, h):
    """Level 0 at the distilled batch 16 (one block a tile) and the mid
    block at the CFG batch (K split over a cluster of 8): the sums run in
    a fixed order, so two runs give the same bits."""
    args = _geglu_args(dev, t, c, h)
    with torch.no_grad():
        a = fg.fused_geglu(*args)
        b = fg.fused_geglu(*args)
    assert torch.equal(a, b)


def test_geglu_refuses_what_it_cannot_do(dev):
    x, w1, b1, w2, b2 = _geglu_args(dev, 8, 64, 256)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bf16"):
            fg.fused_geglu(x.float(), w1, b1, w2, b2)
        with pytest.raises(ValueError, match="shapes do not match"):
            fg.fused_geglu(x, w1[:-8], b1, w2, b2)
        with pytest.raises(ValueError, match="divisible by 8"):
            args = _geglu_args(dev, 8, 36, 144)
            fg.fused_geglu(*args)
        with pytest.raises(ValueError, match="16-byte aligned"):
            flat = torch.empty(8 * 64 + 1, dtype=torch.bfloat16, device=dev)
            fg.fused_geglu(flat[1:].view(1, 8, 64), w1, b1, w2, b2)


def test_geglu_refuses_grad(dev):
    w = _randn(dev, 128, 64).requires_grad_()
    x = _randn(dev, 1, 8, 64)
    with pytest.raises(RuntimeError, match="inference-only"):
        fg.fused_geglu(x, w, w[:, 0], w[:64, :64], w[:64, 0])


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2 ** -7),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("n,c,h,w,act", [(2, 320, 32, 32, "silu"),
                                         (1, 48, 7, 5, None),
                                         (3, 2560, 4, 4, "silu")])
def test_group_norm_matches_plain(dev, dtype, rel, n, c, h, w, act):
    x = _randn(dev, n, c, h, w, scale=2.0, shift=0.3, dtype=dtype)
    gamma = _randn(dev, c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = _randn(dev, c, scale=0.2, dtype=torch.float32)
    before = fused_gn.fused_group_norm.launches
    with torch.no_grad():
        got = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-5, act)
    want = fused_gn.group_norm(x.float(), gamma, beta, 32, 1e-5, act)
    assert fused_gn.fused_group_norm.launches == before + 1
    assert got.dtype == dtype
    assert _max_err(got, want) <= rel * want.abs().max().item()


# every GroupNorm shape of a VAE encode at 256px, at the train batch 8
@pytest.mark.parametrize("c,hw", [(128, 256), (128, 128), (256, 128),
                                  (256, 64), (512, 64), (512, 32)])
def test_group_norm_at_the_encoder_shapes(dev, c, hw):
    x = _randn(dev, 8, c, hw, hw, scale=2.0, shift=0.3)
    gamma = _randn(dev, c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = _randn(dev, c, scale=0.2, dtype=torch.float32)
    with torch.no_grad():
        got = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-6, "silu")
    want = fused_gn.group_norm(x.float(), gamma, beta, 32, 1e-6, "silu")
    assert _max_err(got, want) <= 2 ** -7 * want.abs().max().item()


def test_lora_train_step_runs_its_kernels(dev):
    """A tiny bf16 stack on the card, one LoRA train step: the frozen VAE
    encode launches the GroupNorm kernel once a GroupNorm of its encoder,
    the differentiated UNet no GEGLU kernel; the loss is finite and the
    stack's weights are bit-equal after."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.sd_common import make_components
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.lora import LoRAConfig, init_lora
    from polyp_tpu_torch.models.unet_blocks import GroupNorm
    from polyp_tpu_torch.train import sd_finetune as sf

    stack = load_sd_stack(None, dtype=torch.bfloat16, tiny=True, seed=0)
    before = {k: v.clone() for k, v in stack.unet.state_dict().items()}
    cfg = DiffusionConfig(num_epochs=1, lora_dropout=0.3).with_schedule(2)
    lcfg = LoRAConfig(4, None, 0.3, cfg.modules_lora)
    bundle = sf.init_trainable(init_lora(
        stack.unet, lcfg, torch.Generator(dev).manual_seed(0)))
    state = sf.create_sd_train_state(cfg, bundle)
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                           device=dev)
    gn, geglu = fused_gn.fused_group_norm.launches, fg.fused_geglu.launches
    state, loss = sf.sd_lora_train_step(
        state, make_components(stack, bundle),
        DiffusionSchedule.create(1000, "scaled_linear", 0.00085, 0.012),
        images, torch.as_tensor(stack.tokenizer(["a polyp"]), device=dev),
        None, sf.step_draws(0, 0, 0, dev), lcfg)
    encoder_gn = sum(isinstance(m, GroupNorm)
                     for m in stack.vae.encoder.modules())
    assert fused_gn.fused_group_norm.launches - gn == encoder_gn
    assert fg.fused_geglu.launches == geglu
    assert torch.isfinite(loss)
    for k, v in stack.unet.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# int8 (W8A8) kernels against their plain versions, which run on the CPU on
# the same inputs (exact int32 sums; torch._int_mm's CUDA shape rules do not
# apply there). The kernels return bf16, which rounds at 2^-9 relative, and
# may break a rounding tie of a quantized intermediate the other way (one
# code): held to relative L2 4e-3 and max |err| ≤ 2^-6 · max |y|. The
# GroupNorm epilogue's codes: at most one apart, in at most 0.2% of the
# elements (its y differs from the plain version's in the last bits: __expf,
# summation order).
# ---------------------------------------------------------------------------


def _q8_close(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 4e-3, rel
    assert _max_err(got, want) <= 2 ** -6 * want.abs().max().item()


def _amax_scale(x):
    return (x.float().abs().amax() * 1.05 / 127).reshape(())


# every width the tile plan picks (160 at O = 320/640/1280, 128 at O = 72,
# 64 at O = 64), K split over a cluster (M = 64 and 16 at C = 1280: 4; M =
# 77 at C = 768: 2), rings that wrap (C = 1280 at M = 4096, C = 2560), and
# ragged M (1, 5, 77, 308, 1000) and C (320 = 2.5 chunks of 128).
@pytest.mark.parametrize("m,c,o", [(4096, 320, 320), (308, 768, 320),
                                   (1024, 640, 640), (5, 64, 72),
                                   (130, 1280, 1280), (1, 320, 320),
                                   (77, 768, 1280), (64, 1280, 1280),
                                   (16, 1280, 1280), (4096, 1280, 1280),
                                   (1000, 2560, 1280), (300, 64, 64)])
@pytest.mark.parametrize("int8_in", [False, True])
def test_w8a8_dense_matches_plain(dev, m, c, o, int8_in):
    x = _randn(dev, m, c, seed=1)
    wq, sw = quant.weight_q8_matrix(_randn(dev, o, c, scale=c ** -0.5,
                                           seed=2))
    bias = _randn(dev, o, scale=0.1, seed=3)
    s = _amax_scale(x)
    if int8_in:
        x = quant.quantize_activation(x, s)[0]
    before = fd.fused_w8a8_dense.launches
    with torch.no_grad():
        got = fd.fused_w8a8_dense(x, wq, sw, bias, s,
                                  out_dtype=torch.bfloat16)
    want = fd.reference_w8a8_dense(*(t.cpu() for t in (x, wq, sw, bias, s)),
                                   out_dtype=torch.float32)
    assert fd.fused_w8a8_dense.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, o)
    _q8_close(got, want)


@pytest.mark.parametrize("m,c,o", [(32768, 320, 320), (64, 1280, 1280)])
@pytest.mark.parametrize("int8_in", [False, True])
def test_w8a8_dense_repeats_bit_for_bit(dev, m, c, o, int8_in):
    """to_q at the distilled batch 32 and level 2 at the CFG batch (K split
    over a cluster): a fixed order of sums, so the same bits twice."""
    x = _randn(dev, m, c, seed=1)
    wq, sw = quant.weight_q8_matrix(_randn(dev, o, c, scale=c ** -0.5,
                                           seed=2))
    s = _amax_scale(x)
    if int8_in:
        x = quant.quantize_activation(x, s)[0]
    with torch.no_grad():
        a = fd.fused_w8a8_dense(x, wq, sw, None, s, out_dtype=torch.bfloat16)
        b = fd.fused_w8a8_dense(x, wq, sw, None, s, out_dtype=torch.bfloat16)
    assert torch.equal(a, b)


def _q8_geglu_case(dev, t, c, h):
    x = _randn(dev, 1, t, c, seed=1)
    w1 = _randn(dev, 2 * h, c, scale=c ** -0.5, seed=2)
    b1 = _randn(dev, 2 * h, scale=0.1, seed=3)
    w2 = _randn(dev, c, h, scale=h ** -0.5, seed=4)
    b2 = _randn(dev, c, scale=0.1, seed=5)
    q1, q2 = quant.weight_q8_matrix(w1), quant.weight_q8_matrix(w2)
    return x, (*q1, b1, *q2, b2), (w1, b1, w2, b2)


# the static form: 128-token panels at C <= 640 and T >= 128 (ragged last
# panels at T = 130, 300, 1000), 64 at C > 640 or small T (1, 16, 64, 77);
# hidden tiles split over 1 block (T = 32768) up to 40 (the mid block) a
# panel; the widest C whose panel fits (2560); the second launch is the
# dense with K = H, split over a cluster where its tiles are few; every
# main-path shape of batches 4 and 32
@pytest.mark.parametrize("t,c,h", [(77, 64, 256), (1000, 320, 1280),
                                   (4096, 320, 1280), (64, 1280, 5120),
                                   (300, 640, 2560), (1, 320, 1280),
                                   (130, 320, 1280), (1024, 640, 2560),
                                   (256, 1280, 5120), (16, 1280, 5120),
                                   (300, 768, 3072), (32768, 320, 1280),
                                   (8192, 640, 2560), (2048, 1280, 5120),
                                   (512, 1280, 5120), (8, 2560, 64)])
def test_geglu_w8a8_matches_plain(dev, t, c, h):
    x, weights, (w1, b1, w2, b2) = _q8_geglu_case(dev, t, c, h)
    s1 = _amax_scale(x)
    a, gate = torch.nn.functional.linear(x.float(), w1.float(),
                                         b1.float()).chunk(2, dim=-1)
    s2 = _amax_scale(a * torch.nn.functional.gelu(gate))
    before = fg.fused_geglu_w8a8.launches
    with torch.no_grad():
        got = fg.fused_geglu_w8a8(x, *weights, s1, s2)
    want = fg.reference_geglu_w8a8(*(w.cpu() for w in (x, *weights, s1, s2)),
                                   out_dtype=torch.float32)
    assert fg.fused_geglu_w8a8.launches == before + 1
    assert got.shape == x.shape
    _q8_close(got, want)


@pytest.mark.parametrize("t,c,h", [(32768, 320, 1280), (64, 1280, 5120)])
def test_geglu_w8a8_repeats_bit_for_bit(dev, t, c, h):
    """Level 0 at the distilled batch 32 and the mid block at the CFG batch
    (hidden tiles split over 40 blocks, the second product's K over a
    cluster): sums in a fixed order, so the same bits twice."""
    x, weights, (w1, b1, w2, b2) = _q8_geglu_case(dev, t, c, h)
    s1 = _amax_scale(x)
    s2 = torch.tensor(0.02, device=dev)
    with torch.no_grad():
        a = fg.fused_geglu_w8a8(x, *weights, s1, s2)
        b = fg.fused_geglu_w8a8(x, *weights, s1, s2)
    assert torch.equal(a, b)


def test_geglu_w8a8_refuses_what_it_cannot_do(dev):
    """A CUDA tensor the static kernel cannot take raises; nothing falls
    back to the plain version."""
    # C = 2688: a 64-row panel of 21 chunks leaves no room for two rings of
    # two stages (C = 2560 is the widest that fits)
    x, weights, _ = _q8_geglu_case(dev, 8, 2688, 64)
    s = torch.tensor(0.02, device=dev)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="static W8A8 GEGLU kernel"):
            fg.fused_geglu_w8a8(x, *weights, s, s)
        x, weights, _ = _q8_geglu_case(dev, 8, 64, 256)
        with pytest.raises(ValueError, match="0-d fp32 on x's device"):
            fg.fused_geglu_w8a8(x, *weights, s.cpu(), s)
        with pytest.raises(ValueError, match="16-byte aligned"):
            flat = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16, device=dev)
            fg.fused_geglu_w8a8(flat[1:].view(1, 8, 64), *weights, s, s)
        with pytest.raises(ValueError, match="divisible by 16"):
            x, weights, _ = _q8_geglu_case(dev, 8, 72, 288)
            fg.fused_geglu_w8a8(x, *weights, s, s)


# the per-token form: 64-token panels whose hidden tiles a block takes in
# whole groups of block_h (640 at C = 320, 512 at 640 and 1280, H itself
# where no multiple of 128 divides H); the four CFG batch-4 shapes (a panel's
# groups split over 2, 5, 10 and 10 blocks), ragged T (77, 130, 300, 1000:
# the last panel part full), H = 272 (one group whose last tile ends inside
# it), H = 64 (one tile: one warpgroup has none), a panel split over 5
# blocks (T = 200 at C = 640), and the widest C whose panel fits (2432)
@pytest.mark.parametrize("t,c,h", [(77, 64, 256), (1000, 320, 1280),
                                   (64, 1280, 5120), (300, 640, 2560),
                                   (4096, 320, 1280), (1024, 640, 2560),
                                   (256, 1280, 5120), (130, 64, 272),
                                   (200, 640, 2560), (40, 128, 64),
                                   (8, 2432, 64)])
def test_geglu_w8a8_pt_matches_plain(dev, t, c, h):
    x, weights, _ = _q8_geglu_case(dev, t, c, h)
    before = fg.fused_geglu_w8a8_pt.launches
    with torch.no_grad():
        got = fg.fused_geglu_w8a8_pt(x, *weights)
    want = fg.reference_geglu_w8a8_pt(*(w.cpu() for w in (x, *weights)),
                                      out_dtype=torch.float32)
    assert fg.fused_geglu_w8a8_pt.launches == before + 1
    assert got.shape == x.shape
    _q8_close(got, want)


def _pt_codes_on_card(x, wq1, sw1, b1):
    """The per-token form's first launch alone (polyp_geglu_w8a8_pt_up):
    h's codes [T, H] and group scales [T, G] from its workspace."""
    lib = _build.library()
    t, c = x.numel() // x.shape[-1], x.shape[-1]
    h = wq1.shape[0] // 2
    bh = fg.block_h(c, h)
    ws = torch.empty(lib.polyp_geglu_w8a8_workspace(t, c, h, bh),
                     dtype=torch.uint8, device=x.device)
    err = lib.polyp_geglu_w8a8_pt_up(x.data_ptr(), wq1.data_ptr(),
                                     sw1.data_ptr(), b1.data_ptr(),
                                     ws.data_ptr(), t, c, h, bh,
                                     _build.stream_of(x))
    _build.check(err, "per-token W8A8 GEGLU launch 1")
    sh_at = (t * h + 15) // 16 * 16
    codes = ws[:t * h].view(torch.int8).view(t, h)
    sh = ws[sh_at:sh_at + t * (h // bh) * 4].view(torch.float32)
    return codes, sh.view(t, h // bh)


@pytest.mark.parametrize("t,c,h", [(4096, 320, 1280), (64, 1280, 5120),
                                   (130, 64, 272), (1000, 320, 1280)])
def test_geglu_w8a8_pt_launches_match_their_plain_versions(dev, t, c, h):
    """Launch 1 against reference_geglu_w8a8_pt_codes (on the CPU from the
    same inputs): the group scales agree to 1e-6 relative (h's last bits
    follow the two erf implementations) and the codes agree but at ties
    (at most one apart, in at most 0.1% of them). Launch 2 against
    reference_geglu_w8a8_pt_down on the card's own codes and scales: the
    same products, scale products and adds in the same order and roundings,
    so the same bf16 bits."""
    x, (wq1, sw1, b1, wq2, sw2, b2), _ = _q8_geglu_case(dev, t, c, h)
    with torch.no_grad():
        codes, sh = _pt_codes_on_card(x, wq1, sw1, b1)
        out = fg.fused_geglu_w8a8_pt(x, wq1, sw1, b1, wq2, sw2, b2)
    torch.cuda.synchronize()
    want_q, want_s = fg.reference_geglu_w8a8_pt_codes(
        *(w.cpu() for w in (x, wq1, sw1, b1)))
    torch.testing.assert_close(sh.cpu(), want_s, rtol=1e-6, atol=0)
    diff = (codes.cpu().int() - want_q.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3
    down = fg.reference_geglu_w8a8_pt_down(
        codes.cpu(), sh.cpu(), *(w.cpu() for w in (wq2, sw2, b2)),
        torch.bfloat16)
    assert torch.equal(out.reshape(t, c).cpu(), down)


@pytest.mark.parametrize("t,c,h", [(4096, 320, 1280), (64, 1280, 5120)])
def test_geglu_w8a8_pt_repeats_bit_for_bit(dev, t, c, h):
    """CFG level 0 and the mid block (one group a block, ten blocks a
    panel): every sum in a fixed order, so the same bits twice."""
    x, weights, _ = _q8_geglu_case(dev, t, c, h)
    with torch.no_grad():
        a = fg.fused_geglu_w8a8_pt(x, *weights)
        b = fg.fused_geglu_w8a8_pt(x, *weights)
    assert torch.equal(a, b)


def test_geglu_w8a8_pt_refuses_what_it_cannot_do(dev):
    """A shape the per-token kernel cannot take raises with the C side's
    error; nothing falls back to the plain version."""
    # C = 2560: a 64-row panel of 20 chunks and its row statistics leave no
    # room for two rings of two stages (C = 2432 is the widest that fits)
    x, weights, _ = _q8_geglu_case(dev, 8, 2560, 64)
    before = fg.fused_geglu_w8a8_pt.launches
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="per-token W8A8 GEGLU kernel"):
            fg.fused_geglu_w8a8_pt(x, *weights)
        with pytest.raises(ValueError, match="divisible by 16"):
            x, weights, _ = _q8_geglu_case(dev, 8, 72, 288)
            fg.fused_geglu_w8a8_pt(x, *weights)
    assert fg.fused_geglu_w8a8_pt.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,h,w,act", [(4, 320, 32, 32, "silu"),
                                         (1, 48, 7, 5, None),
                                         (4, 2560, 4, 4, "silu")])
def test_group_norm_q8_matches_plain(dev, dtype, n, c, h, w, act):
    x = _randn(dev, n, c, h, w, scale=2.0, shift=0.3, dtype=dtype)
    gamma = _randn(dev, c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = _randn(dev, c, scale=0.2, dtype=torch.float32)
    y = fused_gn.group_norm(x.float(), gamma, beta, 32, 1e-5, act)
    s = _amax_scale(y)
    before = fused_gn.fused_group_norm.launches
    with torch.no_grad():
        got = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-5, act,
                                        act_scale=s)
    want = fused_gn.reference_gn_q8(x, gamma, beta, s, 32, 1e-5, act)
    assert fused_gn.fused_group_norm.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == x.shape
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 2e-3


# GroupNorm's plan by group size (bf16 unless marked): one block a group up
# to 64 KB (every UNet shape); a cluster of 2 (128 KB groups), 4 (256 KB) or
# 8 (512 KB: the VAE's 128² and 256² levels, slices of 64 KB, kept whole;
# 1 MB: slices of 128 KB, half kept); fp32 groups of 2 MB (a quarter of
# each 256 KB slice kept, the rest read again); H·W no multiple of the
# vector (one element a thread) with a cluster
@pytest.mark.parametrize("n,c,h,w,dtype,cluster,kept", [
    (2, 320, 32, 32, torch.bfloat16, 1, 1.0),
    (1, 32, 256, 256, torch.bfloat16, 2, 1.0),
    (1, 32, 256, 512, torch.bfloat16, 4, 1.0),
    (2, 128, 256, 256, torch.bfloat16, 8, 1.0),
    (1, 256, 256, 256, torch.bfloat16, 8, 0.5),
    (1, 256, 256, 256, torch.float32, 8, 0.25),
    (1, 32, 256, 256, torch.float32, 4, 1.0),
    (1, 32, 255, 257, torch.bfloat16, 2, 1.0),
    (2, 512, 64, 64, torch.bfloat16, 2, 1.0),
    (2, 512, 128, 128, torch.bfloat16, 8, 1.0),
    (2, 256, 128, 128, torch.bfloat16, 4, 1.0)])
def test_group_norm_cluster_plans_match_plain(dev, n, c, h, w, dtype,
                                              cluster, kept):
    x = _randn(dev, n, c, h, w, scale=2.0, shift=0.3, dtype=dtype)
    gamma = _randn(dev, c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = _randn(dev, c, scale=0.2, dtype=torch.float32)
    k, vecs, kept_vecs, _ = _gn_plan(c, h * w, dtype)
    assert (k, kept_vecs / vecs) == (cluster, kept)
    with torch.no_grad():
        got = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-6, "silu")
        again = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-6, "silu")
    want = fused_gn.group_norm(x.float(), gamma, beta, 32, 1e-6, "silu")
    rel = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert _max_err(got, want) <= rel * want.abs().max().item()
    assert torch.equal(got, again)  # the cluster's sums in a fixed order


def _gn_plan(c, hw, dtype):
    """csrc/fused_gn.cu's plan for 32 groups: (cluster, the largest slice's
    vectors, those kept in shared memory, threads a block)."""
    out = (ctypes.c_longlong * 4)()
    _build.library().polyp_group_norm_plan(c, hw, 32,
                                           int(dtype == torch.bfloat16), out)
    return tuple(out)


@pytest.mark.parametrize("n,c,h,w", [(2, 128, 256, 256), (4, 320, 32, 32)])
def test_group_norm_q8_cluster_codes(dev, n, c, h, w):
    x = _randn(dev, n, c, h, w, scale=2.0, shift=0.3)
    gamma = _randn(dev, c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = _randn(dev, c, scale=0.2, dtype=torch.float32)
    s = _amax_scale(fused_gn.group_norm(x.float(), gamma, beta, 32, 1e-5,
                                        "silu"))
    with torch.no_grad():
        got = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu",
                                        act_scale=s)
        again = fused_gn.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu",
                                          act_scale=s)
    want = fused_gn.reference_gn_q8(x, gamma, beta, s, 32, 1e-5, "silu")
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 2e-3
    assert torch.equal(got, again)


def test_group_norm_refuses_what_it_cannot_do(dev):
    x = _randn(dev, 2, 64, 8, 8)
    gamma = torch.ones(64, device=dev)
    with torch.no_grad():
        with pytest.raises(ValueError, match="fp32 or bf16 NCHW"):
            fused_gn.fused_group_norm(x.half(), gamma, gamma, 32)
        with pytest.raises(ValueError, match="0-d fp32"):
            fused_gn.fused_group_norm(x, gamma, gamma, 32,
                                      act_scale=torch.tensor(0.1))
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_gn.fused_group_norm(x, gamma.requires_grad_(), gamma, 32)


def test_int8_kernels_refuse_what_they_cannot_do(dev):
    x = _randn(dev, 40, 72)  # C not a multiple of 16
    wq, sw = quant.weight_q8_matrix(_randn(dev, 64, 72))
    with pytest.raises(ValueError, match="C % 16"):
        fd.fused_w8a8_dense(x, wq, sw, None, _amax_scale(x))
    with pytest.raises(ValueError, match="bf16 or int8"):
        fd.fused_w8a8_dense(x.float(), wq, sw, None, _amax_scale(x))
    with pytest.raises(ValueError, match="fp32 on x's device"):
        fd.fused_w8a8_dense(_randn(dev, 40, 64), *quant.weight_q8_matrix(
            _randn(dev, 64, 64)), None, torch.tensor(0.1))
    with pytest.raises(ValueError, match="O % 8"):
        fd.fused_w8a8_dense(_randn(dev, 40, 64), *quant.weight_q8_matrix(
            _randn(dev, 36, 64)), None, _amax_scale(x))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(40 * 64 + 1, dtype=torch.int8, device=dev)
        fd.fused_w8a8_dense(flat[1:].view(40, 64), *quant.weight_q8_matrix(
            _randn(dev, 64, 64)), None, _amax_scale(x),
            out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="M > 16"):
        quant.int_mm(torch.zeros(8, 64, dtype=torch.int8, device=dev),
                     torch.zeros(64, 64, dtype=torch.int8, device=dev))


# ---------------------------------------------------------------------------
# fused MHA block against its plain version in fp32 on the same bf16
# inputs. The kernel rounds Q (after the scale), K, V, the probabilities,
# each head's output and the result to bf16 (2^-9 relative each), as the
# plain bf16 version does at the same places: held to 2e-2 of max |y|. A
# wrong tile, mask or head column gives O(1) of max |y|.
# ---------------------------------------------------------------------------


def _mha_case(dev, b, tq, c, tk, ckv, h, d, co):
    x = _randn(dev, b, tq, c, seed=1)
    ctx = x if tk is None else _randn(dev, b, tk, ckv, seed=2)
    ckv = c if tk is None else ckv
    wq = _randn(dev, h * d, c, scale=c ** -0.5, seed=3)
    wk = _randn(dev, h * d, ckv, scale=ckv ** -0.5, seed=4)
    wv = _randn(dev, h * d, ckv, scale=ckv ** -0.5, seed=5)
    wo = _randn(dev, co, h * d, scale=(h * d) ** -0.5, seed=6)
    return x, ctx, wq, wk, wv, wo


# (b, tq, c, tk or None for self-attention, ckv, heads, d, co): the CFG and
# distilled level-0 shapes, 512px levels 0 and 1, the 77-token ragged KV,
# d = 64, and ragged Tq / Co that are no multiple of the 64-row tiles
@pytest.mark.parametrize("b,tq,c,tk,ckv,h,d,co", [
    (4, 1024, 320, None, 0, 8, 40, 320),
    (16, 1024, 320, None, 0, 8, 40, 320),
    (2, 4096, 320, None, 0, 8, 40, 320),
    (4, 1024, 640, None, 0, 8, 80, 640),
    (4, 1024, 320, 77, 768, 8, 40, 320),
    (2, 256, 128, None, 0, 2, 64, 128),
    (1, 200, 64, 130, 40, 3, 40, 72),
    # more heads than one cluster of 8 blocks: two heads a block, five
    # blocks; then nine heads (the last block takes one); Co no multiple of
    # 8 x the cluster, and an odd Co
    (2, 256, 128, None, 0, 10, 64, 200),
    (1, 130, 64, 77, 48, 10, 64, 101),
    (1, 192, 96, None, 0, 9, 40, 90),
])
def test_fused_mha_matches_plain(dev, b, tq, c, tk, ckv, h, d, co):
    args = _mha_case(dev, b, tq, c, tk, ckv, h, d, co)
    before = fm.fused_mha.launches
    with torch.no_grad():
        got = fm.fused_mha_linear(*args, num_heads=h, head_dim=d)
    want = fm.reference_mha_linear(*(a.float() for a in args), num_heads=h,
                                   head_dim=d)
    assert fm.fused_mha.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, tq, co)
    assert _max_err(got, want) <= 2e-2 * want.abs().max().item()


def test_fused_mha_public_layout_and_repeatability(dev):
    """The reference's [in, out] layout gives the same bits as the
    nn.Linear layout, and two runs repeat bit for bit (fixed-order sums, no
    atomics)."""
    x, ctx, wq, wk, wv, wo = _mha_case(dev, 2, 1024, 320, None, 0, 8, 40,
                                       320)
    with torch.no_grad():
        a = fm.fused_mha_linear(x, ctx, wq, wk, wv, wo, num_heads=8,
                                head_dim=40)
        b = fm.fused_mha_linear(x, ctx, wq, wk, wv, wo, num_heads=8,
                                head_dim=40)
        c = fm.fused_mha(x, ctx, wq.t(), wk.t(), wv.t(), wo.t(),
                         num_heads=8, head_dim=40)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_fused_mha_refuses_what_it_cannot_do(dev):
    x, ctx, wq, wk, wv, wo = _mha_case(dev, 1, 128, 64, None, 0, 2, 32, 64)
    with pytest.raises(ValueError, match="head dims"):
        fm.fused_mha_linear(x, ctx, wq, wk, wv, wo, num_heads=2, head_dim=32)
    x, ctx, wq, wk, wv, wo = _mha_case(dev, 1, 128, 80, None, 0, 2, 40, 80)
    with pytest.raises(ValueError, match="bf16"):
        fm.fused_mha_linear(x.float(), ctx.float(), wq, wk, wv, wo,
                            num_heads=2, head_dim=40)
    with pytest.raises(ValueError, match="do not match"):
        fm.fused_mha_linear(x, ctx, wq[:40], wk, wv, wo, num_heads=2,
                            head_dim=40)
    with pytest.raises(ValueError, match="do not match"):
        fm.fused_mha_linear(x, ctx, wq, wk, wv, wo, num_heads=1,
                            head_dim=40)


def test_attention_module_takes_the_fused_kernel_where_enabled(dev):
    from polyp_tpu_torch.models.unet_blocks import Attention
    from polyp_tpu_torch.ops.attention import fused_mha_region

    attn = Attention(320, 8, 40, dtype=torch.bfloat16, device=dev)
    x = _randn(dev, 2, 1024, 320, seed=7)
    ctx = _randn(dev, 2, 77, 320, seed=8)
    before = fm.fused_mha.launches, flash_attention.launches
    with torch.no_grad():
        plain = attn(x)
        with fused_mha_region(True):
            fused = attn(x)
            attn(x, ctx)  # cross-attention stays unfused
    assert (fm.fused_mha.launches, flash_attention.launches) == (
        before[0] + 1, before[1] + 1)
    assert _max_err(fused, plain) <= 2e-2 * plain.abs().max().item()


def test_entry_points_build_on_the_card_by_default(dev):
    """load_sd_stack and load_tiny_decoder called with no device build on
    the card, as a user would call them."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.models.tiny_decoder import load_tiny_decoder

    stack = load_sd_stack(None, dtype=torch.bfloat16, tiny=True, seed=0)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        tiny, _ = load_tiny_decoder()
    for module in (stack.unet, stack.vae, stack.text, tiny):
        assert {p.device.type for p in module.parameters()} == {"cuda"}


def _classifier_states(dev, variant, mixed_precision):
    """The classifier from seed 0 on the CPU and an identical copy on the
    card, each with its Adam."""
    import copy

    from polyp_tpu_torch.configs import ClassificationConfig
    from polyp_tpu_torch.train import classifier as tc

    cfg = ClassificationConfig(variant=variant,
                               mixed_precision=mixed_precision)
    cpu = tc.create_classifier_state(cfg, 3, "cpu")
    model = copy.deepcopy(cpu.model).to(dev)
    card = tc.ClassifierState(model, tc.make_optimizer(model, cfg),
                              cpu.dtype)
    return cpu, card


@pytest.mark.parametrize("variant,mixed_precision", [
    ("tiny", "fp32"), ("b0", "fp32"), ("b0", "bf16")])
def test_classifier_forward_and_train_step_match_the_cpu(
        dev, variant, mixed_precision):
    """The classifier at 64 px, batch 8, on the card and on the CPU from
    the same weights and draws: the evaluation logits, and one train step's
    loss, gradients and running statistics' move. fp32 (TF32 off) differs
    by summation order only: 1e-3 relative L2 (the loss 1e-4). Under
    "bf16" the stem conv's bf16 outputs round to other values where its
    products sum in another order: 2e-2, the loss 1e-2."""
    from polyp_tpu_torch.data.transforms import augment_classifier_batch
    from polyp_tpu_torch.train import classifier as tc

    tol, loss_tol = (1e-3, 1e-4) if mixed_precision == "fp32" else (2e-2,
                                                                     1e-2)
    cpu, card = _classifier_states(dev, variant, mixed_precision)
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 3, (8,), generator=g)
    draws = tc.draw_step(cpu.model, 8, torch.Generator().manual_seed(2))
    got = {}
    for name, state in (("cpu", cpu), ("card", card)):
        d = state.device
        state.model.eval()
        with torch.no_grad():
            logits = state.model(augment_classifier_batch(
                images.to(d), None, state.dtype)).cpu()
        before = [b.clone() for b in state.model.buffers()]
        on = tc.ClassifierDraws(draws.flip.to(d), {
            k: v.to(d) for k, v in draws.drop_path.items()},
            draws.dropout.to(d))
        loss, _ = tc.train_step(state, images.to(d), labels.to(d), on)
        got[name] = (logits, loss.item(), torch.cat(
            [p.grad.cpu().reshape(-1) for p in state.model.parameters()]),
            torch.cat([(b - b0).cpu().reshape(-1) for b, b0 in zip(
                state.model.buffers(), before)]))
    (lc, sc, gc, mc), (lk, sk, gk, mk) = got["cpu"], got["card"]
    assert card.device.type == "cuda"
    assert ((lk - lc).norm() / lc.norm()).item() <= tol
    assert abs(sk - sc) <= loss_tol * abs(sc)
    assert ((gk - gc).norm() / gc.norm()).item() <= tol
    assert ((mk - mc).norm() / mc.norm()).item() <= tol


def test_classifier_entry_points_build_on_the_card_by_default(dev):
    """create_classifier_state and the Fréchet extractor called with no
    device build on the card."""
    import numpy as np

    from polyp_tpu_torch.configs import ClassificationConfig
    from polyp_tpu_torch.eval.fid import efficientnet_extractor
    from polyp_tpu_torch.train.classifier import create_classifier_state

    state = create_classifier_state(ClassificationConfig(variant="tiny"), 3)
    assert state.device.type == "cuda"
    feats = efficientnet_extractor(32)(np.zeros((3, 32, 32, 3), np.uint8))
    assert feats.shape == (3, 1280) and np.isfinite(feats).all()
