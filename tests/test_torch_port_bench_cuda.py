"""Card tests of the fp32 inference path: the GEGLU kernel's fp32 form
against its plain version in float64 at the tiny conditional UNet's shapes
(distill_ab --sd's model), at SD-v1-4's widths and at shapes that take its
other code paths (C or H not a multiple of 4, a ragged last hidden chunk,
C wider than one panel), and bit for bit from run to run; that tiny UNet in
fp32 under no_grad on the card launching it once a feed-forward and
agreeing with the same weights on the CPU, and a bf16 one launching the
bf16 form; and an fp32 SD-v1-4 UNet forward at 32x32 latents (CFG batch 2)
launching exactly the fp32 flash and GEGLU forms and GroupNorm where a bf16
one launches the bf16 forms. Marked `cuda`: skipped without a card.
Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_bench_cuda.py
"""

from __future__ import annotations

import copy

import pytest
import torch

from polyp_tpu_torch.cli.common import init_weights_
from polyp_tpu_torch.models.unet_condition import (
    sd14_unet, tiny_condition_unet)
from polyp_tpu_torch.ops.fused_geglu import fused_geglu, reference_geglu

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_port_bench_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _unet(dtype):
    unet = tiny_condition_unet(dtype=dtype)
    init_weights_(unet, torch.Generator().manual_seed(0))
    return unet.eval()


def _inputs(dtype):
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(2, 4, 8, 8, generator=gen).to(dtype),
            torch.tensor([10, 500]),
            torch.randn(2, 16, 32, generator=gen).to(dtype))


def _geglu_f32_args(dev, tokens, c, h=None):
    gen = torch.Generator(dev).manual_seed(tokens + c)
    h = h or 4 * c
    x = torch.randn(tokens, c, generator=gen, device=dev)
    w1 = torch.randn(2 * h, c, generator=gen, device=dev) * c ** -0.5
    b1 = torch.randn(2 * h, generator=gen, device=dev) * 0.1
    w2 = torch.randn(c, h, generator=gen, device=dev) * h ** -0.5
    b2 = torch.randn(c, generator=gen, device=dev) * 0.1
    return x, w1, b1, w2, b2


# (tokens, C, H): the tiny UNet's level 0 (8x8 latents) and mid block (4x4)
# at distill_ab's batches 16 and 32 (CFG), and ragged token counts; SD-v1-4
# at 32x32 latents, CFG batch 2 (levels 0-2 and the mid block); C and H not
# multiples of 4 (4-byte copies), an H whose last 64-unit chunk is ragged,
# and C = 1,400 at 4,096 tokens, wider than a 32-token block's accumulator
# (two panels of output columns)
@pytest.mark.parametrize("tokens,c,h", [
    (16 * 64, 32, None), (32 * 64, 32, None), (16 * 16, 64, None),
    (32 * 16, 64, None), (1, 32, None), (77, 64, None), (130, 40, None),
    (2048, 320, None), (512, 640, None), (128, 1280, None), (32, 1280, None),
    (77, 30, 90), (300, 64, 200), (4096, 1400, None)])
def test_fp32_geglu_matches_the_plain_version(dev, tokens, c, h):
    args = _geglu_f32_args(dev, tokens, c, h)
    x = args[0]
    fused_geglu.f32_launches = fused_geglu.launches = 0
    with torch.no_grad():
        got = fused_geglu(*args)
    assert (fused_geglu.f32_launches, fused_geglu.launches) == (1, 0)
    want = reference_geglu(*(t.double() for t in args))
    err = (got.double() - want).abs().max().item()
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert err <= 1e-4 * want.abs().max().item(), err


def test_fp32_geglu_repeats_bit_for_bit(dev):
    """SD level 0's shape twice: the cluster adds its blocks' partial
    outputs in rank order, so the bits do not move."""
    args = _geglu_f32_args(dev, 2048, 320)
    with torch.no_grad():
        a = fused_geglu(*args)
        b = fused_geglu(*args)
    assert torch.equal(a, b)


def test_mixed_dtypes_raise_on_the_card(dev):
    x = torch.randn(4, 32, device=dev)
    w1, b1 = torch.randn(256, 32, device=dev), torch.zeros(256, device=dev)
    w2, b2 = torch.randn(32, 128, device=dev), torch.zeros(32, device=dev)
    with torch.no_grad(), pytest.raises(ValueError, match="one dtype"):
        fused_geglu(x, w1.bfloat16(), b1, w2, b2)


def test_fp32_unet_on_the_card_matches_the_cpu(dev):
    cpu = _unet(torch.float32)
    card = copy.deepcopy(cpu).to(dev)
    args = _inputs(torch.float32)
    fused_geglu.f32_launches = fused_geglu.launches = 0
    with torch.no_grad():
        want = cpu(*args)
        got = card(*(a.to(dev) for a in args)).cpu()
    # the four transformer blocks' feed-forwards, one fp32 launch each
    assert (fused_geglu.f32_launches, fused_geglu.launches) == (4, 0)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-4, rel


def test_bf16_unet_takes_the_geglu_kernel(dev):
    card = _unet(torch.bfloat16).to(dev)
    fused_geglu.f32_launches = fused_geglu.launches = 0
    with torch.no_grad():
        out = card(*(a.to(dev) for a in _inputs(torch.bfloat16)))
    assert torch.isfinite(out.float()).all()
    assert (fused_geglu.launches, fused_geglu.f32_launches) == (4, 0)


def test_fp32_sd_unet_forward_launches_the_fp32_forms(dev):
    """SD-v1-4's UNet in fp32 (random weights from seed 0) at 32x32 latents,
    CFG batch 2, under no_grad: its five level-0 self-attentions take the
    flash kernel's fp32 form, its 16 feed-forwards the GEGLU's, and its 61
    GroupNorms the GroupNorm kernel; no bf16 form runs. (chip_smoke.py
    holds the same forward to the CPU's.)"""
    from polyp_tpu_torch.ops.flash_attention import flash_attention
    from polyp_tpu_torch.ops.fused_gn import fused_group_norm

    unet = sd14_unet(torch.float32, device="meta").to_empty(device=dev)
    init_weights_(unet, torch.Generator(dev).manual_seed(0))
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(2, 4, 32, 32, generator=gen, device=dev)
    ctx = torch.randn(2, 77, 768, generator=gen, device=dev)
    t = torch.tensor([981, 981], device=dev)
    counters = ((flash_attention, "f32_launches"), (flash_attention,
                                                    "launches"),
                (fused_geglu, "f32_launches"), (fused_geglu, "launches"),
                (fused_group_norm, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    with torch.no_grad():
        out = unet(x, t, ctx)
    torch.cuda.synchronize()
    assert [getattr(fn, attr) for fn, attr in counters] == [5, 0, 16, 0, 61]
    assert out.shape == x.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
