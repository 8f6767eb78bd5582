"""Card tests of what the bench and distill_ab paths added: the GEGLU
kernel's fp32 form against its plain version at the tiny conditional
UNet's shapes (distill_ab --sd's model), that UNet in fp32 under no_grad on
the card launching it once a feed-forward and agreeing with the same
weights on the CPU, and a bf16 one launching the bf16 form. Marked `cuda`:
skipped without a card. Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_bench_cuda.py
"""

from __future__ import annotations

import copy

import pytest
import torch

from polyp_tpu_torch.cli.common import init_weights_
from polyp_tpu_torch.models.unet_condition import tiny_condition_unet
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


# (tokens, C): the tiny UNet's level 0 (8x8 latents) and mid block (4x4)
# at distill_ab's batches 16 and 32 (CFG), and ragged token counts
@pytest.mark.parametrize("tokens,c", [(16 * 64, 32), (32 * 64, 32),
                                      (16 * 16, 64), (32 * 16, 64),
                                      (1, 32), (77, 64), (130, 40)])
def test_fp32_geglu_matches_the_plain_version(dev, tokens, c):
    gen = torch.Generator(dev).manual_seed(tokens + c)
    h = 4 * c
    x = torch.randn(tokens, c, generator=gen, device=dev)
    w1 = torch.randn(2 * h, c, generator=gen, device=dev) * c ** -0.5
    b1 = torch.randn(2 * h, generator=gen, device=dev) * 0.1
    w2 = torch.randn(c, h, generator=gen, device=dev) * h ** -0.5
    b2 = torch.randn(c, generator=gen, device=dev) * 0.1
    args = (x, w1, b1, w2, b2)
    fused_geglu.f32_launches = fused_geglu.launches = 0
    with torch.no_grad():
        got = fused_geglu(*args)
    assert (fused_geglu.f32_launches, fused_geglu.launches) == (1, 0)
    want = reference_geglu(*(t.double() for t in args))
    err = (got.double() - want).abs().max().item()
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert err <= 1e-4 * want.abs().max().item(), err


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
