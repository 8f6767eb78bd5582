"""Attention dispatch: the twin of polyp_tpu/ops/attention.py.

Every UNet, VAE and CLIP attention calls `dot_product_attention`. It takes
the flash kernel (ops/flash_attention.py) where the reference's policy
would (attention.py:61-74): no mask, not causal, Tq ≥ 1024 and Tk ≥ 1024
(`profitable`, flash_attention.py:53-56) and a head dim ≤ 128 (`supported`,
:49; the kernel takes every such d). At SD 256px that is every level-0
self-attention ([2B, 1024, 8, 40]); in the tiny UNet the level-0 one
([2B, 1024, 2, 16]). Everything else — CLIP's causal attention, the 77-token
cross-attention, the VAE's single-head d=512 attention — takes the plain
version. The policy looks at shapes only, never at the device or the
dtype: a CUDA tensor it sends to the kernel launches it (bf16, or the
fp32 form for fp32) or raises.

`use_fused_mha` is the policy of the whole-block fused MHA kernel
(ops/fused_mha.py), which models/unet_blocks.py::Attention asks before
its projections. The reference reads an environment opt-in
(POLYP_FUSED_MHA=1, attention.py:25-58); the port reads no switch: the
caller opts a region in with `fused_mha_region(True)`, a context variable
as `quant.override` is, so no module is mutated (pipeline.py sets it
around each UNet call of a sampler built with `fused_mha=True`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from polyp_tpu_torch.ops import fused_mha as fm
from polyp_tpu_torch.ops import quant
from polyp_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
)


def use_flash(q: torch.Tensor, k: torch.Tensor,
              mask: torch.Tensor | None, is_causal: bool) -> bool:
    return (mask is None and not is_causal
            and q.shape[1] >= 1024 and k.shape[1] >= 1024
            and q.shape[-1] <= 128)


_FUSED_MHA: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "polyp_torch_fused_mha", default=False)


@contextlib.contextmanager
def fused_mha_region(enabled: bool):
    """Opt the attentions called in this region into the fused MHA kernel
    (`enabled`) or out of it; `use_fused_mha` still decides each call."""
    token = _FUSED_MHA.set(enabled)
    try:
        yield
    finally:
        _FUSED_MHA.reset(token)


def use_fused_mha(x: torch.Tensor, ctx: torch.Tensor, num_heads: int,
                  head_dim: int, qkv_bias: bool,
                  is_self: bool = True) -> bool:
    """Route a whole attention block (projections included) through the
    fused MHA kernel: only inside `fused_mha_region(True)`, for
    self-attention (cross-attention's 77-token KV costs the kernel more
    than it saves, :47-51), with no quantization mode active (the kernel
    would bypass the int8 projections, :54-57), and
    where fused_mha.supported admits the shapes (no qkv bias, Tq a
    multiple of 128 and ≥ 1024, head_dim ≤ 128)."""
    return (_FUSED_MHA.get() and is_self and quant.quantization() is None
            and fm.supported(x, ctx, num_heads, head_dim, qkv_bias))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          is_causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over [N, T, H, D] tensors (BTHD)."""
    if use_flash(q, k, mask, is_causal):
        return flash_attention(q, k, v)
    return reference_attention(q, k, v, mask=mask, is_causal=is_causal)
