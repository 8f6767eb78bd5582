"""Attention dispatch: the twin of polyp_tpu/ops/attention.py.

Every UNet, VAE and CLIP attention calls `dot_product_attention`. It takes
the flash kernel (ops/flash_attention.py) where the reference's policy
would (attention.py:61-74): no mask, not causal, Tq ≥ 1024 and Tk ≥ 1024
(`profitable`, flash_attention.py:53-56) and a head dim ≤ 128 that the
kernel was built for. At SD 256px that is every level-0 self-attention
([2B, 1024, 8, 40]). Everything else — CLIP's causal attention, the 77-token
cross-attention, the VAE's single-head d=512 attention — takes the plain
version. The policy looks at shapes only, never at the device: a CUDA
tensor it sends to the kernel launches it or raises.
"""

from __future__ import annotations

import torch

from polyp_tpu_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS,
    flash_attention,
    reference_attention,
)


def use_flash(q: torch.Tensor, k: torch.Tensor,
              mask: torch.Tensor | None, is_causal: bool) -> bool:
    d = q.shape[-1]
    return (mask is None and not is_causal
            and q.shape[1] >= 1024 and k.shape[1] >= 1024
            and d <= 128 and d in SUPPORTED_HEAD_DIMS)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          is_causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over [N, T, H, D] tensors (BTHD)."""
    if use_flash(q, k, mask, is_causal):
        return flash_attention(q, k, v)
    return reference_attention(q, k, v, mask=mask, is_causal=is_causal)
