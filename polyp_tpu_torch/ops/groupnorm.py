"""GroupNorm as a plain function over NCHW tensors, with fp32 statistics.

The twin of polyp_tpu/ops/groupnorm.py and the plain version of the
GroupNorm kernel (ops/fused_gn.py). It keeps the reference's formulation,
not torch's two-pass `F.group_norm`: fp32 Σx and Σx² per (sample, group),
var = E[x²] − E[x]² clamped at 0, then one per-channel multiply-add and an
optional SiLU. Groups are gcd(C, num_groups), so tiny widths degrade to
fewer groups. The output has the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    if act not in (None, "silu"):
        raise ValueError(act)
    n, c = x.shape[:2]
    g = math.gcd(c, num_groups)
    xg = x.reshape(n, g, -1).float()
    cnt = xg.shape[-1]
    mean = xg.sum(-1) / cnt                                   # [n, g]
    var = torch.clamp(xg.square().sum(-1) / cnt - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    # fold group stats and affine into one per-channel scale and offset
    mul = rstd.repeat_interleave(c // g, dim=1) * weight.float()  # [n, c]
    add = bias.float() - mean.repeat_interleave(c // g, dim=1) * mul
    spatial = (1,) * (x.ndim - 2)
    out = x.float() * mul.view(n, c, *spatial) + add.view(n, c, *spatial)
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype)
