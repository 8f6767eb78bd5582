"""GroupNorm(+SiLU) kernel: the twin of polyp_tpu/ops/fused_gn.py.

`fused_group_norm` runs the CUDA kernel `csrc/fused_gn.cu` (which replaces
the Pallas kernel `fused_group_norm`, polyp_tpu/ops/fused_gn.py:136) on a
CUDA tensor, and the plain version `ops.groupnorm.group_norm` on a CPU
tensor. The kernel reads NCHW-contiguous fp32 or bf16 input with fp32
affine parameters and has no per-sample size cap, so the VAE decoder's
large tensors run through it too. The int8 epilogue of the TPU kernel
comes with the int8 slice.

Inference only, as in the reference (fused_gn.py:184-187): the GroupNorm
module takes this path only when autograd is off, and the wrapper raises if
it is asked to record a gradient.
"""

from __future__ import annotations

import math

import torch

from polyp_tpu_torch import _build
from polyp_tpu_torch.ops.groupnorm import group_norm

__all__ = ["fused_group_norm", "group_norm"]


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-5,
                     act: str | None = None) -> torch.Tensor:
    """GN(+SiLU) over NCHW `x`; == `group_norm` to rounding."""
    if act not in (None, "silu"):
        raise ValueError(act)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("the fused GroupNorm kernel is inference-only; "
                           "call it under torch.no_grad()")
    if x.device.type == "cpu":
        return group_norm(x, weight, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: no kernel for device {x.device}")
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("fused_group_norm takes fp32 or bf16 NCHW, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, c, h, w = x.shape
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("weight and bias must be [C]")
    x = x.contiguous()
    weight = weight.float().contiguous()
    bias = bias.float().contiguous()
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.polyp_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, c, h * w, math.gcd(c, num_groups), eps, int(act == "silu"),
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(err, "group_norm kernel")
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0
