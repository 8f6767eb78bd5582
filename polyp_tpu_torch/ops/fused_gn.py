"""GroupNorm(+SiLU) kernel: the twin of polyp_tpu/ops/fused_gn.py.

`fused_group_norm` runs the CUDA kernel `csrc/fused_gn.cu` (which replaces
the Pallas kernel `fused_group_norm`, polyp_tpu/ops/fused_gn.py:136) on a
CUDA tensor, and the plain version `ops.groupnorm.group_norm` on a CPU
tensor. The kernel reads NCHW-contiguous fp32 or bf16 input with fp32
affine parameters and has no per-sample size cap, so the VAE decoder's
large tensors run through it too. With `act_scale` (w8a8_static's
producer-side handoff, a 0-d fp32 tensor on x's device) it runs the TPU
kernel's int8 epilogue: the output is the int8 code clip(round(y / s),
-127, 127) of the fp32 y, whose plain version is `reference_gn_q8`.

Inference only, as in the reference (fused_gn.py:184-187): the GroupNorm
module takes this path only when autograd is off, and the wrapper raises if
it is asked to record a gradient.
"""

from __future__ import annotations

import math

import torch

from polyp_tpu_torch import _build
from polyp_tpu_torch.ops import quant
from polyp_tpu_torch.ops.groupnorm import group_norm

__all__ = ["fused_group_norm", "group_norm", "reference_gn_q8"]


def reference_gn_q8(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, act_scale: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    act: str | None = "silu") -> torch.Tensor:
    """Plain version of the int8 epilogue: GN(+SiLU) in fp32, then the
    static quantize of the fp32 y (the TPU kernel quantizes y before any
    rounding to x's dtype)."""
    y = group_norm(x.float(), weight, bias, num_groups, eps, act)
    return quant.quantize_activation(y, act_scale)[0]


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-5, act: str | None = None,
                     act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """GN(+SiLU) over NCHW `x`; == `group_norm` to rounding, or with
    `act_scale` the int8 codes == `reference_gn_q8` (up to one code where
    y / s lies within rounding of a half)."""
    if act not in (None, "silu"):
        raise ValueError(act)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("the fused GroupNorm kernel is inference-only; "
                           "call it under torch.no_grad()")
    if x.device.type == "cpu":
        if act_scale is not None:
            return reference_gn_q8(x, weight, bias, act_scale, num_groups,
                                   eps, act)
        return group_norm(x, weight, bias, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: no kernel for device {x.device}")
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("fused_group_norm takes fp32 or bf16 NCHW, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, c, h, w = x.shape
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("weight and bias must be [C]")
    if act_scale is not None and (
            act_scale.dtype != torch.float32 or act_scale.numel() != 1
            or act_scale.device != x.device):
        raise ValueError("the int8 epilogue's scale must be a 0-d fp32 "
                         "tensor on x's device")
    x = x.contiguous()
    weight = weight.float().contiguous()
    bias = bias.float().contiguous()
    y = torch.empty_like(x, dtype=torch.int8 if act_scale is not None
                         else x.dtype)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.polyp_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, c, h * w, math.gcd(c, num_groups), eps, int(act == "silu"),
            int(x.dtype == torch.bfloat16),
            0 if act_scale is None else act_scale.data_ptr(),
            _build.stream_of(x))
    _build.check(err, "group_norm kernel")
    fused_group_norm.launches += 1
    if act_scale is not None:
        fused_group_norm.q8_launches += 1  # the int8 epilogue's own count
    return y


fused_group_norm.launches = 0
fused_group_norm.q8_launches = 0
