"""W8A8 dense: the twin of polyp_tpu/ops/fused_dense.py.

`fused_w8a8_dense` runs the CUDA kernel `csrc/fused_dense.cu`, on the
GEMM core `csrc/gemm_core.cuh` (it replaces the Pallas kernel
`fused_w8a8_dense`, polyp_tpu/ops/fused_dense.py:97), on CUDA tensors, and the plain version `reference_w8a8_dense` on CPU
tensors. Weights arrive quantized (`quant.module_weight_q8`: int8 [O, C]
in torch layout and fp32 [O] scales); the activation is quantized inside
with `act_scale`, a 0-d fp32 tensor on the activation's device (calibrated
static or dynamic: the math is the same), or arrives int8 already
quantized with it by its producer. The kernel takes bf16 or int8 x, any
row count, C a multiple of 16 and O of 8, and returns bf16; its fp32 form
(the same file, counted apart as `fused_w8a8_dense.f32_launches`) takes
fp32 x, or int8 x with `out_dtype=torch.float32` (the GroupNorm hand-off of
an fp32 model), with an fp32 bias, and returns fp32, as the Pallas kernel
computes in and returns x's dtype.

The dispatch sends every quantized Linear (to_q/to_k/to_v/to_out) and every
quantized 1×1 stride-1 conv (proj_in, proj_out, conv_shortcut) here, in
both quantized modes; the reference's TPU verdict (default off) carries no
weight here. Inference only: the wrapper raises if asked to record a
gradient.
"""

from __future__ import annotations

import torch

from polyp_tpu_torch import _build
from polyp_tpu_torch.ops import quant


def reference_w8a8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                         bias: torch.Tensor | None, act_scale: torch.Tensor,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version, the TPU kernel's math: q(x) · wqᵀ in int32, then
    acc · (act_scale · sw) + bias in fp32, rounded once to `out_dtype`
    (default: x's dtype; required for an int8 x)."""
    if out_dtype is None and not x.is_floating_point():
        raise ValueError("an int8 x needs out_dtype")
    out_dtype = out_dtype or x.dtype
    c = x.shape[-1]
    xq = x if x.dtype == torch.int8 else quant.quantize_activation(
        x, act_scale)[0]
    y = quant.int_mm(xq.reshape(-1, c), wq).float() * (act_scale * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], wq.shape[0])


def fused_w8a8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     bias: torch.Tensor | None, act_scale: torch.Tensor,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: [..., C] float or int8; wq: [O, C] int8; sw: [O] fp32; bias: [O] or
    None; act_scale: 0-d fp32. Returns [..., O] == reference_w8a8_dense to
    rounding (on the card: bf16 x → bf16, fp32 x → fp32, int8 x →
    `out_dtype`, bf16 or fp32; the bias in the output's dtype)."""
    quant._inference_only(x, bias)
    if x.device.type == "cpu":
        return reference_w8a8_dense(x, wq, sw, bias, act_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_w8a8_dense: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise ValueError(f"the W8A8 dense kernel takes bf16, fp32 or int8 x, "
                         f"got {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            x.dtype != torch.int8 and out_dtype != x.dtype):
        raise ValueError(f"the W8A8 dense kernel returns x's dtype (bf16 or "
                         f"fp32; either for int8 x), not {out_dtype} for "
                         f"{x.dtype} x")
    c = x.shape[-1]
    o = wq.shape[0]
    if wq.dtype != torch.int8 or wq.shape != (o, c) or sw.shape != (o,):
        raise ValueError(f"W8A8 dense shapes do not match: x {tuple(x.shape)}"
                         f", wq {tuple(wq.shape)} {wq.dtype}, sw "
                         f"{tuple(sw.shape)}")
    if bias is not None and (bias.shape != (o,) or bias.dtype != out_dtype):
        raise ValueError(f"the W8A8 dense kernel takes a [O] bias of its "
                         f"output's dtype ({out_dtype}), got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if c % 16 or o % 8:
        raise ValueError(f"W8A8 dense kernel needs C % 16 == 0 and O % 8 == 0, "
                         f"got C={c} O={o}")
    if sw.dtype != torch.float32 or act_scale.dtype != torch.float32 \
            or act_scale.numel() != 1 or act_scale.device != x.device:
        raise ValueError("W8A8 dense scales must be fp32 on x's device "
                         "(act_scale 0-d)")
    xf = x.reshape(-1, c).contiguous()
    wq, sw = wq.contiguous(), sw.contiguous()
    bias = None if bias is None else bias.contiguous()
    if any(t.data_ptr() % 16 for t in (xf, wq, sw)) or (
            bias is not None and bias.data_ptr() % 16):
        raise ValueError("W8A8 dense kernel needs 16-byte aligned x, wq, sw "
                         "and bias")
    m = xf.shape[0]
    f32 = out_dtype == torch.float32
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    if m:
        lib = _build.library()
        entry = lib.polyp_w8a8_dense_f32 if f32 else lib.polyp_w8a8_dense
        with torch.cuda.device(x.device):
            err = entry(
                xf.data_ptr(), int(x.dtype == torch.int8), wq.data_ptr(),
                sw.data_ptr(), 0 if bias is None else bias.data_ptr(),
                act_scale.data_ptr(), out.data_ptr(), m, c, o,
                _build.stream_of(x))
        _build.check(err, "W8A8 dense kernel" + (" (fp32)" if f32 else ""))
        if f32:
            fused_w8a8_dense.f32_launches += 1
        else:
            fused_w8a8_dense.launches += 1
    return out.reshape(*x.shape[:-1], o)


fused_w8a8_dense.launches = 0
fused_w8a8_dense.f32_launches = 0
