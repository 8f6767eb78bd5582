"""Fused GEGLU feed-forward: the twin of polyp_tpu/ops/fused_geglu.py.

`fused_geglu` runs the CUDA kernel `csrc/fused_geglu.cu` (which replaces
the Pallas kernel `fused_geglu`, polyp_tpu/ops/fused_geglu.py:139) on CUDA
tensors, and the plain version `reference_geglu` on CPU tensors. Weights
are in torch's Linear layout: w1 [2H, C] with a = rows :H and gate = rows
H: (diffusers' `chunk(2)`), w2 [C, H]. The kernel takes bf16, any token
count, and C and H that are multiples of 8.

Inference only, as in the reference (ops/dispatch.py): FeedForward takes
this path only when autograd is off, and the wrapper raises if it is asked
to record a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from polyp_tpu_torch import _build


def reference_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version (identical math, erf-form gelu)."""
    a, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(a * F.gelu(gate), w2, b2)


def fused_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x: [..., C]; w1: [2H, C]; b1: [2H]; w2: [C, H]; b2: [C].
    Returns [..., C] == reference_geglu to rounding."""
    args = (x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("the fused GEGLU kernel is inference-only; call it "
                           "under torch.no_grad()")
    if x.device.type == "cpu":
        return reference_geglu(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_geglu: no kernel for device {x.device}")
    if any(t.dtype != torch.bfloat16 for t in args):
        raise ValueError("the GEGLU kernel takes bf16 inputs and weights")
    c = x.shape[-1]
    hidden = w2.shape[1]
    if (w1.shape != (2 * hidden, c) or b1.shape != (2 * hidden,)
            or w2.shape != (c, hidden) or b2.shape != (c,)):
        raise ValueError(f"GEGLU shapes do not match: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if c % 8 or hidden % 8:
        raise ValueError(f"GEGLU kernel needs C and H divisible by 8, got "
                         f"C={c} H={hidden}")
    xf = x.reshape(-1, c).contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    if any(t.data_ptr() % 16 for t in (xf, w1, w2)):
        raise ValueError("GEGLU kernel needs 16-byte aligned x, w1 and w2")
    t = xf.shape[0]
    out = torch.empty_like(xf)
    lib = _build.library()
    with torch.cuda.device(x.device):
        # fp32 partial sums of the hidden splits, which the kernel sizes from
        # the shapes and the card's SM count
        workspace = torch.empty(
            lib.polyp_fused_geglu_workspace(t, c, hidden),
            dtype=torch.float32, device=x.device)
        err = lib.polyp_fused_geglu(
            xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), workspace.data_ptr(), out.data_ptr(), t, c,
            hidden, _build.stream_of(x))
    _build.check(err, "fused GEGLU kernel")
    fused_geglu.launches += 1
    return out.reshape(x.shape)


fused_geglu.launches = 0
