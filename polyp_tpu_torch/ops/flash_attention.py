"""Flash attention: the twin of polyp_tpu/ops/flash_attention.py.

`flash_attention` runs the CUDA kernel `csrc/flash_attention.cu` (which
replaces the Pallas kernel `_flash_impl`, polyp_tpu/ops/flash_attention.py
:185) on CUDA tensors, and the plain version `reference_attention` on CPU
tensors. q, k, v are [N, T, H, D] (BTHD); the kernel takes bf16, head dims
40, 64, 80, 128 and 160, and any T (ragged tiles are masked, no padding).
It has no mask and no causal mode: the wrapper raises on either, and the
dispatch in ops/attention.py keeps those consumers on the plain version.

Differentiable through a `torch.autograd.Function` whose backward
recomputes through the plain version, as `_flash_vjp_bwd` does
(flash_attention.py:130-139): exact up to rounding, O(T²) memory.
"""

from __future__ import annotations

import math

import torch

from polyp_tpu_torch import _build

SUPPORTED_HEAD_DIMS = (40, 64, 80, 128, 160)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        is_causal: bool = False) -> torch.Tensor:
    """Plain softmax(QKᵀ/√d)V over BTHD tensors, with the reference's
    precision (jax.nn.dot_product_attention): fp32 logits and softmax,
    probabilities cast to the value dtype. `mask` is boolean, broadcast to
    [N, H, Tq, Tk], True = attend."""
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    masked_value = -0.7 * torch.finfo(torch.float32).max
    if is_causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, masked_value)
    if mask is not None:
        logits = logits.masked_fill(~mask, masked_value)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", probs, v)


def _forward(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("the flash kernel takes bf16 q, k, v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    n, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (n, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    if tk < 1 or -(-tq // 128) > 65535:  # 128 query rows a block
        raise ValueError(f"flash kernel cannot tile tq={tq} tk={tk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel needs 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.polyp_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, h, tq, tk, d, 1.0 / math.sqrt(d), _build.stream_of(q))
    _build.check(err, "flash attention kernel")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*leaves)
        return torch.autograd.grad(out, leaves, grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    is_causal: bool = False) -> torch.Tensor:
    """q, k, v: [N, T, H, D] (BTHD). Returns [N, Tq, H, D]."""
    if mask is not None or is_causal:
        raise NotImplementedError(
            "the flash kernel has no mask and no causal mode; the dispatch "
            "in ops/attention.py keeps masked and causal attention plain")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel head dims are {SUPPORTED_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0
