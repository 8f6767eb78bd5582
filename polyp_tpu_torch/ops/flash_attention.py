"""Flash attention: the twin of polyp_tpu/ops/flash_attention.py.

`flash_attention` runs the CUDA kernel `csrc/flash_attention.cu` (which
replaces the Pallas kernel `_flash_impl`, polyp_tpu/ops/flash_attention.py
:185) on CUDA tensors, and the plain version `reference_attention` on CPU
tensors. q, k, v are [N, T, H, D] (BTHD); the kernel takes bf16 or fp32
(all three of one dtype; the fp32 form, for fp32 models without autograd,
is counted apart as `flash_attention.f32_launches`), every head dim up to
128 and 160, and any T (ragged tiles are masked, no padding). It is built
for padded widths (16, 32, 40, 48, 64, 80, 96, 112, 128, 160) and reads a
head dim that is a multiple of 8 in place; any other d the wrapper
zero-pads to the next multiple of 8 and slices the output back, as the
reference pads to 64 (flash_attention.py:167-176): zero columns add
nothing to QKᵀ, and the scale is the true d's. It has no mask and no causal
mode: the wrapper raises on either, and the dispatch in ops/attention.py
keeps those consumers on the plain version.

Differentiable through a `torch.autograd.Function` whose backward
recomputes through the plain version, as `_flash_vjp_bwd` does
(flash_attention.py:130-139): exact up to rounding, O(T²) memory.
"""

from __future__ import annotations

import math

import torch

from polyp_tpu_torch import _build


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
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise ValueError("the flash kernel takes bf16 or fp32 q, k, v, all "
                         f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    fp32 = q.dtype == torch.float32
    n, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (n, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    rows = 64 if fp32 else 128  # query rows a block
    if tk < 1 or -(-tq // rows) > 65535:
        raise ValueError(f"flash kernel cannot tile tq={tq} tk={tk}")
    # the kernel reads rows of d8 elements in 16-byte pieces: a head dim
    # that is no multiple of 8 is zero-padded to one
    d8 = -(-d // 8) * 8
    if d8 != d:
        q, k, v = (torch.nn.functional.pad(t, (0, d8 - d)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernel needs 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    lib = _build.library()
    entry = (lib.polyp_flash_attention_f32_fwd if fp32
             else lib.polyp_flash_attention_fwd)
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    n, h, tq, tk, d8, 1.0 / math.sqrt(d), _build.stream_of(q))
    _build.check(err, "flash attention kernel" + (" (fp32)" if fp32 else ""))
    if fp32:
        flash_attention.f32_launches += 1
    else:
        flash_attention.launches += 1
    return out if d8 == d else out[..., :d]


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
    # the reference's d <= 128 (its supported(), flash_attention.py:39-50),
    # and 160
    d = q.shape[-1]
    if not (0 < d <= 128 or d == 160):
        raise ValueError(f"the flash kernel takes head dims up to 128 and "
                         f"160, got {d}")
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0
flash_attention.f32_launches = 0
