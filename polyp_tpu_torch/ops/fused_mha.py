"""Fused multi-head attention block: the twin of polyp_tpu/ops/fused_mha.py.

    out = softmax((x Wq)(ctx Wk)ᵀ/√d) (ctx Wv) Wo

`fused_mha` runs the CUDA kernel `csrc/fused_mha.cu` (which replaces the
Pallas kernel `_fused_mha_impl`, polyp_tpu/ops/fused_mha.py:241) on CUDA
tensors, and the plain version `reference_mha` on CPU tensors. The kernel
takes the projections, the online softmax with ragged keys masked, and the
output projection summed over heads; a first launch of the same entry point
projects K and V once into a workspace that the wrapper allocates.

Two entry points over the same kernel:

* `fused_mha(x, ctx, wq, wk, wv, wo, *, num_heads, head_dim)` takes the
  reference's layout (wq [C, H·D], wk/wv [Ckv, H·D], wo [H·D, Co]), so the
  tests compare like with like; on a card it copies the transposed weights.
* `fused_mha_linear` takes nn.Linear's [out, in] weights as they are
  (wq [H·D, C], wk/wv [H·D, Ckv], wo [Co, H·D]). models/unet_blocks.py's
  Attention calls it, so no transposed or padded weight copy is made per
  call: eager PyTorch has nothing that would hoist one out of the step loop
  the way XLA's scan did.

The kernel takes bf16 or fp32, all six tensors of one dtype (the fp32
form, for fp32 models without autograd, computes in fp32 throughout as the
reference's kernel does for fp32 x, :196-241, and is counted apart as
`fused_mha.f32_launches`), every head dim up to 128 and any C and Ckv
(the reference's gate, :63-75). It is built for padded widths (16, 32, 40,
48, 64, 80, 96, 112, 128) and reads in 16-byte pieces: it takes the
tensors as they are where d, C and Ckv are multiples of 8; otherwise the
wrapper pads each head's rows of the weights with zeros to the next
multiple of 8, as the reference pads d to 64 (:210-223), and x, ctx and
the weights' input columns likewise: zero Q and K columns add nothing to
QKᵀ, zero V columns meet zero Wo columns, zero input channels add nothing
to a projection, and the scale is the true d's. Where a block would need
more shared memory than the card has (many heads of a wide d), the
wrapper raises. The
out-projection bias is the caller's (reference :303). Differentiable
through a `torch.autograd.Function` whose backward recomputes through the
plain version, as `_fused_mha_bwd` (:183-190) does.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from polyp_tpu_torch import _build
from polyp_tpu_torch.ops.flash_attention import reference_attention


def supported(x: torch.Tensor, ctx: torch.Tensor, num_heads: int,
              head_dim: int, qkv_bias: bool) -> bool:
    """The reference's shape gate (fused_mha.py:63-75) without its
    TPU-backend test: no qkv bias, Tq a multiple of 128 and ≥ 1024 (where
    the standalone path's layout copies start to exist), head_dim ≤ 128."""
    if qkv_bias:
        return False
    tq = x.shape[1]
    return (tq % 128 == 0 and tq >= 1024 and head_dim <= 128
            and ctx.shape[1] >= 1)


def reference_mha_linear(x: torch.Tensor, ctx: torch.Tensor,
                         wq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor, wo: torch.Tensor, *,
                         num_heads: int, head_dim: int) -> torch.Tensor:
    """Plain version over nn.Linear weights: the unfused math of
    models/unet_blocks.py::Attention (projections in x's dtype, attention
    with fp32 logits and softmax, probabilities in the value dtype)."""
    b, tq, _ = x.shape
    tk = ctx.shape[1]
    dt = x.dtype
    q = F.linear(x, wq.to(dt)).reshape(b, tq, num_heads, head_dim)
    k = F.linear(ctx, wk.to(dt)).reshape(b, tk, num_heads, head_dim)
    v = F.linear(ctx, wv.to(dt)).reshape(b, tk, num_heads, head_dim)
    o = reference_attention(q, k, v)
    return F.linear(o.reshape(b, tq, num_heads * head_dim), wo.to(dt))


def reference_mha(x: torch.Tensor, ctx: torch.Tensor, wq: torch.Tensor,
                  wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor, *,
                  num_heads: int, head_dim: int) -> torch.Tensor:
    """Plain version in the reference's layout (reference_mha, :78-87): the
    oracle of the kernel and its backward."""
    return reference_mha_linear(x, ctx, wq.t(), wk.t(), wv.t(), wo.t(),
                                num_heads=num_heads, head_dim=head_dim)


def _pad_heads(w: torch.Tensor, h: int, d: int, d8: int,
               dim: int) -> torch.Tensor:
    """w with each head's d rows (dim 0: wq, wk, wv [H·d, C]) or columns
    (dim 1: wo [Co, H·d]) followed by d8 - d zero ones."""
    if dim == 0:
        w = w.reshape(h, d, -1)
        return F.pad(w, (0, 0, 0, d8 - d)).reshape(h * d8, -1)
    w = w.reshape(w.shape[0], h, d)
    return F.pad(w, (0, d8 - d)).reshape(w.shape[0], h * d8)


@functools.lru_cache(maxsize=None)
def _block_smem(fp32: bool, h: int, d8: int, co: int,
                device: int) -> tuple[int, int]:
    """The dynamic shared memory a block of the kernel takes at h heads of
    d8 and co output columns, and the most that card `device` lets a block
    take; asked once a shape."""
    lib = _build.library()
    smem = (lib.polyp_fused_mha_f32_smem if fp32
            else lib.polyp_fused_mha_smem)(h, d8, co)
    return smem, lib.polyp_smem_optin(device)


def _launch(x, ctx, wq, wk, wv, wo, num_heads: int,
            head_dim: int) -> torch.Tensor:
    tensors = (x, ctx, wq, wk, wv, wo)
    if not (all(t.dtype == x.dtype for t in tensors)
            and x.dtype in (torch.bfloat16, torch.float32)):
        raise ValueError(
            "the fused MHA kernel takes bf16 or fp32 activations and "
            "weights, all of one dtype; got "
            + ", ".join(str(t.dtype) for t in tensors))
    fp32 = x.dtype == torch.float32
    if x.dim() != 3 or ctx.dim() != 3 or ctx.shape[0] != x.shape[0]:
        raise ValueError(f"fused MHA needs x [B, Tq, C] and ctx [B, Tk, Ckv]"
                         f", got {tuple(x.shape)} and {tuple(ctx.shape)}")
    b, tq, c = x.shape
    tk, ckv = ctx.shape[1], ctx.shape[2]
    h, d = num_heads, head_dim
    hd = h * d
    co = wo.shape[0]
    if (wq.shape != (hd, c) or wk.shape != (hd, ckv) or wv.shape != (hd, ckv)
            or wo.dim() != 2 or wo.shape[1] != hd):
        raise ValueError(
            f"fused MHA weights do not match x {tuple(x.shape)}, ctx "
            f"{tuple(ctx.shape)}, {h} heads of {d}: wq {tuple(wq.shape)}, wk "
            f"{tuple(wk.shape)}, wv {tuple(wv.shape)}, wo {tuple(wo.shape)}")
    if not 1 <= d <= 128:
        raise ValueError(f"the fused MHA kernel takes head dims up to 128, "
                         f"got {d}")
    if co < 1 or tq < 1 or tk < 1 or b > 65535:
        raise ValueError(f"fused MHA kernel needs non-empty tokens and "
                         f"outputs and B <= 65535; got Co={co} Tq={tq} "
                         f"Tk={tk} B={b}")
    d8 = -(-d // 8) * 8  # the kernel reads a head's rows in 16-byte pieces
    smem, limit = _block_smem(fp32, h, d8, co, x.device.index)
    if smem > limit:
        raise ValueError(
            f"the fused MHA kernel ({x.dtype}) at {h} heads of {d} and "
            f"{co} output columns needs {smem} bytes of shared memory a "
            f"block, more than the card's {limit}")
    if d8 != d:
        wq, wk, wv = (_pad_heads(w, h, d, d8, 0) for w in (wq, wk, wv))
        wo = _pad_heads(wo, h, d, d8, 1)
    # ... and rows of x, ctx and the weights' input channels likewise
    c8, ckv8 = -(-c // 8) * 8, -(-ckv // 8) * 8
    if c8 != c or ckv8 != ckv:
        self_attention = ctx is x
        x, wq = F.pad(x, (0, c8 - c)), F.pad(wq, (0, c8 - c))
        ctx = x if self_attention else F.pad(ctx, (0, ckv8 - ckv))
        wk, wv = (F.pad(w, (0, ckv8 - ckv)) for w in (wk, wv))
    x, ctx, wq, wk, wv, wo = (t.contiguous()
                              for t in (x, ctx, wq, wk, wv, wo))
    if any(t.data_ptr() % 16 for t in (x, ctx, wq, wk, wv, wo)):
        raise ValueError("fused MHA kernel needs 16-byte aligned tensors")
    # K and V, projected once per (b, head) by the kernel's first launch
    k_ws = torch.empty(b, tk, h * d8, dtype=x.dtype, device=x.device)
    v_ws = torch.empty_like(k_ws)
    out = torch.empty(b, tq, co, dtype=x.dtype, device=x.device)
    lib = _build.library()
    entry = lib.polyp_fused_mha_f32 if fp32 else lib.polyp_fused_mha
    with torch.cuda.device(x.device):
        err = entry(
            x.data_ptr(), ctx.data_ptr(), wq.data_ptr(), wk.data_ptr(),
            wv.data_ptr(), wo.data_ptr(), k_ws.data_ptr(), v_ws.data_ptr(),
            out.data_ptr(), b, tq, tk, c8, ckv8, h, d8, co,
            1.0 / math.sqrt(d), _build.stream_of(x))
    _build.check(err, "fused MHA kernel" + (" (fp32)" if fp32 else ""))
    if fp32:
        fused_mha.f32_launches += 1
    else:
        fused_mha.launches += 1
    return out


def _forward(x, ctx, wq, wk, wv, wo, num_heads, head_dim):
    if x.device.type == "cpu":
        return reference_mha_linear(x, ctx, wq, wk, wv, wo,
                                    num_heads=num_heads, head_dim=head_dim)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mha: no kernel for device {x.device}")
    return _launch(x, ctx, wq, wk, wv, wo, num_heads, head_dim)


class _FusedMHA(torch.autograd.Function):

    @staticmethod
    def forward(fctx, x, ctx, wq, wk, wv, wo, num_heads, head_dim):
        fctx.save_for_backward(x, ctx, wq, wk, wv, wo)
        fctx.heads = (num_heads, head_dim)
        return _forward(x, ctx, wq, wk, wv, wo, num_heads, head_dim)

    @staticmethod
    def backward(fctx, grad):
        num_heads, head_dim = fctx.heads
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in fctx.saved_tensors]
            out = reference_mha_linear(*leaves, num_heads=num_heads,
                                       head_dim=head_dim)
        return (*torch.autograd.grad(out, leaves, grad), None, None)


def fused_mha_linear(x: torch.Tensor, ctx: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor, *,
                     num_heads: int, head_dim: int) -> torch.Tensor:
    """x [B, Tq, C], ctx [B, Tk, Ckv] (x itself for self-attention) and
    nn.Linear weights wq [H·D, C], wk/wv [H·D, Ckv], wo [Co, H·D].
    Returns [B, Tq, Co] == reference_mha_linear to rounding."""
    return _FusedMHA.apply(x, ctx, wq, wk, wv, wo, num_heads, head_dim)


def fused_mha(x: torch.Tensor, ctx: torch.Tensor, wq: torch.Tensor,
              wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor, *,
              num_heads: int, head_dim: int) -> torch.Tensor:
    """The reference's signature and layout: wq [C, H·D], wk/wv
    [Ckv, H·D], wo [H·D, Co]. Returns [B, Tq, Co] == reference_mha to
    rounding."""
    return fused_mha_linear(x, ctx, wq.t(), wk.t(), wv.t(), wo.t(),
                            num_heads=num_heads, head_dim=head_dim)


fused_mha.launches = 0
fused_mha.f32_launches = 0
