"""2-D convolutions whose rows do not depend on their batch slot, for the
serving contract (serve.py: a sample is the same whether its request ran
alone or coalesced with others, at a fixed launch size).

On the H100, cuDNN's bf16 3×3 convolutions at the UNet's 8×8 and 16×16
maps (and the VAE's 512-channel 32×32 ones at batch 8) give one sample
different roundings in different batch slots, at the same shapes and on
identical inputs: the reduction order depends on where a row's tile falls
(PERF.md §6, PR 8; 17 of the UNet's and VAE's conv shapes at the serving
batches). The rows of one slot do not depend on the other rows. So inside
`slot_invariant_region(True)` each conv shape is probed once, on a batch
of one random sample repeated: where the direct convolution gives every
slot the same bits it is kept, and otherwise the conv runs as one patch
matrix (F.unfold) times the weight matrix, a GEMM whose row order holds.
Where neither does, the conv raises. Outside the region every conv is
`F.conv2d`, as before.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_SLOT_INVARIANT: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "polyp_torch_slot_invariant", default=False)
# {(device, dtype, x shape, weight shape, stride, padding, bias?): "direct"
#  | "unfold"}, probed once a shape in a process
_PLANS: dict[tuple, str] = {}


@contextlib.contextmanager
def slot_invariant_region(enabled: bool = True):
    """Convolutions inside the region (this thread's context) give a row
    the same bits in every batch slot."""
    token = _SLOT_INVARIANT.set(enabled)
    try:
        yield
    finally:
        _SLOT_INVARIANT.reset(token)


def conv2d_unfold(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, stride: tuple[int, int],
                  padding: tuple[int, int]) -> torch.Tensor:
    """F.conv2d (groups 1, dilation 1) as one product: the [N·OH·OW,
    C·kh·kw] patch matrix times the [C·kh·kw, O] weight matrix, each output
    row reduced over C·kh·kw in one order whatever its slot."""
    n, _, h, w = x.shape
    o, _, kh, kw = weight.shape
    oh = (h + 2 * padding[0] - kh) // stride[0] + 1
    ow = (w + 2 * padding[1] - kw) // stride[1] + 1
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    y = cols.transpose(1, 2).reshape(n * oh * ow, -1) @ weight.reshape(
        o, -1).t()
    if bias is not None:
        y = y + bias
    return y.view(n, oh, ow, o).permute(0, 3, 1, 2).contiguous()


def _slot_invariant(conv, x: torch.Tensor, *args) -> bool:
    """Does `conv` give every slot of a repeated random sample the same
    bits at x's shape?"""
    gen = torch.Generator(x.device).manual_seed(0)
    one = torch.randn(x.shape[1:], generator=gen, device=x.device)
    y = conv(one.to(x.dtype).expand(x.shape).contiguous(), *args)
    return bool((y == y[:1]).all())


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           stride: tuple[int, int], padding: tuple[int, int],
           dilation: tuple[int, int] = (1, 1), groups: int = 1
           ) -> torch.Tensor:
    """F.conv2d, or inside `slot_invariant_region` the form the shape's
    probe chose (module docstring)."""
    if (not _SLOT_INVARIANT.get() or x.shape[0] == 1 or groups != 1
            or tuple(dilation) != (1, 1)):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    key = (x.device, x.dtype, tuple(x.shape), tuple(weight.shape),
           tuple(stride), tuple(padding), bias is not None)
    plan = _PLANS.get(key)
    if plan is None:
        args = (weight, bias, stride, padding)
        if _slot_invariant(F.conv2d, x, *args):
            plan = "direct"
        elif _slot_invariant(conv2d_unfold, x, *args):
            plan = "unfold"
        else:
            raise RuntimeError(f"no slot-invariant convolution for {key}")
        _PLANS[key] = plan
    if plan == "direct":
        return F.conv2d(x, weight, bias, stride, padding)
    return conv2d_unfold(x, weight, bias, stride, padding)
