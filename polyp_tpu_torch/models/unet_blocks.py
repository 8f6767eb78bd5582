"""Shared UNet building blocks: the twin of polyp_tpu/models/unet_blocks.py.

NCHW `nn.Module`s whose parameter names are diffusers' (`to_q`, `to_out.0`,
`ff.net.0.proj`, `proj_in`, `time_emb_proj`, ...), so diffusers checkpoints
load with `strict=True`. Precision follows the reference: weights and
activations in the module's `dtype` (bf16 for sampling), GroupNorm and
LayerNorm statistics and affine in fp32 with the output cast back.

Kernels: GroupNorm and FeedForward take the hand-written CUDA kernels
(ops/fused_gn.py, ops/fused_geglu.py) when autograd is off — the wrappers
then launch on CUDA tensors and run the plain versions on CPU tensors —
and the plain versions under autograd; attention goes through
ops.dot_product_attention's shape policy, or, inside
ops.attention.fused_mha_region(True) where ops.attention.use_fused_mha
admits the call, through the fused MHA kernel (ops/fused_mha.py).

Quantization (ops/quant.py modes, set by `quant.override` around a UNet
call): `QConv2d` and `QLinear` are nn.Conv2d / nn.Linear with the same
parameters and full-precision math that run int8 when the mode quantizes
their layer (the reference's QConv, :109-185, and maybe_quantized_dense):
1×1 stride-1 convs and linears through the W8A8 dense kernel, other convs
through the patch matrix and `torch._int_mm`. Their `path` (the UNet's
module name, set by UNet2DCondition) keys the calibrated scales. Under
w8a8_static a GroupNorm whose consumer is a quantized conv emits int8
itself (producer-side handoff), and FeedForward takes the static int8
GEGLU kernel; under dynamic w8a8 it takes the per-token one. Calibration
records each quantizable layer's input amax.

Tensor parallelism (parallel/sharding.py): an `Attention` or
`FeedForward` that `shard_params` split holds the mesh as `tp` and its
layers' weights as this rank's slices. It runs heads/k heads (or H/k
hidden units) through the same kernels, passes its input through
Megatron's f (`parallel.copy_to_model`), sums the row-parallel partial
product over the model group (g, `parallel.reduce_from_model`) and only
then adds the output bias, once. A row-parallel `QLinear` (`row_tp`) takes
its int8 weight and dynamic activation scales as the model group's max,
and records the group's amax under calibration, so every scale is the
one-process scale. Layers keep `in_features` / `out_features` whole.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from polyp_tpu_torch.ops import dot_product_attention, group_norm, quant
from polyp_tpu_torch.ops.attention import use_fused_mha
from polyp_tpu_torch.ops.conv import conv2d
from polyp_tpu_torch.ops.fused_dense import fused_w8a8_dense
from polyp_tpu_torch.ops.fused_geglu import (
    fused_geglu,
    fused_geglu_w8a8,
    fused_geglu_w8a8_pt,
    reference_geglu,
)
from polyp_tpu_torch.ops.fused_gn import fused_group_norm
from polyp_tpu_torch.ops.fused_mha import fused_mha_linear
from polyp_tpu_torch.parallel.mesh import copy_to_model, reduce_from_model


def sinusoidal_time_embedding(timesteps: torch.Tensor, dim: int,
                              max_period: float = 10000.0,
                              flip_sin_to_cos: bool = True,
                              downscale_freq_shift: float = 0.0
                              ) -> torch.Tensor:
    """Transformer sinusoidal embedding of integer timesteps → [N, dim]
    (diffusers `Timesteps` parity)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Sinusoidal → Linear-SiLU-Linear time embedding."""

    def __init__(self, base_dim: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.base_dim = base_dim
        self.linear_1 = nn.Linear(base_dim, time_embed_dim, dtype=dtype,
                                  device=device)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim, dtype=dtype,
                                  device=device)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_time_embedding(timesteps, self.base_dim)
        emb = F.silu(self.linear_1(emb.to(self.linear_1.weight.dtype)))
        return self.linear_2(emb)


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU) over NCHW with fp32 affine parameters (`weight`,
    `bias`). Without autograd it runs the GroupNorm kernel's wrapper
    (ops/fused_gn.py); under autograd, the plain ops.group_norm.
    `quantize_scale` (w8a8_static's producer-side handoff: the consuming
    conv's calibrated scale) makes it emit that conv's int8 input through
    the kernel's int8 epilogue."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act: str | None = None, device=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor,
                quantize_scale: torch.Tensor | None = None) -> torch.Tensor:
        if quantize_scale is not None:
            return fused_group_norm(x, self.weight, self.bias,
                                    self.num_groups, self.eps, self.act,
                                    act_scale=quantize_scale)
        fn = group_norm if torch.is_grad_enabled() else fused_group_norm
        return fn(x, self.weight, self.bias, self.num_groups, self.eps,
                  self.act)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and affine, output in the input dtype
    (flax `nn.LayerNorm(dtype=...)` semantics)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__(dim, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class QLinear(nn.Linear):
    """nn.Linear that honours the quantization mode: int8 through the W8A8
    dense kernel (static or dynamic activation scale) when the mode
    quantizes its layer, its input amax recorded under calibration.
    `bias=False` in a call leaves the bias out (a row-parallel layer adds
    it after the model group's sum)."""

    path: str | None = None
    row_tp = None  # the mesh, when this layer is row-parallel

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        cin, cout = self.in_features, self.out_features
        b = self.bias if bias else None
        if quant.calibrating() and min(cin, cout) >= quant.MIN_QUANT_CHANNELS:
            quant.record_amax(self.path, x, self.row_tp)
        elif quant.quantizable(cin, cout, self.path):
            scale = quant.static_scale(self.path, x.device)
            return fused_w8a8_dense(
                x, *quant.module_weight_q8(self), b,
                quant.dynamic_scale(x, self.row_tp) if scale is None
                else scale, out_dtype=self.weight.dtype)
        return F.linear(x, self.weight, b)


def row_parallel(linear: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel layer's output: without a mesh `linear(x)`; under
    one, this rank's partial product summed over the model group (g), then
    the whole bias, once."""
    if tp is None:
        return linear(x)
    if isinstance(linear, QLinear):
        y = linear(x, bias=False)
    else:
        y = F.linear(x, linear.weight)
    y = reduce_from_model(y, tp)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d through ops.conv.conv2d: the same parameters and math,
    with every row's bits independent of its batch slot inside
    ops.conv.slot_invariant_region (the serving contract)."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
        if self.padding_mode != "zeros":
            return super()._conv_forward(x, weight, bias)
        return conv2d(x, weight, bias, self.stride, self.padding,
                      self.dilation, self.groups)


class QConv2d(Conv2d):
    """nn.Conv2d that honours the quantization mode (the reference's QConv).
    An int8 input is a producer-side pre-quantized activation, quantized
    with this layer's calibrated scale."""

    path: str | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cin, cout = self.in_channels, self.out_channels
        if x.dtype == torch.int8:
            scale = quant.static_scale(self.path, x.device)
            if scale is None:
                raise ValueError(
                    f"int8 input reached conv {self.path} without a "
                    "calibrated static scale — producer-side quantize out "
                    "of sync")
            return self._int8(x, scale)
        if quant.calibrating() and min(cin, cout) >= quant.MIN_QUANT_CHANNELS:
            quant.record_amax(self.path, x)
        elif quant.quantizable(cin, cout, self.path):
            return self._int8(x, quant.static_scale(self.path, x.device))
        return super().forward(x)

    def _int8(self, x: torch.Tensor,
              scale: torch.Tensor | None) -> torch.Tensor:
        dtype = self.weight.dtype
        q8 = quant.module_weight_q8(self)
        if (self.kernel_size, self.stride, self.padding) == (
                (1, 1), (1, 1), (0, 0)):
            # a 1×1 stride-1 conv is a dense over [N·H·W, C]
            n, c, h, w = x.shape
            if scale is None:
                scale = quant.dynamic_scale(x)
            y = fused_w8a8_dense(x.permute(0, 2, 3, 1).reshape(-1, c), *q8,
                                 self.bias, scale, out_dtype=dtype)
            return y.reshape(n, h, w, -1).permute(0, 3, 1, 2)
        y = quant.w8a8_conv(x, self.weight, self.stride, self.padding, dtype,
                            scale, q8=q8)
        return y + self.bias.to(dtype)[:, None, None]


def conv3x3(cin: int, cout: int, dtype, device, stride: int = 1,
            cls: type[nn.Conv2d] = Conv2d) -> nn.Conv2d:
    return cls(cin, cout, 3, stride=stride, padding=1, dtype=dtype,
               device=device)


def _handoff_scale(conv: QConv2d, x: torch.Tensor) -> torch.Tensor | None:
    """The consuming conv's calibrated w8a8_static scale, when that conv is
    quantized: its producer then emits the int8 activation itself."""
    if (quant.quantization() != "w8a8_static" or not quant.quantizable(
            conv.in_channels, conv.out_channels, conv.path)):
        return None
    return quant.static_scale(conv.path, x.device)


def _nearest_exact(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with the half-pixel rule of `nearest-exact` (source
    index floor((i + 0.5) · in / out)) as an index gather, which int8
    tensors take."""
    def index(n_in, n_out):
        i = torch.arange(n_out, device=x.device)
        return ((2 * i + 1) * n_in // (2 * n_out)).clamp(max=n_in - 1)

    x = x.index_select(2, index(x.shape[2], size[0]))
    return x.index_select(3, index(x.shape[3], size[1]))


class ResnetBlock2D(nn.Module):
    """GN+SiLU+Conv ×2 with additive time embedding and a 1×1 shortcut when
    the width changes. With `dropout` > 0, a call given `keep` (a function
    of the activation's shape returning its bool keep mask) drops the
    second conv's input as flax's nn.Dropout does: kept units scaled by
    1 / (1 − dropout), the rest zeroed. Without `keep` (inference, the
    int8 paths) the dropout is the identity, as the reference's
    deterministic call."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, groups: int = 32,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 device=None, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm1 = GroupNorm(in_channels, groups, eps, "silu", device)
        self.conv1 = conv3x3(in_channels, out_channels, dtype, device,
                             cls=QConv2d)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels, dtype=dtype, device=device)
            if temb_channels is not None else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, "silu", device)
        self.conv2 = conv3x3(out_channels, out_channels, dtype, device,
                             cls=QConv2d)
        self.conv_shortcut = (
            QConv2d(in_channels, out_channels, 1, dtype=dtype, device=device)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None,
                keep: Callable[[tuple[int, ...]], torch.Tensor] | None = None
                ) -> torch.Tensor:
        h = self.conv1(self.norm1(x, _handoff_scale(self.conv1, x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        if keep is None or self.dropout == 0.0:
            h = self.conv2(self.norm2(h, _handoff_scale(self.conv2, h)))
        else:
            # training never quantizes: no int8 handoff into the dropout
            h = self.norm2(h)
            mask = keep(tuple(h.shape)).to(h.device)
            h = self.conv2(torch.where(mask, h / (1.0 - self.dropout),
                                       torch.zeros_like(h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Attention(nn.Module):
    """Multi-head attention with SD naming (to_q/to_k/to_v/to_out.0) over
    [N, T, C] tokens; self-attention when `context` is None.

    Inside ops.attention.fused_mha_region(True), a call that
    ops.attention.use_fused_mha admits runs the whole block — projections,
    attention, output projection — in the fused MHA kernel on the modules'
    own [out, in] weights, and adds the output bias (the reference's fused
    branch, unet_blocks.py:297-303); any other call runs the projections
    and ops.dot_product_attention. Under tensor parallelism (`tp`) each
    path runs this rank's heads/k heads and g sums the out-projection's
    partial products (module docstring)."""

    tp = None  # the mesh, when shard_params split this block

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        kv_dim = context_dim or query_dim
        kw = dict(dtype=dtype, device=device)
        self.to_q = QLinear(query_dim, inner, bias=qkv_bias, **kw)
        self.to_k = QLinear(kv_dim, inner, bias=qkv_bias, **kw)
        self.to_v = QLinear(kv_dim, inner, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList([QLinear(inner, query_dim, **kw)])

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        dtype = self.to_q.weight.dtype
        x = copy_to_model(x.to(dtype), self.tp)
        ctx = x if context is None else copy_to_model(context.to(dtype),
                                                      self.tp)
        heads = self.to_q.weight.shape[0] // self.head_dim  # this rank's
        out = self.to_out[0]
        if use_fused_mha(x, ctx, heads, self.head_dim,
                         self.to_q.bias is not None, is_self=context is None):
            y = fused_mha_linear(
                x, ctx, self.to_q.weight, self.to_k.weight, self.to_v.weight,
                out.weight, num_heads=heads, head_dim=self.head_dim)
            return reduce_from_model(y, self.tp) + out.bias.to(dtype)
        n, tq, tk = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(n, tq, heads, self.head_dim)
        k = self.to_k(ctx).view(n, tk, heads, self.head_dim)
        v = self.to_v(ctx).view(n, tk, heads, self.head_dim)
        o = dot_product_attention(q, k, v)
        return row_parallel(out, o.reshape(n, tq, heads * self.head_dim),
                            self.tp)


class SpatialSelfAttention(Attention):
    """GN → spatial tokens → self-attention → residual: the VAE mid-block
    attention (diffusers keys `group_norm`, `to_q`, ..., `to_out.0`).
    `num_heads=None` means C/64 heads, as in the reference."""

    def __init__(self, channels: int, num_heads: int | None = None,
                 groups: int = 32, eps: float = 1e-5, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        heads = num_heads or max(1, channels // 64)
        super().__init__(channels, heads, channels // heads,
                         qkv_bias=qkv_bias, dtype=dtype, device=device)
        self.group_norm = GroupNorm(channels, groups, eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.group_norm(x).reshape(n, c, h * w).transpose(1, 2)
        y = super().forward(y)
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, device):
        super().__init__()
        self.proj = QLinear(dim, 2 * hidden, dtype=dtype, device=device)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers keys `net.0.proj`, `net.2`), the
    reference's three-way dispatch (:389-428): full precision takes the
    fused GEGLU kernel's wrapper without autograd (its bf16 form, or its
    fp32 form for an fp32 model; the plain version under autograd); with
    both layers quantized, w8a8_static takes the static int8 GEGLU kernel
    and dynamic w8a8 the per-token one; anything else (calibration, a
    layer left out) runs the two QLinears one by one. The
    kernels mask any token count, so the mid-block FF at 64 tokens takes
    them too.

    Under tensor parallelism (`tp`) the kernels take this rank's H/k
    hidden units (W1 as [a_m; gate_m]) and a zero b2; g sums the partial
    outputs and b2 is added once after it. Dynamic w8a8 is the exception:
    the per-token GEGLU quantizes h in groups of `block_h(C, H)` units
    that would straddle the ranks' slices (at C = 640, k = 2 a group of
    512 across 1,280 units), so under k > 1 its FF runs the two QLinears
    through the W8A8 dense kernel, with the model group's max as the
    second one's scale: the per-layer path the reference runs under a
    mesh (polyp_tpu/models/unet_blocks.py:391)."""

    tp = None  # the mesh, when shard_params split this block

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            _GEGLUProj(dim, dim * mult, dtype, device),
            nn.Identity(),  # diffusers' dropout slot, so net.2 keeps its key
            QLinear(dim * mult, dim, dtype=dtype, device=device),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out, tp = self.net[0].proj, self.net[2], self.tp
        x = copy_to_model(x.to(proj.weight.dtype), tp)
        # under tp the kernels add a zero b2; the whole b2 comes after g
        b2 = out.bias if tp is None else torch.zeros_like(out.bias)
        mode = quant.quantization()
        if mode is None:
            fn = reference_geglu if torch.is_grad_enabled() else fused_geglu
            y = fn(x, proj.weight, proj.bias, out.weight, b2)
        elif all(quant.quantizable(m.in_features, m.out_features, m.path)
                 for m in (proj, out)) and not (mode == "w8a8" and tp):
            weights = (*quant.module_weight_q8(proj), proj.bias,
                       *quant.module_weight_q8(out), b2)
            if mode == "w8a8":
                y = fused_geglu_w8a8_pt(x, *weights)
            else:
                y = fused_geglu_w8a8(
                    x, *weights, quant.static_scale(proj.path, x.device),
                    quant.static_scale(out.path, x.device))
        else:
            a, gate = proj(x).chunk(2, dim=-1)
            return row_parallel(out, a * F.gelu(gate), tp)
        if tp is None:
            return y
        return reduce_from_model(y, tp) + out.bias.to(y.dtype)


class BasicTransformerBlock(nn.Module):
    """LN→self-attn, LN→cross-attn, LN→GEGLU-FF with residuals (SD
    layout; LayerNorm eps 1e-5 as diffusers' norm_eps)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: int | None = 768,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn1 = Attention(dim, heads, head_dim, **kw)
        self.norm2 = LayerNorm(dim, device=device)
        self.attn2 = (Attention(dim, heads, head_dim, context_dim, **kw)
                      if context_dim is not None else None)
        self.norm3 = LayerNorm(dim, device=device)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        if self.attn2 is not None:
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN → 1×1 proj_in → transformer blocks over spatial tokens → 1×1
    proj_out → residual (SD Transformer2DModel, conv-projection variant)."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 depth: int = 1, context_dim: int | None = 768,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        inner = heads * head_dim
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm(channels, 32, 1e-6, device=device)
        self.proj_in = QConv2d(channels, inner, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, context_dim, **kw)
            for _ in range(depth)])
        self.proj_out = QConv2d(inner, channels, 1, **kw)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        n, _, h, w = x.shape
        y = self.proj_in(self.norm(x, _handoff_scale(self.proj_in, x)))
        inner = y.shape[1]
        y = y.permute(0, 2, 3, 1).reshape(n, h * w, inner)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.reshape(n, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class Downsample2D(nn.Module):
    """Stride-2 3×3 conv. The UNet pads symmetrically; the VAE encoder
    (`asymmetric=True`) pads (0, 1, 0, 1) and convolves VALID, as diffusers'
    Encoder does. The two are not value-equivalent: the window phase
    differs (the reference's :487-505)."""

    def __init__(self, channels: int, out_channels: int,
                 asymmetric: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = QConv2d(channels, out_channels, 3, stride=2,
                            padding=0 if asymmetric else 1, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest-neighbour resize to `out_size` (default 2×) + 3×3 conv.
    `nearest-exact` is the half-pixel-centre rule of the reference's
    `jax.image.resize(..., "nearest")`, so sizes that are not an exact 2×
    (the up path meeting an odd skip size) match too. Under w8a8_static the
    input is quantized before the resize (which only duplicates values, so
    the two commute) and resized as int8, as the reference does
    (:525-536)."""

    def __init__(self, channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = conv3x3(channels, out_channels, dtype, device,
                            cls=QConv2d)

    def forward(self, x: torch.Tensor,
                out_size: tuple[int, int] | None = None) -> torch.Tensor:
        size = (tuple(out_size) if out_size is not None
                else (2 * x.shape[2], 2 * x.shape[3]))
        s = _handoff_scale(self.conv, x)
        if s is not None:
            x = quant.quantize_activation(x, s)[0]
            return self.conv(_nearest_exact(x, size))
        return self.conv(F.interpolate(x, size=size, mode="nearest-exact"))
