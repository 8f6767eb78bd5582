"""Shared UNet building blocks: the twin of polyp_tpu/models/unet_blocks.py
(full-precision path).

NCHW `nn.Module`s whose parameter names are diffusers' (`to_q`, `to_out.0`,
`ff.net.0.proj`, `proj_in`, `time_emb_proj`, ...), so diffusers checkpoints
load with `strict=True`. Precision follows the reference: weights and
activations in the module's `dtype` (bf16 for sampling), GroupNorm and
LayerNorm statistics and affine in fp32 with the output cast back.

Kernels: GroupNorm and FeedForward take the hand-written CUDA kernels
(ops/fused_gn.py, ops/fused_geglu.py) when autograd is off — the wrappers
then launch on CUDA tensors and run the plain versions on CPU tensors —
and the plain versions under autograd; attention goes through
ops.dot_product_attention's shape policy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from polyp_tpu_torch.ops import dot_product_attention, group_norm
from polyp_tpu_torch.ops.fused_geglu import fused_geglu, reference_geglu
from polyp_tpu_torch.ops.fused_gn import fused_group_norm


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
    (ops/fused_gn.py); under autograd, the plain ops.group_norm."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act: str | None = None, device=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


def conv3x3(cin: int, cout: int, dtype, device, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, dtype=dtype,
                     device=device)


class ResnetBlock2D(nn.Module):
    """GN+SiLU+Conv ×2 with additive time embedding and a 1×1 shortcut when
    the width changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int | None = None, groups: int = 32,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, "silu", device)
        self.conv1 = conv3x3(in_channels, out_channels, dtype, device)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels, dtype=dtype, device=device)
            if temb_channels is not None else None)
        self.norm2 = GroupNorm(out_channels, groups, eps, "silu", device)
        self.conv2 = conv3x3(out_channels, out_channels, dtype, device)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1, dtype=dtype, device=device)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Attention(nn.Module):
    """Multi-head attention with SD naming (to_q/to_k/to_v/to_out.0) over
    [N, T, C] tokens; self-attention when `context` is None."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        kv_dim = context_dim or query_dim
        kw = dict(dtype=dtype, device=device)
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias, **kw)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias, **kw)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, **kw)])

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        dtype = self.to_q.weight.dtype
        x = x.to(dtype)
        ctx = x if context is None else context.to(dtype)
        n, tq, tk = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(n, tq, self.heads, self.head_dim)
        k = self.to_k(ctx).view(n, tk, self.heads, self.head_dim)
        v = self.to_v(ctx).view(n, tk, self.heads, self.head_dim)
        out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(n, tq, self.heads * self.head_dim))


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
        self.proj = nn.Linear(dim, 2 * hidden, dtype=dtype, device=device)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers keys `net.0.proj`, `net.2`). Without
    autograd it runs the fused GEGLU kernel's wrapper (ops/fused_geglu.py),
    under autograd the plain version. The kernel masks any token count, so
    the mid-block FF at 64 tokens takes it too."""

    def __init__(self, dim: int, mult: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            _GEGLUProj(dim, dim * mult, dtype, device),
            nn.Identity(),  # diffusers' dropout slot, so net.2 keeps its key
            nn.Linear(dim * mult, dim, dtype=dtype, device=device),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        fn = reference_geglu if torch.is_grad_enabled() else fused_geglu
        return fn(x.to(proj.weight.dtype), proj.weight, proj.bias,
                  out.weight, out.bias)


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
        self.proj_in = nn.Conv2d(channels, inner, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim, context_dim, **kw)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner, channels, 1, **kw)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        n, _, h, w = x.shape
        y = self.proj_in(self.norm(x))
        inner = y.shape[1]
        y = y.permute(0, 2, 3, 1).reshape(n, h * w, inner)
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.reshape(n, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class Downsample2D(nn.Module):
    """Stride-2 3×3 conv with symmetric padding (the UNet's convention; the
    VAE encoder's (0,1,0,1) variant comes with the encoder)."""

    def __init__(self, channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = conv3x3(channels, out_channels, dtype, device, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest-neighbour resize to `out_size` (default 2×) + 3×3 conv.
    `nearest-exact` is the half-pixel-centre rule of the reference's
    `jax.image.resize(..., "nearest")`, so sizes that are not an exact 2×
    (the up path meeting an odd skip size) match too."""

    def __init__(self, channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = conv3x3(channels, out_channels, dtype, device)

    def forward(self, x: torch.Tensor,
                out_size: tuple[int, int] | None = None) -> torch.Tensor:
        size = (tuple(out_size) if out_size is not None
                else (2 * x.shape[2], 2 * x.shape[3]))
        return self.conv(F.interpolate(x, size=size, mode="nearest-exact"))
