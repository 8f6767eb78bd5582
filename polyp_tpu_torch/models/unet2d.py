"""The scratch-trainable pixel-space diffusion UNet: the twin of
polyp_tpu/models/unet2d.py.

The reference's from-scratch generator is diffusers' `UNet2DModel(
sample_size=224, layers_per_block=2, block_out_channels=(128, 128, 256,
256, 512, 512), AttnDownBlock2D at down position 4, AttnUpBlock2D at up
position 1)` (`POLYP_SCRATCH_CONFIG`). `cross_attention_dim` adds a
cross-attention beside each self-attention, the text conditioning the
reference's `--conditional_generation` intends.

NCHW modules from models/unet_blocks.py, named as the reference's tree
maps through models/importers.py's rules (`down_0_res_1` →
`down_blocks.0.resnets.1`, `mid_attn` → `mid_block.attentions.0`, ...),
so `importers.unet2d_from_jax` carries the JAX package's weights and
`importers.scales_from_jax` its calibrated scales. The attentions have
C / 64 heads (`SpatialSelfAttention`'s default, the reference's choice).
Activations run in `dtype`; `conv_out` runs in fp32, as in the reference
(unet2d.py:130-131). The up path resizes to the next skip's size, so
sizes that are not an exact power of two meet their skips (56 px: 7 → 4
→ 7).

`conv_in`, `conv_out` and the time-embedding linears stay full precision
under ops/quant.py's modes, as in the reference; every other conv and
attention projection is a QConv2d / QLinear keyed by its module name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from polyp_tpu_torch.models.unet_blocks import (
    Attention,
    Downsample2D,
    GroupNorm,
    QConv2d,
    QLinear,
    ResnetBlock2D,
    SpatialSelfAttention,
    TimestepEmbedding,
    Upsample2D,
    conv3x3,
)
from polyp_tpu_torch.models.unet_condition import UNetStage

# the reference's scratch configuration (PolypGeneratorModel.py:25-48)
POLYP_SCRATCH_CONFIG = dict(
    block_out_channels=(128, 128, 256, 256, 512, 512),
    down_block_types=("DownBlock2D", "DownBlock2D", "DownBlock2D",
                      "DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D",
                    "UpBlock2D", "UpBlock2D", "UpBlock2D"),
    layers_per_block=2,
)


class MaybeCrossAttention(nn.Module):
    """Self-attention (`attn`), then, in a conditioned model given a
    context, GroupNorm (`cross_norm`) → cross-attention (`cross_attn`) →
    residual (the reference's `_MaybeCrossAttention`)."""

    def __init__(self, channels: int, cross_attention_dim: int | None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.attn = SpatialSelfAttention(channels, dtype=dtype,
                                         device=device)
        self.cross_norm = self.cross_attn = None
        if cross_attention_dim is not None:
            heads = max(1, channels // 64)
            self.cross_norm = GroupNorm(channels, 32, 1e-5, device=device)
            self.cross_attn = Attention(channels, heads, channels // heads,
                                        cross_attention_dim, dtype=dtype,
                                        device=device)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        x = self.attn(x)
        if self.cross_attn is None or context is None:
            return x
        n, c, h, w = x.shape
        y = self.cross_norm(x).reshape(n, c, h * w).transpose(1, 2)
        y = self.cross_attn(y, context)
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class UNet2D(nn.Module):

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = POLYP_SCRATCH_CONFIG[
                     "block_out_channels"],
                 down_block_types: Sequence[str] = POLYP_SCRATCH_CONFIG[
                     "down_block_types"],
                 up_block_types: Sequence[str] = POLYP_SCRATCH_CONFIG[
                     "up_block_types"],
                 layers_per_block: int = 2,
                 cross_attention_dim: int | None = None,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if dropout != 0.0:
            raise NotImplementedError(
                f"UNet2D dropout={dropout}: the port's ResnetBlock2D has no "
                "dropout, and every entry point of the reference trains at "
                "0.0 (ROADMAP.md Queue 3 lists the gap)")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dtype = dtype
        ch = list(block_out_channels)
        temb = ch[0] * 4
        kw = dict(dtype=dtype, device=device)

        def attention(c):
            return MaybeCrossAttention(c, cross_attention_dim, **kw)

        self.time_embedding = TimestepEmbedding(ch[0], temb, **kw)
        self.conv_in = conv3x3(in_channels, ch[0], **kw)

        skip_ch = [ch[0]]
        self.down_blocks = nn.ModuleList()
        c_prev = ch[0]
        for i, (c_out, btype) in enumerate(zip(ch, down_block_types)):
            attn = btype == "AttnDownBlock2D"
            resnets, attns = [], []
            for j in range(layers_per_block):
                resnets.append(ResnetBlock2D(c_prev if j == 0 else c_out,
                                             c_out, temb, **kw))
                if attn:
                    attns.append(attention(c_out))
                skip_ch.append(c_out)
            down = None
            if i < len(ch) - 1:
                down = Downsample2D(c_out, c_out, **kw)
                skip_ch.append(c_out)
            self.down_blocks.append(UNetStage(resnets, attns, downsample=down))
            c_prev = c_out

        self.mid_block = UNetStage(
            [ResnetBlock2D(ch[-1], ch[-1], temb, **kw),
             ResnetBlock2D(ch[-1], ch[-1], temb, **kw)],
            [attention(ch[-1])])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i, (c_out, btype) in enumerate(zip(rev, up_block_types)):
            attn = btype == "AttnUpBlock2D"
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(ResnetBlock2D(c_prev + skip_ch.pop(), c_out,
                                             temb, **kw))
                if attn:
                    attns.append(attention(c_out))
                c_prev = c_out
            up = Upsample2D(c_out, c_out, **kw) if i < len(rev) - 1 else None
            self.up_blocks.append(UNetStage(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-5, "silu", device)
        self.conv_out = conv3x3(ch[0], out_channels, torch.float32, device)
        for name, module in self.named_modules():
            if isinstance(module, (QConv2d, QLinear)):
                module.path = name

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x: [N, C, H, W] images (any float dtype; cast on entry);
        timesteps: [N] ints; encoder_hidden_states: [N, L, D] or None.
        Returns fp32."""
        temb = self.time_embedding(timesteps)
        ctx = (None if encoder_hidden_states is None
               else encoder_hidden_states.to(self.dtype))
        h = self.conv_in(x.to(self.dtype))
        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if block.attentions is not None:
                    h = block.attentions[j](h, ctx)
                skips.append(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0](h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if block.attentions is not None:
                    h = block.attentions[j](h, ctx)
            if block.upsamplers is not None:
                # to the next skip's size, so odd sizes reconcile going up
                h = block.upsamplers[0](h, out_size=skips[-1].shape[2:])

        h = self.conv_norm_out(h)
        return self.conv_out(h.float())


def tiny_scratch_unet(cross_attention_dim: int | None = None,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> UNet2D:
    """The miniature scratch UNet for tests and smoke runs: the reference
    architecture's block taxonomy on 2 levels instead of 6."""
    return UNet2D(in_channels=3, out_channels=3, block_out_channels=(16, 32),
                  down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                  up_block_types=("AttnUpBlock2D", "UpBlock2D"),
                  layers_per_block=1, cross_attention_dim=cross_attention_dim,
                  dtype=dtype, device=device)


def polyp_scratch_unet(image_channels: int = 3,
                       cross_attention_dim: int | None = None,
                       dtype: torch.dtype = torch.bfloat16,
                       device=None) -> UNet2D:
    """The reference scratch architecture, bf16 compute by default."""
    return UNet2D(in_channels=image_channels, out_channels=image_channels,
                  cross_attention_dim=cross_attention_dim, dtype=dtype,
                  device=device, **POLYP_SCRATCH_CONFIG)
