"""Text-conditional latent UNet — the SD-v1-4 denoiser: the twin of
polyp_tpu/models/unet_condition.py.

State-dict keys are exactly diffusers' `UNet2DConditionModel` keys
(`down_blocks.{i}.resnets.{j}`, `.attentions.{j}`, `.downsamplers.0.conv`,
`mid_block.*`, `up_blocks.*`, ...), listed for the full model in
tests/fixtures/manifests/sd14_unet.json. Activations run in `dtype`;
`conv_out` runs in fp32, as in the reference (unet_condition.py:108).

Under ops/quant.py's modes every QConv2d and QLinear is keyed by its
module name (`down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj`,
`up_blocks.1.upsamplers.0.conv`, ...): the names of calibrated scales.
`conv_in`, `conv_out` and the time-embedding linears stay full precision,
as in the reference (:69, :108).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from polyp_tpu_torch.models.unet_blocks import (
    Downsample2D,
    GroupNorm,
    QConv2d,
    QLinear,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    conv3x3,
)

SD14_CONFIG = dict(
    in_channels=4,
    out_channels=4,
    block_out_channels=(320, 640, 1280, 1280),
    layers_per_block=2,
    cross_attention_dim=768,
    attention_num_heads=8,
    down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                      "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                    "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
)


class UNetStage(nn.Module):
    """One diffusers down/mid/up block: `resnets`, optional `attentions`
    (one per resnet), optional `downsamplers`/`upsamplers` (one module).
    The UNet's forward walks it."""

    def __init__(self, resnets, attentions=None, downsample=None,
                 upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsamplers = nn.ModuleList([downsample]) if downsample else None
        self.upsamplers = nn.ModuleList([upsample]) if upsample else None


class UNet2DCondition(nn.Module):

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, cross_attention_dim: int = 768,
                 attention_num_heads: int = 8,
                 down_block_types: Sequence[str] = SD14_CONFIG[
                     "down_block_types"],
                 up_block_types: Sequence[str] = SD14_CONFIG["up_block_types"],
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ch = list(block_out_channels)
        heads = attention_num_heads
        temb = ch[0] * 4
        kw = dict(dtype=dtype, device=device)

        def transformer(c):
            return Transformer2D(c, heads, c // heads, depth=1,
                                 context_dim=cross_attention_dim, **kw)

        self.conv_in = conv3x3(in_channels, ch[0], **kw)
        self.time_embedding = TimestepEmbedding(ch[0], temb, **kw)

        skip_ch = [ch[0]]
        self.down_blocks = nn.ModuleList()
        c_prev = ch[0]
        for i, (c_out, btype) in enumerate(zip(ch, down_block_types)):
            cross = btype == "CrossAttnDownBlock2D"
            resnets, attns = [], []
            for j in range(layers_per_block):
                resnets.append(ResnetBlock2D(c_prev if j == 0 else c_out,
                                             c_out, temb, **kw))
                if cross:
                    attns.append(transformer(c_out))
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
            [transformer(ch[-1])])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i, (c_out, btype) in enumerate(zip(rev, up_block_types)):
            cross = btype == "CrossAttnUpBlock2D"
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(ResnetBlock2D(c_prev + skip_ch.pop(), c_out,
                                             temb, **kw))
                if cross:
                    attns.append(transformer(c_out))
                c_prev = c_out
            up = Upsample2D(c_out, c_out, **kw) if i < len(rev) - 1 else None
            self.up_blocks.append(UNetStage(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-5, "silu", device)
        self.conv_out = conv3x3(ch[0], out_channels, torch.float32, device)
        for name, module in self.named_modules():
            if isinstance(module, (QConv2d, QLinear)):
                module.path = name

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """x: [N, C, H, W] latents (any float dtype; cast on entry);
        timesteps: [N] ints; encoder_hidden_states: [N, L, D]. Returns fp32."""
        temb = self.time_embedding(timesteps)
        ctx = encoder_hidden_states.to(self.dtype)
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


def sd14_unet(dtype: torch.dtype = torch.bfloat16,
              device=None) -> UNet2DCondition:
    return UNet2DCondition(**SD14_CONFIG, dtype=dtype, device=device)


def tiny_condition_unet(dtype: torch.dtype = torch.float32,
                        device=None) -> UNet2DCondition:
    """Miniature conditional UNet for tests and smoke runs."""
    return UNet2DCondition(
        in_channels=4, out_channels=4, block_out_channels=(32, 64),
        layers_per_block=1, cross_attention_dim=32, attention_num_heads=2,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), dtype=dtype,
        device=device)
