"""SimpleUNet, the minimal educational diffusion UNet: the twin of
polyp_tpu/models/simple_unet.py.

The reference's legacy stack had a hand-rolled `SimpleUNet`: 3 down / 2
bottleneck / 3 up conv blocks, each with a per-block time MLP, and a tanh
output. NCHW modules named as the reference's tree (`down_0.conv1`,
`up_2.upconv`, `mid_conv1`, ...), so `importers.simple_unet_from_jax`
carries its weights. Two details keep the reference's values: a stride-2
3×3 conv pads as XLA's SAME does (nothing before and one after on an even
side), and the 2× nearest resize of `jax.image.resize(..., "nearest")`
is torch's `nearest-exact`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from polyp_tpu_torch.models.unet_blocks import (
    Conv2d, conv3x3, sinusoidal_time_embedding)


class StridedSameConv(Conv2d):
    """A 3×3 stride-2 conv with XLA's SAME padding: the total padding of
    a side is max((ceil(n / 2) - 1) · 2 + 3 - n, 0), the smaller half
    before."""

    def __init__(self, cin: int, cout: int, dtype, device):
        super().__init__(cin, cout, 3, stride=2, padding=0, dtype=dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad: the last dim first
            total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class SimpleBlock(nn.Module):
    """conv-ReLU, + the time MLP of ReLU(temb), conv-ReLU, then a stride-2
    conv down, or a 2× nearest resize and a conv up (the legacy
    `Block`)."""

    def __init__(self, in_channels: int, features: int, time_dim: int,
                 up: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.up = up
        self.conv1 = conv3x3(in_channels, features, **kw)
        self.time_mlp = nn.Linear(time_dim, features, **kw)
        self.conv2 = conv3x3(features, features, **kw)
        if up:
            self.upconv = conv3x3(features, features, **kw)
        else:
            self.downconv = StridedSameConv(features, features, **kw)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(x))
        h = h + self.time_mlp(F.relu(temb))[:, :, None, None]
        h = F.relu(self.conv2(h))
        if self.up:
            return self.upconv(F.interpolate(h, scale_factor=2,
                                             mode="nearest-exact"))
        return self.downconv(h)


class SimpleUNet(nn.Module):
    """3 down / 2 bottleneck / 3 up blocks, skip connections, tanh
    output; `conv_out` in fp32, as in the reference."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 features: Sequence[int] = (64, 128, 256),
                 time_dim: int = 128, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dtype, self.time_dim = dtype, time_dim
        f = list(features)
        self.time_proj = nn.Linear(time_dim, time_dim, **kw)
        self.conv_in = conv3x3(in_channels, f[0], **kw)
        prev = f[0]
        for i, c in enumerate(f):
            self.add_module(f"down_{i}", SimpleBlock(prev, c, time_dim, **kw))
            prev = c
        self.mid_conv1 = conv3x3(f[-1], f[-1], **kw)
        self.mid_conv2 = conv3x3(f[-1], f[-1], **kw)
        # skips, popped last first: conv_in's output, then each down
        # block's output but the last
        skips = [f[0]] + f[:-1]
        for i, c in enumerate(reversed(f)):
            self.add_module(f"up_{i}", SimpleBlock(prev, c, time_dim,
                                                   up=True, **kw))
            prev = c + skips.pop()
        self.conv_out = conv3x3(prev, out_channels, torch.float32, device)

    def forward(self, x: torch.Tensor,
                timesteps: torch.Tensor) -> torch.Tensor:
        temb = sinusoidal_time_embedding(timesteps, self.time_dim)
        temb = self.time_proj(temb.to(self.dtype))
        h = self.conv_in(x.to(self.dtype))
        skips = []
        for block in self.blocks("down"):
            skips.append(h)
            h = block(h, temb)
        h = F.relu(self.mid_conv1(h))
        h = F.relu(self.mid_conv2(h))
        for block in self.blocks("up"):
            h = torch.cat([block(h, temb), skips.pop()], dim=1)
        return torch.tanh(self.conv_out(h.float()))

    def blocks(self, side: str) -> list[SimpleBlock]:
        """The `down_{i}` or `up_{i}` blocks in order."""
        out, i = [], 0
        while hasattr(self, f"{side}_{i}"):
            out.append(getattr(self, f"{side}_{i}"))
            i += 1
        return out
