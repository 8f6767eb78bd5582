"""AutoencoderKL — the SD latent-space VAE: the twin of
polyp_tpu/models/vae.py (Encoder, Decoder, quant_conv, post_quant_conv,
DiagonalGaussian).

State-dict keys are diffusers' `AutoencoderKL` keys (`encoder.*`,
`quant_conv.*`, `decoder.*`, `post_quant_conv.*`;
tests/fixtures/manifests/sd14_vae.json). The encoder's downsamples pad
(0, 1, 0, 1) and convolve VALID, unlike the UNet's. Both convs at the
latent end (`conv_out` of each half, `quant_conv`, `post_quant_conv`) run
in fp32, as in the reference (vae.py:75,103,112-115,119). The frozen
encode of the LoRA trainer runs under `torch.no_grad()`, so its GroupNorms
take the GroupNorm kernel on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from polyp_tpu_torch.models.unet_blocks import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SpatialSelfAttention,
    Upsample2D,
    conv3x3,
)
from polyp_tpu_torch.models.unet_condition import UNetStage

SD_VAE_SCALING = 0.18215


class DiagonalGaussian:
    """Posterior q(z|x) from (mean ‖ logvar) moments split on the channel
    dim of NCHW; logvar clipped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std · `noise` (a standard normal draw of mean's shape,
        made by the caller)."""
        return self.mean + self.std * noise

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(self.mean ** 2 + torch.exp(self.logvar)
                               - 1.0 - self.logvar, dim=(1, 2, 3))


class Encoder(nn.Module):

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ch = list(block_out_channels)
        kw = dict(dtype=dtype, device=device)

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, None, eps=1e-6, **kw)

        self.conv_in = conv3x3(in_channels, ch[0], **kw)
        self.down_blocks = nn.ModuleList()
        c_prev = ch[0]
        for i, c in enumerate(ch):
            resnets = [resnet(c_prev if j == 0 else c, c)
                       for j in range(layers_per_block)]
            down = (Downsample2D(c, c, asymmetric=True, **kw)
                    if i < len(ch) - 1 else None)
            self.down_blocks.append(UNetStage(resnets, downsample=down))
            c_prev = c
        self.mid_block = UNetStage(
            [resnet(ch[-1], ch[-1]), resnet(ch[-1], ch[-1])],
            [SpatialSelfAttention(ch[-1], num_heads=1, eps=1e-6,
                                  qkv_bias=True, **kw)])
        self.conv_norm_out = GroupNorm(ch[-1], 32, 1e-6, "silu", device)
        self.conv_out = conv3x3(ch[-1], 2 * latent_channels, torch.float32,
                                device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0](h)
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(self.conv_norm_out(h).float())


class Decoder(nn.Module):

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, out_channels: int = 3,
                 latent_channels: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        ch = list(reversed(block_out_channels))  # (512, 512, 256, 128)
        kw = dict(dtype=dtype, device=device)

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, None, eps=1e-6, **kw)

        self.conv_in = conv3x3(latent_channels, ch[0], **kw)
        self.mid_block = UNetStage(
            [resnet(ch[0], ch[0]), resnet(ch[0], ch[0])],
            [SpatialSelfAttention(ch[0], num_heads=1, eps=1e-6, qkv_bias=True,
                                  **kw)])
        self.up_blocks = nn.ModuleList()
        c_prev = ch[0]
        for i, c in enumerate(ch):
            resnets = [resnet(c_prev if j == 0 else c, c)
                       for j in range(layers_per_block)]
            up = Upsample2D(c, c, **kw) if i < len(ch) - 1 else None
            self.up_blocks.append(UNetStage(resnets, upsample=up))
            c_prev = c
        self.conv_norm_out = GroupNorm(ch[-1], 32, 1e-6, "silu", device)
        self.conv_out = conv3x3(ch[-1], out_channels, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.to(self.dtype))
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if block.upsamplers is not None:
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h).float())


class AutoencoderKL(nn.Module):

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder = Encoder(block_out_channels, 2, latent_channels,
                               dtype=dtype, device=device)
        self.decoder = Decoder(block_out_channels, 3, 3, latent_channels,
                               dtype=dtype, device=device)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1,
                                 dtype=torch.float32, device=device)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1,
                                      dtype=torch.float32, device=device)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Images [N, 3, H, W] in about [-1, 1] → fp32 (mean ‖ logvar)
        [N, 2·latent, H/8, W/8]."""
        return self.quant_conv(self.encoder(x))

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian(self.encode_moments(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents [N, 4, h, w] → fp32 images [N, 3, 8h, 8w] in
        about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z.float()))


def tiny_vae(dtype: torch.dtype = torch.float32, device=None) -> AutoencoderKL:
    """Miniature VAE for tests and smoke runs (same 8× downsampling)."""
    return AutoencoderKL(block_out_channels=(16, 16, 32, 32), dtype=dtype,
                         device=device)
