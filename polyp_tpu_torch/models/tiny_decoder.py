"""Tiny latent decoder: the twin of polyp_tpu/models/tiny_decoder.py.

A ~0.9M-parameter residual conv net at a uniform 64 channels that maps
SCALED latents (the sampler's output, z = raw·0.18215) straight to images
in about [-1, 1], replacing the full AutoencoderKL decode on the distilled
few-step path, where the decode is a large share of each image:

    tanh(z/3)·3 (fp32)          bounds latent outliers
    conv 4→C                    @ h/8
    2 × ResBlock(C)             @ h/8
    3 × [nearest ×2 → conv C→C → 2 × ResBlock(C)]   @ h/4, h/2, h
    conv C→3 (fp32)             @ h

ResBlock = x + conv(relu(conv(relu(x)))); every conv is 3×3 with "SAME"
padding. NCHW; module names are the reference's flax names (`conv_in`,
`in_block_0.conv1`, `up_2_conv`, `up_2_block_1.conv2`, `conv_out`), so
importers.tiny_decoder_from_jax carries its weights.

Weights: the port's artifact is a directory of `params.npz` (fp32, by
state-dict name) and `meta.json`, which `save_tiny_decoder` writes
(polyp-distill-vae-torch) and `load_tiny_decoder` reads. The reference's
trained artifact is an orbax checkpoint (`models/tiny_decoder/params`),
which a machine without JAX cannot read; `tools/convert_tiny_decoder.py`
converts it once into `polyp_tpu_torch/weights/tiny_decoder/`.
"""

from __future__ import annotations

import json
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from polyp_tpu_torch.models.unet_blocks import Conv2d

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "weights" / "tiny_decoder"


def _conv(cin: int, cout: int, dtype, device) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, dtype=dtype, device=device)


class _ResBlock(nn.Module):

    def __init__(self, channels: int, dtype, device):
        super().__init__()
        self.conv1 = _conv(channels, channels, dtype, device)
        self.conv2 = _conv(channels, channels, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class TinyDecoder(nn.Module):
    """Scaled latents [B, 4, h/8, w/8] → fp32 images [B, 3, h, w] in about
    [-1, 1]. Convs run in `dtype`, `conv_out` in fp32, as the reference's
    fp32 output head."""

    def __init__(self, base_channels: int = 64, latent_channels: int = 4,
                 out_channels: int = 3, blocks_per_stage: int = 2,
                 num_upsamples: int = 3,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        c = base_channels
        self.dtype = dtype
        self.base_channels = c
        self.latent_channels = latent_channels
        self.blocks_per_stage = blocks_per_stage
        self.num_upsamples = num_upsamples
        self.conv_in = _conv(latent_channels, c, dtype, device)
        for j in range(blocks_per_stage):
            self.add_module(f"in_block_{j}", _ResBlock(c, dtype, device))
        for i in range(num_upsamples):
            self.add_module(f"up_{i}_conv", _conv(c, c, dtype, device))
            for j in range(blocks_per_stage):
                self.add_module(f"up_{i}_block_{j}",
                                _ResBlock(c, dtype, device))
        self.conv_out = _conv(c, out_channels, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = (torch.tanh(z.float() / 3.0) * 3.0).to(self.dtype)
        h = self.conv_in(h)
        for j in range(self.blocks_per_stage):
            h = getattr(self, f"in_block_{j}")(h)
        for i in range(self.num_upsamples):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, f"up_{i}_conv")(h)
            for j in range(self.blocks_per_stage):
                h = getattr(self, f"up_{i}_block_{j}")(h)
        return self.conv_out(h.float())


def tiny_decoder_for_vae(vae, base_channels: int = 64,
                         dtype: torch.dtype = torch.bfloat16,
                         device=None) -> TinyDecoder:
    """A TinyDecoder matched to `vae`'s latent geometry (latent channels
    and the ×8 spatial factor)."""
    return TinyDecoder(base_channels=base_channels,
                       latent_channels=vae.latent_channels, dtype=dtype,
                       device=device)


def save_tiny_decoder(out_dir: str | Path, params: dict[str, torch.Tensor],
                      meta: dict) -> Path:
    """Write a trained tiny decoder as `load_tiny_decoder` reads it:
    `{out_dir}/params.npz` (fp32, by state-dict name) and
    `{out_dir}/meta.json` (the architecture and the measured rel-L2 against
    its teacher). Returns `out_dir`."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "params.npz", **{
        k: v.detach().float().cpu().numpy() for k, v in params.items()})
    (out_dir / "meta.json").write_text(json.dumps(meta, indent=2))
    return out_dir


def load_tiny_decoder(out_dir: str | Path = DEFAULT_DIR,
                      dtype: torch.dtype = torch.bfloat16,
                      device: torch.device | str = "cuda"
                      ) -> tuple[TinyDecoder, dict]:
    """The converted artifact in `out_dir` (`params.npz` + `meta.json`) →
    (module on `device`, meta). Warns loudly when the meta says the
    decoder was distilled on synthetic latents: such a decoder was taught
    by a random teacher and is a throughput stand-in, not an image
    decoder."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_tiny_decoder runs on the card by default "
                           "and no CUDA card is present; pass device='cpu' "
                           "to load it on the CPU")
    out_dir = Path(out_dir)
    meta = json.loads((out_dir / "meta.json").read_text())
    if meta.get("latent_source") == "synthetic":
        msg = (f"tiny decoder {out_dir} was distilled on SYNTHETIC latents "
               f"from a random teacher (rel_l2 {meta.get('rel_l2')}): its "
               "images are not the VAE's; use it for throughput only")
        warnings.warn(msg, stacklevel=2)
        print(f"[polyp-tpu-torch] WARNING: {msg}", file=sys.stderr)
    module = TinyDecoder(base_channels=meta["base_channels"],
                         latent_channels=meta.get("latent_channels", 4),
                         blocks_per_stage=meta.get("blocks_per_stage", 2),
                         dtype=dtype, device="meta")
    with np.load(out_dir / "params.npz") as npz:
        state = {k: torch.from_numpy(npz[k]) for k in npz.files}
    module = module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module.eval(), meta
