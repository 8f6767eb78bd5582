"""Batch augmentation on the device: the twin of the diffusion half of
polyp_tpu/data/transforms.py (:24-54).

Input is a uint8 NHWC batch (as the Loader yields it), output fp32 NCHW in
[-1, 1] for the VAE. The flip mask is drawn by the caller (the train
step's draws, train/sd_finetune.py), so a test can hand both packages the
same mask.
"""

from __future__ import annotations

import torch


def random_hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the NHWC images whose `flip` [N] entry is True along W."""
    return torch.where(flip.to(images.device)[:, None, None, None],
                       images.flip(2), images)


def augment_diffusion_batch(images_u8: torch.Tensor,
                            flip: torch.Tensor | None = None,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """uint8 NHWC → (x / 255 − 0.5) / 0.5 as NCHW `dtype`, each image
    flipped where `flip` says (no flip when it is None: evaluation)."""
    x = images_u8.float() / 255.0
    if flip is not None:
        x = random_hflip(x, flip)
    x = (x - 0.5) / 0.5
    return x.permute(0, 3, 1, 2).contiguous().to(dtype)
