"""Batch augmentation on the device: the twin of
polyp_tpu/data/transforms.py (:24-54).

Input is a uint8 NHWC batch (as the Loader yields it); output is NCHW:
fp32 in [-1, 1] for the VAE (`augment_diffusion_batch`), or ImageNet-
normalised in the dtype asked for, for the classifier
(`augment_classifier_batch`). The flip mask is drawn by the caller (the
train steps' draws, train/sd_finetune.py and train/classifier.py), so a
test can hand both packages the same mask.
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


# torchvision's ImageNet constants
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def augment_classifier_batch(images_u8: torch.Tensor,
                             flip: torch.Tensor | None = None,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """uint8 NHWC → x / 255, each image flipped where `flip` says (no flip
    when it is None: evaluation), ImageNet-normalised in fp32, as NCHW
    `dtype` (the classifier's input)."""
    x = images_u8.float() / 255.0
    if flip is not None:
        x = random_hflip(x, flip)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    return x.permute(0, 3, 1, 2).contiguous().to(dtype)
