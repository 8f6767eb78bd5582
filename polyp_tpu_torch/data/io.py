"""Host-side image IO (decode, mask multiply, resize): the twin of
polyp_tpu/data/io.py.

Each image is decoded, masked and resized once, when the dataset cache is
built (data/cache.py). Resize is PIL's bilinear, as torchvision's
`Resize`. `POLYP_NATIVE_PREPROCESS=1` takes the native decoders and the
half-pixel bilinear resize of `native/` where they are built
(data/native.py), as in the reference; PIL stays the parity default.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image


def _native_on() -> bool:
    return os.environ.get("POLYP_NATIVE_PREPROCESS", "0") == "1"


def decode_image(path: str | Path) -> np.ndarray:
    """Any supported image (.tif/.png/...) → uint8 RGB HWC."""
    if _native_on():
        from polyp_tpu_torch.data import native
        name = str(path)
        if name.endswith(".png") and native.decoder_available("png"):
            return native.decode_png(path)
        if name.endswith((".tif", ".tiff")) and native.decoder_available(
                "tiff"):
            try:
                return native.decode_tiff(path)
            except ValueError:
                pass  # outside the native profile: PIL below
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_mask(path: str | Path) -> np.ndarray:
    """A binary mask → bool HW (mask > 0)."""
    with Image.open(path) as im:
        return np.asarray(im.convert("L")) > 0


def apply_mask(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero the pixels outside the polyp."""
    return image * mask[..., None].astype(image.dtype)


def resize_image(image: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize to (size, size): PIL's, or the native kernel's under
    POLYP_NATIVE_PREPROCESS=1 where it is built."""
    if image.shape[0] == size and image.shape[1] == size:
        return image
    if _native_on():
        from polyp_tpu_torch.data import native
        if native.preprocess_available():
            return native.resize_bilinear(image, size)
    im = Image.fromarray(image)
    return np.asarray(im.resize((size, size), Image.BILINEAR))


def load_preprocessed(path: str | Path, size: int,
                      mask_path: str | Path | None = None) -> np.ndarray:
    """decode → optional mask multiply → resize; uint8 [size, size, 3]."""
    image = decode_image(path)
    if mask_path is not None:
        image = apply_mask(image, decode_mask(mask_path))
    return resize_image(image, size)
