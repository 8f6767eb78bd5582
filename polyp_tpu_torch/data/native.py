"""PNG encoding for generated samples: the port's copy of the encode half
of polyp_tpu/data/native.py (:24-48, :83-132).

The native encoder is `polyp_png_encode` in `native/libpolyp_png.so`
(libpng; built by `make -C native libpolyp_png.so`, not built by default).
Where the library is absent, PIL encodes instead. Both are lossless: the
decoded pixels are the same, only compression settings differ. Which one
runs is reported by `png_encoder()`; callers that must have one pass
`encoder="native"` or `"pil"` (the port's form of the reference's
POLYP_PNG_ENCODE environment knob).
"""

from __future__ import annotations

import ctypes
import io
from pathlib import Path

import numpy as np

# the repository's native/ directory, beside the package
LIBRARY = Path(__file__).resolve().parents[2] / "native" / "libpolyp_png.so"
ENCODERS = ("native", "pil")
# {library path: the loaded library, or None where it has no encode entry};
# an absent library is looked for again at the next call, so one built
# while the process runs is taken
_LOADED: dict[Path, ctypes.CDLL | None] = {}


def _library() -> ctypes.CDLL | None:
    """`LIBRARY` loaded with its encode entry declared, or None."""
    path = LIBRARY
    if path not in _LOADED:
        if not path.exists():
            return None
        lib = ctypes.CDLL(str(path))
        if hasattr(lib, "polyp_png_encode"):
            lib.polyp_png_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.polyp_png_encode.restype = ctypes.c_int
        else:
            lib = None
        _LOADED[path] = lib
    return _LOADED[path]


def png_encoder(encoder: str | None = None) -> str:
    """The encoder `encode_png(..., encoder=encoder)` runs: "native" where
    the library is built (None or "native"), else "pil". Asking for
    "native" where it is not built raises."""
    if encoder not in (None, *ENCODERS):
        raise ValueError(f"unknown PNG encoder {encoder!r} (use one of "
                         f"{ENCODERS} or None)")
    if encoder == "pil":
        return "pil"
    if _library() is not None:
        return "native"
    if encoder == "native":
        raise RuntimeError(f"native PNG encoder not built ({LIBRARY}); run "
                           "`make -C native libpolyp_png.so`")
    return "pil"


def _encode_native(image: np.ndarray, level: int) -> bytes:
    h, w = image.shape[:2]
    # a stored deflate stream of the filtered rows plus 1 KiB of headers
    # (the C side's contract)
    cap = h * (3 * w + 1) + 1024
    dst = np.empty(cap, np.uint8)
    size = ctypes.c_int64()
    rc = _library().polyp_png_encode(image.ctypes.data, h, w, int(level),
                                     dst.ctypes.data, cap, ctypes.byref(size))
    if rc != 0:
        raise ValueError(f"png encode failed ({rc}) for shape {image.shape}")
    return dst[:size.value].tobytes()


def encode_png(image: np.ndarray, level: int = 1,
               encoder: str | None = None) -> bytes:
    """uint8 RGB HWC → PNG bytes at zlib `level`, by `png_encoder(encoder)`.
    Level 1 (the serving default) writes rows unfiltered: larger files,
    fastest encode."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected HWC RGB uint8, got shape {image.shape}")
    if png_encoder(encoder) == "native":
        return _encode_native(image, level)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG", compress_level=level)
    return buf.getvalue()
