"""ctypes bindings of the native image libraries in `native/`: the port's
copy of polyp_tpu/data/native.py.

PNG encoding for generated samples (:24-48, :83-132), and the corpus
side that data/io.py takes under POLYP_NATIVE_PREPROCESS=1 where the
libraries are built (`make -C native`): `decode_png` / `decode_tiff`
(`polyp_{kind}_decode` in libpolyp_png.so / libpolyp_tiff.so) and the
half-pixel bilinear `resize_bilinear` of libpolyp_preprocess.so.

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
NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIBRARY = NATIVE_DIR / "libpolyp_png.so"
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


_DECODE_ARGS = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
# {library path: the loaded library, or None where the entry is missing}
_OTHERS: dict[Path, ctypes.CDLL | None] = {}


def _load(path: Path, entry: str, argtypes: list) -> ctypes.CDLL | None:
    """`path` loaded with `entry` declared (restype int), or None where the
    library is not built or lacks the entry."""
    if path not in _OTHERS:
        if not path.exists():
            return None
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, entry, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _OTHERS[path] = lib if fn is not None else None
    return _OTHERS[path]


def _decoder(kind: str) -> ctypes.CDLL | None:
    path = LIBRARY if kind == "png" else NATIVE_DIR / f"libpolyp_{kind}.so"
    return _load(path, f"polyp_{kind}_decode", _DECODE_ARGS)


def decoder_available(kind: str) -> bool:
    """Whether the native `kind` ("png" or "tiff") decoder is built."""
    return _decoder(kind) is not None


def _decode(kind: str, path) -> np.ndarray:
    lib = _decoder(kind)
    if lib is None:
        raise RuntimeError(f"native {kind} decoder not built; run "
                           "`make -C native`")
    fn = getattr(lib, f"polyp_{kind}_decode")
    h, w = ctypes.c_int32(), ctypes.c_int32()
    name = str(path).encode()
    if fn(name, None, 0, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise ValueError(f"{kind} decode failed: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = fn(name, out.ctypes.data, out.nbytes, ctypes.byref(h),
            ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"{kind} decode failed ({rc}): {path}")
    return out


def decode_png(path) -> np.ndarray:
    """libpng decode → uint8 RGB HWC."""
    return _decode("png", path)


def decode_tiff(path) -> np.ndarray:
    """Baseline-TIFF decode → uint8 RGB HWC; ValueError outside the
    supported profile (data/io.py then decodes with PIL)."""
    return _decode("tiff", path)


def _preprocess() -> ctypes.CDLL | None:
    lib = _load(NATIVE_DIR / "libpolyp_preprocess.so",
                "polyp_resize_bilinear",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
    if lib is not None:
        lib.polyp_resize_bilinear.restype = None  # void
    return lib


def preprocess_available() -> bool:
    """Whether libpolyp_preprocess.so (the resize) is built."""
    return _preprocess() is not None


def _require_preprocess() -> ctypes.CDLL:
    lib = _preprocess()
    if lib is None:
        raise RuntimeError("native preprocess library not built; run "
                           "`make -C native`")
    return lib


def resize_bilinear(image: np.ndarray, size: int) -> np.ndarray:
    """Half-pixel bilinear resize of uint8 HWC to (size, size)."""
    lib = _require_preprocess()
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    out = np.empty((size, size, c), np.uint8)
    lib.polyp_resize_bilinear(image.ctypes.data, h, w, c, out.ctypes.data,
                              size, size)
    return out
