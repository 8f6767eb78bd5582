"""Checkpoints of nested dicts of tensors, and a reader of `.safetensors`.

The twin of polyp_tpu/utils/checkpoint.py: orbax's PyTree checkpoints
become one `torch.save` file a tree, read back with
`torch.load(weights_only=True)`, which unpickles tensors, dicts, lists and
numbers only. Adapters, trainable bundles and train states (lora/surgery.py,
train/resume.py) go through these helpers.

`read_safetensors` reads diffusers' `.safetensors` weights without the
`safetensors` package: an 8-byte little-endian header length, a JSON
header {name: {"dtype", "shape", "data_offsets": [begin, end]}} (offsets
into the bytes after the header), then the raw little-endian tensors.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Any, Iterable

import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def tree_map(fn, tree: Any) -> Any:
    """`fn` on every tensor leaf of nested dicts (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def save_pytree(path: str | Path, tree: Any) -> None:
    """Write nested dicts of tensors (and numbers) to one file, tensors on
    the CPU; the file is written beside and renamed, so a reader never
    sees half of it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(tree_map(lambda t: t.detach().to("cpu"), tree), tmp)
    tmp.replace(path)


def load_pytree(path: str | Path, like: Any | None = None) -> Any:
    """Read a `save_pytree` file; with `like` (a tree of the same keys),
    each tensor goes to its counterpart's device and dtype."""
    tree = torch.load(Path(path), map_location="cpu", weights_only=True)
    if like is None:
        return tree

    def match(got, want):
        if isinstance(want, dict):
            if set(got) != set(want):
                raise KeyError(f"checkpoint keys {sorted(got)} differ from "
                               f"{sorted(want)}")
            return {k: match(got[k], want[k]) for k in want}
        if isinstance(want, torch.Tensor):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(f"checkpoint shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
            return got.to(want.device, want.dtype)
        return got

    return match(tree, like)


def read_safetensors(path: str | Path, keys: Iterable[str] | None = None
                     ) -> dict[str, torch.Tensor]:
    """The tensors of a `.safetensors` file (only `keys`, when given), as
    CPU tensors of the file's dtypes."""
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        start = 8 + n
        for name in (list(header) if keys is None else keys):
            entry = header[name]
            begin, end = entry["data_offsets"]
            dtype = SAFETENSORS_DTYPES[entry["dtype"]]
            f.seek(start + begin)
            data = bytearray(f.read(end - begin))
            shape = tuple(entry["shape"])
            if len(data) != dtype.itemsize * math.prod(shape):
                raise ValueError(f"{path}: {name} holds {len(data)} bytes "
                                 f"for {entry['dtype']} {list(shape)}")
            t = (torch.frombuffer(data, dtype=dtype) if data
                 else torch.empty(0, dtype=dtype))
            out[name] = t.reshape(shape)
    return out

