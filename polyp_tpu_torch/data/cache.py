"""The in-memory uint8 dataset: the twin of polyp_tpu/data/cache.py.

`ArrayDataset.from_table` decodes, masks and resizes every image once into
one uint8 [N, H, W, 3] array; with `cache_dir` the array is kept in an npz
file named by a digest of (paths, labels, masks, size), so a rerun skips
decoding. Later epochs are array slicing (data/pipeline.py::Loader).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from polyp_tpu_torch.data.io import load_preprocessed
from polyp_tpu_torch.data.tables import Table


@dataclass
class ArrayDataset:
    images: np.ndarray  # uint8 [N, H, W, 3]
    labels: np.ndarray  # int32 [N]
    label2idx: dict[str, int]

    @property
    def idx2label(self) -> dict[int, str]:
        return {idx: label for label, idx in self.label2idx.items()}

    @property
    def num_classes(self) -> int:
        return len(set(self.label2idx.values()))

    def __len__(self) -> int:
        return len(self.labels)

    @staticmethod
    def from_table(table: Table, image_size: int,
                   cache_dir: str | Path | None = None) -> "ArrayDataset":
        cache_path = None
        if cache_dir is not None:
            digest = hashlib.sha256(json.dumps(
                [table.image_paths, table.labels, table.mask_paths,
                 image_size]).encode()).hexdigest()[:16]
            cache_path = Path(cache_dir) / f"polyp_cache_{digest}.npz"
            if cache_path.exists():
                z = np.load(cache_path)
                return ArrayDataset(z["images"], z["labels"],
                                    dict(table.label2idx))
        images = np.empty((len(table), image_size, image_size, 3), np.uint8)
        for i, path in enumerate(table.image_paths):
            mask = (table.mask_paths[i] if table.mask_paths is not None
                    else None)
            images[i] = load_preprocessed(path, image_size, mask)
        labels = np.asarray(table.labels, dtype=np.int32)
        if cache_path is not None:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            # written whole, then renamed: the ranks of a data-parallel
            # group build the same cache at once
            tmp = cache_path.with_name(f"{os.getpid()}.{cache_path.name}")
            np.savez(tmp, images=images, labels=labels)
            os.replace(tmp, cache_path)
        return ArrayDataset(images, labels, dict(table.label2idx))

    @staticmethod
    def from_arrays(images: np.ndarray, labels: np.ndarray,
                    label2idx: dict[str, int]) -> "ArrayDataset":
        return ArrayDataset(np.asarray(images, dtype=np.uint8),
                            np.asarray(labels, dtype=np.int32),
                            dict(label2idx))
