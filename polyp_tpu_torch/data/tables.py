"""Dataset index tables: the twin of polyp_tpu/data/tables.py without
pandas (the card's machine has none). CSVs are read with the `csv` module.

A table is (image paths, labels, optional mask paths) with the reference's
label semantics, apart from any image IO:

* `ClassificationTable`: a CSV-labelled `.tif` directory with the fixed
  map {'AD': 0, 'ASS': 1, 'HP': 1 if one_vs_rest else 2};
* `DiffusionTable`: several directories, filtered to `keep_one_class`;
  with more than one kept class the first is primary and the others merge
  into "REST". Label ids are given in first-appearance order of the kept
  (merged) classes, directory by directory, as pandas' `unique()` gives
  them in the reference;
* `AugmentedTable`: real CSV-labelled `.tif` directories mixed with
  directories of generated `.png` files whose label is the directory's
  name.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence


def read_rows(csv_file: str | Path) -> list[dict[str, str]]:
    """The rows of a labels CSV (`image_id,cls`, ...) in file order. An
    `image_id` column of integers only is read as pandas reads it, as
    integers ("007" → "7"), so the file names are the reference's."""
    with open(csv_file, newline="") as f:
        rows = list(csv.DictReader(f))
    ids = [r.get("image_id") for r in rows]
    if ids and all(i is not None and _is_int(i) for i in ids):
        for r in rows:
            r["image_id"] = str(int(r["image_id"]))
    return rows


def _is_int(text: str) -> bool:
    try:
        int(text)
    except ValueError:
        return False
    return True


@dataclass
class Table:
    image_paths: list[str]
    labels: list[int]
    label2idx: dict[str, int]
    mask_paths: list[str] | None = None
    transformations_list: list[str] = field(
        default_factory=lambda: ["resize", "randomHorizontalFlip", "normalize"])

    @property
    def idx2label(self) -> dict[int, str]:
        # inverted in insertion order: for {'AD':0,'ASS':1,'HP':1} the later
        # duplicate wins, as the reference's dict comprehension does
        return {idx: label for label, idx in self.label2idx.items()}

    @property
    def num_classes(self) -> int:
        return len(set(self.label2idx.values()))

    def __len__(self) -> int:
        return len(self.image_paths)


def _tif(image_dir, image_id: str) -> str:
    return os.path.join(str(image_dir), f"{image_id}.tif")


class ClassificationTable:

    @staticmethod
    def from_csv(image_dir: str | Path, csv_file: str | Path,
                 mask_dir: str | Path | None = None,
                 one_vs_rest: bool = False) -> Table:
        label2idx = {"AD": 0, "ASS": 1, "HP": 1 if one_vs_rest else 2}
        image_paths, labels, mask_paths = [], [], []
        for row in read_rows(csv_file):
            image_paths.append(_tif(image_dir, row["image_id"]))
            labels.append(label2idx[row["cls"]])
            if mask_dir is not None:
                mask_paths.append(_tif(mask_dir, row["image_id"]))
        return Table(image_paths, labels, label2idx,
                     mask_paths if mask_dir is not None else None)


class DiffusionTable:

    @staticmethod
    def from_dirs(image_dirs: Sequence[str | Path],
                  csv_files: Sequence[str | Path],
                  mask_dirs: Sequence[str | Path] | None = None,
                  keep_one_class: str | Sequence[str] | None = None) -> Table:
        if isinstance(keep_one_class, str):
            keep_one_class = [keep_one_class]
        label2idx: dict[str, int] = {}
        image_paths, labels, mask_paths = [], [], []
        for i, (img_dir, csv_file) in enumerate(zip(image_dirs, csv_files)):
            rows = read_rows(csv_file)
            if keep_one_class is not None:
                rows = [r for r in rows if r["cls"] in keep_one_class]
                if len(keep_one_class) > 1:
                    primary = keep_one_class[0]
                    rows = [{**r, "cls": primary if r["cls"] == primary
                             else "REST"} for r in rows]
            for r in rows:  # first-appearance order, as pandas' unique()
                label2idx.setdefault(r["cls"], len(label2idx))
            for r in rows:
                image_paths.append(_tif(img_dir, r["image_id"]))
                labels.append(label2idx[r["cls"]])
                if mask_dirs is not None:
                    mask_paths.append(_tif(mask_dirs[i], r["image_id"]))
        return Table(image_paths, labels, label2idx,
                     mask_paths if mask_dirs is not None else None)


def extract_label_from_dir(image_dir: str | Path,
                           label2idx: dict[str, int]) -> str:
    """A generated directory's label: its basename, or "REST" for any
    directory but AD when the map has a REST class."""
    label = os.path.basename(str(image_dir).rstrip("/"))
    if label2idx.get("REST") is not None and label != "AD":
        return "REST"
    return label


class AugmentedTable:

    @staticmethod
    def from_dirs(dirs: Sequence[tuple[str | Path, str | Path | None]],
                  ad_vs_rest: bool = False) -> Table:
        label2idx = ({"AD": 0, "REST": 1} if ad_vs_rest
                     else {"AD": 0, "ASS": 1, "HP": 2})
        image_paths, labels = [], []
        for image_dir, csv_file in dirs:
            if csv_file is not None:
                for row in read_rows(csv_file):
                    label = row["cls"]
                    if ad_vs_rest:
                        label = "REST" if label != "AD" else "AD"
                    image_paths.append(_tif(image_dir, row["image_id"]))
                    labels.append(label2idx[label])
            else:
                label = extract_label_from_dir(image_dir, label2idx)
                for file in sorted(os.listdir(image_dir)):
                    if file.endswith(".png"):
                        image_paths.append(os.path.join(str(image_dir), file))
                        labels.append(label2idx[label])
        return Table(image_paths, labels, label2idx)
