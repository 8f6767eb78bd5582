# %% [markdown]
# # Polyp classifier walkthrough
#
# The port's twin of examples/classifier_walkthrough.py: build the
# datasets, inspect a batch, train the EfficientNet-B0 classifier and
# evaluate it, step by step through the polyp_tpu_torch public API. Each
# `# %%` cell is one function; `main` runs them in order:
#
#     python -m polyp_tpu_torch.examples.classifier_walkthrough \
#         [--data-root ./data] [--image-size 224] [--epochs 5] [--device cpu]
#
# Expects the reference corpus layout under --data-root
# (polyp_tpu_torch.cli.common.DataLayout); fabricates a synthetic
# mini-corpus there when the real data is absent, so the walkthrough
# always runs. Trains on the card unless given `--device cpu`.

# %%
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from polyp_tpu_torch.cli.common import DataLayout
from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.data.cache import ArrayDataset
from polyp_tpu_torch.data.pipeline import Loader, weighted_sample_weights
from polyp_tpu_torch.data.tables import ClassificationTable
from polyp_tpu_torch.eval.analysis import split_stats
from polyp_tpu_torch.train.classifier import (
    create_classifier_state, evaluate_classifier, train_classifier)

SYNTHETIC_PX = 48


# %% Build (or fabricate) the corpus -----------------------------------------
def fabricate_corpus(root: Path) -> None:
    """A mini-corpus in the reference layout: AD/HP/ASS tiles of three
    base intensities (12/5/5 train, 4/2/2 valid and test), seed 0."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, csv_name, classes in [
            ("m_train2/m_train", "train.csv",
             ["AD"] * 12 + ["HP"] * 5 + ["ASS"] * 5),
            ("m_valid/m_valid", "valid.csv",
             ["AD"] * 4 + ["HP"] * 2 + ["ASS"] * 2),
            ("m_test/m_test", "gt_test.csv",
             ["AD"] * 4 + ["HP"] * 2 + ["ASS"] * 2)]:
        img_dir = root / split / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        rows = []
        for i, cls in enumerate(classes):
            base = {"AD": 40, "HP": 130, "ASS": 210}[cls]
            arr = np.clip(base + rng.integers(0, 40, (48, 48, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(img_dir / f"s{i}.tif")
            rows.append(f"s{i},{cls}")
        (root / split / csv_name).write_text(
            "image_id,cls\n" + "\n".join(rows) + "\n")


# %% Dataset statistics (the data_analysis view) ------------------------------
def show_stats(layout: DataLayout) -> list[dict]:
    rows = split_stats({"train": layout.train_csv, "valid": layout.val_csv,
                        "test": layout.test_csv})
    for row in rows:
        print("  ".join(f"{k}={v}" for k, v in row.items()))
    return rows


# %% Tables → cached arrays ---------------------------------------------------
def load_splits(layout: DataLayout, image_size: int, cache_dir: Path):
    splits = [ArrayDataset.from_table(
        ClassificationTable.from_csv(images, csv), image_size, cache_dir)
        for images, csv in ((layout.train_images, layout.train_csv),
                            (layout.val_images, layout.val_csv),
                            (layout.test_images, layout.test_csv))]
    train, val, test = splits
    print(f"label map: {train.label2idx}; splits "
          f"{len(train)}/{len(val)}/{len(test)}")
    return train, val, test


# %% Inspect a batch (the notebook's `inspect_batch` cell) --------------------
def inspect_batch(train: ArrayDataset, device: str) -> Loader:
    loader = Loader(train.images, train.labels, batch_size=8, seed=0,
                    weights=weighted_sample_weights(train.labels),
                    device=device)
    images, labels, valid = next(iter(loader))
    print("batch:", tuple(images.shape), images.dtype,
          "labels:", labels.cpu().tolist())
    return loader


# %% Train --------------------------------------------------------------------
def train(config: ClassificationConfig, train_set: ArrayDataset,
          loader: Loader, val: ArrayDataset, device: str):
    state = create_classifier_state(config, train_set.num_classes, device)
    val_loader = Loader(val.images, val.labels, 8, shuffle=False,
                        device=device)
    state, result = train_classifier(
        config, state, loader, val_loader,
        log=lambda k, v, s: print(f"  epoch {s} {k}={v:.4f}"))
    print("best val accuracy:", result.best_val_acc)
    return state, result


# %% Evaluate -----------------------------------------------------------------
def evaluate(state, result, test: ArrayDataset, device: str) -> dict:
    best = state.with_params(result.best_params, result.best_batch_stats)
    test_loader = Loader(test.images, test.labels, 8, shuffle=False,
                         device=device)
    metrics = evaluate_classifier(best, test_loader, test.idx2label)
    print({k: round(metrics[k], 4)
           for k in ("accuracy", "precision", "recall", "f1_score")})
    print("confusion matrix:\n", np.asarray(metrics["confusion_matrix"]))
    return metrics


# %%
def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the card unless given the CPU")
    args, _ = parser.parse_known_args(argv)
    root = Path(args.data_root)
    layout = DataLayout(root)
    image_size = args.image_size
    if not layout.train_csv.exists():
        print("real corpus absent — fabricating a synthetic mini-corpus")
        fabricate_corpus(root)
        image_size = min(image_size, SYNTHETIC_PX)
    show_stats(layout)
    train_set, val, test = load_splits(layout, image_size, root / "cache")
    loader = inspect_batch(train_set, args.device)
    config = ClassificationConfig(image_size=image_size, batch_size=8,
                                  num_epochs=args.epochs, hidden_features=64,
                                  weighted_sampling=True)
    state, result = train(config, train_set, loader, val, args.device)
    return evaluate(state, result, test, args.device)


if __name__ == "__main__":
    main()
