"""Plots (loss curves, the confusion matrix): the twin of
polyp_tpu/utils/plotting.py.

matplotlib is imported only when a plot is drawn. Where it is missing (the
card's machine has none), each function writes the figure's data as JSON
at the plot's path with a `.json` suffix instead, prints one stderr line
naming the missing package, and returns that path, so the CLIs run to the
end without it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def _plt():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _as_json(filename: str | Path, data: dict) -> str:
    path = Path(filename).with_suffix(".json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1))
    print(f"[plotting] matplotlib is not installed; wrote the plot's data "
          f"to {path}", file=sys.stderr)
    return str(path)


def plot_loss(train_losses, val_losses=None, filename="loss_history.png",
              title="Training and Validation Loss Curves") -> str:
    plt = _plt()
    if plt is None:
        return _as_json(filename, {
            "title": title, "train_loss": [float(v) for v in train_losses],
            "val_loss": (None if val_losses is None
                         else [float(v) for v in val_losses])})
    plt.figure(figsize=(10, 6))
    plt.plot(range(1, len(train_losses) + 1), train_losses,
             label="Training Loss", color="blue", linestyle="-", marker="o")
    if val_losses is not None:
        plt.plot(range(1, len(val_losses) + 1), val_losses,
                 label="Validation Loss", color="red", linestyle="--",
                 marker="o")
    plt.title(title)
    plt.xlabel("Epochs")
    plt.ylabel("Loss")
    plt.legend()
    plt.grid(True)
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(filename)
    plt.close()
    return str(filename)


def plot_confusion_matrix(cm: np.ndarray, labels, filename: str) -> str:
    """An annotated heatmap (seaborn's where it is installed)."""
    plt = _plt()
    if plt is None:
        return _as_json(filename, {
            "title": "Confusion Matrix", "labels": [str(l) for l in labels],
            "confusion_matrix": np.asarray(cm).tolist()})
    plt.figure(figsize=(8, 6))
    try:
        import seaborn as sns
        sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                    xticklabels=labels, yticklabels=labels)
    except ImportError:
        plt.imshow(cm, cmap="Blues")
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                plt.text(j, i, str(cm[i, j]), ha="center", va="center")
        plt.xticks(range(len(labels)), labels)
        plt.yticks(range(len(labels)), labels)
    plt.xlabel("Predicted Label")
    plt.ylabel("True Label")
    plt.title("Confusion Matrix")
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(filename)
    plt.close()
    return str(filename)
