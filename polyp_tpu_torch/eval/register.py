"""The experiment register, an append-only CSV of classifier runs (one row
a run: model name, hyperparameters, final weighted F1): a copy of
polyp_tpu/eval/register.py."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any

COLUMNS = [
    "model_name", "transformations", "image_size", "criterion", "optimizer",
    "hidden_features", "batch_size", "dropout", "learning_rate",
    "weight_decay", "num_epochs", "early_stopping", "other_techniques",
    "f1_score",
]


def append_run(register_path: str | Path, model_name: str,
               params: dict[str, Any], f1_score: float | str) -> None:
    path = Path(register_path)
    exists = path.exists()
    path.parent.mkdir(parents=True, exist_ok=True)
    row = {
        "model_name": model_name,
        "transformations": str(params.get("transformations", "")),
        "image_size": params.get("image_size", ""),
        "criterion": params.get("criterion", "CrossEntropy"),
        "optimizer": params.get("optimizer", "Adam"),
        "hidden_features": params.get("hidden_features", ""),
        "batch_size": params.get("batch_size", ""),
        "dropout": params.get("dropout", ""),
        "learning_rate": params.get("learning_rate", ""),
        "weight_decay": params.get("weight_decay", ""),
        "num_epochs": params.get("num_epochs", ""),
        "early_stopping": params.get("early_stopping", ""),
        "other_techniques": str(params.get("other_techniques", "None")),
        "f1_score": f"{float(f1_score):.4f}",
    }
    with path.open("a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=COLUMNS)
        if not exists:
            writer.writeheader()
        writer.writerow(row)


def read_register(register_path: str | Path) -> list[dict[str, str]]:
    with Path(register_path).open() as f:
        return list(csv.DictReader(f))


def best_run(register_path: str | Path) -> dict[str, str] | None:
    rows = read_register(register_path)
    return max(rows, key=lambda r: float(r["f1_score"])) if rows else None
