"""The downstream augmentation eval, the project's quality metric: the twin
of polyp_tpu/eval/harness.py (:66-142) on one device.

Retrain the classifier on the real training images plus a generation
run's `samples/{cls}` directories, and score weighted F1 on the real test
set, logging into the generator's tracker run when one is given
(run-linking): the generate → augment → retrain → F1 loop. Beside it, the
per-class Fréchet distance of the samples to the real images (eval/fid.py;
uncalibrated without ImageNet weights, and the result says so).
Multi-GPU is the multi-GPU slice's (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.data.cache import ArrayDataset
from polyp_tpu_torch.data.pipeline import Loader, weighted_sample_weights
from polyp_tpu_torch.data.tables import AugmentedTable
from polyp_tpu_torch.eval.metrics import balanced_class_weights
from polyp_tpu_torch.track import Tracker
from polyp_tpu_torch.train.classifier import (
    create_classifier_state, evaluate_classifier, train_classifier)


@dataclass
class AugmentedDataDirs:
    """The directories of a generation run's evaluation."""

    train_images: str
    train_csv: str
    val_images: str
    val_csv: str
    test_images: str
    test_csv: str
    samples_root: str  # holds AD/ HP/ ASS/, or AD/ REST/

    def train_dirs(self, ad_vs_rest: bool) -> list[tuple[str, str | None]]:
        sample_classes = ["AD", "REST"] if ad_vs_rest else ["AD", "HP", "ASS"]
        dirs: list[tuple[str, str | None]] = [(self.train_images,
                                               self.train_csv)]
        for cls in sample_classes:
            d = Path(self.samples_root) / cls
            if d.exists():
                dirs.append((str(d), None))
        return dirs


def build_augmented_datasets(dirs: AugmentedDataDirs, image_size: int,
                             ad_vs_rest: bool = False,
                             cache_dir: str | None = None):
    train = ArrayDataset.from_table(
        AugmentedTable.from_dirs(dirs.train_dirs(ad_vs_rest), ad_vs_rest),
        image_size, cache_dir)
    val = ArrayDataset.from_table(
        AugmentedTable.from_dirs([(dirs.val_images, dirs.val_csv)],
                                 ad_vs_rest), image_size, cache_dir)
    test = ArrayDataset.from_table(
        AugmentedTable.from_dirs([(dirs.test_images, dirs.test_csv)],
                                 ad_vs_rest), image_size, cache_dir)
    return train, val, test


def run_augmentation_eval(config: ClassificationConfig,
                          dirs: AugmentedDataDirs,
                          tracker: Tracker | None = None,
                          run_id: str | None = None,
                          ad_vs_rest: bool = False,
                          cache_dir: str | None = None,
                          device: torch.device | str = "cuda") -> dict:
    """Train on real + generated, evaluate on real; returns the metric
    dict (with `frechet` and `train_size`) and logs into the run `run_id`
    when a tracker is given. Runs on the card unless `device` is a CPU."""
    train, val, test = build_augmented_datasets(dirs, config.image_size,
                                                ad_vs_rest, cache_dir)
    weights = (weighted_sample_weights(train.labels)
               if config.weighted_sampling else None)
    class_weights = None
    if config.weighted_loss:
        cw = balanced_class_weights(train.labels)
        class_weights = np.asarray([cw[i] for i in sorted(cw)], np.float32)

    train_loader = Loader(train.images, train.labels, config.batch_size,
                          seed=config.seed, drop_last=True, weights=weights,
                          device=device)
    val_loader = Loader(val.images, val.labels, config.batch_size,
                        seed=config.seed, shuffle=False, device=device)
    test_loader = Loader(test.images, test.labels, config.batch_size,
                         seed=config.seed, shuffle=False, device=device)
    state = create_classifier_state(config, train.num_classes, device)

    frechet = None
    if Path(dirs.samples_root).exists():
        from polyp_tpu_torch.eval.fid import class_frechet_distances
        frechet = class_frechet_distances(
            dirs.train_images, dirs.train_csv, dirs.samples_root,
            ad_vs_rest, config.image_size, cache_dir=cache_dir,
            device=str(device))

    def fit_and_score(log=None) -> dict:
        trained, result = train_classifier(config, state, train_loader,
                                           val_loader, class_weights, log)
        best = trained.with_params(result.best_params,
                                   result.best_batch_stats)
        return evaluate_classifier(best, test_loader, test.idx2label)

    if tracker is not None and run_id is not None:
        with tracker.start_run(run_id=run_id):
            metrics = fit_and_score(
                lambda k, v, s: tracker.log_metric(k, v, s))
            for key in ("accuracy", "precision", "recall", "f1_score"):
                # 4-decimal values, as the reference logs them
                tracker.log_metric(
                    key if key != "accuracy" else "test_accuracy",
                    round(metrics[key], 4))
            if frechet and frechet["per_class"]:
                tracker.log_param("frechet_extractor", frechet["extractor"])
                for cls, val in frechet["per_class"].items():
                    tracker.log_metric(f"frechet_{cls}", round(val, 4))
    else:
        metrics = fit_and_score()
    if frechet is not None:
        metrics["frechet"] = frechet
    metrics["train_size"] = len(train)
    return metrics
