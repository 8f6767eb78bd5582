"""Baseline classifier CLI: the twin of polyp_tpu/cli/train_classifier.py
on one card. Datasets (optional weighted sampling and loss) → training
with early stopping → the loss plot → test metrics and the confusion
matrix → a row of the experiment register.

Usage (on the card; `--device cpu` for the CPU):
  polyp-train-classifier-torch --data-root ./data --batch_size 16 \\
      --learning_rate 1e-3 --weight_decay 1e-3 --hidden_features 256 \\
      --image_size 224 --dropout 0.5 [--one_vs_all] [--weighted_loss] \\
      [--weighted_sampling]
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path

import numpy as np

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, get_tracker_from, print_banner)
from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.data.cache import ArrayDataset
from polyp_tpu_torch.data.pipeline import Loader, weighted_sample_weights
from polyp_tpu_torch.data.tables import ClassificationTable
from polyp_tpu_torch.eval.metrics import balanced_class_weights
from polyp_tpu_torch.eval.register import append_run
from polyp_tpu_torch.train.classifier import (
    create_classifier_state, evaluate_classifier, train_classifier)
from polyp_tpu_torch.utils.checkpoint import save_pytree
from polyp_tpu_torch.utils.plotting import plot_confusion_matrix, plot_loss


def build_datasets(layout: DataLayout, image_size: int, one_vs_rest: bool,
                   cache_dir: str, use_masks: bool = False):
    """(train, val, test) ArrayDatasets of the corpus; the npz cache in
    `cache_dir` skips decoding on a rerun."""
    mask_dir = layout.train_masks if use_masks else None
    train = ArrayDataset.from_table(
        ClassificationTable.from_csv(layout.train_images, layout.train_csv,
                                     mask_dir, one_vs_rest),
        image_size, cache_dir)
    val = ArrayDataset.from_table(
        ClassificationTable.from_csv(layout.val_images, layout.val_csv,
                                     None, one_vs_rest),
        image_size, cache_dir)
    test = ArrayDataset.from_table(
        ClassificationTable.from_csv(layout.test_images, layout.test_csv,
                                     None, one_vs_rest),
        image_size, cache_dir)
    return train, val, test


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=1e-3)
    parser.add_argument("--hidden_features", type=int, default=256)
    parser.add_argument("--variant", type=str, default="b0",
                        help="EfficientNet b0..b7 (the reference pins b0)")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--one_vs_all", action="store_true")
    parser.add_argument("--weighted_loss", action="store_true")
    parser.add_argument("--weighted_sampling", action="store_true")
    parser.add_argument("--use_masks", action="store_true")
    parser.add_argument("--output-dir", type=str,
                        default="./models/baseline_classification")
    parser.add_argument("--register", type=str,
                        default="./results/parameters_register.csv")
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="snapshot the state and the early-stop "
                             "bookkeeping every N epochs under "
                             "{output-dir}/ckpt; a killed run called again "
                             "with the same flags resumes from the last "
                             "snapshot (0 = off)")
    args = parser.parse_args(argv)

    config = ClassificationConfig(
        image_size=args.image_size, batch_size=args.batch_size,
        num_epochs=args.num_epochs, patience=args.patience,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        hidden_features=args.hidden_features, dropout=args.dropout,
        variant=args.variant, weighted_sampling=args.weighted_sampling,
        weighted_loss=args.weighted_loss, one_vs_rest=args.one_vs_all)
    techniques = []
    if args.one_vs_all:
        techniques.append("ad vs rest")
    if args.weighted_sampling:
        techniques.append("weighted sampling")
    if args.weighted_loss:
        techniques.append("weighted loss")

    print_banner("Constructing datasets")
    layout = DataLayout(Path(args.data_root))
    train, val, test = build_datasets(layout, config.image_size,
                                      config.one_vs_rest, args.cache_dir,
                                      args.use_masks)
    print(f"train/val/test sizes: {len(train)}/{len(val)}/{len(test)}")
    weights = (weighted_sample_weights(train.labels)
               if config.weighted_sampling else None)
    class_weights = None
    if config.weighted_loss:
        cw = balanced_class_weights(train.labels)
        class_weights = np.asarray([cw[i] for i in sorted(cw)], np.float32)
        print("class weights:", cw)

    train_loader = Loader(train.images, train.labels, config.batch_size,
                          seed=config.seed, drop_last=True, weights=weights,
                          device=args.device)
    val_loader = Loader(val.images, val.labels, config.batch_size,
                        shuffle=False, device=args.device)
    test_loader = Loader(test.images, test.labels, config.batch_size,
                         shuffle=False, device=args.device)
    state = create_classifier_state(config, train.num_classes, args.device)

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    model_name = f"classifier_{timestamp}"
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    params = {
        "transformations": ["resize", "randomHorizontalFlip", "normalize"],
        "image_size": config.image_size,
        "criterion": "CrossEntropy",
        "optimizer": "Adam",
        "hidden_features": config.hidden_features,
        "batch_size": config.batch_size,
        "dropout": config.dropout,
        "learning_rate": config.learning_rate,
        "weight_decay": config.weight_decay,
        "num_epochs": config.num_epochs,
        "early_stopping": config.patience,
        "other_techniques": techniques or "None",
    }
    print(params)
    tracker = get_tracker_from(args)
    tracker.set_experiment(args.experiment_name or config.experiment_name)
    checkpointer = None
    if args.ckpt_every > 0:
        from polyp_tpu_torch.train.resume import EpochCheckpointer
        checkpointer = EpochCheckpointer(out_dir / "ckpt",
                                         every=args.ckpt_every)

    print_banner("Training")
    with tracker.start_run(run_name=model_name) as run:
        tracker.log_params(params)
        state, result = train_classifier(
            config, state, train_loader, val_loader, class_weights,
            log=lambda k, v, s: tracker.log_metric(k, v, s),
            checkpointer=checkpointer)
        tracker.log_metric("best_val_accuracy", round(result.best_val_acc, 4))
        run_id = run.run_id
        ckpt_path = out_dir / f"{model_name}.pt"
        save_pytree(ckpt_path, {"params": result.best_params,
                                "batch_stats": result.best_batch_stats})
        print(f"best checkpoint saved at {ckpt_path}")
        loss_path = plot_loss(result.train_loss_hist, result.val_loss_hist,
                              f"./results/loss_{timestamp}.png")
        tracker.log_artifact(loss_path, "results")

        print_banner("Evaluating")
        best = state.with_params(result.best_params, result.best_batch_stats)
        metrics = evaluate_classifier(best, test_loader, test.idx2label)
        for key in ("precision", "recall", "f1_score"):
            tracker.log_metric(key, round(metrics[key], 4))
        tracker.log_metric("test_accuracy", round(metrics["accuracy"], 4))
        cm_path = plot_confusion_matrix(
            metrics["confusion_matrix"], metrics["labels"],
            f"./results/confusion_matrix_{timestamp}.png")
        tracker.log_artifact(cm_path, "results")
        report_path = Path(f"./results/metrics_report_{timestamp}.json")
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(metrics["report"], indent=2))
        tracker.log_artifact(str(report_path), "results")

    print({k: round(metrics[k], 4)
           for k in ("accuracy", "precision", "recall", "f1_score")})
    append_run(args.register, model_name, params, metrics["f1_score"])
    print(f"run registered at {args.register} (run_id {run_id})")
    return metrics


if __name__ == "__main__":
    main()
