"""Downstream augmentation eval CLI: the twin of
polyp_tpu/cli/eval_augmentation.py (`--mesh data=N` under torchrun:
data-parallel over N cards, rank 0 writing). Retrain the classifier on
real + generated samples and log the test metrics into the generator's
run (eval/harness.py).

Usage (on the card; `--device cpu` for the CPU):
  polyp-eval-augmentation-torch --path_model runs/lora --run_id <run> \\
      [--ad_vs_rest]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, get_mesh_from, get_tracker_from,
    print_banner)
from polyp_tpu_torch.configs import ClassificationConfig
from polyp_tpu_torch.eval.harness import (
    AugmentedDataDirs, run_augmentation_eval)
from polyp_tpu_torch.parallel import barrier, is_writer
from polyp_tpu_torch.utils.plotting import plot_confusion_matrix


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--path_model", type=str, required=True,
                        help="generation run folder holding samples/")
    parser.add_argument("--run_id", type=str, default=None,
                        help="the generator's run to log the metrics into")
    parser.add_argument("--ad_vs_rest", action="store_true")
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=16)
    args = parser.parse_args(argv)

    config = ClassificationConfig(
        image_size=args.image_size, batch_size=args.batch_size,
        num_epochs=args.num_epochs, weighted_sampling=True,
        one_vs_rest=args.ad_vs_rest)
    layout = DataLayout(Path(args.data_root))
    dirs = AugmentedDataDirs(
        str(layout.train_images), str(layout.train_csv),
        str(layout.val_images), str(layout.val_csv),
        str(layout.test_images), str(layout.test_csv),
        str(Path(args.path_model) / "samples"))
    mesh = get_mesh_from(args)
    writer = is_writer(mesh)
    tracker = get_tracker_from(args, mesh)
    if args.experiment_name:
        tracker.set_experiment(args.experiment_name)
    params = json.dumps({
        "image_size": config.image_size, "batch_size": config.batch_size,
        "num_epochs": config.num_epochs, "patience": config.patience,
        "learning_rate": config.learning_rate,
        "weight_decay": config.weight_decay,
        "hidden_features": config.hidden_features, "dropout": config.dropout,
        "weighted_sampling": config.weighted_sampling,
        "ad_vs_rest": args.ad_vs_rest,
    }, indent=2)
    if writer:
        (Path(args.path_model) / "params.json").write_text(params)

    print_banner("Augmented retrain + eval")
    metrics = run_augmentation_eval(config, dirs, tracker, args.run_id,
                                    args.ad_vs_rest, args.cache_dir,
                                    device=args.device, mesh=mesh)
    out = {k: round(metrics[k], 4)
           for k in ("accuracy", "precision", "recall", "f1_score")}
    if metrics.get("frechet") and metrics["frechet"]["per_class"]:
        out["frechet"] = {c: round(v, 4)
                          for c, v in metrics["frechet"]["per_class"].items()}
        out["frechet_extractor"] = metrics["frechet"]["extractor"]
    print(json.dumps(out))
    if writer:
        cm_path = plot_confusion_matrix(
            metrics["confusion_matrix"], metrics["labels"],
            str(Path(args.path_model) / "confusion_matrix_augmented.png"))
        print(f"confusion matrix at {cm_path}")
    barrier(mesh)
    return metrics


if __name__ == "__main__":
    main()
