"""All-classes SD LoRA CLI: the twin of polyp_tpu/cli/lora_all_classes.py
on one card.

Every class in one run, with quotas computed from the training CSV
(eval/quota.py), gradient accumulation, and the `--generate_subsamples`
quick mode (5 images a class). Each class goes through
cli/sd_common.py::train_class: its LoRA bundle saved as
`{folder}/lora_{cls}`, its samples in `{folder}/samples/{cls}`.

Usage (on the card; `--device cpu` for the CPU):
  polyp-lora-all-classes-torch --folder runs/lora_all [--one_vs_rest]
      [--generate_subsamples] [--accumulation_steps N] ...
"""

from __future__ import annotations

import argparse
from pathlib import Path

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, class_split, get_mesh_from,
    get_tracker_from, load_sd_stack)
from polyp_tpu_torch.cli.sd_common import SDFlags, train_class
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.eval.quota import (
    counts_per_class, default_distribution, get_num_images_to_generate)


def main(argv=None) -> dict:
    """Trains every class in turn; returns {"quotas", "classes": {cls:
    train_class's result}}."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--folder", type=str, required=True)
    parser.add_argument("--one_vs_rest", action="store_true")
    parser.add_argument("--unconditional", action="store_true")
    parser.add_argument("--class_condition", action="store_true")
    parser.add_argument("--train_text_encoder", action="store_true")
    parser.add_argument("--dreambooth", action="store_true")
    parser.add_argument("--add_visual_influence", action="store_true")
    parser.add_argument("--unfreeze_layers", action="store_true")
    parser.add_argument("--generate_subsamples", action="store_true",
                        help="quick mode: 5 images per class")
    parser.add_argument("--accumulation_steps", type=int, default=1)
    parser.add_argument("--num_epochs", type=int, default=200)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--ad_minimum", type=int, default=1000)
    parser.add_argument("--pretrained-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="miniature SD stack (smoke/CI)")
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="snapshot the class train state every N "
                             "epochs under {folder}/ckpt_{cls}; a killed "
                             "run re-invoked with the same flags resumes "
                             "from the last snapshot deterministically "
                             "(train/resume.py; 0 = off)")
    args = parser.parse_args(argv)

    config = DiffusionConfig(quantize=args.quantize,
                             quant_fp_head=args.quant_fp_head,
                             quant_fp_tail=args.quant_fp_tail,
                             image_size=args.image_size,
                             num_epochs=args.num_epochs,
                             accumulation_steps=args.accumulation_steps,
                             experiment_name="baseline_with_lora")
    flags = SDFlags(args.unconditional, args.class_condition,
                    args.train_text_encoder, args.dreambooth,
                    args.add_visual_influence, args.unfreeze_layers)

    folder = Path(args.folder)
    folder.mkdir(parents=True, exist_ok=True)
    layout = DataLayout(Path(args.data_root))

    classes, class_map = class_split(args.one_vs_rest)

    dist = default_distribution(args.one_vs_rest)
    quotas = get_num_images_to_generate(counts_per_class(layout.train_csv),
                                        dist, args.ad_minimum,
                                        args.one_vs_rest)
    print(f"Quotas: {quotas}")

    mesh = get_mesh_from(args)
    stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                                         device=args.device, mesh=mesh)
    tracker = get_tracker_from(args, mesh)
    tracker.set_experiment(args.experiment_name or config.experiment_name)
    out: dict = {"quotas": quotas, "classes": {}}
    with tracker.start_run(run_name=folder.name):
        tracker.log_param("images_to_generate_per_class", quotas)
        for cls in classes:
            generate = 5 if args.generate_subsamples else None
            out["classes"][cls] = train_class(
                stack, config, layout, folder, cls, class_map, quotas[cls],
                flags, tracker, args.cache_dir, generate=generate,
                ckpt_every=args.ckpt_every, mesh=mesh)
    return out


if __name__ == "__main__":
    main()
