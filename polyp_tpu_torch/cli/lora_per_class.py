"""Per-class SD LoRA CLI, the flagship workflow: the twin of
polyp_tpu/cli/lora_per_class.py.

One LoRA bundle a class, with filesystem-state resume: a class whose
`{folder}/lora_{cls}` exists is not trained again, and its
`samples/{cls}` is topped up to the quota (cli/sd_common.py).

Usage (on the card; `--device cpu` for the CPU):
  polyp-lora-per-class-torch --folder runs/lora --classes_to_train AD HP ASS \\
      --num_imgs_to_generate 465 619 628 --run_id <id> [--dreambooth] ...
Data-parallel over N cards (one process a card; rank 0 writes):
  torchrun --nproc_per_node=N -m polyp_tpu_torch.cli.lora_per_class \\
      --mesh data=-1 --folder runs/lora ...
"""

from __future__ import annotations

import argparse
from pathlib import Path

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, get_mesh_from, get_tracker_from,
    load_sd_stack)
from polyp_tpu_torch.cli.sd_common import SDFlags, resume_class, train_class
from polyp_tpu_torch.configs import DiffusionConfig


def main(argv=None) -> dict:
    """Runs the classes in turn; returns {"run_id", "classes": {cls:
    train_class's or resume_class's result, with "trained"}}."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--folder", type=str, required=True)
    parser.add_argument("--classes_to_train", nargs="+", type=str,
                        required=True)  # AD HP ASS REST
    parser.add_argument("--num_imgs_to_generate", nargs="+", type=int,
                        required=True)  # e.g. 465 619 628 413
    parser.add_argument("--run_id", type=str, default=None)
    parser.add_argument("--unconditional", action="store_true")
    parser.add_argument("--class_condition", action="store_true")
    parser.add_argument("--train_text_encoder", action="store_true")
    parser.add_argument("--dreambooth", action="store_true")
    parser.add_argument("--add_visual_influence", action="store_true")
    parser.add_argument("--unfreeze_layers", action="store_true")
    parser.add_argument("--num_epochs", type=int, default=200)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--pretrained-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="miniature SD stack (smoke/CI)")
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="snapshot the class train state every N "
                             "epochs under {folder}/ckpt_{cls}; a killed "
                             "run called again with the same flags resumes "
                             "from the last snapshot (0 = off)")
    args = parser.parse_args(argv)
    if len(args.classes_to_train) != len(args.num_imgs_to_generate):
        parser.error("--num_imgs_to_generate needs one quota a class")

    config = DiffusionConfig(quantize=args.quantize,
                             quant_fp_head=args.quant_fp_head,
                             quant_fp_tail=args.quant_fp_tail,
                             image_size=args.image_size,
                             num_epochs=args.num_epochs)
    flags = SDFlags(args.unconditional, args.class_condition,
                    args.train_text_encoder, args.dreambooth,
                    args.add_visual_influence, args.unfreeze_layers)
    folder = Path(args.folder)
    folder.mkdir(parents=True, exist_ok=True)
    layout = DataLayout(Path(args.data_root))
    class_map = {cls: ["HP", "ASS"] if cls == "REST" else [cls]
                 for cls in args.classes_to_train}

    mesh = get_mesh_from(args)
    stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                                         device=args.device, mesh=mesh)
    tracker = get_tracker_from(args, mesh)
    tracker.set_experiment(args.experiment_name or config.experiment_name)
    out: dict = {"classes": {}}
    with tracker.start_run(run_id=args.run_id) as run:
        out["run_id"] = run.run_id
        for cls, quota in zip(args.classes_to_train,
                              args.num_imgs_to_generate):
            result = resume_class(stack, config, folder, cls, quota, flags,
                                  tracker, mesh=mesh)
            trained = result is None
            if trained:
                result = train_class(stack, config, layout, folder, cls,
                                     class_map, quota, flags, tracker,
                                     args.cache_dir,
                                     ckpt_every=args.ckpt_every, mesh=mesh)
            out["classes"][cls] = {"trained": trained, **result}
    return out


if __name__ == "__main__":
    main()
