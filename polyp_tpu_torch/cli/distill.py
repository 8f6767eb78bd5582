"""Progressive distillation of the scratch-trained per-class DDPMs: the twin
of polyp_tpu/cli/distill.py (`polyp-distill-torch`; `--mesh data=N` under
torchrun: each phase's steps data-parallel over N cards, rank 0 writing).

Each class's `models/model_{cls}` (a polyp-train-scratch-torch output:
the fp32 masters of the pixel UNet) is distilled phase by phase
(train/distill.py), each phase training the student to do in ONE
deterministic DDIM step what its teacher does in two.

Usage (on the card; `--device cpu` for the CPU):
  polyp-distill-torch --data-root ./data --model-dir RUN
      [--start_steps 100] [--end_steps 25] [--steps_per_phase 2000]
      [--num_train_timesteps 1000] [--generate N] [--tiny]

Grid rule: T % (2·N) at every phase (nested trailing grids); T = 1000
supports 100 → 50 → 25 and 20 → 10 → 5. Students land in
`--output-dir`/models/distilled_{cls} with `distilled_{cls}_meta.json`
(num_steps, prediction_type, the sampling convention: ddim on the
trailing grid, steps_offset 0); `--generate N` samples N images a class
with the student. `--student_prediction_type v_prediction` switches the
head after a reparam warmup, which `check_reparam_converged` guards.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, class_split, get_mesh_from,
    get_tracker_from, print_banner)
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.parallel import barrier, is_writer
from polyp_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from polyp_tpu_torch.utils.rng import stream_generator

TRAILING = {"spacing": "trailing", "steps_offset": 0}


def main(argv=None) -> dict:
    """Distils every class in turn; returns {cls: {"num_steps",
    "prediction_type", "losses" (a list a phase), "distill_s",
    "generate_s"}} (host seconds around synchronised work)."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--model-dir", type=str, required=True,
                        help="a polyp-train-scratch-torch output dir "
                             "(models/model_{cls} checkpoints)")
    parser.add_argument("--one_vs_rest", action="store_true")
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--train_batch_size", type=int, default=8)
    parser.add_argument("--num_train_timesteps", type=int, default=1000,
                        help="must match the teacher's training T")
    parser.add_argument("--start_steps", type=int, default=100)
    parser.add_argument("--end_steps", type=int, default=25)
    parser.add_argument("--steps_per_phase", type=int, default=2000)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--reparam_steps", type=int, default=-1,
                        help="0-substep warmup for the ε→v head switch; "
                             "-1 auto-scales to --steps_per_phase")
    parser.add_argument("--student_prediction_type", type=str,
                        default="epsilon",
                        choices=["v_prediction", "epsilon"])
    parser.add_argument("--generate", type=int, default=0,
                        help="sample N images per class with the distilled "
                             "student after the final phase")
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="miniature scratch UNet (smoke/CI)")
    args = parser.parse_args(argv)

    from polyp_tpu_torch.data.cache import ArrayDataset
    from polyp_tpu_torch.data.pipeline import Loader
    from polyp_tpu_torch.data.tables import DiffusionTable
    from polyp_tpu_torch.data.transforms import augment_diffusion_batch
    from polyp_tpu_torch.models.unet2d import (
        polyp_scratch_unet, tiny_scratch_unet)
    from polyp_tpu_torch.pipeline import (
        PixelDiffusionSampler, generate_to_dir)
    from polyp_tpu_torch.train.distill import distill_progressive

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("polyp-distill-torch runs on the CUDA card by "
                           "default and no card is present; pass --device "
                           "cpu")
    config = DiffusionConfig(
        image_size=args.image_size, train_batch_size=args.train_batch_size,
        num_train_timesteps=args.num_train_timesteps,
        experiment_name="diffusion_distilled",
        **({"output_dir": args.output_dir} if args.output_dir else {}))
    layout = DataLayout(Path(args.data_root))
    classes, class_map = class_split(args.one_vs_rest)
    mesh = get_mesh_from(args)
    device = torch.device(args.device)
    tracker = get_tracker_from(args, mesh)
    tracker.set_experiment(args.experiment_name or config.experiment_name)

    model = (tiny_scratch_unet if args.tiny else polyp_scratch_unet)(
        device=device)
    schedule = DiffusionSchedule.create(config.num_train_timesteps)

    out: dict = {}
    with tracker.start_run(run_name=os.path.basename(config.output_dir)):
        tracker.log_params({
            "start_steps": args.start_steps, "end_steps": args.end_steps,
            "steps_per_phase": args.steps_per_phase,
            "student_prediction_type": args.student_prediction_type,
            "teacher_model_dir": str(args.model_dir),
        })
        for cls in classes:
            print_banner(f"Distilling class {cls}: "
                         f"{args.start_steps} -> {args.end_steps} steps")
            ckpt = Path(args.model_dir) / "models" / f"model_{cls}"
            teacher_params = {k: v.to(device) for k, v in
                              load_pytree(ckpt)["params"].items()}
            table = DiffusionTable.from_dirs(
                [layout.train_images, layout.val_images],
                [layout.train_csv, layout.val_csv],
                keep_one_class=class_map[cls])
            data = ArrayDataset.from_table(table, config.image_size,
                                           args.cache_dir)
            loader = Loader(data.images, data.labels,
                            config.train_batch_size, seed=config.seed,
                            device=device, mesh=mesh,
                            process_shard=mesh is not None)

            def batches(_loader=loader):
                for i, (images, _, _) in enumerate(_loader):
                    # drawn for the global batch, this rank's rows kept
                    flip = torch.rand(
                        config.train_batch_size, device=device,
                        generator=stream_generator(
                            config.seed, "distill", i, device=device))
                    if mesh is not None:
                        flip = mesh.local(flip)
                    yield augment_diffusion_batch(images, flip < 0.5)

            start = time.perf_counter()
            result = distill_progressive(
                model, teacher_params, schedule, batches,
                start_steps=args.start_steps, end_steps=args.end_steps,
                steps_per_phase=args.steps_per_phase,
                learning_rate=args.learning_rate,
                student_prediction_type=args.student_prediction_type,
                reparam_steps=args.reparam_steps,
                log=lambda k, v, s, _c=cls: tracker.log_metric(
                    f"{k}_{_c}", v, s), mesh=mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            distill_s = time.perf_counter() - start

            target = Path(config.output_dir) / "models" / f"distilled_{cls}"
            if is_writer(mesh):
                save_pytree(target, {"params": result.params})
                (target.parent / f"distilled_{cls}_meta.json").write_text(
                    json.dumps({"num_steps": result.num_steps,
                                "prediction_type": result.prediction_type,
                                "sampler": "ddim",
                                "sampler_kwargs": dict(TRAILING),
                                "num_train_timesteps":
                                    config.num_train_timesteps}))
            barrier(mesh)
            tracker.log_artifact(str(target), f"distilled/model_{cls}")
            for ph in result.phases:
                tail = ph.losses[-20:]
                print(f"  phase {ph.num_steps} steps: final loss "
                      f"{sum(tail) / max(len(tail), 1):.3e}")

            generate_s = 0.0
            if args.generate > 0:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        p.copy_(result.params[name])
                sampler = PixelDiffusionSampler(
                    model, DiffusionSchedule.create(
                        config.num_train_timesteps,
                        prediction_type=result.prediction_type),
                    config.image_size, sampler="ddim",
                    num_steps=result.num_steps,
                    sampler_kwargs=dict(TRAILING), mesh=mesh)
                sample_dir = Path(config.output_dir) / "samples" / cls
                start = time.perf_counter()
                generate_to_dir(sampler, args.generate, sample_dir,
                                config.eval_batch_size, config.seed,
                                mesh=mesh)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                generate_s = time.perf_counter() - start
                print(f"  wrote {args.generate} {result.num_steps}-step "
                      f"samples to {sample_dir}")
            out[cls] = {"num_steps": result.num_steps,
                        "prediction_type": result.prediction_type,
                        "losses": [ph.losses for ph in result.phases],
                        "distill_s": distill_s, "generate_s": generate_s}
    return out


if __name__ == "__main__":
    main()
