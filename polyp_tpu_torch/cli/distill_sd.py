"""Progressive distillation of the per-class SD models: the twin of
polyp_tpu/cli/distill_sd.py (`polyp-distill-sd-torch`; `--mesh data=N`
under torchrun: each phase's steps data-parallel over N cards, rank 0
writing). Under `--mesh data=N,model=k` the phases still train the whole
student on every rank (the reference's training is data-parallel too),
so a rank keeps the whole stack; the student is cut in place to the
rank's shards for `--generate`, as `load_student_sampler` cuts a saved
one (the reference's sampler shards it, its :226,273,299).

Each class's fine-tuned model (the stack with the class's `lora_{cls}`
bundle from polyp-lora-per-class-torch or polyp-lora-all-classes-torch)
is distilled into a few-step student with the guidance FOLDED IN: the
teacher runs the CFG pair at 2× batch, the student consumes the class
prompt's cond embedding only (train/distill.py). The student starts from
the class model's UNet in fp32 with the adapter merged and never rounded
(cli/sd_common.py::fp32_unet_params), as the reference's starts from its
merged fp32 params.

Usage (on the card; `--device cpu` for the CPU):
  polyp-distill-sd-torch --data-root ./data --model-dir RUN
      [--pretrained-dir SD_DIR | --tiny]
      [--start_steps 40] [--end_steps 10] [--steps_per_phase 2000]
      [--student_prediction_type epsilon|v_prediction] [--generate N]

Outputs in `--output-dir`/models: `distilled_{cls}` (every UNet parameter,
fp32, by state-dict name), `distilled_{cls}_cond.npy` (the fp32 cond
embedding the student was trained on) and `distilled_{cls}_meta.json`
(num_steps, prediction_type, the sampling convention: ddim on the
trailing grid with steps_offset 0, guidance "folded", the prompt);
`--generate N` samples N images a class with the student.

`load_student_sampler` reads those back into a sampler (polyp-serve-torch
--distilled-dir); `make_student_sampler` serves a student: trailing DDIM
at its step count, `guidance_scale=None` (cond-only forwards at 1×
batch), optionally the tiny decoder in place of the VAE decode.
`quantize="promoted"` resolves to the distilled verdict of the port's own
quant gate (ops/quant.py::resolve_quantize_arg, `distilled=True`).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, class_split, get_mesh_from,
    get_tracker_from, load_sd_stack, print_banner, replicate_stack)
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.diffusion.schedule import DiffusionSchedule
from polyp_tpu_torch.parallel import barrier, is_writer, sharding
from polyp_tpu_torch.pipeline import StableDiffusionSampler
from polyp_tpu_torch.utils.checkpoint import save_pytree
from polyp_tpu_torch.utils.rng import stream_generator

TRAILING = {"spacing": "trailing", "steps_offset": 0}


def sd_schedule(num_train_timesteps: int = 1000,
                prediction_type: str = "epsilon") -> DiffusionSchedule:
    """The SD-v1 schedule (scaled_linear, 0.00085 to 0.012)."""
    return DiffusionSchedule.create(num_train_timesteps, "scaled_linear",
                                    0.00085, 0.012,
                                    prediction_type=prediction_type)


def main(argv=None) -> dict:
    """Distils every class in turn; returns {cls: {"num_steps",
    "prediction_type", "losses" (a list a phase), "distill_s", "save_s",
    "generate_s"}} (host seconds around synchronised work)."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--model-dir", type=str, required=True,
                        help="a lora-per-class/all-classes output dir "
                             "(lora_{cls} bundles)")
    parser.add_argument("--pretrained-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="miniature SD stack (smoke/CI)")
    parser.add_argument("--one_vs_rest", action="store_true")
    parser.add_argument("--unconditional", action="store_true",
                        help="the class model was trained unconditional "
                             "(the prompt is then empty)")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--train_batch_size", type=int, default=8)
    parser.add_argument("--num_train_timesteps", type=int, default=1000)
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="CFG scale folded into the student (default: "
                             "the config's, 7.5)")
    parser.add_argument("--start_steps", type=int, default=40)
    parser.add_argument("--end_steps", type=int, default=10)
    parser.add_argument("--steps_per_phase", type=int, default=2000)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--reparam_steps", type=int, default=-1,
                        help="-1 auto-scales to --steps_per_phase; the "
                             "warmup is convergence-checked "
                             "(train/distill.py check_reparam_converged)")
    parser.add_argument("--student_prediction_type", type=str,
                        default="epsilon",
                        choices=["v_prediction", "epsilon"],
                        help="'epsilon' keeps the teacher's head (exact "
                             "warm start); 'v_prediction' switches it "
                             "after a reparam warmup")
    parser.add_argument("--generate", type=int, default=0)
    parser.add_argument("--output-dir", type=str, default=None)
    args = parser.parse_args(argv)

    from polyp_tpu_torch.cli.sd_common import (
        attach_bundle, fp32_unet_params, load_class_bundle)
    from polyp_tpu_torch.data.cache import ArrayDataset
    from polyp_tpu_torch.data.pipeline import Loader
    from polyp_tpu_torch.data.tables import DiffusionTable
    from polyp_tpu_torch.data.transforms import augment_diffusion_batch
    from polyp_tpu_torch.models.vae import SD_VAE_SCALING, DiagonalGaussian
    from polyp_tpu_torch.pipeline import generate_to_dir
    from polyp_tpu_torch.train.distill import distill_progressive
    from polyp_tpu_torch.train.dreambooth import resume_prompt

    config = DiffusionConfig(
        image_size=args.image_size, train_batch_size=args.train_batch_size,
        num_train_timesteps=args.num_train_timesteps,
        experiment_name="diffusion_sd_distilled",
        **({"guidance_scale": args.guidance_scale}
           if args.guidance_scale is not None else {}),
        **({"output_dir": args.output_dir} if args.output_dir else {}))
    layout = DataLayout(Path(args.data_root))
    classes, class_map = class_split(args.one_vs_rest)
    mesh = get_mesh_from(args)
    device = torch.device(args.device)
    writer = is_writer(mesh)
    tracker = get_tracker_from(args, mesh)
    tracker.set_experiment(args.experiment_name or config.experiment_name)

    stack = replicate_stack(load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                                          device=device), mesh)
    schedule = sd_schedule(config.num_train_timesteps)

    def global_rows(n: int, generator: torch.Generator, *shape: int
                    ) -> torch.Tensor:
        """A draw for the group's global batch (n rows a rank), this
        rank's rows kept: the one-process draw without a mesh."""
        wide = n * (1 if mesh is None else mesh.size)
        x = torch.rand(wide, device=device, generator=generator) \
            if not shape else torch.randn((wide, *shape), device=device,
                                          generator=generator)
        return x if mesh is None else mesh.local(x)

    @torch.no_grad()
    def encode_latents(images: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
        """The class's images in SD latent space, as the fine-tune
        encoded them (train/sd_finetune.py)."""
        posterior = DiagonalGaussian(stack.vae.encode_moments(images))
        noise = global_rows(images.shape[0], generator,
                            *posterior.mean.shape[1:])
        return posterior.sample(noise) * SD_VAE_SCALING

    out: dict = {}
    with tracker.start_run(run_name=os.path.basename(config.output_dir)):
        tracker.log_params({
            "start_steps": args.start_steps, "end_steps": args.end_steps,
            "steps_per_phase": args.steps_per_phase,
            "student_prediction_type": args.student_prediction_type,
            "guidance_scale_folded": config.guidance_scale,
            "teacher_model_dir": str(args.model_dir),
        })
        for cls in classes:
            bundle = load_class_bundle(stack, Path(args.model_dir), cls)
            if bundle is None:
                raise FileNotFoundError(
                    f"{args.model_dir}/lora_{cls} not found — run "
                    "polyp-lora-per-class-torch (or -all-classes-torch) "
                    "first")
            merged = attach_bundle(stack, config, cls, bundle)
            teacher_params = fp32_unet_params(stack, config, bundle)
            del bundle
            print_banner(f"Distilling SD class {cls}: "
                         f"{args.start_steps} -> {args.end_steps} steps, "
                         f"guidance {config.guidance_scale} folded")

            prompt = resume_prompt(cls, args.unconditional)
            with torch.no_grad():
                def encode(text: str) -> torch.Tensor:
                    ids = torch.as_tensor(merged.tokenizer([text]),
                                          dtype=torch.long, device=device)
                    return merged.text(ids).float()

                cond, uncond = encode(prompt), encode("")

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
                    flip = global_rows(images.shape[0], stream_generator(
                        config.seed, "distill-sd", i, device=device))
                    yield encode_latents(
                        augment_diffusion_batch(images, flip < 0.5),
                        stream_generator(config.seed, "latent", i,
                                         device=device))

            start = time.perf_counter()
            result = distill_progressive(
                stack.unet, teacher_params, schedule, batches,
                start_steps=args.start_steps, end_steps=args.end_steps,
                steps_per_phase=args.steps_per_phase,
                learning_rate=args.learning_rate,
                student_prediction_type=args.student_prediction_type,
                reparam_steps=args.reparam_steps,
                guidance_scale=config.guidance_scale,
                cond=cond, uncond=uncond,
                log=lambda k, v, s, _c=cls: tracker.log_metric(
                    f"{k}_{_c}", v, s), mesh=mesh)
            _sync(device)
            distill_s = time.perf_counter() - start
            del teacher_params

            start = time.perf_counter()
            models = Path(config.output_dir) / "models"
            target = models / f"distilled_{cls}"
            if writer:
                save_pytree(target, {"params": result.params})
                # the trained cond embedding travels with the student: a
                # DreamBooth class's token exists only in a grown vocabulary
                np.save(models / f"distilled_{cls}_cond.npy",
                        cond.cpu().numpy().astype(np.float32))
                (models / f"distilled_{cls}_meta.json").write_text(
                    json.dumps({
                        "num_steps": result.num_steps,
                        "prediction_type": result.prediction_type,
                        "sampler": "ddim", "sampler_kwargs": dict(TRAILING),
                        "guidance": "folded",
                        "guidance_scale": config.guidance_scale,
                        "prompt": prompt, "image_size": config.image_size,
                        "num_train_timesteps": config.num_train_timesteps}))
            barrier(mesh)
            save_s = time.perf_counter() - start
            tracker.log_artifact(str(target), f"distilled/model_{cls}")
            for ph in result.phases:
                print(f"  phase {ph.num_steps} steps: final loss "
                      f"{float(np.mean(ph.losses[-20:])):.3e}")

            generate_s = 0.0
            if args.generate > 0:
                # under a model axis the student is cut in place to this
                # rank's shards and its whole weights dropped (they are on
                # disk): the sampler runs it as it is
                student = sharding.shard_params(
                    student_unet(stack.unet, result.params), mesh)
                result.params = None
                sampler = make_student_sampler(
                    merged, student,
                    num_steps=result.num_steps,
                    prediction_type=result.prediction_type,
                    image_size=config.image_size,
                    num_train_timesteps=config.num_train_timesteps,
                    mesh=mesh)
                sample_dir = Path(config.output_dir) / "samples" / cls
                start = time.perf_counter()
                generate_to_dir(sampler.for_prompt(prompt), args.generate,
                                sample_dir, config.eval_batch_size,
                                config.seed, mesh=mesh)
                _sync(device)
                generate_s = time.perf_counter() - start
                print(f"  wrote {args.generate} {result.num_steps}-step "
                      f"samples to {sample_dir}")
            out[cls] = {"num_steps": result.num_steps,
                        "prediction_type": result.prediction_type,
                        "losses": [ph.losses for ph in result.phases],
                        "distill_s": distill_s, "save_s": save_s,
                        "generate_s": generate_s}
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def student_unet(unet: nn.Module, params: dict[str, torch.Tensor]
                 ) -> nn.Module:
    """A copy of `unet` holding a student's weights (each rounded once to
    its parameter's dtype); `unet` is left as it was."""
    from polyp_tpu_torch.lora.surgery import merged_module
    return merged_module(unet, params).eval()


def load_student_sampler(stack, output_dir: str | Path, cls: str, *,
                         image_size: int = 256,
                         quantize: str | None = None,
                         quant_fp_head: int = 0, quant_fp_tail: int = 0,
                         quant_promoted: bool = False,
                         decoder: nn.Module | None = None,
                         mesh=None) -> StableDiffusionSampler:
    """A polyp-distill-sd-torch output (`models/distilled_{cls}` and its
    meta.json) as a ready sampler over `stack`'s VAE, text encoder and
    tokenizer: the serving path for students (polyp-serve-torch
    --distilled-dir; reference :235-281). The meta's sampling convention
    (step count, prediction type, trailing grid, folded guidance) holds;
    the class prompt resolves to the saved cond embedding (a DreamBooth
    token the base text stack cannot encode included). `decoder`: a
    TinyDecoder replacing the VAE decode. `quantize="promoted"`, or
    `quant_promoted` (a DiffusionConfig's, which expanded "promoted" with
    the full-trajectory verdict), resolves to the distilled verdict
    (reference :257-265): a full-trajectory bf16 head would cover a
    4-8-step grid and drop the quantization (pipeline._precision_split).
    `mesh`: as `make_student_sampler`'s."""
    from polyp_tpu_torch.ops.quant import resolve_quantize_arg
    from polyp_tpu_torch.utils.checkpoint import load_pytree

    if quantize == "promoted" or quant_promoted:
        quantize, quant_fp_head, quant_fp_tail = resolve_quantize_arg(
            "promoted", 0, 0, distilled=True)
    models = Path(output_dir) / "models"
    meta = json.loads((models / f"distilled_{cls}_meta.json").read_text())
    params = load_pytree(models / f"distilled_{cls}")["params"]
    device = next(stack.unet.parameters()).device
    student = sharding.shard_params(student_unet(
        stack.unet, {k: v.to(device) for k, v in params.items()}), mesh)
    del params
    sampler = make_student_sampler(
        stack, student,
        num_steps=meta["num_steps"],
        prediction_type=meta["prediction_type"], image_size=image_size,
        num_train_timesteps=meta["num_train_timesteps"], quantize=quantize,
        quant_fp_head=quant_fp_head, quant_fp_tail=quant_fp_tail,
        decoder=decoder, mesh=mesh)
    cond = models / f"distilled_{cls}_cond.npy"
    if cond.exists():
        sampler.register_prompt_embedding(
            meta["prompt"], torch.from_numpy(np.load(cond)).to(
                next(stack.text.parameters()).dtype))
    return sampler


def make_student_sampler(stack, unet: nn.Module, *, num_steps: int,
                         prediction_type: str = "epsilon",
                         image_size: int = 256,
                         num_train_timesteps: int = 1000,
                         quantize: str | None = None,
                         quant_fp_head: int = 0, quant_fp_tail: int = 0,
                         decoder: nn.Module | None = None,
                         fused_mha: bool = False,
                         mesh=None) -> StableDiffusionSampler:
    """A StableDiffusionSampler over the student `unet` and the VAE, text
    encoder and tokenizer of `stack` (cli/common.py::SDStack): trailing
    DDIM at `num_steps`, `guidance_scale=None`, the SD-v1 schedule with the
    student's `prediction_type` (reference :284-303). `decoder`: a
    TinyDecoder replacing the VAE decode; `mesh`: fan batches out over its
    data group and, with a model axis, run the student over its model
    group (a UNet sharded over `mesh` as it is, as this module's callers
    pass it; a whole one through a sharded copy, `unet` staying whole)."""
    return StableDiffusionSampler(
        unet, stack.vae, stack.text, stack.tokenizer,
        sd_schedule(num_train_timesteps, prediction_type),
        image_size=image_size, num_steps=num_steps, guidance_scale=None,
        sampler="ddim", quantize=quantize, quant_fp_head=quant_fp_head,
        quant_fp_tail=quant_fp_tail, sampler_kwargs=dict(TRAILING),
        decoder=decoder, fused_mha=fused_mha, mesh=mesh)


if __name__ == "__main__":
    main()
