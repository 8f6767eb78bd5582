"""Per-class scratch DDPM CLI: the twin of polyp_tpu/cli/train_scratch.py
(`--mesh data=N` under torchrun: each class trained and its quota sampled
data-parallel over N cards, rank 0 writing).

Per class (AD, HP, ASS, or AD and REST with `--one_vs_rest`): the class's
images (train + valid) → a pixel-space DDPM trained from scratch
(train/scratch_ddpm.py; `polyp_scratch_unet`, or `tiny_scratch_unet` with
`--tiny`) → in the final epoch, the class's quota sampled into
`{output-dir}/samples/{cls}` (ancestral DDPM over every train timestep, or
DDIM with `--sample_steps`) and the fp32 parameters saved as
`{output-dir}/models/model_{cls}`. `--conditional_generation` conditions
the UNet on a CLIP ViT-B/32 text encoding of the class's prompt
(initialised from seed 0 unless a tokenizer directory is given, as in the
reference). `--ckpt-every N` snapshots the train state every N epochs
under `{output-dir}/ckpt_{cls}`; a killed run called again with the same
flags resumes from the last snapshot.

Usage (on the card; `--device cpu` for the CPU):
  polyp-train-scratch-torch --data-root ./data [--one_vs_rest]
      [--conditional_generation] [--num_epochs N] [--image_size N]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, class_split, get_mesh_from,
    get_tracker_from, init_weights_, print_banner)
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.eval.quota import (
    counts_per_class, default_distribution, get_num_images_to_generate)
from polyp_tpu_torch.parallel import barrier, is_writer, replicate_to
from polyp_tpu_torch.pipeline import PixelDiffusionSampler, generate_to_dir
from polyp_tpu_torch.train.scratch_ddpm import (
    create_ddpm_state, train_scratch_ddpm)
from polyp_tpu_torch.utils.checkpoint import save_pytree

ACRONYMS_TO_WORDS = {
    "AD": "adenomatous",
    "HP": "hyperplastic",
    "ASS": "sessile serrated",
    "REST": "hyperplastic and sessile serrated",
}


@torch.no_grad()
def class_text_embeddings(cls: str, text_encoder_dir: str | None,
                          device) -> torch.Tensor:
    """The [1, 77, 512] CLIP ViT-B/32 encoding of the class's prompt, the
    text model initialised from seed 0 (the reference's PRNGKey(0))."""
    from polyp_tpu_torch.models import (
        VIT_B32_TEXT_CONFIG, CLIPTextModel, load_tokenizer)

    tokenizer = load_tokenizer(text_encoder_dir)
    text = CLIPTextModel(VIT_B32_TEXT_CONFIG, device=device)
    init_weights_(text, torch.Generator(device).manual_seed(0))
    prompt = (f"a high-resolution endoscopic image of "
              f"{ACRONYMS_TO_WORDS[cls]} polyp")
    print(prompt)
    ids = torch.as_tensor(tokenizer([prompt]), dtype=torch.long,
                          device=device)
    return text(ids)


def main(argv=None) -> dict:
    """Trains the classes in turn; returns {cls: the final DDPMState}."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--one_vs_rest", action="store_true")
    parser.add_argument("--conditional_generation", action="store_true")
    parser.add_argument("--num_epochs", type=int, default=200)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--train_batch_size", type=int, default=8)
    parser.add_argument("--num_train_timesteps", type=int, default=1000)
    parser.add_argument("--sample_steps", type=int, default=None,
                        help="inference steps (default: full T ancestral)")
    parser.add_argument("--ad_minimum", type=int, default=1000)
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--text-encoder-dir", type=str, default=None,
                        help="local clip-vit-base-patch32 dir (optional)")
    parser.add_argument("--tiny", action="store_true",
                        help="miniature scratch UNet (smoke/CI)")
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="snapshot train state every N epochs under "
                             "{output-dir}/ckpt_{cls}; a killed run "
                             "re-invoked with the same flags resumes from "
                             "the last snapshot deterministically "
                             "(train/resume.py; 0 = off)")
    args = parser.parse_args(argv)

    from polyp_tpu_torch.data.cache import ArrayDataset
    from polyp_tpu_torch.data.pipeline import Loader
    from polyp_tpu_torch.data.tables import DiffusionTable
    from polyp_tpu_torch.models.unet2d import (
        polyp_scratch_unet, tiny_scratch_unet)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("polyp-train-scratch-torch runs on the CUDA card "
                           "by default and no card is present; pass "
                           "--device cpu")
    config = DiffusionConfig(
        quantize=args.quantize,
        quant_fp_head=args.quant_fp_head,
        quant_fp_tail=args.quant_fp_tail,
        image_size=args.image_size, train_batch_size=args.train_batch_size,
        num_epochs=args.num_epochs,
        num_train_timesteps=args.num_train_timesteps,
        experiment_name="diffusion_from_scratch",
        **({"output_dir": args.output_dir} if args.output_dir else {}))

    layout = DataLayout(Path(args.data_root))
    classes, class_map = class_split(args.one_vs_rest)

    dist = default_distribution(args.one_vs_rest)
    quotas = get_num_images_to_generate(counts_per_class(layout.train_csv),
                                        dist, args.ad_minimum,
                                        args.one_vs_rest)
    print(f"Images that will be generated:\n {quotas}")

    mesh = get_mesh_from(args)
    device = torch.device(args.device)
    tracker = get_tracker_from(args, mesh)
    tracker.set_experiment(args.experiment_name or config.experiment_name)
    states = {}
    with tracker.start_run(run_name=os.path.basename(config.output_dir)):
        tracker.log_param("images_to_generate_per_class", quotas)
        tracker.log_param("percentage_image_distribution", dist)
        if args.one_vs_rest:
            tracker.log_param("technique", "AD vs REST")

        for cls in classes:
            print_banner(f"Training class {cls}")
            table = DiffusionTable.from_dirs(
                [layout.train_images, layout.val_images],
                [layout.train_csv, layout.val_csv],
                keep_one_class=class_map[cls])
            data = ArrayDataset.from_table(table, config.image_size,
                                           args.cache_dir)
            loader = Loader(data.images, data.labels, config.train_batch_size,
                            seed=config.seed, device=device, mesh=mesh,
                            process_shard=mesh is not None)
            cfg = config.with_schedule(len(loader))

            tracker.log_params({
                "transformations": table.transformations_list,
                "criterion": "MSELoss", "optimizer": "AdamW",
                "batch_size": cfg.train_batch_size,
                "learning_rate": cfg.learning_rate,
                "num_epochs": cfg.num_epochs,
                "image_size": cfg.image_size,
                f"train_timesteps_{cls}": cfg.num_train_timesteps,
            })

            text_embeddings, ctx_dim = None, None
            if args.conditional_generation:
                text_embeddings = class_text_embeddings(
                    cls, args.text_encoder_dir, device)
                ctx_dim = text_embeddings.shape[-1]
                tracker.log_param(
                    "input_prompt",
                    "a high-resolution endoscopic image of x polyp")

            model = (tiny_scratch_unet if args.tiny else polyp_scratch_unet)(
                cross_attention_dim=ctx_dim, device=device)
            state = create_ddpm_state(
                cfg, model, torch.Generator(device).manual_seed(cfg.seed))
            replicate_to(state.params, mesh)
            schedule = DiffusionSchedule.create(cfg.num_train_timesteps)

            def final_epoch_hook(epoch, st, _cls=cls, _cfg=cfg,
                                 _sched=schedule, _emb=text_embeddings):
                if epoch != _cfg.num_epochs - 1:
                    return
                sampler = PixelDiffusionSampler(
                    st.load_into_model(), _sched, _cfg.image_size,
                    sampler="ddpm" if args.sample_steps is None else "ddim",
                    num_steps=args.sample_steps, text_embeddings=_emb,
                    quantize=_cfg.quantize,
                    quant_fp_head=_cfg.quant_fp_head,
                    quant_fp_tail=_cfg.quant_fp_tail, mesh=mesh)
                out = Path(_cfg.output_dir) / "samples" / _cls
                generate_to_dir(sampler, quotas[_cls], out,
                                _cfg.eval_batch_size, _cfg.seed,
                                progress=lambda a, b: print(
                                    f"   Saved {a}/{b}"), mesh=mesh)
                ckpt = Path(_cfg.output_dir) / "models" / f"model_{_cls}"
                if is_writer(mesh):
                    save_pytree(ckpt, {"params": st.params})
                barrier(mesh)
                tracker.log_artifact(str(ckpt),
                                     f"diffusion_model/model_{_cls}")

            checkpointer = None
            if args.ckpt_every > 0:
                from polyp_tpu_torch.train.resume import EpochCheckpointer
                checkpointer = EpochCheckpointer(
                    Path(cfg.output_dir) / f"ckpt_{cls}",
                    every=args.ckpt_every, mesh=mesh)

            state, _ = train_scratch_ddpm(
                cfg, state, schedule, loader, text_embeddings,
                log=lambda k, v, s, _cls=cls: tracker.log_metric(
                    f"{k}_{_cls}", v, s),
                epoch_callback=final_epoch_hook,
                checkpointer=checkpointer)
            states[cls] = state
            print(f"Training for class {cls} finished successfully\n")
    return states


if __name__ == "__main__":
    main()
