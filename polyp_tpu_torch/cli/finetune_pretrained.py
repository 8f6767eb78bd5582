"""Pretrained SD latent fine-tune CLI: the twin of
polyp_tpu/cli/finetune_pretrained.py (the reference's
train_from_pretrained.py); `--mesh data=N` under torchrun trains and
samples data-parallel over N cards, rank 0 writing; `--mesh
data=N,model=k` adds tensor parallelism over k cards, as the reference
shards the frozen UNet and CLIP (:73-78): the stack is sharded at load,
and a rank holds only its shards.

LoRA r=4 α=4 (no dropout) on the attention projections, 256 px, over
every training image with the fixed prompt "a realistic photo of colon
polyp"; then the adapter is saved as `{output-dir}/lora_weights`, merged
into the stack, and one grid of `--eval_batch_size` images sampled into
`{output-dir}/samples/{last epoch:04d}`. At 256 px the UNet's top level
has 1,024 tokens, so its five self-attentions take the flash kernel, in
the train step and in every sampling forward.

Usage (on the card; `--device cpu` for the CPU):
  polyp-finetune-pretrained-torch --data-root ./data [--num_epochs N]
      [--pretrained-dir DIR] [--output-dir runs/finetune_pretrained]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from polyp_tpu_torch.cli.common import (
    DataLayout, add_common_flags, get_mesh_from, get_tracker_from,
    load_sd_stack, print_banner)
from polyp_tpu_torch.cli.sd_common import (
    make_components, make_sampler, merged_stack)
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.lora.surgery import LoRAConfig, init_lora, save_lora
from polyp_tpu_torch.parallel import is_writer, replicate_to
from polyp_tpu_torch.pipeline import generate_to_dir
from polyp_tpu_torch.train.sd_finetune import (
    create_sd_train_state, init_trainable, train_sd_lora, trainable_layout)
from polyp_tpu_torch.utils.rng import stream_generator

PROMPT = "a realistic photo of colon polyp"  # the reference's :169


def main(argv=None) -> dict:
    """Returns {"loss_hist", "steps", "samples": the grid's directory}."""
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    parser.add_argument("--num_epochs", type=int, default=200)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--lora_rank", type=int, default=4)
    parser.add_argument("--eval_batch_size", type=int, default=20)
    parser.add_argument("--num_inference_steps", type=int, default=25)
    parser.add_argument("--pretrained-dir", type=str, default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="miniature SD stack (smoke/CI)")
    parser.add_argument("--output-dir", type=str,
                        default="runs/finetune_pretrained")
    args = parser.parse_args(argv)

    from polyp_tpu_torch.data.cache import ArrayDataset
    from polyp_tpu_torch.data.pipeline import Loader
    from polyp_tpu_torch.data.tables import ClassificationTable

    config = DiffusionConfig(quantize=args.quantize,
                             quant_fp_head=args.quant_fp_head,
                             quant_fp_tail=args.quant_fp_tail,
                             image_size=args.image_size,
                             num_epochs=args.num_epochs,
                             lora_rank=args.lora_rank,
                             lora_alpha=args.lora_rank, lora_dropout=0.0,
                             eval_batch_size=args.eval_batch_size,
                             num_inference_steps=args.num_inference_steps,
                             output_dir=args.output_dir,
                             experiment_name="generator_model")
    layout = DataLayout(Path(args.data_root))
    mesh = get_mesh_from(args)
    stack = load_sd_stack(args.pretrained_dir, tiny=args.tiny,
                                         device=args.device, mesh=mesh)
    device = next(stack.unet.parameters()).device

    data = ArrayDataset.from_table(
        ClassificationTable.from_csv(layout.train_images, layout.train_csv),
        config.image_size, args.cache_dir)
    loader = Loader(data.images, data.labels, config.train_batch_size,
                    seed=config.seed, device=device, mesh=mesh,
                    process_shard=mesh is not None)
    cfg = config.with_schedule(len(loader))

    lcfg = LoRAConfig(cfg.lora_rank, cfg.lora_alpha, 0.0, cfg.modules_lora)
    adapter = init_lora(stack.unet, lcfg, stream_generator(
        cfg.seed, "lora_init", 0, device=device))
    trainable = replicate_to(init_trainable(adapter), mesh)
    frozen = make_components(stack, trainable)
    state = create_sd_train_state(
        cfg, trainable, trainable_layout(trainable, frozen, mesh), mesh)
    schedule = DiffusionSchedule.create(cfg.num_train_timesteps,
                                        "scaled_linear", 0.00085, 0.012)
    prompt_ids = np.asarray(stack.tokenizer([PROMPT]))
    print(PROMPT)

    tracker = get_tracker_from(args, mesh)
    tracker.set_experiment(args.experiment_name or cfg.experiment_name)
    print_banner("Starting training")
    with tracker.start_run(run_name=Path(cfg.output_dir).name):
        state, result = train_sd_lora(
            cfg, state, frozen.on_mesh(mesh), schedule, loader, prompt_ids,
            lcfg, log=lambda k, v, s: tracker.log_metric(k, v, s))

        out = Path(cfg.output_dir)
        adapter = state.whole_trainable()["unet_lora"]
        if is_writer(mesh):
            save_lora(out / "lora_weights", adapter)
        del adapter
        # over the sharded stack the merge takes the trainer's own shards
        merged = merged_stack(stack, frozen, state.trainable, lcfg)
        sampler = make_sampler(merged, cfg, mesh=mesh)
        epoch_dir = out / "samples" / f"{cfg.num_epochs - 1:04d}"
        generate_to_dir(sampler.for_prompt(PROMPT), cfg.eval_batch_size,
                        epoch_dir, cfg.eval_batch_size, cfg.seed, mesh=mesh)
        tracker.log_artifact(str(out / "lora_weights"), "lora")
        print(f"  Images saved at {epoch_dir}")
    return {"loss_hist": result.loss_hist, "steps": state.step,
            "samples": epoch_dir}


if __name__ == "__main__":
    main()
