"""The SD fine-tuning workflow shared by the per-class CLI: the twin of
polyp_tpu/cli/sd_common.py (:94-371).

* `train_class`: a class's images (DiffusionTable over train + valid,
  REST merging) → a new LoRA bundle (UNet adapter, and by the flags a text
  adapter, a DreamBooth token row, the visual-influence projection,
  unfrozen attention projections) → train_sd_lora → the whole trainable
  bundle saved as `{folder}/lora_{cls}` → the class's quota generated into
  `{folder}/samples/{cls}`.
* `restore_class_params` / `resume_class`: the filesystem-state resume
  branch (`load_class_bundle` + `attach_bundle`; `fp32_unet_params` gives
  the distillation CLI the merged UNet in fp32). A saved bundle is loaded
  and attached; the DreamBooth token is
  registered again in this process's tokenizer and its row scattered at
  the id it has here (ids are given in the order classes register them,
  so the id at training time may differ); missing samples are topped up
  to the quota with the same seeds and file names.
* `make_components` / `merged_stack` / `make_sampler`: the frozen side of
  a train step, and the stack with a bundle attached for sampling: new
  UNet and CLIP modules that share every tensor with the stack except the
  merged kernels (and the grown token table), so the stack's own weights
  stay bit for bit. `unfrozen` weights are fp32 copies, never views of
  the stack.

Under a model axis the CLIs' stack is sharded at load (cli/common.py::
load_sd_stack(mesh=)), and everything here works shard-wise: the fp32
kernels are this rank's slices, the trainer holds its shards, the merge
takes the trainer's own shards (never the gathered bundle) and gives a
merged UNet and CLIP sharded over the same mesh, which the sampler runs
as they are. Only the saved bundle is whole (gathered, bit-equal across
the ranks).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from polyp_tpu_torch.cli.common import DataLayout, SDStack, print_banner
from polyp_tpu_torch.configs import LORA_MODULE_PRESETS, DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.lora.surgery import (
    LoRAConfig, init_lora, load_lora, merge_lora, merged_module, save_lora)
from polyp_tpu_torch.parallel import mesh as pmesh
from polyp_tpu_torch.parallel import sharding
from polyp_tpu_torch.pipeline import (
    StableDiffusionSampler, count_samples, generate_to_dir, top_up_samples)
from polyp_tpu_torch.train.dreambooth import (
    SPECIAL_TOKENS, dreambooth_prompt, dreambooth_token_init,
    embed_with_special_rows, resize_token_embeddings, resume_prompt)
from polyp_tpu_torch.train.sd_finetune import (
    TOKEN_TABLE, SDComponents, create_sd_train_state, init_proj_params,
    init_trainable, module_dtype, train_sd_lora, trainable_layout)
from polyp_tpu_torch.utils.checkpoint import tree_map
from polyp_tpu_torch.utils.rng import stream_generator

# the base attention projections that train beside the adapter under
# --unfreeze_layers
UNFROZEN_MODULES = ("to_q", "to_k", "to_v", "to_out")


@dataclass
class SDFlags:
    """The reference CLI's feature flags."""

    unconditional: bool = False
    class_condition: bool = False
    train_text_encoder: bool = False
    dreambooth: bool = False
    add_visual_influence: bool = False
    unfreeze_layers: bool = False


def log_sample_images(tracker, sample_dir: Path, cls: str,
                      num_samples: int = 10) -> None:
    """Log the first `num_samples` generated PNGs (by name) as run
    artifacts."""
    if not Path(sample_dir).exists():
        return
    files = sorted(p for p in Path(sample_dir).iterdir()
                   if p.suffix == ".png")[:num_samples]
    for f in files:
        tracker.log_artifact(str(f), f"samples/{cls}")


def make_components(stack: SDStack, trainable: dict,
                    token_table: torch.Tensor | None = None
                    ) -> SDComponents:
    """The frozen side of a train step over `stack`: its modules, and the
    fp32 weights (SDStack.fp32_params) of every kernel the bundle's
    adapters target; `token_table` is a grown embedding table
    (DreamBooth)."""
    def kernels(part, adapter):
        return stack.fp32_params(part, [f"{n}.weight" for n in adapter])

    text_params = kernels("text", trainable.get("text_lora", {}))
    if token_table is not None:
        text_params[TOKEN_TABLE] = token_table
    return SDComponents(stack.unet, stack.vae, stack.text,
                        kernels("unet", trainable["unet_lora"]), text_params)


@torch.no_grad()
def merged_stack(stack: SDStack, frozen: SDComponents, trainable: dict,
                 unet_lora_cfg: LoRAConfig,
                 text_lora_cfg: LoRAConfig | None = None,
                 special_ids: torch.Tensor | None = None) -> SDStack:
    """`stack` with a trained bundle attached, for sampling: the UNet
    adapter merged (over the `unfrozen` weights where there are some), the
    DreamBooth rows scattered into the token table, the text adapter
    merged. No dropout. `trainable` is in the stack's layout: whole over a
    whole stack; over a sharded stack this rank's shards (a trainer's
    `state.trainable`, or a bundle cut as `attach_bundle` cuts it),
    merged into `frozen`'s slices of the kernels into a UNet and CLIP
    sharded over the same mesh."""
    kernels = frozen.unet_params
    unet_weights = {}
    if "unfrozen" in trainable:
        kernels = {**kernels, **trainable["unfrozen"]}
        unet_weights = dict(trainable["unfrozen"])
    unet_weights.update(merge_lora(kernels, trainable["unet_lora"],
                                   unet_lora_cfg,
                                   dtype=module_dtype(stack.unet)))
    text_weights = {k: v for k, v in frozen.text_params.items()
                    if k == TOKEN_TABLE}
    if "special_rows" in trainable:
        table = text_weights.get(TOKEN_TABLE,
                                 stack.text.get_parameter(TOKEN_TABLE))
        text_weights[TOKEN_TABLE] = embed_with_special_rows(
            table, trainable["special_rows"], special_ids)
    if "text_lora" in trainable:
        text_weights.update(merge_lora(frozen.text_params,
                                       trainable["text_lora"], text_lora_cfg,
                                       dtype=module_dtype(stack.text)))
    return replace(stack, unet=merged_module(stack.unet, unet_weights),
                   text=merged_module(stack.text, text_weights))


def make_sampler(stack: SDStack, config: DiffusionConfig,
                 decoder=None, mesh: pmesh.DataMesh | None = None
                 ) -> StableDiffusionSampler:
    """A StableDiffusionSampler over `stack` on the SD-v1 schedule
    (scaled_linear, 0.00085 to 0.012) with `config`'s image size, steps,
    guidance, sampler and quantization. `decoder`: a TinyDecoder replacing
    the VAE decode; `mesh`: fan batches out over a data-parallel group."""
    schedule = DiffusionSchedule.create(config.num_train_timesteps,
                                        "scaled_linear", 0.00085, 0.012)
    return StableDiffusionSampler(
        stack.unet, stack.vae, stack.text, stack.tokenizer, schedule,
        image_size=config.image_size, num_steps=config.num_inference_steps,
        guidance_scale=config.guidance_scale, sampler=config.sampler,
        quantize=config.quantize, quant_fp_head=config.quant_fp_head,
        quant_fp_tail=config.quant_fp_tail, decoder=decoder, mesh=mesh)


def _device(stack: SDStack) -> torch.device:
    return next(stack.unet.parameters()).device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _text_lora_config(config: DiffusionConfig) -> LoRAConfig:
    return LoRAConfig(config.lora_rank, config.lora_alpha, 0.0,
                      LORA_MODULE_PRESETS["text_encoder"])


def load_class_bundle(stack: SDStack, folder: Path,
                      cls: str) -> dict | None:
    """Class `cls`'s saved bundle (`{folder}/lora_{cls}`) on the stack's
    device, less the DreamBooth id it had at training time; None where
    there is no bundle."""
    path = Path(folder) / f"lora_{cls}"
    if not path.exists():
        return None
    device = _device(stack)
    bundle = tree_map(lambda t: t.to(device), load_lora(path))
    bundle.pop("special_ids", None)
    return bundle


def attach_bundle(stack: SDStack, config: DiffusionConfig, cls: str,
                  bundle: dict) -> SDStack:
    """`stack` with class `cls`'s `bundle` attached (merged_stack). Where
    the bundle holds a DreamBooth row, the class's token is registered in
    `stack.tokenizer` and the row goes to the id it has there."""
    device = _device(stack)
    lcfg = LoRAConfig(config.lora_rank, config.lora_alpha,
                      config.lora_dropout, config.modules_lora)
    table, special_ids = None, None
    if "special_rows" in bundle:
        token = SPECIAL_TOKENS[cls]
        stack.tokenizer.add_tokens([token])
        current = stack.tokenizer.convert_tokens_to_ids(token)
        table = resize_token_embeddings(
            stack.text.get_parameter(TOKEN_TABLE), current + 1,
            torch.Generator(device).manual_seed(0))
        special_ids = torch.tensor([current], device=device)
    mesh = sharding.sharded(stack.unet)
    if mesh is not None:  # this rank's shards, in the trainer's layout
        bundle = sharding.shard_tree(bundle, sharding.trainable_sharding(
            bundle, stack.unet, stack.text, mesh.model_size), mesh)
    frozen = make_components(stack, bundle, token_table=table)
    tcfg = _text_lora_config(config) if "text_lora" in bundle else None
    return merged_stack(stack, frozen, bundle, lcfg, tcfg, special_ids)


@torch.no_grad()
def fp32_unet_params(stack: SDStack, config: DiffusionConfig,
                     bundle: dict) -> dict[str, torch.Tensor]:
    """Every UNet parameter in fp32 with `bundle` merged, as the
    reference's `restore_class_params` returns them
    (polyp_tpu/cli/sd_common.py:94-117): the stack's fp32 weights
    (SDStack.fp32_params), the `unfrozen` weights over them, the adapter
    merged in fp32 and never rounded. `merged_stack` rounds the same
    merge to the module's dtype for sampling."""
    lcfg = LoRAConfig(config.lora_rank, config.lora_alpha,
                      config.lora_dropout, config.modules_lora)
    params = stack.fp32_params("unet", [n for n, _ in
                                        stack.unet.named_parameters()])
    params.update({k: v.float() for k, v in
                   bundle.get("unfrozen", {}).items()})
    params.update(merge_lora(params, bundle["unet_lora"], lcfg))
    return params


def restore_class_params(stack: SDStack, config: DiffusionConfig,
                         folder: Path, cls: str) -> SDStack | None:
    """`stack` with class `cls`'s saved bundle (`{folder}/lora_{cls}`)
    attached (attach_bundle), or None where there is no bundle."""
    bundle = load_class_bundle(stack, folder, cls)
    return None if bundle is None else attach_bundle(stack, config, cls,
                                                     bundle)


def resume_class(stack: SDStack, config: DiffusionConfig, folder: Path,
                 cls: str, quota: int, flags: SDFlags,
                 tracker=None, mesh: pmesh.DataMesh | None = None
                 ) -> dict | None:
    """The resume branch: where `{folder}/lora_{cls}` exists, reload it and
    top `samples/{cls}` up to `quota` (the missing tail, with the seeds
    and file names of the first run); returns {"images": added,
    "generate_s"}, or None where the class has no bundle (train it).
    Under `mesh` every rank reads rank 0's bundle and count."""
    pmesh.barrier(mesh)  # rank 0's files are whole before anyone reads
    merged = restore_class_params(stack, config, folder, cls)
    if merged is None:
        return None
    print_banner(f"Model for {cls} class already trained")
    out_dir = Path(folder) / "samples" / cls
    added, seconds = 0, 0.0
    if pmesh.broadcast_object(count_samples(out_dir), mesh) < quota:
        sampler = make_sampler(merged, config, mesh=mesh)
        start = time.perf_counter()
        added = top_up_samples(
            sampler.for_prompt(resume_prompt(cls, flags.unconditional)),
            quota, out_dir, config.eval_batch_size, config.seed,
            progress=lambda a, b: print(f"Generated {a}/{b}"), mesh=mesh)
        _sync(_device(stack))
        seconds = time.perf_counter() - start
        print(f"Generated {added} images for class {cls} successfully!")
    return {"images": added, "generate_s": seconds}


def train_class(stack: SDStack, config: DiffusionConfig, layout: DataLayout,
                folder: Path, cls: str, class_map: dict, quota: int,
                flags: SDFlags, tracker=None, cache_dir: str | None = None,
                generate: int | None = None, ckpt_every: int = 0,
                mesh: pmesh.DataMesh | None = None) -> dict:
    """The train branch: dataset → LoRA bundle → train_sd_lora → the
    bundle saved → `generate` (default `quota`) samples. `ckpt_every` > 0
    snapshots the train state every N epochs under `{folder}/ckpt_{cls}`
    (train/resume.py), so a killed class resumes from its last snapshot.
    Under `mesh` the steps and the quota are the group's and rank 0
    writes. Returns {"images", "steps", "train_s", "generate_s"} (host
    seconds around synchronised work)."""
    from polyp_tpu_torch.data.cache import ArrayDataset
    from polyp_tpu_torch.data.pipeline import Loader
    from polyp_tpu_torch.data.tables import DiffusionTable

    print_banner(f"Training {cls}")
    device = _device(stack)
    folder = Path(folder)
    table = DiffusionTable.from_dirs(
        [layout.train_images, layout.val_images],
        [layout.train_csv, layout.val_csv], keep_one_class=class_map[cls])
    data = ArrayDataset.from_table(table, config.image_size, cache_dir)
    print(cls, class_map[cls], len(data))
    loader = Loader(data.images, data.labels, config.train_batch_size,
                    seed=config.seed, device=device, mesh=mesh,
                    process_shard=mesh is not None)
    cfg = config.with_schedule(max(len(loader), 1))
    writer = pmesh.is_writer(mesh)

    def generator(stream: int) -> torch.Generator:
        return stream_generator(cfg.seed, "lora_init", stream, device=device)

    lcfg = LoRAConfig(cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout,
                      cfg.modules_lora)
    adapter = init_lora(stack.unet, lcfg, generator(0))
    n_lora = sum(t.numel() for f in adapter.values() for t in f.values())
    total = sum(p.numel() for p in stack.unet.parameters()) + n_lora
    print(f"Trainable params of unet: {n_lora} / {total} "
          f"({100 * n_lora / total:.2f}%)")
    text_lora_cfg, text_lora = None, None
    if flags.train_text_encoder:
        text_lora_cfg = _text_lora_config(cfg)
        text_lora = init_lora(stack.text, text_lora_cfg, generator(1))
    proj = (init_proj_params(generator(2), 4, stack.text.config.width)
            if flags.add_visual_influence else None)
    unfrozen = None
    if flags.unfreeze_layers:
        # whole: the trainer cuts its own shards of rank 0's bundle
        unfrozen = stack.fp32_params("unet", [
            n for n, _ in stack.unet.named_parameters()
            if any(m in n for m in UNFROZEN_MODULES)], whole=True)
    table_grown, special_rows, special_ids = None, None, None
    if flags.dreambooth:
        token = SPECIAL_TOKENS[cls]
        stack.tokenizer.add_tokens([token])
        table_grown = resize_token_embeddings(
            stack.text.get_parameter(TOKEN_TABLE), len(stack.tokenizer),
            generator(3))
        special_rows = dreambooth_token_init(
            table_grown, stack.tokenizer, cls, cfg.weight_token_class,
            cfg.weight_token_polyp, flags.class_condition)[None]
        special_ids = torch.tensor(
            [stack.tokenizer.convert_tokens_to_ids(token)], device=device)

    prompt = dreambooth_prompt(cls, flags.unconditional,
                               flags.class_condition, flags.dreambooth)
    print(f"Prompt: {prompt!r}")
    if tracker and writer:
        tracker.log_param(f"prompt_{cls}", prompt)
        tracker.log_params({
            "criterion": "MSELoss", "optimizer": "AdamW",
            "batch_size": cfg.train_batch_size,
            "learning_rate": cfg.learning_rate,
            "num_epochs": cfg.num_epochs, "image_size": cfg.image_size,
            f"train_timesteps_{cls}": cfg.total_train_steps,
            f"lr_warmup_steps_{cls}": cfg.lr_warmup_steps,
            "noise_scheduler": "UniPCMultistepScheduler",
            "lora_rank": cfg.lora_rank,
            "lora_alpha": cfg.effective_lora_alpha,
            "target_modules_lora": list(cfg.modules_lora),
        })

    trainable = pmesh.replicate_to(init_trainable(
        adapter, text_lora, proj, special_rows, unfrozen), mesh)
    frozen = make_components(stack, trainable, token_table=table_grown)
    state = create_sd_train_state(
        cfg, trainable, trainable_layout(trainable, frozen, mesh), mesh)
    if not pmesh.replicated(state.whole_trainable(), mesh):
        raise RuntimeError("the ranks' trainables differ after the broadcast")
    # the trainer holds its own copies (its shards under a model axis)
    del trainable, adapter, text_lora, unfrozen
    schedule = DiffusionSchedule.create(cfg.num_train_timesteps,
                                        "scaled_linear", 0.00085, 0.012)
    checkpointer = None
    if ckpt_every > 0:
        from polyp_tpu_torch.train.resume import EpochCheckpointer
        checkpointer = EpochCheckpointer(folder / f"ckpt_{cls}",
                                         every=ckpt_every, mesh=mesh)
    start = time.perf_counter()
    state, result = train_sd_lora(
        cfg, state, frozen.on_mesh(mesh), schedule, loader,
        np.asarray(stack.tokenizer([prompt])), lcfg, text_lora_cfg,
        special_ids,
        log=((lambda k, v, s: tracker.log_metric(f"{k}_{cls}", v, s))
             if tracker else None),
        checkpointer=checkpointer)
    _sync(device)
    train_s = time.perf_counter() - start

    # the whole trainable bundle (gathered under a model axis), with the
    # DreamBooth token's id
    save_path = folder / f"lora_{cls}"
    bundle = dict(state.whole_trainable())
    if special_ids is not None:
        bundle["special_ids"] = special_ids
    if writer:
        save_lora(save_path, bundle)
    del bundle
    pmesh.barrier(mesh)
    # the trainer's own trainables: over a sharded stack, its shards
    merged = merged_stack(stack, frozen, state.trainable, lcfg,
                          text_lora_cfg, special_ids)
    n_generate = quota if generate is None else generate
    generate_s = 0.0
    if n_generate > 0:
        sampler = make_sampler(merged, cfg, mesh=mesh)
        start = time.perf_counter()
        generate_to_dir(sampler.for_prompt(prompt), n_generate,
                        folder / "samples" / cls, cfg.eval_batch_size,
                        cfg.seed, progress=lambda a, b: print(
                            f"Generated {a}/{b} images"), mesh=mesh)
        _sync(device)
        generate_s = time.perf_counter() - start
    if tracker and writer:
        from polyp_tpu_torch.utils.plotting import plot_loss

        tracker.log_artifact(str(save_path), f"models/lora_{cls}")
        tracker.log_artifact(plot_loss(
            result.loss_hist, filename=str(folder / f"loss_history_{cls}.png"),
            title="Training Loss over Epochs"))
        log_sample_images(tracker, folder / "samples" / cls, cls)
        if n_generate >= 2 and len(data) >= 2:
            # the class's fidelity: its real images against its samples
            from polyp_tpu_torch.eval import fid as fid_mod
            extractor = fid_mod.efficientnet_extractor(
                cfg.image_size, device=str(device))
            fake = fid_mod.load_image_dir(folder / "samples" / cls,
                                          cfg.image_size)
            value = fid_mod.frechet_from_arrays(data.images, fake, extractor)
            tracker.log_param("frechet_extractor", extractor.name)
            tracker.log_metric(f"frechet_{cls}", round(value, 4))
    pmesh.barrier(mesh)
    print(f"Training for class {cls} finished and images generated\n")
    return {"images": n_generate, "steps": state.step, "train_s": train_s,
            "generate_s": generate_s}
