"""The SD fine-tuning workflow's shared pieces: the twin of
polyp_tpu/cli/sd_common.py's `make_components` (:62-74), `make_sampler`
(:77-91) and the merge half of `restore_class_params` (:307-345).

A trained bundle is sampled with through `merged_stack`: new UNet and CLIP
modules that share every tensor with the stack except the merged kernels
(and the DreamBooth token table), so the stack's own modules keep their
weights bit for bit. The CLI flow around these (`train_class`,
`resume_class`, the per-class and all-classes CLIs) comes with the data
layer (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from polyp_tpu_torch.cli.common import SDStack
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.lora.surgery import LoRAConfig, merge_lora, merged_module
from polyp_tpu_torch.pipeline import StableDiffusionSampler
from polyp_tpu_torch.train.dreambooth import embed_with_special_rows
from polyp_tpu_torch.train.sd_finetune import (
    TOKEN_TABLE, SDComponents, module_dtype)


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
    merged. No dropout."""
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
                 decoder=None) -> StableDiffusionSampler:
    """A StableDiffusionSampler over `stack` on the SD-v1 schedule
    (scaled_linear, 0.00085 to 0.012) with `config`'s image size, steps,
    guidance, sampler and quantization. `decoder`: a TinyDecoder replacing
    the VAE decode."""
    schedule = DiffusionSchedule.create(config.num_train_timesteps,
                                        "scaled_linear", 0.00085, 0.012)
    return StableDiffusionSampler(
        stack.unet, stack.vae, stack.text, stack.tokenizer, schedule,
        image_size=config.image_size, num_steps=config.num_inference_steps,
        guidance_scale=config.guidance_scale, sampler=config.sampler,
        quantize=config.quantize, quant_fp_head=config.quant_fp_head,
        quant_fp_tail=config.quant_fp_tail, decoder=decoder)
