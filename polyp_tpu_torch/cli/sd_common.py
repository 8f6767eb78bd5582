"""The SD sampler of a config: the twin of
polyp_tpu/cli/sd_common.py::make_sampler (:77-91). The rest of that module
(LoRA training and restore) comes with the LoRA slice (ROADMAP.md Queue 1
item 9)."""

from __future__ import annotations

from polyp_tpu_torch.cli.common import SDStack
from polyp_tpu_torch.configs import DiffusionConfig
from polyp_tpu_torch.diffusion import DiffusionSchedule
from polyp_tpu_torch.pipeline import StableDiffusionSampler


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
