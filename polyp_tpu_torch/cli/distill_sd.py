"""Distilled SD students: the twin of the sampler half of
polyp_tpu/cli/distill_sd.py.

`make_student_sampler` serves a progressively distilled student: DDIM on
the trailing grid the student was distilled onto, at its step count, with
guidance folded (cond-only UNet forwards at 1× batch), and optionally the
tiny decoder in place of the VAE decode. The quant mode is explicit: the
port never reads polyp_tpu/ops/quant_gate.json, whose promoted verdict
(w8a8_static, no bf16 head, for distilled students) was measured on a TPU.
`load_student_sampler`, which reads a student's checkpoint, comes with the
CLIs that write them (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

from torch import nn

from polyp_tpu_torch.diffusion.schedule import DiffusionSchedule
from polyp_tpu_torch.pipeline import StableDiffusionSampler

TRAILING = {"spacing": "trailing", "steps_offset": 0}


def make_student_sampler(stack, unet: nn.Module, *, num_steps: int,
                         prediction_type: str = "epsilon",
                         image_size: int = 256,
                         num_train_timesteps: int = 1000,
                         quantize: str | None = None,
                         quant_fp_head: int = 0, quant_fp_tail: int = 0,
                         decoder: nn.Module | None = None,
                         fused_mha: bool = False) -> StableDiffusionSampler:
    """A StableDiffusionSampler over the student `unet` and the VAE, text
    encoder and tokenizer of `stack` (cli/common.py::SDStack): trailing
    DDIM at `num_steps`, `guidance_scale=None`, the SD-v1 schedule with the
    student's `prediction_type` (reference :284-303). `decoder`: a
    TinyDecoder replacing the VAE decode."""
    schedule = DiffusionSchedule.create(
        num_train_timesteps, "scaled_linear", 0.00085, 0.012,
        prediction_type=prediction_type)
    return StableDiffusionSampler(
        unet, stack.vae, stack.text, stack.tokenizer, schedule,
        image_size=image_size, num_steps=num_steps, guidance_scale=None,
        sampler="ddim", quantize=quantize, quant_fp_head=quant_fp_head,
        quant_fp_tail=quant_fp_tail, sampler_kwargs=dict(TRAILING),
        decoder=decoder, fused_mha=fused_mha)
