"""Sampling configuration: a copy of the sampling fields of
polyp_tpu/configs/base.py::DiffusionConfig (:44-84), with the same names and
defaults. It is a copy, not an import: `polyp_tpu.configs` runs the JAX
package's `__init__`.

The training fields come with the training slices. `quantize` takes the
explicit modes only: "promoted" expands, in the reference, to the verdict
of a quant gate measured on a TPU (polyp_tpu/ops/quant_gate.json), which
the port does not read (ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass

QUANTIZE_MODES = (None, "w8a8", "w8a8_static")


@dataclass(frozen=True)
class DiffusionConfig:
    image_size: int = 224
    eval_batch_size: int = 20
    seed: int = 0

    # diffusion process
    num_train_timesteps: int = 1000
    beta_schedule: str = "linear"  # diffusers DDPMScheduler's default
    prediction_type: str = "epsilon"

    # sampling
    num_inference_steps: int = 25
    guidance_scale: float = 7.5
    sampler: str = "unipc"  # "ddpm" | "ddim" | "dpmpp_2m" | "unipc"
    quantize: str | None = None  # None | "w8a8" | "w8a8_static"
    # the first / final N inference steps in full precision, the rest
    # quantized (pipeline._precision_split); 0/0 = the pure mode
    quant_fp_head: int = 0
    quant_fp_tail: int = 0

    def __post_init__(self):
        if self.quantize == "promoted":
            raise NotImplementedError(
                "quantize='promoted' names the TPU's quant gate verdict, "
                "which polyp_tpu_torch does not read; pass w8a8 or "
                "w8a8_static (ROADMAP.md Queue 1 item 2: the port's own "
                "gate)")
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantization mode: {self.quantize!r}")
