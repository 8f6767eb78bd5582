"""Diffusion configuration: a copy of the sampling and training fields of
polyp_tpu/configs/base.py::DiffusionConfig (:44-151) and of
LORA_MODULE_PRESETS (:24-35), with the same names and defaults. It is a
copy, not an import: `polyp_tpu.configs` runs the JAX package's
`__init__`.

The presets name modules as the reference does (`to_out`,
`ff_net_0_proj`, ...); lora/surgery.py matches them through
models/importers.py::jax_module_path, so a preset picks the same layers in
both packages. `quantize="promoted"` expands, as in the reference
(:86-104), to the full-trajectory verdict of the port's own quant gate
(ops/quant.py::resolve_quantize_arg, measured on the card), and sets
`quant_promoted`. `device_count` comes with multi-GPU.

`ClassificationConfig` is a copy of the reference's (:155-183): the
classifier's fields, its CLI defaults and the same timestamped
`output_dir`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from datetime import datetime

LORA_MODULE_PRESETS: dict[str, tuple[str, ...]] = {
    "attention": ("to_q", "to_k", "to_v", "to_out"),
    "attention_added_kv": ("to_q", "to_k", "to_v", "to_out", "add_k_proj",
                           "add_v_proj"),
    "attention_mlp": (
        "to_q", "to_k", "to_v", "to_out",
        "proj_in", "proj_out", "ff_net_0_proj", "ff_net_2",
    ),
    "attention_mlp_time": (
        "to_q", "to_k", "to_v", "to_out",
        "proj_in", "proj_out", "ff_net_0_proj", "ff_net_2", "time_emb_proj",
    ),
    "text_encoder": ("q_proj", "k_proj", "v_proj", "out_proj"),
}

QUANTIZE_MODES = (None, "w8a8", "w8a8_static")


def _timestamp() -> str:
    return datetime.now().strftime("%Y%m%d_%H%M%S")


@dataclass(frozen=True)
class DiffusionConfig:
    image_size: int = 224
    train_batch_size: int = 8
    accumulation_steps: int = 1
    eval_batch_size: int = 20
    num_epochs: int = 200
    learning_rate: float = 1e-4
    mixed_precision: str = "bf16"  # "bf16" | "fp32"
    seed: int = 0

    # diffusion process
    num_train_timesteps: int = 1000
    beta_schedule: str = "linear"  # diffusers DDPMScheduler's default
    prediction_type: str = "epsilon"

    # sampling
    num_inference_steps: int = 25
    guidance_scale: float = 7.5
    sampler: str = "unipc"  # "ddpm" | "ddim" | "dpmpp_2m" | "unipc"
    quantize: str | None = None  # None | "w8a8" | "w8a8_static" | "promoted"
    # the first / final N inference steps in full precision, the rest
    # quantized (pipeline._precision_split); 0/0 = the pure mode
    quant_fp_head: int = 0
    quant_fp_tail: int = 0
    # True when `quantize` was "promoted": few-step consumers
    # (cli/distill_sd.py::load_student_sampler) re-resolve it to the
    # distilled verdict rather than carry a full-trajectory head onto a
    # 4-8-step grid
    quant_promoted: bool = False

    # LoRA
    lora_rank: int = 8
    lora_alpha: float | None = None  # None → = lora_rank
    lora_dropout: float = 0.3
    lora_preset: str = "attention"

    # auxiliary loss weights (visual influence, DreamBooth token init)
    weight_img: float = 1.0
    weight_text: float = 0.1
    weight_token_class: float = 0.5
    weight_token_polyp: float = 0.5

    # derived schedule fields: set by `with_schedule`, never mutated
    total_train_steps: int = 0
    lr_warmup_steps: int = 0
    lr_warmup_frac: float = 0.03

    # where the scratch and fine-tuning CLIs write (the per-class CLIs
    # write to their --folder)
    output_dir: str = field(
        default_factory=lambda: f"runs/diffusion_{_timestamp()}")
    experiment_name: str = "baseline_with_lora"  # the tracker's default

    @property
    def modules_lora(self) -> tuple[str, ...]:
        return LORA_MODULE_PRESETS[self.lora_preset]

    @property
    def effective_lora_alpha(self) -> float:
        return self.lora_rank if self.lora_alpha is None else self.lora_alpha

    def with_schedule(self, steps_per_epoch: int) -> "DiffusionConfig":
        """The learning-rate schedule's lengths: `total_train_steps`
        counts optimizer updates (micro-steps / accumulation_steps, as
        MultiSteps advances the schedule once an update), warmup is
        `lr_warmup_frac` of them."""
        total = max(1, (steps_per_epoch * self.num_epochs)
                    // max(1, self.accumulation_steps))
        return replace(self, total_train_steps=total,
                       lr_warmup_steps=int(self.lr_warmup_frac * total))

    def __post_init__(self):
        if self.quantize == "promoted":
            from polyp_tpu_torch.ops.quant import resolve_quantize_arg
            mode, head, tail = resolve_quantize_arg(
                "promoted", self.quant_fp_head, self.quant_fp_tail)
            object.__setattr__(self, "quantize", mode)
            object.__setattr__(self, "quant_fp_head", head)
            object.__setattr__(self, "quant_fp_tail", tail)
            object.__setattr__(self, "quant_promoted", True)
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantization mode: {self.quantize!r}")


@dataclass(frozen=True)
class ClassificationConfig:
    """The classifier's configuration (the reference's
    `ConfigClassification` and the flags of its classifier CLI)."""

    image_size: int = 224
    batch_size: int = 16
    num_epochs: int = 100
    patience: int = 10  # early stopping
    learning_rate: float = 1e-3
    weight_decay: float = 1e-3
    hidden_features: int = 256
    dropout: float = 0.5
    # EfficientNet b0..b7 (models/efficientnet.py VARIANTS) or "tiny"
    variant: str = "b0"
    seed: int = 0

    weighted_sampling: bool = True
    weighted_loss: bool = False
    one_vs_rest: bool = False
    pretrained_backbone: bool = True

    mixed_precision: str = "bf16"  # "bf16": the stem conv in bf16 | "fp32"
    device_count: int = 1

    output_dir: str = field(
        default_factory=lambda: f"runs/classifier_{_timestamp()}")
    experiment_name: str = "baseline_classification_model"
