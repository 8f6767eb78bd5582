from polyp_tpu_torch.configs.base import (  # noqa: F401
    LORA_MODULE_PRESETS,
    ClassificationConfig,
    DiffusionConfig,
)
