from polyp_tpu_torch.lora.surgery import (  # noqa: F401
    LoRAConfig,
    apply_lora_to_kernels,
    count_lora_params,
    init_lora,
    load_lora,
    lorarized_layers,
    merge_lora,
    merged_module,
    save_lora,
    target_layers,
)
from polyp_tpu_torch.lora.partition import (  # noqa: F401
    extract_by_mask,
    overlay_params,
    path_mask,
    trainable_count,
)
