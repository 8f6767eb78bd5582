from polyp_tpu_torch.ops.attention import dot_product_attention  # noqa: F401
from polyp_tpu_torch.ops.groupnorm import group_norm  # noqa: F401
