from polyp_tpu_torch.models.unet_condition import (  # noqa: F401
    UNet2DCondition,
    sd14_unet,
    tiny_condition_unet,
)
from polyp_tpu_torch.models.vae import (  # noqa: F401
    SD_VAE_SCALING,
    AutoencoderKL,
    tiny_vae,
)
from polyp_tpu_torch.models.clip_text import (  # noqa: F401
    SD14_TEXT_CONFIG,
    TINY_TEXT_CONFIG,
    VIT_B32_TEXT_CONFIG,
    CLIPTextConfig,
    CLIPTextModel,
)
from polyp_tpu_torch.models.clip_tokenizer import (  # noqa: F401
    CLIPBPETokenizer,
    HashTokenizer,
    load_tokenizer,
)
