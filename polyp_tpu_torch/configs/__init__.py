from polyp_tpu_torch.configs.base import DiffusionConfig  # noqa: F401
