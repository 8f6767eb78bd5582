from polyp_tpu_torch.diffusion.schedule import (  # noqa: F401
    DiffusionSchedule,
    inference_timesteps,
)
from polyp_tpu_torch.diffusion.losses import (  # noqa: F401
    epsilon_mse_loss,
    visual_influence_loss,
)
from polyp_tpu_torch.diffusion.samplers import (  # noqa: F401
    ddim_sample,
    ddpm_sample,
    dpmpp_2m_sample,
    sample,
    sampler_timesteps,
    unipc_sample,
    with_cfg,
)
