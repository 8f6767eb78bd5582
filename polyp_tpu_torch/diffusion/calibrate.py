"""Activation-scale calibration for W8A8-static sampling: the twin of
polyp_tpu/diffusion/calibrate.py.

It drives the UNet along a short full-precision DDIM trajectory under
quant's "w8a8_calib" mode, in which every quantizable layer records its
input amax; the per-layer max over each trajectory point (± margin) becomes
the scale of each timestep (tables, interpolated between the points).
The result is keyed by the port's module names, so the disk cache lives
under a directory of its own (`default_scales_cache`) and never reads the
reference's, whose keys differ (importers.scales_from_jax maps them).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from polyp_tpu_torch.diffusion.schedule import DiffusionSchedule
from polyp_tpu_torch.ops import quant

# bump when the scales payload shape changes (v2: per-timestep tables)
CACHE_FORMAT = 2
# head-room over the observed amax; values beyond saturate to ±127
MARGIN = 1.05


def cached_scales(cache_path: str | Path, compute: Callable[[], dict],
                  fingerprint: str) -> dict:
    """Disk cache for calibration, keyed by a caller-supplied fingerprint
    (weights/config digest): reuse a matching file, else compute and
    write."""
    cache_path = Path(cache_path)
    if cache_path.exists():
        try:
            payload = json.loads(cache_path.read_text())
            if (payload.get("fingerprint") == fingerprint
                    and payload.get("format") == CACHE_FORMAT):
                return payload["scales"]
        except (OSError, ValueError):
            pass  # unreadable cache → recompute
    scales = compute()
    cache_path.parent.mkdir(parents=True, exist_ok=True)
    cache_path.write_text(json.dumps(
        {"fingerprint": fingerprint, "format": CACHE_FORMAT,
         "scales": scales}))
    return scales


def params_fingerprint(module: torch.nn.Module, *extra: object) -> str:
    """Cheap content fingerprint of a module's parameters: names, shapes and
    one fp32 sum per parameter, fetched in one device transfer. Not a
    cryptographic hash."""
    h = hashlib.sha256()
    params = list(module.named_parameters())
    for name, p in params:
        h.update(name.encode())
        h.update(str(tuple(p.shape)).encode())
    with torch.no_grad():
        sums = torch.stack([p.float().sum() for _, p in params]).cpu()
    h.update(np.ascontiguousarray(sums.numpy(), np.float32).tobytes())
    for e in extra:
        h.update(str(e).encode())
    return h.hexdigest()[:24]


def default_scales_cache(fingerprint: str) -> Path:
    """Per-checkpoint cache file for calibrated scales (root overridable
    with POLYP_TORCH_QUANT_CACHE)."""
    root = Path(os.environ.get(
        "POLYP_TORCH_QUANT_CACHE",
        str(Path.home() / ".cache" / "polyp_tpu_torch")))
    return root / f"quant_scales_{fingerprint}.json"


def ensure_scales(unet: torch.nn.Module, schedule: DiffusionSchedule,
                  latent_shape: tuple[int, ...],
                  cond: torch.Tensor | None = None,
                  uncond: torch.Tensor | None = None, *,
                  num_steps: int = 8, guidance_scale: float | None = 7.5,
                  fingerprint_extras: tuple = ()) -> dict:
    """Fingerprint the UNet's weights → reuse the disk cache → calibrate on
    a miss."""
    fp = params_fingerprint(unet, *fingerprint_extras)
    return cached_scales(
        default_scales_cache(fp),
        lambda: calibrate_unet_scales(unet, schedule, latent_shape, cond,
                                      uncond, num_steps=num_steps,
                                      guidance_scale=guidance_scale), fp)


def _calib_forward(unet, x, t, ctx) -> tuple[torch.Tensor, dict[str, float]]:
    with quant.override("w8a8_calib") as state:
        out = unet(x, t) if ctx is None else unet(x, t, ctx)
    names = list(state.stats)
    values = (torch.stack([state.stats[k] for k in names]).tolist()
              if names else [])  # one transfer per forward
    return out, dict(zip(names, values))


@torch.no_grad()
def calibrate_unet_scales(
    unet: torch.nn.Module,
    schedule: DiffusionSchedule,
    latent_shape: tuple[int, ...],
    cond: torch.Tensor | None = None,
    uncond: torch.Tensor | None = None,
    num_steps: int = 8,
    guidance_scale: float | None = 7.5,
    init: torch.Tensor | None = None,
) -> dict:
    """Per-layer, per-timestep activation scales for
    quant.override("w8a8_static").

    Drives `unet` along a `num_steps`-point DDIM trajectory from `init`
    (NCHW latents of `latent_shape`; drawn from a generator seeded 0 when
    None), recording each quantizable layer's input amax at every point,
    on the conditional and the unconditional branch as separate forwards,
    as the reference does. `cond=None` drives an unconditional pixel model
    (models/unet2d.py), called without a context, with the trajectory in
    the module's dtype. Returns {module name: [num_train_timesteps
    floats]}, linearly interpolated between the points."""
    device = next(unet.parameters()).device
    dtype = cond.dtype if cond is not None else unet.dtype
    n = latent_shape[0]
    if guidance_scale is None:
        uncond = None  # guidance folded into the model: no uncond branch

    def bcast(emb):
        return (None if emb is None
                else emb.expand(n, *emb.shape[-2:]).to(device))

    T = schedule.num_train_timesteps
    ts = np.unique(np.linspace(T - 1, 0, num_steps).round().astype(np.int64)
                   )[::-1]
    abar = schedule.alphas_cumprod.double().cpu().numpy()
    if init is None:
        init = torch.randn(latent_shape, device=device,
                           generator=torch.Generator(device).manual_seed(0))
    x = init.to(device, dtype)

    points: list[tuple[int, list[dict[str, float]]]] = []
    for i, t in enumerate(ts):
        tt = torch.full((n,), int(t), device=device)
        eps, stats = _calib_forward(unet, x, tt, bcast(cond))
        point = [stats]
        if uncond is not None:
            eps_u, stats = _calib_forward(unet, x, tt, bcast(uncond))
            point.append(stats)
            eps = eps_u + guidance_scale * (eps - eps_u)
        points.append((int(t), point))
        if i + 1 < len(ts):
            # deterministic DDIM move to the next calibration timestep
            a_t, a_n = float(abar[int(t)]), float(abar[int(ts[i + 1])])
            out32, x32 = eps.float(), x.float()
            if schedule.prediction_type == "v_prediction":
                out32 = math.sqrt(a_t) * out32 + math.sqrt(1.0 - a_t) * x32
            x0 = (x32 - math.sqrt(1.0 - a_t) * out32) / math.sqrt(a_t)
            x = (math.sqrt(a_n) * x0 + math.sqrt(1.0 - a_n) * out32).to(dtype)
    return quant.scale_tables_from_stats(points, T, MARGIN)
