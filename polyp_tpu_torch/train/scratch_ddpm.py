"""The learning-rate schedule of the reference's trainers
(polyp_tpu/train/scratch_ddpm.py::cosine_warmup_schedule, :42-49). The
rest of that module (the scratch DDPM trainer) is a later slice's
(ROADMAP.md Queue 1)."""

from __future__ import annotations

import math
from typing import Callable


def cosine_warmup_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, learning_rate,
    max(warmup_steps, 1), max(total_steps, 2), 0): linear from 0 over the
    warmup (so update 0 has learning rate 0), then cosine decay to 0 over
    the rest; `total_steps` counts the warmup. Maps an update count to its
    learning rate."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, 2) - warmup
    if decay <= 0:
        raise ValueError(f"total_steps {total_steps} leaves no decay after "
                         f"{warmup} warmup steps")

    def schedule(count: int) -> float:
        if count < warmup:
            return learning_rate * (1.0 - (1.0 - min(max(count, 0), warmup)
                                           / warmup))
        t = min(count - warmup, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule
