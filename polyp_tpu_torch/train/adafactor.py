"""Adafactor behind the global-norm clip: optax.chain(
clip_by_global_norm(1.0), adafactor(learning_rate)) at optax's defaults, on
nested dicts of fp32 tensors, updated in place (the idiom of
train/sd_finetune.py::SDOptimizer, whose `init` / `update` it shares, so a
distill state takes either).

The arithmetic is optax's (optax/_src/factorized.py, alias.py), in its
order:
* clip: g · 1 / ‖g‖ when ‖g‖ ≥ 1 (no ε);
* the second moment, decay β_t = 1 − (count + 1)^−0.8 (fp32 powf):
  a leaf whose second-largest dimension is at least
  `min_dim_size_to_factor` (128) keeps a row and a column mean of g² + ε
  (ε = 1e-30) over its two largest dimensions (d1, d0 by numpy's
  argsort of the shape, as optax), and its update is
  g · (v_row / mean(v_row))^−½ · v_col^−½; any other leaf keeps v in full
  and its update is g · v^−½;
* each leaf's update divided by max(1, rms(u) / 1) (clip_by_block_rms);
* times the learning rate, times max(rms(p), 1e-3) of the parameter
  (multiply_by_parameter_scale), negated and added to the parameter.
No momentum and no weight decay, as optax's defaults.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from polyp_tpu_torch.utils.checkpoint import tree_leaves


def factored_dims(shape: tuple[int, ...],
                  min_dim_size_to_factor: int = 128
                  ) -> tuple[int, int] | None:
    """(d1, d0): the two largest dimensions of `shape` (d0 the largest),
    or None when the second largest is below `min_dim_size_to_factor`
    (optax's _factored_dims, numpy's argsort)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """optax.chain(clip_by_global_norm(1.0), adafactor(learning_rate)) with
    adafactor's defaults (module docstring). `learning_rate` is a rate or
    a schedule of the update count (read before the count advances)."""

    MAX_NORM = 1.0
    DECAY_RATE = 0.8
    EPS = 1e-30
    CLIPPING_THRESHOLD = 1.0
    MIN_SCALE = 1e-3

    def __init__(self, learning_rate: float | Callable[[int], float],
                 min_dim_size_to_factor: int = 128):
        self.learning_rate = learning_rate
        self.min_dim_size_to_factor = min_dim_size_to_factor

    def _dims(self, t: torch.Tensor) -> tuple[int, int] | None:
        return factored_dims(tuple(t.shape), self.min_dim_size_to_factor)

    def init(self, params: dict) -> dict:
        """The update count and, for each parameter in `tree_leaves`
        order, its second-moment statistics: {"v_row", "v_col"} of a
        factored leaf, else {"v"}."""
        def moments(p: torch.Tensor) -> dict:
            dims = self._dims(p)
            if dims is None:
                return {"v": torch.zeros_like(p)}
            d1, d0 = dims
            return {"v_row": p.new_zeros(np.delete(p.shape, d0).tolist()),
                    "v_col": p.new_zeros(np.delete(p.shape, d1).tolist())}

        return {"count": 0,
                "moments": [moments(p) for p in tree_leaves(params)]}

    @staticmethod
    def _rms(t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.mean(torch.square(t)))

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> bool:
        """Apply one step of `grads` to `params` and `state` in place;
        returns True (the parameters moved)."""
        g = tree_leaves(grads)
        p = tree_leaves(params)
        moments = state["moments"]
        f32 = dict(dtype=torch.float32, device=p[0].device)
        norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        keep = norm < self.MAX_NORM
        count = state["count"]
        t = torch.tensor(float(count + 1), **f32)
        decay = 1.0 - t ** -self.DECAY_RATE
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        for grad, param, m in zip(g, p, moments):
            grad = torch.where(keep, grad, grad / norm * self.MAX_NORM)
            grad_sqr = torch.square(grad) + self.EPS
            dims = self._dims(param)
            if dims is None:
                m["v"].copy_(decay * m["v"] + (1.0 - decay) * grad_sqr)
                u = grad * m["v"] ** -0.5
            else:
                d1, d0 = dims
                m["v_row"].copy_(decay * m["v_row"] + (1.0 - decay)
                                 * torch.mean(grad_sqr, dim=d0))
                m["v_col"].copy_(decay * m["v_col"] + (1.0 - decay)
                                 * torch.mean(grad_sqr, dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = torch.mean(m["v_row"], dim=reduced_d1,
                                          keepdim=True)
                row_factor = (m["v_row"] / row_col_mean) ** -0.5
                col_factor = m["v_col"] ** -0.5
                u = (grad * row_factor.unsqueeze(d0)
                     * col_factor.unsqueeze(d1))
            u = u / torch.clamp(self._rms(u) / self.CLIPPING_THRESHOLD,
                                min=1.0)
            u = u * lr
            rms_p = self._rms(param)
            u = u * torch.where(rms_p <= self.MIN_SCALE,
                                torch.tensor(self.MIN_SCALE, **f32), rms_p)
            param.add_(-u)
        state["count"] = count + 1
        return True

