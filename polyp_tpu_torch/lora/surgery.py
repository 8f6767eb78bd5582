"""LoRA as parameter surgery: the twin of polyp_tpu/lora/surgery.py.

The frozen base and the adapter are kept apart. An adapter is a dict
{module name: {"lora_A": [in, r], "lora_B": [r, out]}} keyed by the port's
module names (`down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q`),
with the factors in the reference's layout, so `lora_from_jax`
(models/importers.py) carries a reference adapter over unchanged.

* `target_layers` picks the Linear and 1×1-conv modules whose reference
  name (the last component of models/importers.py::jax_module_path, e.g.
  `to_out` for `to_out.0`, `ff_net_0_proj` for `ff.net.0.proj`) is a
  target, so a preset of configs.LORA_MODULE_PRESETS picks the same layers
  in both packages.
* `init_lora`: A = N(0, 1) / r, B = 0 (PEFT's gaussian init, as the
  reference), so a new adapter is an exact no-op.
* `merge_lora` returns dtype(W + s·((A ⊙ m) / keep) @ B) for each adapted
  kernel, W the fp32 base weight: with bf16 modules a young adapter's δ
  is far below half an ulp of bf16(W) (about 1e-4 at |W| ≈ 0.05), so the
  sum is taken in fp32 and rounded once, as the reference adds in its
  fp32 parameters and casts in use. A dense layer's δ is [in, out] and
  enters as δᵀ; a 1×1 conv's as [out, in, 1, 1]. Differentiable with
  respect to A and B: the train step merges inside autograd and runs the
  module through `torch.func.functional_call`.
* dropout: one keep mask [in, 1] a kernel a step (rows of A), drawn by the
  caller, as the reference's kernel-space dropout.
* `merged_module`: a copy of a module that shares every parameter tensor
  with it except the merged ones, for sampling with an adapter without
  writing into the frozen module. On a tensor-parallel rank the kernels,
  the adapter's factors and so the merged weights are this rank's slices
  (parallel/sharding.py::lora_param_sharding), and the merge is the same
  arithmetic on them.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from polyp_tpu_torch.models.importers import jax_module_path
from polyp_tpu_torch.utils.checkpoint import load_pytree, save_pytree


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float | None = None  # None → = rank
    dropout: float = 0.0
    target_modules: Sequence[str] = ("to_q", "to_k", "to_v", "to_out")

    @property
    def scale(self) -> float:
        return (self.alpha if self.alpha is not None else self.rank) / self.rank


def _in_out(module: nn.Module) -> tuple[int, int]:
    if isinstance(module, nn.Linear):
        return module.in_features, module.out_features
    if module.kernel_size == (1, 1):
        return module.in_channels, module.out_channels
    raise ValueError(f"LoRA target kernel has unsupported shape "
                     f"{tuple(module.weight.shape)}")


def target_layers(module: nn.Module, targets: Sequence[str]
                  ) -> dict[str, nn.Module]:
    """{name: submodule} of the Linear / Conv2d layers whose reference
    module name is in `targets`, in module order."""
    out = {}
    for name, sub in module.named_modules():
        if (isinstance(sub, (nn.Linear, nn.Conv2d))
                and jax_module_path(name).rsplit("/", 1)[-1] in targets):
            _in_out(sub)
            out[name] = sub
    return out


def init_lora(module: nn.Module, config: LoRAConfig,
              generator: torch.Generator) -> dict:
    """A new adapter for `module`'s targeted layers, fp32 on the
    generator's device: lora_A ~ N(0, 1) / r, lora_B = 0."""
    adapter = {}
    for name, sub in target_layers(module, config.target_modules).items():
        fan_in, fan_out = _in_out(sub)
        a = torch.randn(fan_in, config.rank, generator=generator,
                        device=generator.device) / config.rank
        adapter[name] = {"lora_A": a,
                         "lora_B": torch.zeros(config.rank, fan_out,
                                               device=generator.device)}
    return adapter


def apply_lora_to_kernels(kernels: dict[str, torch.Tensor], adapter: dict,
                          scale: float,
                          keep_masks: dict[str, torch.Tensor] | None = None,
                          keep: float = 1.0,
                          dtype: torch.dtype | None = None
                          ) -> dict[str, torch.Tensor]:
    """{"{name}.weight": dtype(W + scale·((A ⊙ m) / keep) @ B)} for each
    adapted module `name`, W = kernels["{name}.weight"] (fp32 base
    weights; `dtype` defaults to W's)."""
    out = {}
    for name, factors in adapter.items():
        key = f"{name}.weight"
        w = kernels[key]
        a = factors["lora_A"]
        if keep_masks is not None:
            a = a * keep_masks[name] / keep
        delta = ((a @ factors["lora_B"]) * scale).T  # [out, in]
        if w.ndim == 4:  # 1×1 conv
            delta = delta[:, :, None, None]
        out[key] = (w.float() + delta).to(dtype or w.dtype)
    return out


def merge_lora(kernels: dict[str, torch.Tensor], adapter: dict,
               config: LoRAConfig,
               keep_masks: dict[str, torch.Tensor] | None = None,
               dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Merge with the config's α/r scale; `keep_masks` (training, when
    config.dropout > 0) drop rows of A and rescale by 1 / (1 − dropout)."""
    return apply_lora_to_kernels(kernels, adapter, config.scale, keep_masks,
                                 1.0 - config.dropout, dtype)


def merged_module(module: nn.Module,
                  weights: dict[str, torch.Tensor]) -> nn.Module:
    """A copy of `module` whose parameters and buffers are `module`'s own
    tensors (shared, not copied), except `weights` ({parameter name:
    tensor}), which take their place in the copy. `module` is left as it
    was. A module sharded over a mesh (parallel/sharding.py) gives a copy
    sharded over the same mesh: `weights` then hold this rank's slices."""
    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    for sub in module.modules():  # cached int8 codes: shared too
        memo.update((id(t), t) for t in getattr(sub, "_q8_weight", ())
                    if isinstance(t, torch.Tensor))
    mesh = getattr(module, "_tp_mesh", None)
    if mesh is not None:
        memo[id(mesh)] = mesh  # shared, as the tensors are
    out = copy.deepcopy(module, memo)
    for name, value in weights.items():
        owner, leaf = name.rsplit(".", 1)
        sub = out.get_submodule(owner)
        old = getattr(sub, leaf)
        setattr(sub, leaf, nn.Parameter(value.detach().to(old.dtype),
                                        requires_grad=False))
        if isinstance(sub, nn.Embedding):
            sub.num_embeddings = value.shape[0]
    return out


def lorarized_layers(adapter: dict) -> list[str]:
    """Sorted module names carrying lora_A / lora_B factors."""
    return sorted(name for name, f in adapter.items()
                  if {"lora_A", "lora_B"} <= set(f))


def count_lora_params(adapter: dict) -> int:
    return sum(t.numel() for f in adapter.values() for t in f.values())


def save_lora(path, adapter: dict) -> None:
    """Adapter-only (or whole trainable bundle) checkpoint."""
    save_pytree(path, adapter)


def load_lora(path, like: dict | None = None) -> dict:
    return load_pytree(path, like)
