"""Megatron tensor parallelism on the mesh's `model` axis: the twin of
polyp_tpu/parallel/sharding.py.

The reference annotates parameters with PartitionSpecs and lets GSPMD
place the collectives. The port cuts the weights itself and its modules
call the collectives (models/unet_blocks.py, models/clip_text.py):

* attention to_q/to_k/to_v, the FF up-projection and CLIP's q/k/v_proj and
  fc1 are column-parallel: each rank keeps its 1/k of the output features
  (dim 0 of torch's [out, in] weight, and of the bias), so it runs heads/k
  heads or H/k hidden units;
* to_out, the FF down-projection and CLIP's out_proj and fc2 are
  row-parallel: each rank keeps its 1/k of the input features (dim 1);
  the partial products are summed over the model group (Megatron's g)
  before their bias, which stays whole;
* everything else (convs, norms, embeddings, biases after g) stays whole.

Two rules the reference leaves to GSPMD are written out here:

* the GEGLU's `ff.net.0.proj` is [a; gate] stacked (ops/fused_geglu.py):
  rank m takes a's rows m·H/k to (m+1)·H/k and gate's same rows, and
  restacks them [a_m; gate_m] (`Split.halves` = 2), never one contiguous
  block of the stack;
* a block is split only where k divides its head count (attention) or its
  hidden width (FF, CLIP MLP); any other stays whole on every rank, as a
  conv does, and `shard_params` names it once. GSPMD would reshard such a
  block; keeping it whole computes the same function.

LoRA adapters follow their kernel (`lora_param_sharding`): a column
target's B is split on its output features and its A is whole, a row
target's A is split on its input features and its B is whole. Those whole
factors see only this rank's slice of the product, so their gradients are
summed over the model group (`PARTIAL`).

`shard_params` / `gather_params` (modules), `shard_tensors` (named
tensors) and `shard_tree` / `gather_tree`
(adapters and whole trainable bundles, by a layout of the same shape:
`lora_param_sharding`, `trainable_sharding`) carry weights between the
whole form, which is what every file holds, and rank m's shards. A
module keeps its layers' `in_features` / `out_features` whole; the weight
holds the slice.

A rank holds only its shards: `shard_params` cuts a module in place and
nothing else keeps the whole tensors, so a stack sharded at load
(cli/common.py::load_sd_stack(mesh=)) holds the whole stack less (1 − 1/k)
of its split bytes. What needs the whole weights takes them one tensor at
a time (`whole_param_sums`, the calibration cache's key) or for one call
(`gathered_copy`, which calibration frees after it). `sharded_copy` is for
a caller that keeps a whole module by its own choice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import torch
from torch import nn

from polyp_tpu_torch.parallel import mesh as pmesh

COLUMN_PARALLEL = ("to_q", "to_k", "to_v", "ff_net_0_proj", "q_proj",
                   "k_proj", "v_proj", "fc1")
ROW_PARALLEL = ("to_out", "ff_net_2", "out_proj", "fc2")
# a whole trainable whose gradient each rank computes over its slice only
PARTIAL = "partial"


@dataclass(frozen=True)
class Split:
    """A tensor cut on `dim` into k slices; with `halves` = 2 the tensor
    is two stacked halves along `dim` (the GEGLU's [a; gate]), each cut
    alone and rank m's pieces restacked."""

    dim: int
    halves: int = 1


def take(t: torch.Tensor, split: Split | None, rank: int,
         k: int) -> torch.Tensor:
    """Rank `rank`'s slice of the whole `t` (a new contiguous tensor)."""
    if not isinstance(split, Split) or k == 1:
        return t
    parts = t.chunk(split.halves, dim=split.dim)
    return torch.cat([p.chunk(k, dim=split.dim)[rank] for p in parts],
                     dim=split.dim).contiguous()


def assemble(shards: list[torch.Tensor], split: Split | None
             ) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order."""
    if not isinstance(split, Split) or len(shards) == 1:
        return shards[0]
    halves = [s.chunk(split.halves, dim=split.dim) for s in shards]
    return torch.cat([torch.cat([h[i] for h in halves], dim=split.dim)
                      for i in range(split.halves)], dim=split.dim)


def _gather(local: torch.Tensor, split: Split | None,
            mesh: pmesh.DataMesh) -> torch.Tensor:
    """The whole tensor on every rank of the model group, bit for bit."""
    if not isinstance(split, Split) or mesh.model_size == 1:
        return local
    k, m = mesh.model_size, mesh.model_rank
    shape = list(local.shape)
    shape[split.dim] *= k
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    for whole_half, mine in zip(full.chunk(split.halves, dim=split.dim),
                                local.chunk(split.halves, dim=split.dim)):
        whole_half.chunk(k, dim=split.dim)[m].copy_(mine)
    return pmesh.model_gather_exact(full, mesh)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _reference_name(module_name: str) -> str:
    from polyp_tpu_torch.models.importers import jax_module_path
    return jax_module_path(module_name).rsplit("/", 1)[-1]


def tp_blocks(module: nn.Module, k: int) -> dict[str, bool]:
    """{name: split?} of the blocks tensor parallelism cuts: attentions
    (UNet and CLIP), the UNet's GEGLU FFs and CLIP's MLPs; a block is
    split when k divides its head count or its hidden width."""
    from polyp_tpu_torch.models.clip_text import CLIPAttention, CLIPMLP
    from polyp_tpu_torch.models.unet_blocks import Attention, FeedForward

    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, (Attention, CLIPAttention)):
            out[name] = sub.heads % k == 0
        elif isinstance(sub, FeedForward):
            out[name] = sub.net[2].in_features % k == 0
        elif isinstance(sub, CLIPMLP):
            out[name] = sub.fc1.out_features % k == 0
    return out


def _owner(blocks: dict[str, bool], module_name: str) -> str | None:
    """The block that holds layer `module_name`."""
    best = None
    for name in blocks:
        if module_name.startswith(f"{name}." if name else "") and (
                best is None or len(name) > len(best)):
            best = name
    return best


def _layer_rules(module: nn.Module, k: int) -> dict[str, str]:
    """{layer name: "column" | "row"} of the split blocks' layers."""
    blocks = tp_blocks(module, k)
    out = {}
    for name, sub in module.named_modules():
        if not isinstance(sub, nn.Linear):
            continue
        ref = _reference_name(name)
        kind = ("column" if ref in COLUMN_PARALLEL else
                "row" if ref in ROW_PARALLEL else None)
        owner = _owner(blocks, name)
        if kind is not None and owner is not None and blocks[owner]:
            out[name] = kind
    return out


def _halves(layer: str) -> int:
    return 2 if _reference_name(layer) == "ff_net_0_proj" else 1


def unet_param_sharding(module: nn.Module, k: int
                        ) -> dict[str, Split | None]:
    """{parameter name: Split or None (whole)} of every parameter of
    `module` (a UNet or a CLIP text model) under a model axis of k: a
    column-parallel layer's weight and bias on dim 0, a row-parallel
    layer's weight on dim 1 (the reference's PartitionSpecs in torch's
    [out, in] layout: P(None, 'model') on a kernel [in, out] is dim 0
    here)."""
    rules = _layer_rules(module, k) if k > 1 else {}
    out: dict[str, Split | None] = {}
    for name, _ in module.named_parameters():
        layer, leaf = name.rsplit(".", 1)
        kind = rules.get(layer)
        if kind == "column":
            out[name] = Split(0, _halves(layer))
        elif kind == "row" and leaf == "weight":
            out[name] = Split(1)
        else:
            out[name] = None
    return out


def lora_param_sharding(adapter: dict, module: nn.Module, k: int) -> dict:
    """{layer: {"lora_A": ..., "lora_B": ...}} for an adapter of `module`
    (factors A [in, r], B [r, out]): a column target's B Split on dim 1
    (its output features, per half for the GEGLU) and its A `PARTIAL`; a
    row target's A Split on dim 0 (its input features) and its B
    `PARTIAL`; None (whole) elsewhere. The r dimension is never cut."""
    rules = _layer_rules(module, k) if k > 1 else {}
    out = {}
    for layer, factors in adapter.items():
        kind = rules.get(layer)
        spec = {name: None for name in factors}
        if kind == "column":
            spec.update(lora_A=PARTIAL, lora_B=Split(1, _halves(layer)))
        elif kind == "row":
            spec.update(lora_A=Split(0), lora_B=PARTIAL)
        out[layer] = spec
    return out


def trainable_sharding(trainable: dict, unet: nn.Module,
                       text: nn.Module | None, k: int) -> dict:
    """The layout of a LoRA trainer's bundle (train/sd_finetune.py:
    `unet_lora`, `text_lora`, `unfrozen`, `proj`, `special_rows`), a tree
    of its shape whose leaves are Split, PARTIAL or None: the adapters by
    `lora_param_sharding`, the unfrozen base weights by
    `unet_param_sharding`, the rest whole."""
    out: dict[str, Any] = {}
    for key, value in trainable.items():
        if key == "unet_lora":
            out[key] = lora_param_sharding(value, unet, k)
        elif key == "text_lora":
            out[key] = lora_param_sharding(value, text, k)
        elif key == "unfrozen":
            plan = unet_param_sharding(unet, k)
            out[key] = {name: plan[name] for name in value}
        else:
            out[key] = _none_like(value)
    return out


def _none_like(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _none_like(v) for k, v in tree.items()}
    return None


# ---------------------------------------------------------------------------
# carrying weights: whole <-> rank m's shards
# ---------------------------------------------------------------------------

def _whole_from_rank0(t: torch.Tensor, mesh: pmesh.DataMesh
                      ) -> torch.Tensor:
    """Global rank 0's value of `t`, in a new tensor (the ranks' own
    tensors stay as they are)."""
    return pmesh.replicate_to(t.detach().clone(), mesh)


def shard_tree(tree: Any, layout: Any, mesh: pmesh.DataMesh | None) -> Any:
    """`tree` (nested dicts of whole tensors) with each Split leaf cut to
    this rank's slice of global rank 0's value; other leaves as they
    are."""
    if mesh is None or mesh.model_size == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_tree(v, layout[k], mesh) for k, v in tree.items()}
    if not isinstance(layout, Split):
        return tree
    return take(_whole_from_rank0(tree, mesh), layout, mesh.model_rank,
                mesh.model_size)


def gather_tree(tree: Any, layout: Any, mesh: pmesh.DataMesh | None) -> Any:
    """The whole tensors of a tree of shards, on every rank (a new tree;
    whole leaves are the tree's own)."""
    if mesh is None or mesh.model_size == 1:
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, layout[k], mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _gather(tree.detach(), layout, mesh)
    return tree


def shard_tensors(tensors: dict[str, torch.Tensor],
                  plan: dict[str, Split | None],
                  mesh: pmesh.DataMesh | None) -> dict[str, torch.Tensor]:
    """Named whole tensors (a module's parameters by name, e.g. the fp32
    kernels a LoRA merge reads) cut by `plan`; names the plan lacks stay
    whole."""
    return shard_tree(tensors, {k: plan.get(k) for k in tensors}, mesh)


def sharded(module: nn.Module) -> pmesh.DataMesh | None:
    """The mesh `module` was sharded over by `shard_params`, or None."""
    return getattr(module, "_tp_mesh", None)


def shard_params(module: nn.Module, mesh: pmesh.DataMesh | None
                 ) -> nn.Module:
    """Cut `module` (a UNet or a CLIP text model) in place to this rank's
    shards under `mesh`'s model axis, from this rank's own whole weights,
    which the caller has made equal across the ranks (cli/common.py::
    replicate_stack, mesh.replicate_to): each split layer's weight (and a
    column layer's bias) becomes a new parameter holding the slice, and
    the whole one is dropped; each split block learns the mesh (its forward
    then runs the collectives), and a row-parallel layer learns it too
    (its int8 scales are the model group's). A no-op on a model axis of 1
    and on a module already sharded over `mesh`. Returns `module`."""
    if mesh is None or mesh.model_size == 1 or sharded(module) is mesh:
        return module
    if sharded(module) is not None:
        raise ValueError("the module is sharded over another mesh")
    k = mesh.model_size
    blocks = tp_blocks(module, k)
    plan = unet_param_sharding(module, k)
    for name, split in plan.items():
        if split is None:
            continue
        layer, leaf = name.rsplit(".", 1)
        owner = module.get_submodule(layer)
        old = getattr(owner, leaf)
        piece = take(old.detach(), split, mesh.model_rank, k)
        setattr(owner, leaf, nn.Parameter(piece,
                                          requires_grad=old.requires_grad))
        owner.__dict__.pop("_q8_weight", None)  # the whole weight's codes
        if split.dim == 1:
            owner.row_tp = mesh
    for name, split in blocks.items():
        if split:
            module.get_submodule(name).tp = mesh
    whole = sorted(name for name, split in blocks.items() if not split)
    if whole and pmesh.is_writer(mesh):
        print(f"[polyp-tpu-torch] model={k}: {len(whole)} blocks kept whole "
              f"(k divides neither their heads nor their width), e.g. "
              f"{whole[0]}", flush=True)
    module._tp_mesh = mesh
    return module


def sharded_copy(module: nn.Module, mesh: pmesh.DataMesh | None
                 ) -> nn.Module:
    """A copy of `module` sharded over `mesh` (`shard_params`), sharing
    every whole tensor with `module`, which is left as it was and keeps
    its whole weights: for a caller that holds a whole module by its own
    choice. `module` itself on a model axis of 1 or when it is sharded
    already."""
    if mesh is None or mesh.model_size == 1 or sharded(module) is not None:
        return module
    from polyp_tpu_torch.lora.surgery import merged_module
    return shard_params(merged_module(module, {}), mesh)


def gather_params(module: nn.Module, names: Iterable[str] | None = None
                  ) -> dict[str, torch.Tensor]:
    """The whole parameters of a module (sharded or not) by name (all, or
    `names`), on every rank of its model group: what a one-process module
    holds, bit for bit."""
    mesh = sharded(module)
    params = {k: v.detach() for k, v in module.named_parameters()}
    if names is not None:
        params = {k: params[k] for k in names}
    if mesh is None:
        return params
    plan = unet_param_sharding(module, mesh.model_size)
    return gather_tree(params, {k: plan[k] for k in params}, mesh)


def whole_param_sums(module: nn.Module
                     ) -> list[tuple[str, tuple[int, ...], torch.Tensor]]:
    """(name, whole shape, fp32 sum of the whole tensor) of every
    parameter, in `named_parameters` order: on a sharded module each split
    parameter is gathered alone, summed and dropped, so every rank of the
    model group gets one process's values, bit for bit, and never holds
    more than one whole tensor."""
    mesh = sharded(module)
    plan = ({} if mesh is None
            else unet_param_sharding(module, mesh.model_size))
    out = []
    for name, p in module.named_parameters():
        t = p.detach()
        if plan.get(name) is not None:
            t = _gather(t, plan[name], mesh)
        out.append((name, tuple(t.shape), t.float().sum()))
    return out


def gathered_copy(module: nn.Module) -> nn.Module:
    """A whole copy of a sharded module on every rank of its model group,
    for one call (calibration): it shares every whole tensor with
    `module`, holds each split parameter gathered, and runs as one
    process's module (no mesh, no collectives). Drop it after use; the
    rank's resident state is `module`'s shards. `module` itself when it
    is not sharded."""
    from polyp_tpu_torch.lora.surgery import merged_module

    mesh = sharded(module)
    if mesh is None:
        return module
    plan = unet_param_sharding(module, mesh.model_size)
    out = merged_module(module, {
        name: _gather(p.detach(), plan[name], mesh)
        for name, p in module.named_parameters() if plan[name] is not None})
    for sub in out.modules():  # the class defaults: no mesh
        for attr in ("tp", "row_tp", "_tp_mesh"):
            sub.__dict__.pop(attr, None)
    return out
