"""Process meshes on torch.distributed: the twin of
polyp_tpu/parallel/mesh.py.

A "mesh" here is a `data × model` grid of ranks, one process a card,
launched by `torchrun --nproc_per_node=N` (or spawned, parallel/launch.py).
Ranks are laid out as the reference's `make_mesh` reshapes its devices,
row-major over (data, model): rank = d·k + m for k = model. A model group
is then k consecutive ranks (NVLink neighbours on one node), a data group
the ranks that share a model rank. The JAX package jits one program over a
device mesh and lets XLA insert the collectives; the port runs one process
a rank and writes its few collectives by hand.

Over the data group (`DataMesh.size`, `rank`, `group`):

* every rank holds the whole model (`replicate_to` broadcasts rank 0's
  weights; `replicated` checks that the ranks hold the same bits);
* every rank walks the same seeded global batch stream and keeps its own
  rows of each global batch (`DataMesh.local`, `shard_batch`,
  data/pipeline.py::Loader), and every random draw of a step is made for
  the global batch and then sliced the same way (`RankDraws`), so the
  group's step computes the one-process step on the whole batch;
* gradients are averaged in one flattened bucket before the optimizer
  (`allreduce_grads`), and a step's loss is the group's mean (`all_mean`);
* sampled rows are put back together on every rank (`gather_rows`).

Over the world: global rank 0 alone writes files (`is_writer`), and
`replicate_to`, `replicated`, `barrier` and `broadcast_object` span every
rank.

Over the model group (`model_size`, `model_rank`, `model_group`), the
Megatron tensor parallelism of parallel/sharding.py: the region operators
`copy_to_model` (f: identity forward, all-reduce backward, at the input of
a column-parallel block) and `reduce_from_model` (g: all-reduce forward,
identity backward, after a row-parallel product), `model_max` (the int8
scales of a row-parallel input) and `model_sum_` (gradients).

Collectives are all-reduce and broadcast only, the two that the gloo
backend carries for CUDA tensors; `gather_rows` is an all-reduce of
zero-padded rows, exact since every other rank adds zeros.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataMesh:
    """A `data × model` mesh seen from one rank. `size` ranks on the data
    axis, this process being data rank `rank`, `group` its data group
    (None: the default one, when the model axis is 1); `model_size`,
    `model_rank` and `model_group` the same on the model axis. A mesh
    made without torch.distributed initialised has `distributed=False`,
    and its collectives are the identity (one rank) or refused (more).
    Copies of a module that holds the mesh share it (`__deepcopy__`)."""

    size: int
    rank: int = 0
    group: Any = None
    distributed: bool = False
    model_size: int = 1
    model_rank: int = 0
    model_group: Any = None

    def __deepcopy__(self, memo) -> "DataMesh":
        return self  # immutable, and a process group cannot be copied

    @property
    def world_rank(self) -> int:
        return self.rank * self.model_size + self.model_rank

    @property
    def shape(self) -> dict[str, int]:
        if self.model_size == 1:
            return {"data": self.size}
        return {"data": self.size, "model": self.model_size}

    def model_ranks(self) -> list[int]:
        """The world ranks of this rank's model group, in model order."""
        k = self.model_size
        return [self.rank * k + m for m in range(k)]

    def data_ranks(self) -> list[int]:
        """The world ranks of this rank's data group, in data order."""
        k = self.model_size
        return [d * k + self.model_rank for d in range(self.size)]

    def local(self, x):
        """This rank's rows of `x` (a global batch along dim 0)."""
        validate_batch_for_mesh(x.shape[0], self)
        per = x.shape[0] // self.size
        return x[self.rank * per:(self.rank + 1) * per]


def _collective(mesh: DataMesh | None) -> bool:
    """Does `mesh` run collectives? Only a mesh over an initialised
    group; a one-rank mesh without one needs none."""
    if mesh is None:
        return False
    if not mesh.distributed:
        if mesh.size * mesh.model_size > 1:
            raise RuntimeError(f"a mesh of {mesh.size * mesh.model_size} "
                               "ranks needs torch.distributed initialised")
        return False
    return True


def _model_collective(mesh: DataMesh | None) -> bool:
    """Does `mesh` run collectives over a model group of 2 or more?"""
    return mesh is not None and mesh.model_size > 1 and _collective(mesh)


def process_count() -> int:
    """Ranks of the default group (1 without torch.distributed)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def default_backend(device: torch.device | str) -> str:
    """nccl for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(backend: str | None, rank: int, world_size: int,
               init_method: str | None = None,
               device: torch.device | str = "cuda",
               local_rank: int | None = None) -> None:
    """Start the default process group; on CUDA this process takes card
    `local_rank` (default `rank`) first. `init_method` defaults to env://
    (MASTER_ADDR / MASTER_PORT)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank if local_rank is None else local_rank)
    dist.init_process_group(backend or default_backend(device),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def init_distributed(backend: str | None = None,
                     device: torch.device | str = "cuda") -> bool:
    """Bring-up for a torchrun launch, the twin of `multihost_init`: reads
    RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR and starts the default
    group (nccl for CUDA, gloo for the CPU, unless `backend` is named).
    A no-op returning False when WORLD_SIZE is unset or 1; True when a
    group runs (also one started before)."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    init_group(backend, int(os.environ["RANK"]), world, "env://", device,
               int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    return True


def current_mesh() -> DataMesh:
    """The data mesh over the running group (one rank without one)."""
    if not dist.is_initialized():
        return DataMesh(1)
    return DataMesh(dist.get_world_size(), dist.get_rank(), None, True)


# the groups of each (data, model) layout over the running default group:
# dist.new_group is collective, so every rank makes every group once, in
# the same order, and later meshes of the same layout reuse them
_GROUPS: dict[tuple, tuple[list, list]] = {}


def _groups(n: int, k: int) -> tuple[list, list]:
    """([data group of model rank m for m < k], [model group of data rank
    d for d < n]) over the running default group, made on first use."""
    key = (id(dist.group.WORLD), n, k)
    if key not in _GROUPS:
        data = [dist.new_group([d * k + m for d in range(n)])
                for m in range(k)]
        model = [dist.new_group([d * k + m for m in range(k)])
                 for d in range(n)]
        _GROUPS.clear()  # groups of an earlier default group are gone
        _GROUPS[key] = (data, model)
    return _GROUPS[key]


def make_mesh(data: int, model: int = 1) -> DataMesh:
    """This rank's view of a `data × model` mesh over the running group
    (rank = d·model + m); without torch.distributed, rank 0 of a mesh
    that runs no collectives."""
    if not dist.is_initialized():
        return DataMesh(data, model_size=model)
    world = dist.get_rank()
    d, m = divmod(world, model)
    if model == 1:
        return DataMesh(data, d, None, True)
    data_groups, model_groups = _groups(data, model)
    return DataMesh(data, d, data_groups[m], True, model, m,
                    model_groups[d])


def mesh_from_spec(spec: str | None, world_size: int | None = None
                   ) -> DataMesh | None:
    """Parse a CLI mesh spec with the reference's grammar ("data=8",
    "data=4,model=2"; None / empty: no mesh; "data=-1": fill with every
    rank) into this rank's view of the mesh over the running group.
    data × model must equal the world size (`world_size`, default the
    running group's)."""
    if not spec:
        return None
    ranks = process_count() if world_size is None else world_size
    axes: dict[str, int] = {}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        name = name.strip()
        if not name or not val.strip().lstrip("-").isdigit():
            raise ValueError(f"bad mesh spec {spec!r}; want e.g. "
                             "'data=8' or 'data=4,model=2'")
        size = int(val)
        if size < 1 and size != -1:
            raise ValueError(f"bad axis size {size} in {spec!r}; axis sizes "
                             "must be >= 1 (-1 = fill with all devices)")
        axes[name] = size
    fill = [k for k, v in axes.items() if v == -1]
    if len(fill) > 1:
        raise ValueError(f"only one axis may be -1 in {spec!r}")
    if fill:
        rest = int(np.prod([v for v in axes.values() if v != -1]))
        if ranks % rest:
            raise ValueError(f"{ranks} devices not divisible by {rest}")
        axes[fill[0]] = ranks // rest
    unknown = sorted(set(axes) - {"data", "model"})
    if unknown:
        raise ValueError(f"mesh axes {unknown} in {spec!r}: the port's "
                         "mesh has the axes 'data' and 'model'")
    n, k = axes.get("data", 1), axes.get("model", 1)
    if n * k != ranks:
        raise ValueError(f"mesh {dict(axes)} needs {n * k} ranks, got a "
                         f"world of {ranks}; launch one process a card "
                         f"(torchrun --nproc_per_node={n * k}) or use "
                         "data=-1")
    return make_mesh(n, k)


def validate_batch_for_mesh(batch_size: int, mesh: DataMesh | None,
                            what: str = "batch_size") -> None:
    """Data-parallel batches must split evenly over the 'data' axis."""
    if mesh is None:
        return
    d = mesh.size
    if batch_size % d:
        raise ValueError(
            f"{what}={batch_size} not divisible by mesh data axis ({d}); "
            f"pick a multiple of {d}")


def padded_batch(batch_size: int, mesh: DataMesh | None) -> int:
    """`batch_size` rounded up to a multiple of the group's size (a ragged
    quota tail keeps even rows a rank); callers slice back."""
    if mesh is None:
        return batch_size
    return -(-batch_size // mesh.size) * mesh.size


def is_writer(mesh: DataMesh | None) -> bool:
    """Does this process write files (global rank 0, or no group)?"""
    return mesh is None or mesh.world_rank == 0


def shard_batch(batch: Any, mesh: DataMesh | None) -> Any:
    """This rank's rows of every array of a global batch (a tuple, list or
    dict of arrays or tensors)."""
    if mesh is None:
        return batch
    if isinstance(batch, dict):
        return {k: mesh.local(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(mesh.local(v) for v in batch)
    return mesh.local(batch)


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return [t for t in tree.state_dict(keep_vars=True).values()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate_to(tree: Any, mesh: DataMesh | None) -> Any:
    """Global rank 0's values of every tensor of `tree` (a module, or a
    nested dict / list of tensors) on every rank, in place; returns
    `tree`."""
    if _collective(mesh):
        for t in _tensors(tree):
            dist.broadcast(t.data, src=0)
    return tree


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def checksum(tree: Any) -> int:
    """A position-weighted sum of the bits of every tensor of `tree`,
    modulo 2**64: integer arithmetic, so the value does not depend on
    reduction order or device, and any changed bit or moved element
    changes it (but for a 2**-64 chance)."""
    total, offset = 0, 0
    for t in _tensors(tree):
        t = t.detach().contiguous()
        bits = t.view(_INT_VIEW[t.element_size()]).reshape(-1).to(
            torch.int64)
        w = (torch.arange(bits.numel(), device=bits.device,
                          dtype=torch.int64) + offset) % 65521 + 1
        total = (total + int((bits * w).sum())) % 2 ** 64
        offset += bits.numel()
    return total


def replicated(tree: Any, mesh: DataMesh | None) -> bool:
    """Do all ranks hold the same bits in `tree`? (`checksum` compared
    over the world; True without a group.)"""
    if not _collective(mesh):
        return True
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, checksum(tree))
    return len(set(sums)) == 1


def allreduce_grads(grads: Sequence[torch.Tensor], mesh: DataMesh | None,
                    average: bool = True) -> Sequence[torch.Tensor]:
    """Sum (`average`: mean) the gradient tensors `grads` over the data
    group, in place, one flattened bucket a dtype; returns `grads`."""
    if not _collective(mesh) or mesh.size == 1:
        return grads
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.group)
        if average:
            flat /= mesh.size
        for g, part in zip(group, flat.split([g.numel() for g in group])):
            g.copy_(part.view_as(g))
    return grads


def all_sum(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The group's sum of `x` (a new tensor; not differentiable)."""
    if not _collective(mesh):
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def all_mean(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The group's mean of `x` (a step's loss, each rank's mean over
    rows of one size)."""
    return x if not _collective(mesh) else all_sum(x, mesh) / mesh.size


def sum_over_group(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The group's sum of `x`, differentiable: the backward sums the
    gradients over the group too (torch.distributed.nn.functional)."""
    if not _collective(mesh):
        return x
    from torch.distributed.nn.functional import all_reduce
    with warnings.catch_warnings():  # its successor has no backward yet
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(x, group=mesh.group or dist.group.WORLD)


def gather_rows(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """Every rank's rows of `x` in rank order, on every rank: the global
    batch that `DataMesh.local` split."""
    if not _collective(mesh):
        return x
    n = x.shape[0]
    full = torch.zeros((n * mesh.size, *x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    full[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(full, group=mesh.group)
    return full


def gather_objects(obj: Any, mesh: DataMesh | None) -> list:
    """Every rank's `obj` (picklable, e.g. a host array), in rank order."""
    if not _collective(mesh):
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_object(obj: Any, mesh: DataMesh | None) -> Any:
    """Global rank 0's `obj` on every rank."""
    if not _collective(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: DataMesh | None) -> None:
    """Every rank of the world waits for the others."""
    if _collective(mesh):
        dist.barrier()


# ---------------------------------------------------------------------------
# the model group: Megatron's region operators and reductions
# ---------------------------------------------------------------------------

def _all_reduce_model(x: torch.Tensor, mesh: DataMesh,
                      op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=mesh.model_group)
    return x


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward; the backward sums the gradient over the
    model group (each rank's column-parallel block saw the whole input)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_model(grad.contiguous().clone(), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the forward sums the row-parallel partial products over the
    model group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_model(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """Megatron's f at the input of a column-parallel block."""
    if not _model_collective(mesh):
        return x
    return _CopyToModel.apply(x, mesh)


# host seconds spent in g's forward all-reduce (the tensor-parallel
# forward's communication), and its count; callers may reset both
reduce_seconds = [0.0]
reduce_calls = [0]


def reduce_from_model(x: torch.Tensor,
                      mesh: DataMesh | None) -> torch.Tensor:
    """Megatron's g after a row-parallel product: the model group's sum."""
    if not _model_collective(mesh):
        return x
    start = time.perf_counter()
    out = _ReduceFromModel.apply(x, mesh)
    reduce_seconds[0] += time.perf_counter() - start
    reduce_calls[0] += 1
    return out


def model_max(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The model group's elementwise max of `x` (a new tensor; the int8
    scale of an input that each rank holds a slice of)."""
    if not _model_collective(mesh):
        return x
    return _all_reduce_model(x.detach().clone(), mesh, dist.ReduceOp.MAX)


def all_model_sum(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The model group's sum of `x` (a new tensor; not differentiable)."""
    if not _model_collective(mesh):
        return x
    return _all_reduce_model(x.detach().clone(), mesh)


def model_sum_(tensors: Sequence[torch.Tensor],
               mesh: DataMesh | None) -> None:
    """Sum the tensors over the model group, in place, one flattened
    bucket a dtype (gradients of whole trainables that each rank computed
    over its slice)."""
    if not _model_collective(mesh) or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _all_reduce_model(torch.cat([t.reshape(-1) for t in group]),
                                 mesh)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def model_gather_exact(full: torch.Tensor, mesh: DataMesh | None
                       ) -> torch.Tensor:
    """`full`, in which this rank filled its own slice and left zeros
    elsewhere, summed over the model group on its integer bits, in place:
    every rank then holds every rank's slice, bit for bit (a float sum
    would turn −0.0 into +0.0)."""
    if not _model_collective(mesh):
        return full
    size = full.element_size()
    bits = full.view(_INT_VIEW[size])
    wide = bits if size >= 4 else bits.to(torch.int32)
    _all_reduce_model(wide, mesh)
    if wide is not bits:
        bits.copy_(wide.to(bits.dtype))
    return full


class RankDraws:
    """A step's random draws made for the group's global batch, of which
    this rank keeps its rows, so every rank's generator advances as the
    one-process step's does and the rows a rank sees are the one-process
    step's rows. Wraps the trainers' draw objects: `StepDraws` (flip,
    normal, timesteps, keep_mask: one mask a module, not a row, kept
    whole) and `DistillDraws` (idx, noise)."""

    def __init__(self, draws, mesh: DataMesh):
        self.draws, self.mesh = draws, mesh

    def _rows(self, x):
        return self.mesh.local(x)

    def _wide(self, shape: Iterable[int]) -> tuple[int, ...]:
        shape = tuple(shape)
        return (shape[0] * self.mesh.size, *shape[1:])

    def flip(self, n: int) -> torch.Tensor:
        return self._rows(self.draws.flip(n * self.mesh.size))

    def normal(self, what: str, shape) -> torch.Tensor:
        return self._rows(self.draws.normal(what, self._wide(shape)))

    def timesteps(self, n: int, high: int) -> torch.Tensor:
        return self._rows(self.draws.timesteps(n * self.mesh.size, high))

    def keep_mask(self, stream: str, name: str, rows: int,
                  keep: float) -> torch.Tensor:
        return self.draws.keep_mask(stream, name, rows, keep)

    def idx(self, n: int, high: int) -> torch.Tensor:
        return self._rows(self.draws.idx(n * self.mesh.size, high))

    def noise(self, shape) -> torch.Tensor:
        return self._rows(self.draws.noise(self._wide(shape)))


def rank_draws(draws, mesh: DataMesh | None):
    """`draws` for this rank's rows of the global batch (`RankDraws`), or
    `draws` itself without a mesh."""
    return draws if mesh is None else RankDraws(draws, mesh)
