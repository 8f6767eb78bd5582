"""Shared CLI plumbing: the twin of polyp_tpu/cli/common.py (the corpus
layout `DataLayout`, `add_common_flags`, `get_mesh_from`,
`get_tracker_from`, `print_banner`) and SD stack loading (`load_sd_stack`).

The CLIs run on the card unless `--device cpu` is given. `--mesh data=N`
(or `data=-1`) runs a training CLI data-parallel over the ranks of a
`torchrun --nproc_per_node=N` launch, one process a card
(parallel/mesh.py); `--mesh data=N,model=k` over N·k ranks adds Megatron
tensor parallelism on the model axis (parallel/sharding.py) to the SD
LoRA training and sampling; without it a CLI runs on one device.

The stack comes from a local diffusers checkpoint (`pretrained_dir`,
models/importers.py::load_sd_checkpoint) or from a seeded random
initialisation. The modules are built on the meta device and then
materialised on `device`, filled either from the checkpoint or from one
seeded `torch.Generator` there, so a full-width stack is made directly on
the card without a CPU copy.

`SDStack.fp32_params` gives fp32 copies of named parameters of a stack
kept in bf16, from the stack's own source: the checkpoint's values, or
the seeded draws again (a replay of the initialisation, which consumes the
generator in the same order). The LoRA trainer merges its adapter into
those fp32 weights (lora/surgery.py).

Under a model axis (`load_sd_stack(mesh=)`, the CLIs' `--mesh
data=N,model=k`) the stack is broadcast from rank 0, checked, and its
UNet and CLIP text model are cut in place to this rank's shards
(parallel/sharding.py; the VAE and the tokenizer stay whole, the
reference's placements, polyp_tpu/cli/sd_common.py:293-297): a rank holds
the whole stack less (1 − 1/k) of the split bytes. `fp32_params` of such
a stack gives this rank's slice of each split kernel, cut from the source
one tensor at a time.
"""

from __future__ import annotations

import argparse
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import torch
from torch import nn

PARTS = ("unet", "vae", "text")


@dataclass
class DataLayout:
    """The reference's corpus layout: {root}/m_train2/m_train/{images,
    train.csv, masks}, {root}/m_valid/m_valid/{images,valid.csv},
    {root}/m_test/m_test/{images,gt_test.csv}."""

    root: Path

    @property
    def train_images(self): return self.root / "m_train2/m_train/images"
    @property
    def train_csv(self): return self.root / "m_train2/m_train/train.csv"
    @property
    def train_masks(self): return self.root / "m_train2/m_train/masks"
    @property
    def val_images(self): return self.root / "m_valid/m_valid/images"
    @property
    def val_csv(self): return self.root / "m_valid/m_valid/valid.csv"
    @property
    def test_images(self): return self.root / "m_test/m_test/images"
    @property
    def test_csv(self): return self.root / "m_test/m_test/gt_test.csv"


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--data-root", type=str, default="./data",
                        help="corpus root (the reference's layout)")
    parser.add_argument("--cache-dir", type=str, default="./data/cache")
    parser.add_argument("--tracker-root", type=str, default="mlruns_local")
    parser.add_argument("--experiment-name", type=str, default=None)
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["w8a8", "w8a8_static", "promoted"],
                        help="quantized UNet sampling (ops/quant.py); "
                             "training is never quantized. 'promoted' "
                             "expands to the gate-passing config from "
                             "quant.promoted_config() (DiffusionConfig "
                             "resolves it)")
    parser.add_argument("--quant_fp_head", type=int, default=0,
                        help="with --quantize: the first N sampling steps "
                             "in full precision")
    parser.add_argument("--quant_fp_tail", type=int, default=0,
                        help="with --quantize: the final N sampling steps "
                             "in full precision")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; the CLIs run on the card "
                             "unless given a CPU")
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh spec, e.g. 'data=8' (pure DP) or "
                             "'data=4,model=2' (DP × Megatron-TP on the "
                             "attention/FF kernels); 'data=-1' = all devices. "
                             "Default: single-device, like the reference "
                             "(classification.sh:8, gres gpu:1). The port "
                             "runs the mesh over the ranks of a torchrun "
                             "launch, one process a card, data × model "
                             "ranks (rank = d·model + m)")


def get_mesh_from(args):
    """The mesh named by --mesh (None when unset): starts the
    torchrun launch's process group first (parallel/mesh.py::
    init_distributed, nccl on the card, gloo on the CPU), so 'data=-1'
    spans every rank. On the card each rank takes card LOCAL_RANK, and
    `args.device` becomes that card."""
    from polyp_tpu_torch.parallel import init_distributed, mesh_from_spec
    spec = getattr(args, "mesh", None)
    if spec:
        init_distributed(device=args.device)
        if torch.device(args.device).type == "cuda" and \
                torch.distributed.is_initialized():
            args.device = f"cuda:{torch.cuda.current_device()}"
    mesh = mesh_from_spec(spec)
    if mesh is not None:
        print(f"[polyp-tpu-torch] mesh: {mesh.shape} over "
              f"{mesh.size * mesh.model_size} ranks (rank {mesh.world_rank})")
    return mesh


def get_tracker_from(args, mesh=None):
    """The run tracker; under a data-parallel `mesh` only rank 0 records
    (the other ranks get a NullTracker)."""
    from polyp_tpu_torch.parallel import is_writer
    from polyp_tpu_torch.track import NullTracker, get_tracker
    return get_tracker(args.tracker_root) if is_writer(mesh) else NullTracker()


def replicate_stack(stack: "SDStack", mesh) -> "SDStack":
    """Rank 0's weights of the stack's three modules on every rank of
    `mesh` (a broadcast; the seeded initialisation should agree already),
    checked by checksum. A no-op without a mesh."""
    from polyp_tpu_torch.parallel import replicate_to, replicated
    if mesh is None:
        return stack
    for part in PARTS:
        module = getattr(stack, part)
        replicate_to(module, mesh)
        if not replicated(module, mesh):
            raise RuntimeError(f"the ranks' {part} weights differ after the "
                               "broadcast")
    return stack


def print_banner(msg: str) -> None:
    print(f"\n=== {msg} ===")


def class_split(one_vs_rest: bool) -> tuple[list[str], dict[str, list[str]]]:
    """The classes a per-class CLI trains, and the labels each keeps: AD,
    HP and ASS each alone, or AD and REST (HP with ASS)."""
    if one_vs_rest:
        return ["AD", "REST"], {"AD": ["AD"], "REST": ["HP", "ASS"]}
    return ["AD", "HP", "ASS"], {c: [c] for c in ("AD", "HP", "ASS")}


@dataclass
class SDStack:
    unet: nn.Module
    vae: nn.Module
    text: nn.Module
    tokenizer: object
    pretrained_dir: str | None = None
    seed: int = 0
    tiny: bool = False

    @torch.no_grad()
    def fp32_params(self, part: str, names: Iterable[str],
                    whole: bool = False) -> dict[str, torch.Tensor]:
        """Fresh fp32 tensors (never views of the stack's parameters) of
        the parameters `names` of `part` ("unet", "vae" or "text"), on
        that module's device, exactly as the source holds them. Of a
        module sharded over a model axis: this rank's slice of each split
        parameter, or with `whole` the whole tensors (what a trainer
        cuts to its own shards)."""
        from polyp_tpu_torch.parallel import sharding

        names = list(names)
        module = getattr(self, part)
        mesh = sharding.sharded(module)
        plan = ({} if mesh is None else
                sharding.unet_param_sharding(module, mesh.model_size))

        def cut(name: str, t: torch.Tensor) -> torch.Tensor:
            if whole or plan.get(name) is None:
                return t
            return sharding.take(t, plan[name], mesh.model_rank,
                                 mesh.model_size)

        params = dict(module.named_parameters())
        if all(params[n].dtype == torch.float32 for n in names):
            if whole:
                return {n: v.clone() for n, v in sharding.gather_params(
                    module, names).items()}
            return {n: params[n].detach().clone() for n in names}
        device = next(module.parameters()).device
        if self.pretrained_dir is not None:
            from polyp_tpu_torch.models.importers import (
                SD_WEIGHT_FILES, find_weights, load_state_dict)
            from polyp_tpu_torch.utils.checkpoint import read_safetensors

            path = find_weights(Path(self.pretrained_dir)
                                / SD_WEIGHT_FILES[part][0],
                                SD_WEIGHT_FILES[part][1])
            sd = (read_safetensors(path, names)
                  if path.suffix == ".safetensors" else load_state_dict(path))
            # cut on the host, so only the slice is copied to the card
            return {n: cut(n, sd[n]).to(device, torch.float32)
                    for n in names}
        return _replay_init(self.tiny, self.seed, part, set(names), device,
                            cut)


def build_modules(tiny: bool, dtype: torch.dtype, device) -> tuple:
    """(UNet, VAE, CLIP text model) of SD-v1-4, or of the tiny stack,
    unfilled, in `dtype` on `device` (e.g. "meta")."""
    from polyp_tpu_torch.models import (
        SD14_TEXT_CONFIG, TINY_TEXT_CONFIG, AutoencoderKL, CLIPTextModel,
        sd14_unet, tiny_condition_unet, tiny_vae)

    if tiny:
        return (tiny_condition_unet(dtype=dtype, device=device),
                tiny_vae(dtype=dtype, device=device),
                CLIPTextModel(TINY_TEXT_CONFIG, dtype=dtype, device=device))
    return (sd14_unet(dtype=dtype, device=device),
            AutoencoderKL(dtype=dtype, device=device),
            CLIPTextModel(SD14_TEXT_CONFIG, dtype=dtype, device=device))


def _init_values(module: nn.Module, generator: torch.Generator):
    """(name, parameter, fp32 value) in the order of the reference's init
    scheme (flax defaults): dense and conv kernels normal with std
    1/√fan_in (lecun), biases 0, norm scales 1, token embeddings
    N(0, 0.02), position embeddings N(0, 0.01). Only the normal draws
    consume the generator."""
    for name, p in module.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        if isinstance(module.get_submodule(owner), nn.Embedding):
            std = 0.01 if "position" in owner else 0.02
        elif leaf == "bias":
            yield name, p, 0.0
            continue
        elif p.ndim == 1:  # GroupNorm / LayerNorm scales
            yield name, p, 1.0
            continue
        else:
            std = 1.0 / math.sqrt(p[0].numel())
        yield name, p, torch.randn(p.shape, generator=generator,
                                   device=generator.device) * std


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill `module` by the reference's init scheme (`_init_values`)."""
    for _, p, value in _init_values(module, generator):
        if isinstance(value, float):
            p.fill_(value)
        else:
            p.copy_(value)


@torch.no_grad()
def _replay_init(tiny: bool, seed: int, part: str, names: set[str],
                 device, cut=None) -> dict[str, torch.Tensor]:
    """The fp32 values `load_sd_stack` drew for `names` of `part`: the
    same generator walked over meta copies of the modules in the same
    order, one tensor at a time, each kept as `cut(name, value)` (a
    rank's slice) when given."""
    gen = torch.Generator(device).manual_seed(seed)
    out = {}
    for which, module in zip(PARTS, build_modules(tiny, torch.float32,
                                                   "meta")):
        for name, p, value in _init_values(module, gen):
            if which == part and name in names:
                value = (torch.full(p.shape, value, device=device)
                         if isinstance(value, float) else value)
                out[name] = value if cut is None else cut(name, value)
        if which == part:
            return out
    raise KeyError(part)


def load_sd_stack(pretrained_dir: str | None = None,
                  dtype: torch.dtype = torch.bfloat16, tiny: bool = False,
                  device: torch.device | str = "cuda",
                  seed: int = 0, mesh=None) -> SDStack:
    """SD-v1-4 components (UNet, VAE, CLIP text encoder, tokenizer) on
    `device`: imported from a local diffusers layout when `pretrained_dir`
    is given (a directory that is not there raises), else randomly
    initialised from `seed`. `tiny=True` swaps in the miniature stack and a
    hash tokenizer, as the reference does. The stack is built on the card
    unless the caller passes `device="cpu"`; with no card it raises rather
    than move to the CPU on its own. Under `mesh` the stack is rank 0's on
    every rank (`replicate_stack`), and under a model axis its UNet and
    CLIP text model are cut in place to this rank's shards
    (parallel/sharding.py::shard_params; the whole tensors are dropped);
    the VAE and the tokenizer stay whole."""
    from polyp_tpu_torch.models import (
        SD14_TEXT_CONFIG, TINY_TEXT_CONFIG, HashTokenizer, load_tokenizer)
    from polyp_tpu_torch.parallel import sharding

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_sd_stack builds on the CUDA card by default and no card "
            "is present; pass device='cpu' to build the stack on the CPU")
    if pretrained_dir is not None and not Path(pretrained_dir).is_dir():
        raise FileNotFoundError(f"no checkpoint directory {pretrained_dir}")
    modules = [m.to_empty(device=device)
               for m in build_modules(tiny, dtype, "meta")]
    if pretrained_dir is not None:
        from polyp_tpu_torch.models.importers import load_sd_checkpoint

        weights = load_sd_checkpoint(pretrained_dir)
        for part, m in zip(PARTS, modules):
            m.load_state_dict(weights[part], strict=True)
        tokenizer_dir = Path(pretrained_dir) / "tokenizer"
    else:
        print("[polyp-tpu-torch] no pretrained dir — using RANDOM INIT "
              "(smoke mode)")
        gen = torch.Generator(device).manual_seed(seed)
        for m in modules:
            init_weights_(m, gen)
        tokenizer_dir = None
    if tiny:
        tokenizer = HashTokenizer(vocab_size=TINY_TEXT_CONFIG.vocab_size,
                                  max_length=TINY_TEXT_CONFIG.max_length)
    else:
        tokenizer = load_tokenizer(tokenizer_dir, SD14_TEXT_CONFIG.max_length)
    stack = replicate_stack(SDStack(
        *(m.eval() for m in modules), tokenizer=tokenizer,
        pretrained_dir=None if pretrained_dir is None else str(
            pretrained_dir), seed=seed, tiny=tiny), mesh)
    for module in (stack.unet, stack.text):
        # checked equal across the ranks: each cuts its own copy
        sharding.shard_params(module, mesh)
    return stack
