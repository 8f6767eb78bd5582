"""EfficientNet (b0–b7 and `tiny`) and the polyp classifier head as
`nn.Module`s: the twin of polyp_tpu/models/efficientnet.py, built by hand
(the card's machine has no torchvision).

`PolypClassifier` is an EfficientNet backbone whose pooled features go
through Linear(features → hidden) → ReLU → Dropout → Linear(hidden →
classes). Parameter names follow the reference's tree
(`backbone.stage2_block0.depthwise.conv.weight`, `fc1.weight`, ...), so
models/importers.py::efficientnet_from_jax is a rename and a transpose.

What it pins against the reference:

* every conv pads (k − 1) // 2 on each side, also at stride 2 (not SAME,
  which pads (0, 1) on even inputs);
* BatchNorm eps / EMA decay from `bn_config`: 1e-5 / 0.9 for b0–b4 and
  `tiny` (torch's momentum 0.1), 1e-3 / 0.99 for the TF-ported b5–b7;
* dtypes: the stem conv runs in its input's dtype (bf16 under the
  classifier's "bf16" mixed precision, with its weight cast to bf16);
  every BatchNorm computes in fp32 and returns fp32, so every layer after
  the stem's BN runs in fp32, as the reference's `nn.BatchNorm(dtype=
  float32)` and `dtype=x.dtype` convs do. Nothing is autocast;
* `BatchNorm` in training normalises with the batch's biased variance,
  computed as flax computes it (E[x²] − E[x]²), and moves `running_var`
  towards that biased variance, as flax does (torch's `nn.BatchNorm2d`
  moves it towards the unbiased one);
* the squeeze-excite width is the block's input channels // 4;
* stochastic depth drops whole rows of a residual branch (rate rising
  linearly with the block index, 0 at block 0), and the head's dropout
  sits between fc1 and fc2. Both take their keep masks from the caller
  (`draws`, train/classifier.py::ClassifierDraws), so a test can hand over
  the reference's masks;
* under a data-parallel group (`global_batch_stats(mesh)`), training
  BatchNorm takes its statistics over the group's global batch, as the
  reference's step jitted over a mesh sees it: Σx and Σx² summed over the
  ranks by a differentiable all-reduce, kept in flax's E[x²] − E[x]² form.

Precision on the card: cuDNN runs the fp32 convs in TF32 where
`torch.backends.cudnn.allow_tf32` is on (its default). The classifier
keeps that default: the reference's fp32 convs run at the TPU's default
precision (bf16 passes), so TF32 is nearer to it than full fp32, and its
error stays inside the bf16 stem's own (chip_smoke.py holds a forward and
a train step on the card to fp32 on the CPU).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

# (expand_ratio, channels, repeats, stride, kernel) per stage of B0
B0_STAGES: tuple[tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# width_mult, depth_mult, dropout of each member; "tiny" (tests, smoke) is
# not a torchvision model: one block a stage at minimal widths
VARIANTS: dict[str, tuple[float, float, float]] = {
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5),
    "tiny": (0.1, 0.1, 0.1),
}

_TF_PORTED = frozenset({"b5", "b6", "b7"})


def bn_config(variant: str) -> tuple[float, float]:
    """(eps, EMA decay) of the variant's BatchNorms, torchvision's."""
    return (1e-3, 0.99) if variant in _TF_PORTED else (1e-5, 0.9)


def _round_channels(ch: float, width_mult: float, divisor: int = 8) -> int:
    ch *= width_mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return new


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "polyp_bn_group", default=None)


@contextlib.contextmanager
def global_batch_stats(mesh):
    """Training BatchNorms inside the region (this thread's context) take
    their statistics over the rows of every rank of `mesh` (a
    parallel.mesh.DataMesh; None: this process's rows)."""
    token = _BATCH_GROUP.set(mesh)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


class BatchNorm(nn.Module):
    """flax's BatchNorm over NCHW in fp32. In training it normalises with
    the batch mean and the biased variance as flax computes them (E[x²] −
    E[x]², clamped at 0: `use_fast_variance`), as (x − μ)·(rsqrt(σ² + ε)·
    scale) + bias, and moves the running averages towards them by
    `decay`; in evaluation it uses the running averages. torch's own
    training batch norm computes the variance another way, which moves
    the tiny variant's train step off the reference's by more than
    tests/test_torch_port_classifier.py allows."""

    def __init__(self, features: int, eps: float = 1e-5,
                 decay: float = 0.9, device=None):
        super().__init__()
        self.eps, self.decay = eps, decay
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mesh = _BATCH_GROUP.get()
        if mesh is None:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
        else:
            from polyp_tpu_torch.parallel.mesh import sum_over_group
            count = x.shape[0] * x.shape[2] * x.shape[3] * mesh.size
            sums = sum_over_group(torch.stack([x.sum((0, 2, 3)),
                                               (x * x).sum((0, 2, 3))]),
                                  mesh)
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(self.decay).add_(mean,
                                                    alpha=1 - self.decay)
            self.running_var.mul_(self.decay).add_(var, alpha=1 - self.decay)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvBNAct(nn.Module):
    """Conv (no bias, (k − 1) // 2 padding, in the input's dtype) → fp32
    BatchNorm → SiLU (unless `act` is False)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True, eps: float = 1e-5,
                 decay: float = 0.9, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                              groups=groups, bias=False, device=device)
        self.bn = BatchNorm(cout, eps, decay, device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x, c.weight.to(x.dtype), None, c.stride, c.padding, 1,
                     c.groups)
        x = self.bn(x)
        return F.silu(x) if self.act else x


class SqueezeExcite(nn.Module):

    def __init__(self, channels: int, squeeze: int, device=None):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1, device=device)
        self.fc2 = nn.Conv2d(squeeze, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = self.fc2(F.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted residual: 1×1 expand (where the ratio is not 1) →
    depthwise k×k → squeeze-excite → 1×1 project, with stochastic depth
    on the residual branch where the block has one."""

    def __init__(self, name: str, cin: int, cout: int, expand_ratio: int,
                 kernel: int, stride: int, drop_path: float,
                 eps: float = 1e-5, decay: float = 0.9, device=None):
        super().__init__()
        bn = dict(eps=eps, decay=decay, device=device)
        expanded = cin * expand_ratio
        self.expand = (ConvBNAct(cin, expanded, 1, **bn)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvBNAct(expanded, expanded, kernel, stride,
                                   groups=expanded, **bn)
        self.se = SqueezeExcite(expanded, max(1, cin // 4), device)
        self.project = ConvBNAct(expanded, cout, 1, act=False, **bn)
        self.residual = stride == 1 and cin == cout
        self.drop_path = drop_path
        self.block_name = name

    @property
    def draws_rows(self) -> bool:
        """Whether a training forward takes a keep row for this block."""
        return self.residual and self.drop_path > 0.0

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        residual = x
        if self.expand is not None:
            x = self.expand(x)
        x = self.project(self.se(self.depthwise(x)))
        if not self.residual:
            return x
        if self.training and self.draws_rows:
            keep = draws.drop_path[self.block_name].to(x.device)
            x = torch.where(keep[:, None, None, None],
                            x / (1.0 - self.drop_path), 0.0)
        return x + residual


class EfficientNet(nn.Module):
    """The backbone: stem → MBConv stages → 1×1 head conv → global average
    pool, giving [N, num_features] (1280·width for b0–b7)."""

    def __init__(self, variant: str = "b0", stochastic_depth: float = 0.2,
                 device=None):
        super().__init__()
        width, depth, _ = VARIANTS[variant]
        eps, decay = bn_config(variant)
        bn = dict(eps=eps, decay=decay, device=device)
        stem_ch = _round_channels(32, width)
        self.stem = ConvBNAct(3, stem_ch, 3, 2, **bn)
        total = sum(_round_repeats(r, depth) for _, _, r, _, _ in B0_STAGES)
        self.block_names: list[str] = []
        index, in_ch = 0, stem_ch
        for stage_i, (expand, ch, repeats, stride, kernel) in enumerate(
                B0_STAGES):
            out_ch = _round_channels(ch, width)
            for i in range(_round_repeats(repeats, depth)):
                name = f"stage{stage_i + 1}_block{i}"
                self.add_module(name, MBConv(
                    name, in_ch, out_ch, expand, kernel,
                    stride if i == 0 else 1,
                    stochastic_depth * index / total, **bn))
                self.block_names.append(name)
                in_ch = out_ch
                index += 1
        self.num_features = _round_channels(1280, width)
        self.head = ConvBNAct(in_ch, self.num_features, 1, **bn)

    def blocks(self) -> list[MBConv]:
        return [getattr(self, n) for n in self.block_names]

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        x = self.stem(x)
        for block in self.blocks():
            x = block(x, draws)
        return self.head(x).mean((2, 3))


class PolypClassifier(nn.Module):
    """EfficientNet backbone + the reference's replacement head."""

    def __init__(self, num_classes: int, hidden_features: int = 256,
                 dropout: float = 0.5, variant: str = "b0", device=None):
        super().__init__()
        self.backbone = EfficientNet(variant, device=device)
        self.fc1 = nn.Linear(self.backbone.num_features, hidden_features,
                             device=device)
        self.fc2 = nn.Linear(hidden_features, num_classes, device=device)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        """Logits (fp32) of NCHW images; in training, `draws` holds the
        stochastic-depth rows and the head's dropout keep mask."""
        h = F.relu(self.fc1(self.backbone(x, draws)))
        if self.training and self.dropout > 0.0:
            h = torch.where(draws.dropout.to(h.device),
                            h / (1.0 - self.dropout), 0.0)
        return self.fc2(h)


def _lecun_normal(shape, fan_in: int, generator: torch.Generator
                  ) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated to ±2 σ, scaled so the
    variance is 1 / fan_in (drawn by the inverse CDF from `generator`)."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=generator.device)
    z = math.sqrt(2.0) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return z.clamp(-2.0, 2.0) * std


@torch.no_grad()
def init_classifier_(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's init scheme (flax defaults): conv and dense kernels
    lecun-normal over their fan-in, biases 0, BN scales 1, running
    averages (0, 1). Only the kernels consume the generator."""
    for name, p in model.named_parameters():
        if p.ndim > 1:
            p.copy_(_lecun_normal(p.shape, p[0].numel(), generator))
        elif name.endswith("bn.weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        b.fill_(1.0 if name.endswith("running_var") else 0.0)
