"""Roofline of the port's SD sampling and training steps on the card: the
twin of tools/roofline.py, with the H100's peaks in place of the TPU's.

The default mode measures, on the card, (a) the 3×3 convolutions of each
UNet level in bf16 (cuDNN) and through the port's int8 conv
(ops/quant.py::w8a8_conv), (b) the port's flash attention at each level's
token count, (c) the VAE decode, and counts (d) the FLOPs and bytes of one
CFG UNet step (2×batch) and one folded step (1×batch, a distilled
student's). It prints the per-step floors and the samples/s ceilings
beside the measured sampling rate. The levels follow `--image-size`
(latent = size / 8; 256 px by default). The reference's other modes:

* `--few-step` (its run_fewstep): the folded 1×-batch step's counted work,
  the conv rates at 1× batch, the VAE decode counted and measured, and for
  4, 8 and 25 steps the analytic ceiling, the ceiling with the measured
  decode and the decode's share at the floor;
* `--train` (its run_train): the SD LoRA step (train/sd_finetune.py,
  batch 8, rank 8, alpha 8, no dropout) and the classifier step
  (train/classifier.py, B0 at batch 16, 224 px);
* `--distill` (its run_distill): train/distill.py::make_distill_step at
  batch 8 (`--batch` 16 maps to 8): the teacher's two CFG substeps at 2×
  batch under no_grad, the student's forward and backward over every
  parameter and `SDOptimizer`, with the minutes a 2,000-step phase takes.

A training mode reports each step's counted FLOPs and bytes, the floors
(FLOPs at the best measured bf16 conv rate and at peak, bytes at the HBM
peak), the images/s ceiling (its floor: the larger of the FLOPs at the
best conv rate and the bytes), the measured images/s (the host clock
around synchronised steps 2..`--train-steps` after a warm-up, as
chip_smoke.py times training) and the % of the ceiling. Every report
carries the card's name and power limit.

    python -m polyp_tpu_torch.tools.roofline [--batch 16] [--steps 50]
        [--image-size 256] [--few-step | --train | --distill]
        [--iters 20] [--train-steps 6] [--out report.json]

Counting: torch's FlopCounterMode does not see the port's kernels (ctypes
calls), so the work is counted from the shapes each op is called at
(`count_work` for a forward, `count_step` for a train step): every
convolution and linear, the attention products (QKᵀ and PV, 4·N·T·S·inner;
`ops.dot_product_attention` as the UNet, the VAE and CLIP call it), the
GEGLU feed-forward's two products and the LoRA merge's A·B, and the
GroupNorms' bytes. FLOPs count the products only, as FlopCounterMode does
(GroupNorm and elementwise work is not in them). In a step each product also costs its backward: the
gradient of its input where one flows into it (the input requires grad)
and of its weight where that weight, or a LoRA factor merged into it, is
trained; the flash path's plain backward first recomputes the forward and
then runs the attention backward's four products; a forward that
autograd reruns in the backward (`SDComponents.remat`) counts its forward
again. Nothing under no_grad has a backward (the teacher, the VAE encode,
a frozen CLIP). Bytes are each counted product's operands and result read
and written once (a gradient reads dY and the other operand and writes
its own), as an unfused graph moves them, and the optimizer's: each
trained element's parameter, gradient and two moments read and parameter
and moments written, in fp32. Times are device times from CUDA graph
replays (utils/profiling.py::graph_ms), or host seconds around
synchronised steps where a step is measured.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from pathlib import Path
from typing import Callable, Iterable

import torch
import torch.utils.checkpoint
from torch import nn

# the H100 SXM's dense peaks (NVIDIA's data sheet), as PERF.md's kernel
# table and chip_smoke.py's bounds take them
PEAK_BF16_TFLOPS = 989.0
PEAK_INT8_TOPS = 1979.0
HBM_GBPS = 3350.0
PEAKS = {"bf16_tflops": PEAK_BF16_TFLOPS, "int8_tops": PEAK_INT8_TOPS,
         "hbm_gbps": HBM_GBPS}

HEADS = 8
# SD-v1-4's level widths; level 3 shares level 2's and has no attention
WIDTHS = (320, 640, 1280, 1280)
# an fp32 optimizer element: parameter, gradient, two moments read;
# parameter and moments written
OPTIMIZER_BYTES_PER_ELEMENT = 7 * 4
PROMPT = "a realistic photo of colon polyp"


def levels(image_size: int = 256) -> list[tuple[int, int]]:
    """(spatial, channels) of the UNet's four levels at `image_size`."""
    latent = image_size // 8
    if image_size % 64:
        raise ValueError(f"image size {image_size} is not a multiple of 64")
    return [(latent >> i, c) for i, c in enumerate(WIDTHS)]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def _in_backward() -> bool:
    """Inside autograd's backward: a forward run there is a recompute."""
    return torch._C._current_graph_task_id() != -1


class _Work:
    """The running count: {"flops", "bytes", "by_op": {kind: flops},
    "by_pass": {"forward" | "backward" | "recompute": flops}}."""

    def __init__(self):
        self.work = {"flops": 0, "bytes": 0, "by_op": {},
                     "by_pass": {"forward": 0, "backward": 0,
                                 "recompute": 0}}

    def add(self, kind: str, phase: str, flops: int, n_bytes: int) -> None:
        w = self.work
        w["flops"] += flops
        w["bytes"] += n_bytes
        w["by_op"][kind] = w["by_op"].get(kind, 0) + flops
        w["by_pass"][phase] += flops

    def product(self, kind: str, flops: int, x_bytes: int, w_bytes: int,
                y_bytes: int, x_grad: bool, w_grad: bool,
                extra_bytes: int = 0) -> None:
        """y = x·w: its forward (x, w, `extra_bytes` such as a bias, and y
        moved); dX where a gradient flows into x and dW where w is
        trained, each as many FLOPs (reading dY and the other operand,
        writing the gradient; none under no_grad); in the backward a
        recompute, forward alone."""
        forward = x_bytes + w_bytes + y_bytes + extra_bytes
        if _in_backward():
            self.add(kind, "recompute", flops, forward)
            return
        self.add(kind, "forward", flops, forward)
        if not torch.is_grad_enabled():
            return
        if x_grad:
            self.add(kind, "backward", flops, y_bytes + w_bytes + x_bytes)
        if w_grad:
            self.add(kind, "backward", flops, y_bytes + x_bytes + w_bytes)

    def attention(self, q, k, v, out, flash: bool) -> None:
        """softmax(QKᵀ)V over BTHD q [N, T, H, D] and k, v [N, S, H, D]:
        two products of 2·N·H·T·S·D each. Its backward where q, k or v
        require grad: the flash path's plain backward recomputes the
        forward and runs all four products (dP, dV, dQ, dK); the plain
        path runs dP where q or k needs a gradient, and dV, dQ, dK where
        each does."""
        n, t, h, d = q.shape
        half = 2 * n * h * t * k.shape[1] * d
        io = _nbytes(q, k, v, out)
        if _in_backward():
            self.add("attention", "recompute", 2 * half, io)
            return
        self.add("attention", "forward", 2 * half, io)
        gq, gk, gv = _grad(q), _grad(k), _grad(v)
        if not (torch.is_grad_enabled() and (gq or gk or gv)):
            return
        if flash:
            self.add("attention", "recompute", 2 * half, io)
            self.add("attention", "backward", 4 * half,
                     _nbytes(out) + 2 * _nbytes(q, k, v))
            return
        products = (gq or gk) + gq + gk + gv
        written = sum(_nbytes(t) for t, g in ((q, gq), (k, gk), (v, gv)) if g)
        self.add("attention", "backward", products * half,
                 _nbytes(out, q, k, v) + written)


@contextlib.contextmanager
def _counting(modules: Iterable[nn.Module]):
    """Count what `modules` (and the attention and LoRA merge functions
    they call) compute inside the block: yields the `_Work`."""
    from polyp_tpu_torch.lora import surgery
    from polyp_tpu_torch.models import clip_text, unet_blocks
    from polyp_tpu_torch.models.efficientnet import ConvBNAct
    from polyp_tpu_torch.models.unet_blocks import FeedForward, GroupNorm
    from polyp_tpu_torch.ops.attention import use_flash

    work = _Work()
    modules = list(modules)
    # the GEGLU's own linears: counted by their FeedForward
    skip = {id(m.net[i].proj if i == 0 else m.net[i])
            for root in modules for m in root.modules()
            if isinstance(m, FeedForward) for i in (0, 2)}

    def conv_hook(m, inputs, out):
        x, w = inputs[0], m.weight
        flops = 2 * out.numel() * (m.in_channels // m.groups) * math.prod(
            m.kernel_size)
        work.product("conv", flops, _nbytes(x), _nbytes(w), _nbytes(out),
                     _grad(x), _grad(w), _nbytes(m.bias))

    def conv_bn_hook(m, inputs, out):
        # ConvBNAct runs its conv functionally, in the input's dtype
        x, c = inputs[0], m.conv
        e = x.element_size()
        flops = 2 * out.numel() * (c.in_channels // c.groups) * math.prod(
            c.kernel_size)
        work.product("conv", flops, _nbytes(x), c.weight.numel() * e,
                     out.numel() * e, _grad(x), _grad(c.weight))

    def linear_hook(m, inputs, out):
        if id(m) in skip:
            return
        x, w = inputs[0], m.weight
        flops = 2 * (x.numel() // m.in_features) * m.in_features \
            * m.out_features
        work.product("linear", flops, _nbytes(x), _nbytes(w), _nbytes(out),
                     _grad(x), _grad(w), _nbytes(m.bias))

    def ff_hook(m, inputs, out):
        x = inputs[0]
        proj, down = m.net[0].proj, m.net[2]
        e = proj.weight.element_size()
        rows = x.numel() // proj.in_features
        u_bytes = rows * down.in_features * e  # the gated activation
        w1_grad = _grad(proj.weight)
        work.product("geglu", 2 * rows * proj.in_features * proj.out_features,
                     rows * proj.in_features * e, _nbytes(proj.weight),
                     u_bytes, _grad(x), w1_grad, _nbytes(proj.bias))
        work.product("geglu", 2 * rows * down.in_features * down.out_features,
                     u_bytes, _nbytes(down.weight), _nbytes(out),
                     _grad(x) or w1_grad, _grad(down.weight),
                     _nbytes(down.bias))

    def gn_hook(m, inputs, out):
        x = inputs[0]  # no FLOPs: bytes only (dX where x needs one)
        work.product("group_norm", 0, _nbytes(x), 0, _nbytes(out), _grad(x),
                     False)

    attend = unet_blocks.dot_product_attention
    merge = surgery.apply_lora_to_kernels

    def counted_attention(q, k, v, mask=None, is_causal=False):
        out = attend(q, k, v, mask=mask, is_causal=is_causal)
        work.attention(q, k, v, out, use_flash(q, k, mask, is_causal))
        return out

    def counted_merge(kernels, adapter, scale, keep_masks=None, keep=1.0,
                      dtype=None):
        out = merge(kernels, adapter, scale, keep_masks, keep, dtype)
        for name, f in adapter.items():
            a, b = f["lora_A"], f["lora_B"]
            merged = out[f"{name}.weight"]
            work.product("lora_merge", 2 * a.shape[0] * a.shape[1]
                         * b.shape[1], _nbytes(a), _nbytes(b),
                         _nbytes(merged), _grad(a), _grad(b),
                         _nbytes(kernels[f"{name}.weight"]))
        return out

    handles = []
    for root in modules:
        for m in root.modules():
            if isinstance(m, ConvBNAct):
                handles.append(m.register_forward_hook(conv_bn_hook))
            elif isinstance(m, nn.Conv2d):
                handles.append(m.register_forward_hook(conv_hook))
            elif isinstance(m, nn.Linear):
                handles.append(m.register_forward_hook(linear_hook))
            elif isinstance(m, FeedForward):
                handles.append(m.register_forward_hook(ff_hook))
            elif isinstance(m, GroupNorm):
                handles.append(m.register_forward_hook(gn_hook))
    unet_blocks.dot_product_attention = counted_attention
    clip_text.dot_product_attention = counted_attention
    surgery.apply_lora_to_kernels = counted_merge
    try:
        yield work
    finally:
        unet_blocks.dot_product_attention = attend
        clip_text.dot_product_attention = attend
        surgery.apply_lora_to_kernels = merge
        for h in handles:
            h.remove()


def count_work(module: nn.Module, *args, **kwargs) -> dict:
    """FLOPs and bytes of one forward of `module` on `args`, counted from
    the shapes its convolutions, linears, attentions, GEGLU feed-forwards
    and GroupNorms are called at (the module runs once, under no_grad):
    {"flops", "bytes", "by_op": {kind: flops}, "by_pass"}."""
    with _counting([module]) as counter, torch.no_grad():
        module(*args, **kwargs)
    return counter.work


@contextlib.contextmanager
def _only_trained_require_grad(modules: Iterable[nn.Module],
                               trained: Iterable[torch.Tensor]):
    """The modules' parameters that are not in `trained` frozen for the
    block: then a tensor requires grad exactly where a gradient of a
    trained tensor flows through it, as autograd's backward computes."""
    keep = {id(t) for t in trained}
    frozen = [p for m in modules for p in m.parameters()
              if p.requires_grad and id(p) not in keep]
    for p in frozen:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in frozen:
            p.requires_grad_(True)


def count_step(step: Callable[[], object], modules: Iterable[nn.Module],
               trained: Iterable[torch.Tensor]) -> dict:
    """FLOPs and bytes of one train step: `step()` runs once with the
    counters on `modules` (module docstring). `trained` are the tensors
    the step's optimizer updates (its leaves: LoRA factors, masters, a
    model's parameters); each adds its fp32 optimizer bytes. Returns
    count_work's dict with "trained_elements" and "optimizer_bytes"."""
    modules, trained = list(modules), list(trained)
    with _only_trained_require_grad(modules, trained), \
            torch.utils.checkpoint.set_checkpoint_early_stop(False), \
            _counting(modules) as counter:
        step()
    elements = sum(t.numel() for t in trained)
    opt = OPTIMIZER_BYTES_PER_ELEMENT * elements
    counter.add("optimizer", "backward", 0, opt)
    return {**counter.work, "trained_elements": elements,
            "optimizer_bytes": opt}


def unet_step(unet: nn.Module, batch: int, latent: int, cfg: bool = True,
              context: tuple[int, int] = (77, 768), device="cuda") -> dict:
    """Counted work of one UNet forward at (2×)batch (`cfg`: the guided
    pair; False: a folded student's 1× batch) with a [tokens, width]
    text context."""
    n = 2 * batch if cfg else batch
    dtype = next(unet.parameters()).dtype
    x = torch.zeros((n, 4, latent, latent), dtype=dtype, device=device)
    t = torch.zeros((n,), dtype=torch.long, device=device)
    ctx = torch.zeros((n, *context), dtype=dtype, device=device)
    return count_work(unet, x, t, ctx)


def bench_conv(n: int, spatial: int, c: int, int8: bool,
               iters: int) -> dict:
    """A 3×3 stride-1 convolution at a UNet level: cuDNN in bf16, or the
    port's int8 conv (w8a8_conv, weights quantized once)."""
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.utils.profiling import graph_ms

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((n, c, spatial, spatial), generator=g, device=dev,
                    dtype=torch.bfloat16)
    w = (torch.randn((c, c, 3, 3), generator=g, device=dev)
         / math.sqrt(9 * c)).to(torch.bfloat16)
    if int8:
        q8 = quant.weight_q8_matrix(w)
        scale = quant.dynamic_scale(x)

        def fn():
            return quant.w8a8_conv(x, w, (1, 1), (1, 1), torch.bfloat16,
                                   scale, q8=q8)
    else:
        def fn():
            return torch.nn.functional.conv2d(x, w, padding=1)
    ms = graph_ms(fn, iters)
    flops = 2 * n * spatial * spatial * 9 * c * c
    return {"ms": ms, "tflops": flops / (ms / 1e3) / 1e12}


def conv_rates(n: int, image_size: int, iters: int,
               int8: bool = False) -> dict:
    """bench_conv at each level: {"{s}x{s}x{c}": bf16 (and int8) rates}."""
    out = {}
    for spatial, c in levels(image_size):
        key = f"{spatial}x{spatial}x{c}"
        out[key] = ({"bf16": bench_conv(n, spatial, c, False, iters),
                     "int8": bench_conv(n, spatial, c, True, iters)}
                    if int8 else bench_conv(n, spatial, c, False, iters))
        print(f"# conv {key} at batch {n}: {out[key]}", flush=True)
    return out


def bench_attention(n: int, tokens: int, head_dim: int,
                    iters: int) -> dict:
    """The port's flash attention (self-attention, BTHD) at a level's
    token count."""
    from polyp_tpu_torch.ops.flash_attention import flash_attention
    from polyp_tpu_torch.utils.profiling import graph_ms

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn((n, tokens, HEADS, head_dim), generator=g,
                           device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    ms = graph_ms(lambda: flash_attention(q, k, v), iters)
    flops = 4 * n * HEADS * tokens * tokens * head_dim
    return {"ms": ms, "tflops": flops / (ms / 1e3) / 1e12}


def vae_decode(vae: nn.Module, batch: int, latent: int, iters: int) -> dict:
    """The VAE decode's counted work and device time at `batch`."""
    from polyp_tpu_torch.utils.profiling import graph_ms

    dev = torch.device("cuda")
    z = torch.randn((batch, 4, latent, latent), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    work = count_work(_Decode(vae), z)
    with torch.no_grad():
        ms = graph_ms(lambda: vae.decode(z), iters)
    return {"ms": ms, "flops": work["flops"], "bytes": work["bytes"],
            "tflops": work["flops"] / (ms / 1e3) / 1e12, "batch": batch}


class _Decode(nn.Module):
    """The VAE's decode as a module's forward, for `count_work`."""

    def __init__(self, vae: nn.Module):
        super().__init__()
        self.vae = vae

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z)


def card() -> str:
    from polyp_tpu_torch.tools.profile_census import card as name
    return name()


def floors_ms(work: dict, best_tflops: float) -> dict:
    """A step's floors: its FLOPs at the best measured bf16 conv rate and
    at the bf16 peak, its bytes at the HBM peak."""
    return {"flops_at_best_measured_bf16_conv": work["flops"]
            / (best_tflops * 1e12) * 1e3,
            "flops_at_peak_bf16": work["flops"] / (PEAK_BF16_TFLOPS * 1e12)
            * 1e3,
            "bytes_at_hbm_peak": work["bytes"] / (HBM_GBPS * 1e9) * 1e3}


def measured_samples_per_s(stack, batch: int, steps: int,
                           image_size: int = 256) -> dict:
    """The CFG sampler (DDIM, `steps` steps, batch `batch`) end to end on
    the card: samples/s over two timed batches after one warm-up."""
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.configs import DiffusionConfig

    cfg = DiffusionConfig(image_size=image_size, num_inference_steps=steps,
                          sampler="ddim")
    fn = make_sampler(stack, cfg).for_prompt(PROMPT)
    fn(batch, 0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for seed in (1, 2):
        fn(batch, seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return {"samples_per_s": 2 * batch / seconds, "sampler": "ddim",
            "steps": steps, "batch": batch, "clock": "host, synchronised"}


def run(batch: int = 16, steps: int = 50, iters: int = 20,
        measure: bool = True, image_size: int = 256) -> dict:
    from polyp_tpu_torch.cli.common import load_sd_stack

    latent = image_size // 8
    report: dict = {"card": card(), "batch": batch, "steps": steps,
                    "image_size": image_size, "peaks": PEAKS}
    cfg_batch = 2 * batch
    convs = conv_rates(cfg_batch, image_size, iters, int8=True)
    report["conv_rates"] = convs

    attn = {}
    for spatial, c in levels(image_size)[:3]:
        tokens = spatial * spatial
        attn[f"{tokens}tok"] = bench_attention(cfg_batch, tokens,
                                               c // HEADS, iters)
        print(f"# flash attention {tokens} tokens: {attn[f'{tokens}tok']}",
              flush=True)
    report["attention"] = attn

    stack = load_sd_stack(device="cuda")
    report["unet_cfg_step"] = unet_step(stack.unet, batch, latent, True)
    report["unet_folded_step"] = unet_step(stack.unet, batch, latent, False)
    report["vae_decode"] = vae_decode(stack.vae, batch, latent, 3)
    print(f"# unet CFG step: {report['unet_cfg_step']}", flush=True)
    print(f"# vae decode: {report['vae_decode']}", flush=True)

    best_bf16 = max(v["bf16"]["tflops"] for v in convs.values())
    best_int8 = max(v["int8"]["tflops"] for v in convs.values())
    floors = {}
    for name in ("unet_cfg_step", "unet_folded_step"):
        work = report[name]
        floors[name] = {
            **floors_ms(work, best_bf16),
            "flops_at_best_measured_int8_conv": work["flops"]
            / (best_int8 * 1e12) * 1e3}
    vae = report["vae_decode"]
    floors["vae_decode"] = {
        "floor": max(vae["flops"] / (PEAK_BF16_TFLOPS * 1e12),
                     vae["bytes"] / (HBM_GBPS * 1e9)) * 1e3,
        "measured": vae["ms"]}
    floors["attention_measured_per_step"] = sum(v["ms"]
                                                for v in attn.values())
    report["floors_ms"] = floors

    def per_step(name, rate_key):
        f = floors[name]
        return max(f[rate_key], f["bytes_at_hbm_peak"])

    def ceiling(step_ms, n_steps):
        return batch / ((n_steps * step_ms + vae["ms"]) / 1e3)

    report["ceiling_samples_per_s"] = {
        "cfg_bf16_at_peak": ceiling(per_step("unet_cfg_step",
                                             "flops_at_peak_bf16"), steps),
        "cfg_bf16_at_best_conv": ceiling(per_step(
            "unet_cfg_step", "flops_at_best_measured_bf16_conv"), steps),
        "cfg_int8_at_best_conv": ceiling(per_step(
            "unet_cfg_step", "flops_at_best_measured_int8_conv"), steps),
        "folded_bf16_at_peak_4_steps": ceiling(per_step(
            "unet_folded_step", "flops_at_peak_bf16"), 4),
    }
    if measure:
        report["measured"] = measured_samples_per_s(stack, batch, steps,
                                                    image_size)
        report["measured"]["pct_of_cfg_bf16_ceiling_at_peak"] = (
            100 * report["measured"]["samples_per_s"]
            / report["ceiling_samples_per_s"]["cfg_bf16_at_peak"])
    return report


def run_fewstep(batch: int = 16, image_size: int = 256, iters: int = 20,
                step_counts: tuple[int, ...] = (4, 8, 25)) -> dict:
    """Folded-guidance few-step sampling (distilled students): a sample
    costs steps × the 1×-batch UNet step + the VAE decode. The step's
    counted work, the conv rates at 1× batch, the decode counted and
    measured, and for each step count the analytic ceiling, the ceiling
    with the measured decode and the decode's share at the floor."""
    from polyp_tpu_torch.cli.common import load_sd_stack

    latent = image_size // 8
    report: dict = {"card": card(), "mode": "folded_cfg_1x_batch",
                    "batch": batch, "image_size": image_size,
                    "peaks": PEAKS}
    stack = load_sd_stack(device="cuda")
    step = report["unet_1x_step"] = unet_step(stack.unet, batch, latent,
                                              cfg=False)
    print(f"# unet 1x step: {step}", flush=True)
    convs = report["conv_rates_1x"] = conv_rates(batch, image_size, iters)
    best = max(v["tflops"] for v in convs.values())
    vae = report["vae_decode"] = vae_decode(stack.vae, batch, latent, 3)
    print(f"# vae decode: {vae}", flush=True)
    step_floors = floors_ms(step, best)
    step_floor = max(step_floors["flops_at_best_measured_bf16_conv"],
                     step_floors["bytes_at_hbm_peak"])
    vae_floor = max(vae["flops"] / (best * 1e12),
                    vae["bytes"] / (HBM_GBPS * 1e9)) * 1e3
    report["floors_ms"] = {"unet_1x_step": step_floors,
                           "unet_1x_step_floor": step_floor,
                           "vae_decode_floor": vae_floor,
                           "vae_decode_measured": vae["ms"]}
    report["fewstep_ceilings"] = {str(n): {
        "samples_per_s_analytic": batch / ((n * step_floor + vae_floor)
                                           / 1e3),
        "samples_per_s_measured_decode": batch / ((n * step_floor
                                                   + vae["ms"]) / 1e3),
        "vae_share_at_floor": vae["ms"] / (n * step_floor + vae["ms"]),
    } for n in step_counts}
    return report


def timed_steps(step: Callable[[int], object], n: int) -> list[float]:
    """Host seconds of `n` steps, each synchronised before and after."""
    out = []
    for i in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - start)
    return out


def step_report(work: dict, batch: int, best_tflops: float,
                seconds: list[float]) -> dict:
    """A training step's counted work, floors, ceiling and measured rate
    (the mean of steps 2.. of `seconds`)."""
    floors = floors_ms(work, best_tflops)
    floors["optimizer_bytes_at_hbm_peak"] = (
        work["optimizer_bytes"] / (HBM_GBPS * 1e9) * 1e3)
    ceiling = batch / (max(floors["flops_at_best_measured_bf16_conv"],
                           floors["bytes_at_hbm_peak"]) / 1e3)
    step_s = sum(seconds[1:]) / len(seconds[1:])
    measured = batch / step_s
    return {**work, "batch": batch, "floors_ms": floors,
            "ceiling_images_per_s": ceiling,
            "ceiling_images_per_s_at_peak": batch / (max(
                floors["flops_at_peak_bf16"], floors["bytes_at_hbm_peak"])
                / 1e3),
            "step_s": step_s, "first_step_s": seconds[0],
            "measured_images_per_s": measured,
            "pct_of_ceiling": 100 * measured / ceiling,
            "clock": "host, synchronised, steps 2.."}


def run_train(sd_batch: int = 8, sd_image_size: int = 256,
              cls_batch: int = 16, cls_image_size: int = 224,
              iters: int = 20, train_steps: int = 6) -> dict:
    """The training paths: the SD LoRA step (the reference's run_train
    configuration: batch 8, rank 8, alpha 8, no dropout, the attention
    projections) and the classifier step (B0, batch 16, 224 px), each
    counted (`count_step`) and timed over `train_steps` steps; the floors
    at the best bf16 conv rate measured at the SD batch."""
    import numpy as np

    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.sd_common import make_components
    from polyp_tpu_torch.configs import ClassificationConfig, DiffusionConfig
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.lora.surgery import LoRAConfig, init_lora
    from polyp_tpu_torch.train import classifier as tc
    from polyp_tpu_torch.train import sd_finetune as sf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    dev = torch.device("cuda")
    report: dict = {"card": card(), "mode": "train", "peaks": PEAKS}
    best = max(v["tflops"] for v in conv_rates(
        sd_batch, sd_image_size, iters).values())
    report["best_conv_tflops_sd_batch"] = best

    stack = load_sd_stack(device="cuda")
    cfg = DiffusionConfig(image_size=sd_image_size,
                          train_batch_size=sd_batch).with_schedule(100)
    lcfg = LoRAConfig(rank=8, alpha=8.0, dropout=0.0)
    trainable = sf.init_trainable(init_lora(
        stack.unet, lcfg, torch.Generator(dev).manual_seed(1)))
    frozen = make_components(stack, trainable)
    state = sf.create_sd_train_state(cfg, trainable)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (sd_batch, sd_image_size, sd_image_size, 3),
        dtype=np.uint8)).to(dev)
    ids = torch.as_tensor(stack.tokenizer([PROMPT]), device=dev)

    def lora_step(i):
        return sf.sd_lora_train_step(state, frozen, schedule, images, ids,
                                     None, sf.step_draws(0, 0, i, dev), lcfg)

    work = count_step(lambda: lora_step(0), (stack.unet, stack.vae,
                                             stack.text),
                      tree_leaves(state.trainable))
    sd = report["sd_lora_step"] = {
        "image_size": sd_image_size, "lora_rank": 8,
        **step_report(work, sd_batch, best, timed_steps(
            lambda i: lora_step(i + 1), train_steps))}
    print(f"# sd lora step: {_brief(sd)}", flush=True)
    del state, frozen, stack, trainable
    torch.cuda.empty_cache()

    ccfg = ClassificationConfig(image_size=cls_image_size,
                                batch_size=cls_batch)
    cstate = tc.create_classifier_state(ccfg, 3, dev)
    cimages = torch.from_numpy(rng.integers(
        0, 256, (cls_batch, cls_image_size, cls_image_size, 3),
        dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 3, cls_batch)).to(dev)

    def cls_step(i):
        return tc.train_step(cstate, cimages, labels, tc.step_draws(
            0, 0, i, cstate.model, cls_batch, dev))

    work = count_step(lambda: cls_step(0), [cstate.model],
                      list(cstate.model.parameters()))
    cls = report["classifier_step"] = {
        "image_size": cls_image_size, "variant": ccfg.variant,
        **step_report(work, cls_batch, best, timed_steps(
            lambda i: cls_step(i + 1), train_steps)),
        "note": "B0's depthwise convs run far below the conv rate, so "
                "the FLOP floor is an underestimate; the bytes floor is "
                "the binding one"}
    print(f"# classifier step: {_brief(cls)}", flush=True)
    return report


def run_distill(batch: int = 8, image_size: int = 256, iters: int = 20,
                train_steps: int = 6, student_steps: int = 20,
                guidance_scale: float = 7.5) -> dict:
    """The distill phase step (the reference's run_distill and the port's
    cli/bench.py::bench_distill_train: the 40 → 20 phase, CFG 7.5 folded,
    adamw 1e-4 with weight decay 1e-2 behind the global-norm clip, at
    full SD size): train/distill.py::make_distill_step over
    make_applies' teacher (the CFG pair at 2× batch, under no_grad, two
    substeps) and student (fp32 masters of every UNet parameter), counted
    and timed, with the minutes a 2,000-step phase takes at that rate."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.train import distill as td
    from polyp_tpu_torch.train.sd_finetune import SDOptimizer

    dev = torch.device("cuda")
    report: dict = {"card": card(), "mode": "distill_train",
                    "batch": batch, "image_size": image_size,
                    "student_steps": student_steps, "peaks": PEAKS}
    best = max(v["tflops"] for v in conv_rates(batch, image_size,
                                               iters).values())
    report["best_conv_tflops"] = best
    unet = load_sd_stack(device="cuda").unet
    gen = torch.Generator(dev).manual_seed(1)
    cond, uncond = (torch.randn((1, 77, 768), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
    applies = td.make_applies(unet, guidance_scale, cond, uncond)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)
    step = td.make_distill_step(applies.student, applies.teacher, schedule,
                                schedule, td.distill_grid(schedule,
                                                          student_steps))
    teacher = {k: p.detach() for k, p in unet.named_parameters()}
    state = td.init_distill_state(
        {k: p.float() for k, p in teacher.items()},
        SDOptimizer(lambda count: 1e-4))
    latent = image_size // 8
    x0 = torch.randn((batch, 4, latent, latent), generator=gen, device=dev)

    def distill_step(i):
        return step(state, teacher, x0, td.distill_draws("phase", 0, i, dev))

    work = count_step(lambda: distill_step(0), [unet],
                      list(state.params.values()))
    out = report["distill_step"] = {
        **step_report(work, batch, best, timed_steps(
            lambda i: distill_step(i + 1), train_steps)),
        "optimizer": "adamw (SDOptimizer)"}
    out["minutes_per_2000step_phase"] = 2000 * out["step_s"] / 60
    print(f"# distill step: {_brief(out)}", flush=True)
    return report


def _brief(step: dict) -> dict:
    return {k: step[k] for k in ("flops", "bytes", "floors_ms",
                                 "ceiling_images_per_s",
                                 "measured_images_per_s", "pct_of_ceiling")}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--image-size", type=int, default=256,
                        help="image size in px (latent = size / 8)")
    parser.add_argument("--few-step", action="store_true",
                        help="folded-guidance few-step sampling: the 1x-batch "
                             "UNet step and the VAE decode's share "
                             "(run_fewstep)")
    parser.add_argument("--train", action="store_true",
                        help="the training paths: the SD LoRA step (batch 8) "
                             "and the classifier step (batch 16, 224 px), "
                             "floors against the measured rate (run_train)")
    parser.add_argument("--distill", action="store_true",
                        help="the distill phase step: the teacher's two CFG "
                             "substeps and the full-parameter student, the "
                             "measured rate against its ceiling and the "
                             "minutes of a 2,000-step phase (run_distill)")
    parser.add_argument("--iters", type=int, default=20,
                        help="calls a CUDA graph holds, a timing")
    parser.add_argument("--train-steps", type=int, default=6,
                        help="steps a training mode runs after the counted "
                             "one; the first is a warm-up, the rest timed")
    parser.add_argument("--no-measure", action="store_true",
                        help="skip the end-to-end sampling rate")
    parser.add_argument("--out", type=str, default=None,
                        help="write the JSON report here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the roofline measures the card and no card is "
                         "present")
    levels(args.image_size)  # refuse a size the levels cannot take
    if args.distill:
        # the sampling default (--batch 16) is not the distill
        # configuration; 8 is the reference's train batch
        report = run_distill(8 if args.batch == 16 else args.batch,
                             args.image_size, args.iters, args.train_steps)
    elif args.train:
        report = run_train(sd_image_size=args.image_size, iters=args.iters,
                           train_steps=args.train_steps)
    elif args.few_step:
        report = run_fewstep(args.batch, args.image_size, args.iters)
    else:
        report = run(args.batch, args.steps, args.iters,
                     not args.no_measure, args.image_size)
    text = json.dumps(report)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return report


if __name__ == "__main__":
    main()
