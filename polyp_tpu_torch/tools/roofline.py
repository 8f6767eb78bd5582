"""Roofline of the 256 px SD sampling step on the card: the twin of
tools/roofline.py, with the H100's peaks in place of the TPU's.

It measures, on the card, (a) the 3×3 convolutions of each UNet level in
bf16 (cuDNN) and through the port's int8 conv (ops/quant.py::w8a8_conv),
(b) the port's flash attention at each level's token count, (c) the VAE
decode, and counts (d) the FLOPs and bytes of one CFG UNet step (2×batch)
and one folded step (1×batch, a distilled student's). It prints the
per-step floors and the samples/s ceilings beside the measured sampling
rate, in one JSON report with the card's name and power limit.

    python -m polyp_tpu_torch.tools.roofline [--batch 16] [--steps 50]
        [--iters 20] [--out report.json]

Counting (`count_work`): torch's FlopCounterMode does not see the port's
kernels (ctypes calls), so the work is counted from the shapes each module
is called at, by forward hooks: every convolution and linear, the
attention products (QKᵀ and PV, 4·N·T·S·inner) and the GEGLU
feed-forward's two products. FLOPs count the products only, as
FlopCounterMode does (GroupNorm and elementwise work is not in them);
bytes are each counted op's inputs, weights and outputs, read and written
once (GroupNorms included), as an unfused graph moves them. Times are
device times from CUDA graph replays (utils/profiling.py::graph_ms).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch
from torch import nn

# the H100 SXM's dense peaks (NVIDIA's data sheet), as PERF.md's kernel
# table and chip_smoke.py's bounds take them
PEAK_BF16_TFLOPS = 989.0
PEAK_INT8_TOPS = 1979.0
HBM_GBPS = 3350.0

# SD UNet levels at 32×32 latents: (spatial, channels); level 3 shares
# level 2's width and has no attention
LEVELS = [(32, 320), (16, 640), (8, 1280), (4, 1280)]
HEADS = 8


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def count_work(module: nn.Module, *args, **kwargs) -> dict:
    """FLOPs and bytes of one forward of `module` on `args`, counted from
    the shapes its convolutions, linears, attentions, GEGLU feed-forwards
    and GroupNorms are called at (the module runs once, under no_grad):
    {"flops", "bytes", "by_op": {kind: flops}}."""
    from polyp_tpu_torch.models.unet_blocks import (
        Attention, FeedForward, GroupNorm)

    skip = set()  # the GEGLU's own linears: counted by their FeedForward
    for m in module.modules():
        if isinstance(m, FeedForward):
            skip.update({id(m.net[0].proj), id(m.net[2])})
    work = {"flops": 0, "bytes": 0, "by_op": {}}

    def add(kind, flops, n_bytes):
        work["flops"] += flops
        work["bytes"] += n_bytes
        work["by_op"][kind] = work["by_op"].get(kind, 0) + flops

    def conv_hook(m, inputs, out):
        x = inputs[0]
        k = m.kernel_size[0] * m.kernel_size[1]
        add("conv", 2 * out.numel() * (m.in_channels // m.groups) * k,
            _nbytes(x, m.weight, m.bias, out))

    def linear_hook(m, inputs, out):
        if id(m) in skip:
            return
        x = inputs[0]
        add("linear", 2 * (x.numel() // m.in_features) * m.in_features
            * m.out_features, _nbytes(x, m.weight, m.bias, out))

    def attention_hook(m, inputs, out):
        x = inputs[0]
        if x.ndim == 4:  # SpatialSelfAttention: NCHW tokens
            n, t = x.shape[0], x.shape[2] * x.shape[3]
        else:
            n, t = x.shape[0], x.shape[1]
        ctx = inputs[1] if len(inputs) > 1 and inputs[1] is not None else None
        s = t if ctx is None else ctx.shape[1]
        inner = m.heads * m.head_dim
        add("attention", 4 * n * t * s * inner,
            2 * (n * t * inner + 2 * n * s * inner) * x.element_size())

    def ff_hook(m, inputs, out):
        x = inputs[0]
        proj, down = m.net[0].proj, m.net[2]
        rows = x.numel() // proj.in_features
        add("geglu", 2 * rows * proj.in_features * proj.out_features
            + 2 * rows * down.in_features * down.out_features,
            _nbytes(x, proj.weight, proj.bias, down.weight, down.bias, out))

    def gn_hook(m, inputs, out):
        add("group_norm", 0, _nbytes(inputs[0], out))

    handles = []
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            handles.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, nn.Linear):
            handles.append(m.register_forward_hook(linear_hook))
        elif isinstance(m, FeedForward):
            handles.append(m.register_forward_hook(ff_hook))
        elif isinstance(m, GroupNorm):
            handles.append(m.register_forward_hook(gn_hook))
        if isinstance(m, Attention):
            handles.append(m.register_forward_hook(attention_hook))
    try:
        with torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return work


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


def measured_samples_per_s(stack, batch: int, steps: int) -> dict:
    """The CFG sampler (DDIM, `steps` steps, batch `batch`, 256 px) end to
    end on the card: samples/s over two timed batches after one warm-up."""
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.configs import DiffusionConfig

    cfg = DiffusionConfig(image_size=256, num_inference_steps=steps,
                          sampler="ddim")
    fn = make_sampler(stack, cfg).for_prompt(
        "a realistic photo of colon polyp")
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
        measure: bool = True) -> dict:
    from polyp_tpu_torch.cli.common import load_sd_stack

    latent = 32
    report: dict = {"card": card(), "batch": batch, "steps": steps,
                    "image_size": 256,
                    "peaks": {"bf16_tflops": PEAK_BF16_TFLOPS,
                              "int8_tops": PEAK_INT8_TOPS,
                              "hbm_gbps": HBM_GBPS}}
    cfg_batch = 2 * batch
    convs = {}
    for spatial, c in LEVELS:
        key = f"{spatial}x{spatial}x{c}"
        convs[key] = {"bf16": bench_conv(cfg_batch, spatial, c, False,
                                         iters),
                      "int8": bench_conv(cfg_batch, spatial, c, True,
                                         iters)}
        print(f"# conv {key}: {convs[key]}", flush=True)
    report["conv_rates"] = convs

    attn = {}
    for spatial, c in LEVELS[:3]:
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
            "flops_at_peak_bf16": work["flops"] / (PEAK_BF16_TFLOPS * 1e12)
            * 1e3,
            "flops_at_best_measured_bf16_conv": work["flops"]
            / (best_bf16 * 1e12) * 1e3,
            "flops_at_best_measured_int8_conv": work["flops"]
            / (best_int8 * 1e12) * 1e3,
            "bytes_at_hbm_peak": work["bytes"] / (HBM_GBPS * 1e9) * 1e3,
        }
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
        report["measured"] = measured_samples_per_s(stack, batch, steps)
        report["measured"]["pct_of_cfg_bf16_ceiling_at_peak"] = (
            100 * report["measured"]["samples_per_s"]
            / report["ceiling_samples_per_s"]["cfg_bf16_at_peak"])
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--iters", type=int, default=20,
                        help="calls a CUDA graph holds, a timing")
    parser.add_argument("--no-measure", action="store_true",
                        help="skip the end-to-end sampling rate")
    parser.add_argument("--out", type=str, default=None,
                        help="write the JSON report here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the roofline measures the card and no card is "
                         "present")
    report = run(args.batch, args.steps, args.iters, not args.no_measure)
    text = json.dumps(report)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return report


if __name__ == "__main__":
    main()
