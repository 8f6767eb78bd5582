#!/usr/bin/env python3
"""Which convolutions of the port give one sample different bits in
different batch slots on the card (the serving contract's enemy,
polyp_tpu_torch/ops/conv.py), and what the slot-invariant form costs.

    python3 tools/conv_slots.py          # card only, about 40 s

For every conv shape of the full-width SD-v1-4 UNet (at the serving
batches 8, 16 and 32) and VAE decoder (at 8), random weights from seed 0,
bf16: a batch of one random sample repeated through cuDNN (F.conv2d) and
through ops.conv.conv2d_unfold; a shape is slot-dependent where some slot's
output differs from slot 0's. Prints each slot-dependent shape, the summed
device time (CUDA events) of each form over all shapes, and one UNet
forward (batches 16 and 8) and one VAE decode (batch 8) with every conv in
each form. Prints the card's name and power limit; fails without a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCHES = {"unet": (8, 16, 32), "vae": (8,)}


def device_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_slots: no CUDA device", file=sys.stderr)
        return 1
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.models.unet_blocks import Conv2d
    from polyp_tpu_torch.ops.conv import conv2d_unfold

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stack = load_sd_stack(None, dtype=torch.bfloat16, seed=0)
    shapes: dict[tuple, nn.Conv2d] = {}

    def grab(tag):
        def hook(m, args, out):
            key = (tag, tuple(m.weight.shape), tuple(args[0].shape[1:]),
                   m.stride, m.padding)
            shapes.setdefault(key, m)
        return hook

    hooks = [m.register_forward_hook(grab(tag))
             for tag, model in (("unet", stack.unet), ("vae", stack.vae))
             for m in model.modules() if isinstance(m, nn.Conv2d)]
    with torch.no_grad():
        stack.unet(torch.randn(2, 4, 32, 32, device=dev),
                   torch.full((2,), 500, device=dev),
                   torch.randn(2, 77, 768, device=dev, dtype=torch.bfloat16))
        stack.vae.decode(torch.randn(1, 4, 32, 32, device=dev,
                                     dtype=torch.bfloat16))
    for h in hooks:
        h.remove()

    forms = {"cudnn": lambda x, w, b, s, p: F.conv2d(x, w, b, s, p),
             "unfold": conv2d_unfold}
    gen = torch.Generator(dev).manual_seed(0)
    print(f"[card] {card}; {len(shapes)} conv shapes", flush=True)
    for name, form in forms.items():
        dependent, total_ms = [], 0.0
        for (tag, ws, xs, stride, pad), m in shapes.items():
            w = m.weight.to(torch.bfloat16)
            b = None if m.bias is None else m.bias.to(torch.bfloat16)
            for n in BATCHES[tag]:
                one = torch.randn((1, *xs), generator=gen, device=dev)
                x = one.to(torch.bfloat16).expand(n, *xs).contiguous()
                with torch.no_grad():
                    y = form(x, w, b, stride, pad)
                    total_ms += device_ms(lambda: form(x, w, b, stride, pad))
                if not bool((y == y[:1]).all()):
                    dependent.append((tag, n, ws, xs, stride))
        print(f"[{name}] slot-dependent shapes: {len(dependent)} of "
              f"{sum(len(BATCHES[k[0]]) for k in shapes)}; summed device "
              f"time {total_ms:.3f} ms on {card}", flush=True)
        for row in dependent:
            print(f"    {row}", flush=True)

    original = Conv2d._conv_forward
    try:
        for name, form in forms.items():
            Conv2d._conv_forward = (
                lambda self, x, w, b, form=form: form(x, w, b, self.stride,
                                                      self.padding))
            with torch.no_grad():
                for n in (16, 8):
                    x = torch.randn(n, 4, 32, 32, device=dev)
                    t = torch.full((n,), 500, device=dev)
                    ctx = torch.randn(n, 77, 768, device=dev,
                                      dtype=torch.bfloat16)
                    ms = device_ms(lambda: stack.unet(x, t, ctx), 5)
                    print(f"[{name}] UNet forward, batch {n}: {ms:.2f} ms "
                          f"(CUDA events around eager calls) on {card}",
                          flush=True)
                z = torch.randn(8, 4, 32, 32, device=dev, dtype=torch.bfloat16)
                ms = device_ms(lambda: stack.vae.decode(z), 3)
                print(f"[{name}] VAE decode, batch 8: {ms:.2f} ms on {card}",
                      flush=True)
    finally:
        Conv2d._conv_forward = original
    return 0


if __name__ == "__main__":
    sys.exit(main())
