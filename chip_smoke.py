#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`polyp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases; any failure raises and exits non-zero, and no phase's failure is
caught:

1. a CUDA card is required; prints its name and power limit (nvidia-smi);
2. builds the hand-written kernels from polyp_tpu_torch/csrc/ and prints
   the build seconds;
3. holds each kernel (flash attention, fused GEGLU, GroupNorm+SiLU) against
   its plain PyTorch version at the main path's shapes: both in bf16,
   measured against the plain version in fp32 on the same inputs, with the
   tolerance in TOLERANCE; prints both times from CUDA events;
4. drives the main path: the full-width SD-v1-4 stack (UNet 859,520,964
   params, VAE decoder, CLIP ViT-L/14 text encoder; bf16, random weights
   from seed 0) → StableDiffusionSampler (256px, 20 DDIM steps, CFG 7.5)
   → generate_to_dir of 4 images at batch 2. Requires finite images, 4
   PNGs of 256×256×3, and every kernel's launch count above zero;
5. holds one UNet forward and one VAE decode on the card (bf16, kernels)
   against the same weights run on the CPU in fp32 (plain versions), by
   relative L2 error;
6. prints the kernel table as one JSON line, the card line, and last the
   result line {"ok": true, "device": {...}}.

TF32 is off for every comparison. Details of each check go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PROMPT = "a colonoscopy image of an adenomatous polyp"
SD14_UNET_PARAMS = 859_520_964
# max |kernel(bf16) - plain(fp32)| over the output. The outputs are O(1);
# bf16 keeps 8 bits, so output rounding alone reaches ~0.016 near |y| = 4,
# and the GEGLU also rounds its hidden activation to bf16 before the second
# product, as the TPU kernel does. A wrong tile or mask gives O(1) errors.
TOLERANCE = {"flash_attention": 2e-2, "fused_geglu": 6e-2,
             "fused_group_norm": 6e-2}
# relative L2 of a whole bf16 forward on the card vs fp32 on the CPU
REL_L2_TOLERANCE = 5e-2


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, kernel_fn, plain_fn, fp32_ref: torch.Tensor,
            shape: str) -> dict:
    out = kernel_fn()
    torch.cuda.synchronize()
    err = (out.float() - fp32_ref).abs().max().item()
    plain_err = (plain_fn().float() - fp32_ref).abs().max().item()
    row = {"name": name, "shape": shape, "max_abs_err": err,
           "plain_bf16_max_abs_err": plain_err, "tolerance": TOLERANCE[name],
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn)}
    print(f"[check] {name} {shape}: max|err| {err:.3e} (plain bf16 "
          f"{plain_err:.3e}, tol {TOLERANCE[name]:.0e}); kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms", flush=True)
    if not err <= TOLERANCE[name]:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version: {err} > {TOLERANCE[name]}")
    return row


def check_kernels(dev: torch.device) -> list[dict]:
    from polyp_tpu_torch.ops.flash_attention import (
        flash_attention, reference_attention)
    from polyp_tpu_torch.ops.fused_geglu import fused_geglu, reference_geglu
    from polyp_tpu_torch.ops.fused_gn import fused_group_norm, group_norm

    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                + shift).to(torch.bfloat16)

    rows = []
    # level-0 self-attention at 256px, batch 2 under CFG: [4, 1024, 8, 40]
    q, k, v = (randn(4, 1024, 8, 40) for _ in range(3))
    rows.append(compare(
        "flash_attention", lambda: flash_attention(q, k, v),
        lambda: reference_attention(q, k, v),
        reference_attention(q.float(), k.float(), v.float()),
        "[4,1024,8,40]"))

    # transformer FF per UNet level (tokens = 4 x H x W at 256px) and mid
    for c, tokens in ((320, 4096), (640, 1024), (1280, 256), (1280, 64)):
        h = 4 * c
        x = randn(4, tokens // 4, c)
        w1, b1 = randn(2 * h, c, scale=c ** -0.5), randn(2 * h, scale=0.1)
        w2, b2 = randn(c, h, scale=h ** -0.5), randn(c, scale=0.1)
        args = (x, w1, b1, w2, b2)
        rows.append(compare(
            "fused_geglu", lambda: fused_geglu(*args),
            lambda: reference_geglu(*args),
            reference_geglu(*(t.float() for t in args)),
            f"[{tokens},{c}]x[{c},{2 * h}]"))

    # GN+SiLU: UNet level widths (incl. the up path's concat widths) and the
    # VAE decoder's largest tensor
    for n, c, hw, eps in ((4, 320, 32, 1e-5), (4, 960, 32, 1e-5),
                          (4, 640, 16, 1e-5), (4, 1280, 8, 1e-5),
                          (4, 2560, 4, 1e-5), (2, 512, 32, 1e-6),
                          (2, 128, 256, 1e-6)):
        x = randn(n, c, hw, hw, scale=2.0, shift=0.3)
        gamma = randn(c, scale=0.1, shift=1.0).float()
        beta = randn(c, scale=0.1).float()
        rows.append(compare(
            "fused_group_norm",
            lambda: fused_group_norm(x, gamma, beta, 32, eps, "silu"),
            lambda: group_norm(x, gamma, beta, 32, eps, "silu"),
            group_norm(x.float(), gamma, beta, 32, eps, "silu"),
            f"[{n},{c},{hw},{hw}]"))
    return rows


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


def check_against_cpu(stack, dev: torch.device) -> dict:
    """One UNet forward (latents 32×32, CFG batch 2) and one VAE decode
    (8×8 latents) with the kernels, vs the same weights in fp32 on the CPU
    running the plain versions."""
    from polyp_tpu_torch.models import AutoencoderKL, sd14_unet

    g = torch.Generator("cpu").manual_seed(1)
    x = torch.randn(2, 4, 32, 32, generator=g)
    t = torch.tensor([981, 981])
    ctx = torch.randn(2, 77, 768, generator=g)
    z = torch.randn(1, 4, 8, 8, generator=g)

    unet_cpu = sd14_unet(torch.float32, device="meta").to_empty(device="cpu")
    unet_cpu.load_state_dict(stack.unet.state_dict())
    vae_cpu = AutoencoderKL(dtype=torch.float32, device="meta")
    vae_cpu = vae_cpu.to_empty(device="cpu")
    vae_cpu.load_state_dict(stack.vae.state_dict())
    with torch.no_grad():
        want_unet = unet_cpu(x, t, ctx)
        want_img = vae_cpu.decode(z)
        got_unet = stack.unet(x.to(dev), t.to(dev), ctx.to(dev))
        got_img = stack.vae.decode(z.to(dev))
    out = {"unet_rel_l2": rel_l2(got_unet, want_unet),
           "vae_rel_l2": rel_l2(got_img, want_img)}
    print(f"[check] card bf16 vs cpu fp32: UNet rel L2 "
          f"{out['unet_rel_l2']:.3e}, VAE decode rel L2 "
          f"{out['vae_rel_l2']:.3e} (tol {REL_L2_TOLERANCE:.0e})", flush=True)
    for key, val in out.items():
        if not val <= REL_L2_TOLERANCE:
            raise AssertionError(f"{key} {val} > {REL_L2_TOLERANCE}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from polyp_tpu_torch import _build
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.ops.flash_attention import flash_attention
    from polyp_tpu_torch.ops.fused_geglu import fused_geglu
    from polyp_tpu_torch.ops.fused_gn import fused_group_norm
    from polyp_tpu_torch.pipeline import (
        StableDiffusionSampler, generate_to_dir)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {lib_path.name} in {build_s:.1f} s", flush=True)
    log = lib_path.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    kernels = {"flash_attention": flash_attention, "fused_geglu": fused_geglu,
               "fused_group_norm": fused_group_norm}
    with torch.no_grad():
        rows = check_kernels(dev)

    stack = load_sd_stack(None, dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in stack.unet.parameters())
    if n_params != SD14_UNET_PARAMS:
        raise AssertionError(f"UNet has {n_params} params")
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085, 0.012)
    sampler = StableDiffusionSampler(
        stack.unet, stack.vae, stack.text, stack.tokenizer, schedule,
        image_size=256, num_steps=20, guidance_scale=7.5, sampler="ddim")

    def run_main_path(out_dir: Path) -> float:
        fn = sampler.for_prompt(PROMPT)

        def checked(batch_size: int, seed: int) -> torch.Tensor:
            images = fn(batch_size, seed)
            if images.shape != (batch_size, 3, 256, 256):
                raise AssertionError(f"images {tuple(images.shape)}")
            if not torch.isfinite(images).all():
                raise AssertionError("non-finite images")
            return images

        start = time.perf_counter()
        written = generate_to_dir(checked, 4, out_dir, eval_batch_size=2,
                                  seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        pngs = sorted(out_dir.glob("*.png"))
        if written != 4 or len(pngs) != 4:
            raise AssertionError(f"{written} written, {len(pngs)} PNGs")
        from PIL import Image
        for p in pngs:
            with Image.open(p) as im:
                if im.size != (256, 256) or im.mode != "RGB":
                    raise AssertionError(f"{p.name}: {im.size} {im.mode}")
        return seconds

    with tempfile.TemporaryDirectory() as tmp:
        for fn in kernels.values():
            fn.launches = 0
        cold_s = run_main_path(Path(tmp) / "cold")
        launches = {name: fn.launches for name, fn in kernels.items()}
        warm_s = run_main_path(Path(tmp) / "warm")
    print(f"[main] 4 images, 256px, 20 DDIM steps, CFG 7.5, batch 2: "
          f"first run {cold_s:.2f} s, second run {warm_s:.2f} s = "
          f"{4 / warm_s:.3f} samples/s on {card}; launches {launches}",
          flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")

    agreement = check_against_cpu(stack, dev)

    sources = {"flash_attention": ("polyp_tpu_torch/csrc/flash_attention.cu",
                                   "polyp_tpu/ops/flash_attention.py:185"),
               "fused_geglu": ("polyp_tpu_torch/csrc/fused_geglu.cu",
                               "polyp_tpu/ops/fused_geglu.py:139"),
               "fused_group_norm": ("polyp_tpu_torch/csrc/fused_gn.cu",
                                    "polyp_tpu/ops/fused_gn.py:136")}
    table = []
    for name, (source, replaces) in sources.items():
        mine = [r for r in rows if r["name"] == name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": max(r["max_abs_err"] for r in mine),
                      # first row: the main path's headline shape
                      "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"]})
    detail = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "checks": rows, "main_path": {
                  "images": 4, "image_size": 256, "steps": 20, "batch": 2,
                  "first_run_s": cold_s, "second_run_s": warm_s,
                  "samples_per_s": 4 / warm_s, "launches": launches},
              "card_vs_cpu": agreement}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))

    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
