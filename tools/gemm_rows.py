#!/usr/bin/env python3
"""Rows 2-6 of PERF.md's kernel table (the bf16 GEGLU, GroupNorm, the
static int8 GEGLU, the W8A8 dense and the per-token int8 GEGLU), rows 1
and 7 in bf16 (flash attention and the fused MHA at the SD stack's
shapes), the fp32 forms of rows 1 and 2 (flash attention and the GEGLU in
fp32) and of rows 4-6 (the int8 kernels on fp32 x) and the sampling
loops' device time,
for the polyp_tpu_torch of any checkout, so that two commits are compared
on one card in one call.

    python3 tools/gemm_rows.py --root DIR --tag NAME
                               [--rows geglu,dense,geglu_q8,geglu_q8_pt,gn,
                                       attention,flash_f32,geglu_f32,
                                       int8_f32 | all | none]
                               [--no-profiles]

Needs a CUDA card. It builds the kernels of DIR/polyp_tpu_torch and runs
chip_smoke.py's `gemm_rows`, `geglu_q8_rows` and `gn_rows` (this
checkout's: device time from a CUDA graph of 20 calls, the CUDA-event time
of the same calls, the plain version, the yardsticks, the bound),
`attention_rows`, `fp32_rows` (flash's fp32 form, the GEGLU's, or
both) and `q8_f32_rows` (a checkout from before the int8 kernels' fp32
forms has none) on that package at every main-path shape; then, on
the full-width SD-v1-4 stack (random weights, seed 0) at 256px,
`profile_loop` over one batch of four loops: w8a8_static under CFG (20
DDIM steps, 5-step bf16 head, batch 2), dynamic w8a8 under CFG (the same
steps and batch, no head), distilled bf16 (8 steps, batch 16, fused MHA)
and distilled w8a8_static (4 steps, batch 32), each with its device time
by kernel family. Everything goes to
chiprun_out/gemm_rows_NAME.json; one line a row is printed.

To compare a parent commit, unpack `git archive <commit>` into a directory
git ignores (under build/) and run the two in turns: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROWS = ("geglu", "dense", "geglu_q8", "geglu_q8_pt", "gn", "attention",
        "flash_f32", "geglu_f32", "int8_f32")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose polyp_tpu_torch is measured")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--rows", default="all",
                    help="comma-separated kernels whose rows to time: "
                         f"{', '.join(ROWS)}; or all, or none")
    ap.add_argument("--no-profiles", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("gemm_rows: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from polyp_tpu_torch import _build
    if Path(_build.__file__).resolve().parents[1] != args.root.resolve():
        raise AssertionError(f"imported {_build.__file__}, not {args.root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    start = time.perf_counter()
    _build.library()
    out = {"root": str(args.root), "tag": args.tag, "card": card,
           "build_s": time.perf_counter() - start}
    dev = torch.device("cuda", 0)
    rows = {"all": ROWS, "none": ()}.get(args.rows, args.rows.split(","))
    unknown = set(rows) - set(ROWS)
    if unknown:
        raise SystemExit(f"gemm_rows: unknown rows {sorted(unknown)}")
    with torch.no_grad():
        out["rows"] = smoke.gemm_rows(
            dev, geglu_batches=(4, 16, 32) if "geglu" in rows else (),
            dense_batches=(4, 32) if "dense" in rows else ())
        if "geglu_q8" in rows or "geglu_q8_pt" in rows:
            out["rows"] += smoke.geglu_q8_rows(
                dev, static="geglu_q8" in rows,
                per_token="geglu_q8_pt" in rows)
        if "gn" in rows:
            out["rows"] += smoke.gn_rows(dev)
        if "attention" in rows:
            out["rows"] += smoke.attention_rows(dev)
        if "flash_f32" in rows or "geglu_f32" in rows:
            out["rows"] += smoke.fp32_rows(dev, flash="flash_f32" in rows,
                                           geglu="geglu_f32" in rows)
        if "int8_f32" in rows:
            out["rows"] += smoke.q8_f32_rows(dev)
    if not args.no_profiles:
        out["loops"] = profiles(smoke, dev)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"gemm_rows_{args.tag}.json").write_text(json.dumps(out,
                                                                indent=1))
    print(f"[gemm_rows] {args.tag}: {card}, build {out['build_s']:.1f} s",
          flush=True)
    return 0


def profiles(smoke, dev) -> dict:
    import os
    import tempfile

    import torch

    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.distill_sd import make_student_sampler
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.pipeline import StableDiffusionSampler

    stack = load_sd_stack(None, dtype=torch.bfloat16, seed=0)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085, 0.012)
    loops = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["POLYP_TORCH_QUANT_CACHE"] = str(Path(tmp) / "quant")
        samplers = {
            "w8a8_static": (StableDiffusionSampler(
                stack.unet, stack.vae, stack.text, stack.tokenizer, schedule,
                image_size=256, num_steps=20, guidance_scale=7.5,
                sampler="ddim", quantize="w8a8_static", quant_fp_head=5), 2),
            "w8a8": (StableDiffusionSampler(
                stack.unet, stack.vae, stack.text, stack.tokenizer, schedule,
                image_size=256, num_steps=20, guidance_scale=7.5,
                sampler="ddim", quantize="w8a8"), 2),
            "distilled_bf16": (make_student_sampler(
                stack, stack.unet, num_steps=8, fused_mha=True), 16),
            "distilled_int8_tiny": (make_student_sampler(
                stack, stack.unet, num_steps=4, quantize="w8a8_static"), 32)}
        for name, (sampler, batch) in samplers.items():
            sampler.for_prompt(smoke.PROMPT)  # calibrates the int8 ones
            smoke.profile_loop(sampler, batch)  # warm
            loops[name] = prof = smoke.profile_loop(sampler, batch)
            print(f"[loop] {name}: device {prof['device_s']:.4f} s; "
                  + "; ".join(f"{k} {v[0]:.3f} ms ({v[1]})"
                              for k, v in prof["families"].items()),
                  flush=True)
    return loops


if __name__ == "__main__":
    sys.exit(main())
