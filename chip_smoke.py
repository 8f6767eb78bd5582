#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`polyp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases; any failure raises and exits non-zero, and no phase's failure is
caught:

1. a CUDA card is required; prints its name and power limit (nvidia-smi);
2. builds the hand-written kernels from polyp_tpu_torch/csrc/ (one nvcc
   per source, all at once) and prints the build seconds, and the
   registers, spill bytes and dynamic shared memory a block of the
   attention kernels (flash at every head dim, the fused MHA, its K/V
   projection) and the GEMM kernels (the GEMM core's instantiations for
   the bf16 GEGLU's two launches, the dense and both int8 GEGLU forms'
   two launches) from the build's -Xptxas -v log; a spill of an
   attention kernel at d <= 80 (every head dim a path runs) or of any GEMM
   kernel fails the run after the main paths;
3. holds each kernel against its plain PyTorch version at the shapes each
   main path gives it (the CFG batch 4 and the distilled batches 16 and
   32), measured against the plain version in fp32 on the same inputs,
   and prints its device time (time_ms: a CUDA graph of 20 calls, so the
   wrapper's host work is not in it) beside the CUDA-event time of 20
   eager calls (event_ms, the earlier timer), the plain version's device
   time, the kernel's bound (the larger of its bytes over the memory rate
   and its operations over the peak of their type) and, where one PyTorch
   call computes the same function, that call's time (`library_ms`, timed
   here only), with the achieved TFLOP/s of the operations the bound
   counts and the bound's share of the kernel's time: flash attention, the
   fused MHA block (also beside the port's unfused path), fused GEGLU
   (beside the products alone and the cuBLAS chain) and GroupNorm+SiLU in
   bf16 (tolerance in TOLERANCE; at the UNet's shapes and every VAE decode
   shape at batches 2 and 16, every VAE encode shape at the train batch
   8; flash also at the train batch [8,1024,8,40]); the int8 kernels —
   the W8A8 dense (beside
   `_int_mm` on the codes), the static int8 GEGLU (beside `_int_mm` on the
   codes of x and h, and the bf16 GEGLU at the same shape) and the
   per-token one (at every level of batch 4, beside the same `_int_mm`
   pair and the static form) — by relative L2 and max error (Q8_REL_L2,
   Q8_MAX_REL),
   and GroupNorm's int8 epilogue by the share of codes that differ (at
   most one code, in at most GN_Q8_SHARE of the elements);
4. drives the main paths on the full-width SD-v1-4 stack (UNet 859,520,964
   params, VAE decoder, CLIP ViT-L/14 text encoder; bf16, random weights
   from seed 0) through generate_to_dir, each twice (first run through
   for_prompt, counted, with every launch count set to 0 just before it
   and read just after; second run timed, its sampling loops and decodes
   timed apart):
   - StableDiffusionSampler at 256px, 20 DDIM steps, CFG 7.5, batch 2:
     bf16 (4 images); w8a8_static with a 5-step bf16 head (calibration
     seconds and layer count printed; 4 images, held within
     INT8_IMAGE_REL_L2 of the bf16 images of the same seeds); dynamic
     w8a8 (2 images); and bf16 at the sampler's defaults (UniPC, 25 steps,
     CFG 7.5; 2 images);
   - the distilled path, make_student_sampler over the same UNet (folded
     guidance, trailing DDIM grid): bf16 with fused_mha=True, 8 steps,
     batch 16, full VAE decode (16 images; exactly 40 fused MHA launches,
     no flash), the same with fused_mha=False (held within
     FUSED_IMAGE_REL_L2 of the fused images); bf16, 4 steps, batch 32,
     tiny decoder (32 images); w8a8_static with no bf16 head, calibrated
     on the folded trajectory, 4 steps, batch 32, tiny decoder (held
     within INT8_IMAGE_REL_L2 of the bf16 4-step images);
   Each requires finite images, PNGs of 256×256×3, and a launch count
   above zero for each kernel that path runs; images/s of each path are
   printed side by side, beside the UNet-only and decode-only seconds and
   the decode share; torch.profiler gives the device time of one sampling
   loop, and its kernel families, of the w8a8_static and the dynamic w8a8
   CFG paths and of the fused, the unfused and the int8 distilled paths;
   one bf16 and one w8a8_static UNet forward count the GEGLU's and the
   dense's launches by shape, and one VAE decode GroupNorm's (the census);
5. holds one tiny-decoder forward on the card against the same weights in
   fp32 on the CPU, one bf16 UNet forward and one VAE decode on the card
   (kernels) against the same weights run on the CPU in fp32 (plain
   versions), by relative L2 error (REL_L2_TOLERANCE); and one
   w8a8_static UNet forward (the calibrated scales) layer by layer: every
   quantized layer it ran (convs, linears, feed-forwards, GroupNorm int8
   epilogues) is re-run on the CPU in fp32 from the card's own input to
   that layer and must agree within LAYER_REL_L2 (codes within
   GN_Q8_SHARE); the whole int8 forward must stay within
   INT8_FORWARD_NOISE times the CPU's own int8-vs-fp32 distance (see
   there);
6. serves (serving_phase, about a minute): GenerationService over
   make_sampler's bf16 stack at the service defaults (UniPC, 25 steps,
   CFG 7.5, max_batch 8) behind the HTTP server on a loopback port —
   /healthz, 8 concurrent requests in at most 2 launches, a solo request
   whose PNG equals its coalesced twin's pixel for pixel; the w8a8_static
   and w8a8 services and a 4-step student (tiny decoder, fused MHA): each
   kernel's launches a request, and the student's solo twin pixel-equal;
   two models behind one service, each request reaching its own; 429s
   under a burst at max_pending 1; the load generator on the student at 8
   clients, coalesced vs solo; and generate_to_dir on distilled_bf16_tiny,
   the host seconds an image beyond the sampling, serial vs overlapped,
   with the PNG encoder that ran (`make -C native libpolyp_png.so` is
   tried first; a failure is printed and PIL encodes);
7. trains (training_phase, "LoRA training"): SD LoRA at full width
   through train_sd_lora over a Loader of 48 synthetic 256px images
   (batch 8, rank 8, α 8, dropout 0, the `attention` preset, lr 1e-4,
   with_schedule(6): 6 steps), every count set to 0 just before it and
   read just after and after each step: every loss finite, lora_B 0 after
   step 1 (lr 0) and not after step 2, exactly STEP_FLASH flash launches,
   ENCODE_GN GroupNorm launches (one VAE encode under no_grad) and no
   GEGLU launch a step; the seconds a step (steps 2-6), train images/s
   and torch.cuda.max_memory_allocated beside the card's name and power
   limit, and one more step under torch.profiler (device time, busy
   share, kernel families). Then every flag on (text LoRA, DreamBooth
   `sks`, visual influence, unfrozen attention projections, dropout 0.3,
   accumulation 2) for two updates (four micro-steps): finite losses,
   every trainable leaf moved by the second update (the first at lr > 0);
   one step at batch 1 on the card against the same step in fp32 on the
   CPU with the same draws (loss within REL_L2_TOLERANCE, LoRA gradients
   within LORA_GRAD_REL_L2 relative L2); the default run's bundle saved,
   reloaded, merged (merged_stack) and sampled through
   StableDiffusionSampler (2 PNGs of 256×256×3). Every parameter of the
   stack is bit-equal before the phase and after each run and the
   sampling;
8. runs the generate → augment → retrain → F1 loop (augmentation_loop_
   phase, "augmentation loop") through the port's CLIs on a corpus
   fabricated in the reference's layout (seeded .tif images, train AD 32 /
   HP 8 / ASS 8, valid and test 4 and 8 a class): polyp-lora-per-class's
   main on full-width SD-v1-4 from seed 0 (AD HP ASS, 224 px, one epoch,
   8 images a class), every count set to 0 just before each class and
   read just after (flash exactly 0 at 224 px, whose 784 tokens are below
   its 1024; GroupNorm and the GEGLU above 0); the same command again with
   one sample a class deleted (nothing trained, each class topped up to
   its quota under the same file names); the CLI's stack bit-equal after
   both; polyp-train-classifier's and polyp-eval-augmentation's mains (B0,
   224 px, batch 16, 3 epochs, weighted sampling): accuracy, precision,
   recall and F1 finite and in [0, 1], the per-class Fréchet distances;
   the classifier's seconds a train step (steps 2-6 at batch 16), train
   and eval images/s, peak memory and a profiled step; and B0 at 224 px on
   the card against the CPU (CLS_FORWARD_REL_L2 and the train-step
   tolerances). cuDNN's TF32 is on in this phase, as PyTorch's default
   and the classifier's choice (models/efficientnet.py);
9. runs the scratch DDPM (scratch_phase, "scratch DDPM") through
   polyp-train-scratch's main on phase 8's corpus at the reference's
   width (polyp_scratch_unet, 113,664,003 params, bf16 over fp32 masters;
   224 px, batch 8, one epoch, 25 DDIM sample steps, quotas AD 4 / HP 19
   / ASS 19), every count set to 0 just before it and read just after
   (GroupNorm exactly 71 a sampling forward, nothing else): the samples
   and saved models; GroupNorm against its plain version at every shape
   the CLI gave it (recorded on the path); one sampling forward's launches
   (GroupNorm 71, flash 0); the train step's seconds (steps 2-6 at batch
   8), train images/s, peak memory and a profiled step; the card against
   the CPU at 112 px (a bf16 forward within REL_L2_TOLERANCE of fp32, one
   train step's loss within REL_L2_TOLERANCE and its gradients within
   LORA_GRAD_REL_L2); and the --quantize w8a8_static sampler over the
   trained UNet, calibrated with cond=None: its launches a forward
   (GroupNorm 71, 64 with the int8 epilogue, the dense 44), GroupNorm,
   its int8 epilogue (against reference_gn_q8, as gn_rows holds it) and
   the dense against their plain versions at every shape the sampler
   gave them, and one int8 forward layer by layer against the CPU
   (int8_layers);
10. runs the SD CLIs (sd_clis_phase, "SD CLIs") on the same corpus at full
   SD-v1-4 width: polyp-lora-all-classes --generate_subsamples at its
   defaults with one epoch (flash 0 at 224 px), polyp-finetune-pretrained
   at 256 px with one epoch and a grid of 4 (flash exactly STEP_FLASH a
   train step and a sampling forward, counted apart), and
   polyp-inspect-lora on its adapter (128 modules, rank 4); GroupNorm and
   the bf16 GEGLU against their plain versions at every shape the two
   training CLIs gave them (recorded on the path);
11. distils (distill_phase, "distill") at full width: polyp-distill-sd-
   torch's main over phase 10's three LoRA bundles (SD-v1-4, 256 px, batch
   8, one 8 → 4 phase of 4 steps a class, 8 samples a class): every step
   launches exactly flash 15, GEGLU 32 and GroupNorm 122 (the teacher's
   two CFG forwards at batch 16; the student's forward under autograd runs
   flash only), and its seconds (steps 2-4), train images/s, peak memory,
   a profiled step's busy share and each student's save seconds are
   printed; its reparam warmup once through distill_progressive (a
   v-prediction student, 2 warmup steps of flash 10, GEGLU 16 and
   GroupNorm 61, then 2 phase steps); load_student_sampler on a saved
   student (16 images at batch 16, launches exact); the three students
   behind polyp-serve-torch's service (--distilled-dir, --distilled-class
   all) over HTTP, 8 requests across them, each of 3 solo twins
   pixel-equal to its coalesced request; polyp-distill-torch over phase
   9's models (224 px, batch 8, GroupNorm exactly 142 a step) and
   polyp-distill-vae-torch with mixed latents (256 px, batch 8, 20 steps,
   GroupNorm exactly 30 a step; the tiny decoder reloaded and decoding);
   one SD distill step at batch 1 on the card against the same step in
   fp32 on the CPU (loss within REL_L2_TOLERANCE, student gradients within
   LORA_GRAD_REL_L2); and flash, the bf16 GEGLU and GroupNorm against
   their plain versions at every shape these paths gave them (recorded
   on the path);
12. prints the kernel table (all eight kernel entries, with launches on
   the main path that runs each, launches a train step, launches a loop
   class, launches a scratch forward and launches a distill step) as one
   JSON line, the card line, and last the result line {"ok": true,
   "device": {...}}. Each phase's seconds are printed as it ends
   ("[time]").

TF32 is off for every comparison but the augmentation loop's (phase 8).
Details of each check go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
             "fused_group_norm": 6e-2, "fused_mha": 2e-2}
# ... except the fused MHA block, whose tolerance is relative to max |y|:
# its outputs are small here (max |y| about 0.4: attention over 1024
# near-uniform keys averages V down), and it rounds Q (after the scale),
# K, V, the probabilities, each head's output and the result to bf16
# (2^-9 relative each), as the plain bf16 version does. A wrong tile,
# mask or head column gives O(1) of max |y|.
RELATIVE_TO_MAX = {"fused_mha"}
# int8 kernels vs their plain version's fp32 result on the same inputs: the
# kernels round their output to bf16 (2^-9 relative), and an int8 code of an
# intermediate (the GEGLU's h) may break a rounding tie the other way. A
# wrong scale, tile or mask gives O(1).
Q8_REL_L2 = 4e-3
Q8_MAX_REL = 2 ** -6   # max |err| / max |y|
GN_Q8_SHARE = 2e-3     # share of int8 codes one apart (never more)
# relative L2 of a whole forward on the card (bf16) vs fp32 on the CPU
REL_L2_TOLERANCE = 5e-2
# one quantized layer of the card's int8 forward vs the same layer on the
# CPU (fp32, plain versions) from the same input: bf16 output rounding,
# twice on the patch-matrix conv path (dequantize, then + bias), and rare
# ties. A wrong scale, weight or layout gives O(1).
LAYER_REL_L2 = 5e-3
# A whole int8 forward cannot be held to REL_L2_TOLERANCE: an activation
# code that breaks a rounding tie the other way (which bf16 vs fp32 makes
# common) moves the next layers' inputs and so their ties, and the two
# forwards drift apart until they differ by about as much as int8 differs
# from fp32 (PERF.md, Findings). So the card's int8 forward is held to twice
# the CPU's own int8-vs-fp32 distance; a broken path gives O(1).
INT8_FORWARD_NOISE = 2.0
# w8a8_static (+ 5-step bf16 head) images vs the bf16 images of the same
# seeds; a wrong scale or code path gives O(1). The distilled w8a8_static
# images (4 steps, no bf16 head) are held to the same bound against the
# bf16 4-step images through the same decoder.
INT8_IMAGE_REL_L2 = 0.15
# distilled bf16 images through the fused MHA kernel vs the same seeds
# through the unfused path (projections + flash kernel): the same math with
# bf16 rounding at other places (Q is scaled before its rounding, the heads'
# outputs are summed inside one product), carried through 8 steps and the
# VAE decode. A wrong kernel gives O(1).
FUSED_IMAGE_REL_L2 = 5e-2

# the LoRA training phase: bench.py::bench_sd_lora_train's configuration
# (256px, batch 8, rank 8, α 8, the `attention` preset) on 48 synthetic
# images, 6 steps (one epoch); the all-flags run's micro-batch
TRAIN_IMAGES, TRAIN_BATCH, TRAIN_PX = 48, 8, 256
# the card's step (bf16 weights and activations, the kernels) against the
# same step in fp32 on the CPU (plain versions), at batch 1 with the same
# draws. The loss: the UNet output's bf16 error (a bf16 forward is 0.014
# rel L2 from fp32 on the H100, check_against_cpu) enters the MSE against
# ε only through pred − ε, so it is held
# to REL_L2_TOLERANCE. The LoRA gradients pass bf16 rounding through the
# UNet twice, its forward activations (saved in bf16) and the backward's
# own bf16 products, so they are held to twice that: a gradient of B is a
# product of a forward activation and a backward signal, each about as far
# from fp32 as a forward output. A wrong layer, transpose, mask or backward
# gives O(1).
LORA_GRAD_REL_L2 = 2 * REL_L2_TOLERANCE
# a VAE encode's GroupNorms: 2 a resnet (8 down, 2 mid), the mid
# attention's, conv_norm_out (polyp_tpu/models/vae.py:48-76)
ENCODE_GN = 22
# flash launches a train step: the five level-0 self-attentions of one
# UNet forward (the backward recomputes through the plain version)
STEP_FLASH = 5

# the card's peak rates (NVIDIA's H100 SXM data sheet, dense): the least
# time for a kernel's work is the larger of its bytes over the memory rate
# and its operations over the peak of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


# graph replays a device time averages over (each of `iters` calls)
GRAPH_REPLAYS = 5


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: `iters` calls captured once in a
    CUDA graph (after warm-up calls on a side stream), the graph replayed
    GRAPH_REPLAYS times between two CUDA events. The calls' host work
    (argument checks, allocation, the launch itself) is not in it, so a
    kernel shorter than its wrapper is timed as the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * GRAPH_REPLAYS)
    del graph
    return ms


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The earlier timer, kept beside time_ms: CUDA events around `iters`
    eager calls, which holds the wrapper's host time where the kernel is
    shorter than it."""
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


def nbytes(*tensors) -> int:
    """Bytes of distinct tensors (a tensor passed twice counts once)."""
    seen = {id(t): t for t in tensors if t is not None}
    return sum(t.numel() * t.element_size() for t in seen.values())


def bound(ops: float, kind: str, n_bytes: int) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    of their type, whichever is longer."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_ops": ops, "bound_bytes": n_bytes}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


def compare(name: str, kernel_fn, plain_fn, fp32_ref: torch.Tensor,
            shape: str, cost: dict, library_fn=None, **others) -> dict:
    """A bf16 kernel vs its plain version's fp32 result; times the kernel,
    the plain version, `library_fn` (one PyTorch call computing the same
    function, timed only here) and any `others`; `cost` is bound()'s."""
    out = kernel_fn()
    torch.cuda.synchronize()
    err = (out.float() - fp32_ref).abs().max().item()
    plain_err = (plain_fn().float() - fp32_ref).abs().max().item()
    tol = TOLERANCE[name] * (fp32_ref.abs().max().item()
                             if name in RELATIVE_TO_MAX else 1.0)
    row = {"name": name, "shape": shape, "max_abs_err": err,
           "plain_bf16_max_abs_err": plain_err, "tolerance": tol,
           "ms": time_ms(kernel_fn), "event_ms": event_ms(kernel_fn),
           "plain_ms": time_ms(plain_fn),
           "library_ms": time_ms(library_fn) if library_fn else None,
           **{f"{k}_ms": time_ms(fn) for k, fn in others.items()}, **cost}
    # achieved rate of the operations the bound counts, and the bound's
    # share of the kernel's time
    row["tflops"] = cost["bound_ops"] / row["ms"] / 1e9
    row["bound_share"] = cost["bound_ms"] / row["ms"]
    extra = "".join(f", {k} {row[f'{k}_ms']:.4f} ms"
                    for k in (["library"] if library_fn else []) + list(others))
    print(f"[check] {name} {shape}: max|err| {err:.3e} (plain bf16 "
          f"{plain_err:.3e}, tol {tol:.1e}); kernel {row['ms']:.4f} ms "
          f"(events {row['event_ms']:.4f}), plain {row['plain_ms']:.4f} ms"
          f"{extra}, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of the "
          f"bound", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version: {err} > {tol}")
    return row


def compare_q8(name: str, kernel_fn, plain_fn, fp32_ref: torch.Tensor,
               shape: str, cost: dict, **others) -> dict:
    """An int8 kernel (bf16 out) vs its plain version's fp32 result; times
    any `others` (yardsticks timed only here) as compare() does."""
    out = kernel_fn()
    torch.cuda.synchronize()
    err = (out.float() - fp32_ref).abs().max().item()
    rel = rel_l2(out, fp32_ref)
    tol = Q8_MAX_REL * fp32_ref.abs().max().item()
    row = {"name": name, "shape": shape, "max_abs_err": err,
           "max_abs_tolerance": tol, "rel_l2": rel,
           "rel_l2_tolerance": Q8_REL_L2,
           "ms": time_ms(kernel_fn), "event_ms": event_ms(kernel_fn),
           "plain_ms": time_ms(plain_fn), "library_ms": None,
           **{f"{k}_ms": time_ms(fn) for k, fn in others.items()}, **cost}
    row["bound_share"] = cost["bound_ms"] / row["ms"]
    extra = "".join(f", {k} {row[f'{k}_ms']:.4f} ms" for k in others)
    print(f"[check] {name} {shape}: rel L2 {rel:.3e} (tol {Q8_REL_L2:.0e}), "
          f"max|err| {err:.3e} (tol {tol:.3e}); kernel {row['ms']:.4f} ms "
          f"(events {row['event_ms']:.4f}), plain {row['plain_ms']:.4f} ms"
          f"{extra}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{row['bound_share']:.3f} of it", flush=True)
    if not (rel <= Q8_REL_L2 and err <= tol):
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version: rel L2 {rel}, max {err}")
    return row


# the kernels whose registers, spills and shared memory a block chip_smoke
# reports from the build's -Xptxas -v log (mangled names): the attention
# kernels, and the GEMM core's instantiations (gemm_core.cuh) for the two
# launches of the bf16 GEGLU and of both int8 GEGLU forms and the dense, by
# tile (and, for the dense, quantized x)
ATTENTION_KERNELS = re.compile(
    r"(flash_fwd_kernel|fused_mha_kernel|kv_project_kernel)(?:ILi(\d+)E)?")
GEMM_KERNELS = re.compile(
    r"gemm_kernelI\w*?(GegluQ8PtUp|GegluQ8PtDown|GegluQ8Up|GegluQ8Down|GegluUp"
    r"|GegluDown|Dense)"
    r"I((?:Li\d+E|Lb[01]E)+)")


def ptxas_report(log: str) -> dict:
    """{"flash_fwd_kernel<40>": {"head_dim", "registers", "spill_bytes",
    "stack_bytes"}, "gemm_kernel<Dense<160,1>>": {...}} for the attention
    and GEMM kernels (every template argument in the name), from nvcc's
    -Xptxas -v report."""
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = ATTENTION_KERNELS.search(line)
            gm = GEMM_KERNELS.search(line)
            name = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                    if m else None)
            if name:
                report[name] = {"head_dim": int(m.group(2) or 0) or None}
            elif gm:
                args = ",".join(re.findall(r"L[ib](\d+)E", gm.group(2)))
                name = f"gemm_kernel<{gm.group(1)}<{args}>>"
                report[name] = {"head_dim": None}
        elif name and "spill stores" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", line))
            report[name].update(stack_bytes=stack,
                                spill_bytes=stores + loads)
        elif name and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return report


def randn_on(dev: torch.device, seed: int):
    """randn(*shape, scale=, shift=) -> bf16 on `dev`, from one generator."""
    g = torch.Generator(dev).manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                + shift).to(torch.bfloat16)
    return randn


def amax_scale(t: torch.Tensor) -> torch.Tensor:
    return (t.float().abs().amax() * 1.05 / 127).reshape(())


# the transformer FF's (C, tokens an image at 256px) at UNet levels 0-2 and
# the mid block, and its launches per UNet forward at each: SD-v1-4 has two
# transformers a down block and three an up block at levels 0-2, one mid
FF_LEVELS = ((320, 1024), (640, 256), (1280, 64), (1280, 16))
FF_PER_FORWARD = {320: 5, 640: 5, 1280: 5}
# the W8A8 dense's shapes: (tokens an image, C, O, int8 x, what): to_q at
# level 0 (also to_k/v/out and proj_out), the cross-attention K/V at levels
# 0 and 2 (77 tokens of 768), proj_in at level 1 (bf16 in, and int8 in from
# the GroupNorm handoff), level 2 and the mid block at C = O = 1280
DENSE_CASES = ((1024, 320, 320, False, "to_q"),
               (77, 768, 320, False, "to_k"),
               (77, 768, 1280, False, "to_k level 2"),
               (256, 640, 640, False, "proj_in"),
               (256, 640, 640, True, "proj_in int8"),
               (64, 1280, 1280, False, "level 2"),
               (16, 1280, 1280, False, "mid"))


def geglu_case(randn, n: int, c: int, per_image: int):
    """x [n, per_image, C] and GEGLU weights w1 [8C, C], b1, w2 [C, 4C], b2
    (bf16, scaled so the outputs are O(1))."""
    h = 4 * c
    x = randn(n, per_image, c)
    w1, b1 = randn(2 * h, c, scale=c ** -0.5), randn(2 * h, scale=0.1)
    w2, b2 = randn(c, h, scale=h ** -0.5), randn(c, scale=0.1)
    return x, w1, b1, w2, b2


def gemm_rows(dev: torch.device, geglu_batches=(4, 16, 32),
              dense_batches=(4, 32)) -> list[dict]:
    """Rows 2 and 5 of the kernel table, each kernel against its plain
    version at every main-path shape: the bf16 GEGLU at UNet levels 0-2 and
    mid at the CFG batch 4 and the distilled batches 16 and 32, beside the
    products alone (two bf16 F.linear) and the cuBLAS chain (bf16 F.linear,
    the GELU gate, F.linear); the W8A8 dense at DENSE_CASES at the
    w8a8_static batches 4 and 32, beside the product alone (`_int_mm` on
    int8 codes). The yardsticks are timed here only."""
    import torch.nn.functional as F

    from polyp_tpu_torch.ops.fused_geglu import fused_geglu, reference_geglu

    randn = randn_on(dev, seed=0)
    rows = []
    for n, c, per_image in ((n, c, t) for n in geglu_batches
                            for c, t in FF_LEVELS):
        h, tokens = 4 * c, n * per_image
        x, w1, b1, w2, b2 = geglu_case(randn, n, c, per_image)
        hb = randn(n, per_image, h)
        args = (x, w1, b1, w2, b2)

        def chain():
            a, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            return F.linear(a * F.gelu(gate), w2, b2)

        row = compare(
            "fused_geglu", lambda: fused_geglu(*args),
            lambda: reference_geglu(*args),
            reference_geglu(*(t.float() for t in args)),
            f"[{tokens},{c}]x[{c},{2 * h}]",
            bound(6 * tokens * c * h, "bf16",
                  2 * nbytes(x) + nbytes(w1, b1, w2, b2)),
            products=lambda: (F.linear(x, w1, b1), F.linear(hb, w2, b2)),
            cublas_chain=chain)
        row["launches_per_forward"] = 1 if per_image == 16 else \
            FF_PER_FORWARD[c]
        rows.append(row)
    for n, (per_image, c, o, int8_in, what) in ((n, case)
                                                for n in dense_batches
                                                for case in DENSE_CASES):
        rows.append(dense_row(randn, n * per_image, c, o, int8_in, what))
    return rows


def dense_row(randn, m: int, c: int, o: int, int8_in: bool,
              what: str) -> dict:
    """compare_q8() of the W8A8 dense on x [m, c] (bf16, or its int8 codes
    where `int8_in`: a GroupNorm's handoff) and weights [o, c], beside the
    product alone (`_int_mm` on the codes)."""
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.ops.fused_dense import (
        fused_w8a8_dense, reference_w8a8_dense)

    x = randn(m, c)
    wq, sw = quant.weight_q8_matrix(randn(o, c, scale=c ** -0.5))
    bias = randn(o, scale=0.1)
    s = amax_scale(x)
    codes = quant.quantize_activation(x, s)[0]
    if int8_in:
        x = codes
    args = (x, wq, sw, bias, s)
    return compare_q8(
        "fused_w8a8_dense",
        lambda: fused_w8a8_dense(*args, out_dtype=torch.bfloat16),
        lambda: reference_w8a8_dense(*args, out_dtype=torch.bfloat16),
        reference_w8a8_dense(*args, out_dtype=torch.float32),
        f"{what} [{m},{c}]x[{c},{o}]",
        bound(2 * m * c * o, "int8", nbytes(*args) + 2 * m * o),
        products=lambda: quant.int_mm(codes, wq))


def check_kernels(dev: torch.device) -> list[dict]:
    import torch.nn.functional as F

    from polyp_tpu_torch.ops.flash_attention import (
        flash_attention, reference_attention)
    from polyp_tpu_torch.ops.fused_mha import (
        fused_mha_linear, reference_mha_linear)

    randn = randn_on(dev, seed=0)
    rows = []
    # level-0 self-attention at 256px: [4, 1024, 8, 40] for batch 2 under
    # CFG (the headline row), the LoRA train step's batch 8, and the
    # distilled batches 16 (unfused) and 32 (w8a8_static); q, k, v read
    # once and one output of q's size
    for n in (4, 8, 16, 32):
        q, k, v = (randn(n, 1024, 8, 40) for _ in range(3))
        rows.append(compare(
            "flash_attention", lambda: flash_attention(q, k, v),
            lambda: reference_attention(q, k, v),
            reference_attention(q.float(), k.float(), v.float()),
            f"[{n},1024,8,40]",
            bound(4 * n * 8 * 1024 * 1024 * 40, "bf16",
                  nbytes(q, k, v) + nbytes(q)),
            library_fn=lambda: sdpa(q, k, v)))

    # the fused MHA block, on nn.Linear weights as the UNet calls it: the
    # distilled batches 16 (its headline row) and 32, the CFG batch, 512px
    # levels 0 and 1, and the 77-token ragged KV. Beside
    # the kernel: the port's unfused path (cuBLAS projections + the flash
    # kernel) and, timed only here, four F.linear + SDPA
    for b, tq, c, tk, ckv, d in ((16, 1024, 320, None, 320, 40),
                                 (32, 1024, 320, None, 320, 40),
                                 (4, 1024, 320, None, 320, 40),
                                 (2, 4096, 320, None, 320, 40),
                                 (4, 1024, 640, None, 640, 80),
                                 (4, 1024, 320, 77, 768, 40)):
        h, co = 8, c
        x = randn(b, tq, c)
        ctx = x if tk is None else randn(b, tk, ckv)
        tk = ctx.shape[1]
        w = (randn(h * d, c, scale=c ** -0.5),
             randn(h * d, ckv, scale=ckv ** -0.5),
             randn(h * d, ckv, scale=ckv ** -0.5),
             randn(co, h * d, scale=(h * d) ** -0.5))

        def heads(t):
            return t.view(t.shape[0], t.shape[1], h, d)

        def unfused(attend):
            o = attend(heads(F.linear(x, w[0])), heads(F.linear(ctx, w[1])),
                       heads(F.linear(ctx, w[2])))
            return F.linear(o.reshape(b, tq, h * d), w[3])

        ops = 2 * b * (tq * c + 2 * tk * ckv + tq * co) * h * d \
            + 4 * b * h * tq * tk * d
        rows.append(compare(
            "fused_mha",
            lambda: fused_mha_linear(x, ctx, *w, num_heads=h, head_dim=d),
            lambda: reference_mha_linear(x, ctx, *w, num_heads=h,
                                         head_dim=d),
            reference_mha_linear(x.float(), ctx.float(),
                                 *(t.float() for t in w), num_heads=h,
                                 head_dim=d),
            f"x[{b},{tq},{c}] ctx[{b},{tk},{ckv}] {h}x{d}",
            bound(ops, "bf16", nbytes(x, ctx, *w) + 2 * b * tq * co),
            library_fn=lambda: unfused(sdpa),
            unfused=lambda: unfused(flash_attention)))

    # rows 2 and 5 (the bf16 GEGLU and the W8A8 dense) at every main-path
    # shape
    rows += gemm_rows(dev)

    rows += geglu_q8_rows(dev)
    rows += gn_rows(dev)
    return rows


# the w8a8_static batches: CFG 4 (2 images) and the distilled 32
Q8_BATCHES = (4, 32)


def geglu_q8_rows(dev: torch.device, static: bool = True,
                  per_token: bool = True) -> list[dict]:
    """Row 4 (the static int8 GEGLU) at the w8a8_static batches 4 and 32 at
    every UNet level and the mid block, beside two yardsticks timed here
    only: its two products alone (`_int_mm` on int8 codes of x and of h)
    and the bf16 GEGLU on the same x and weights; and row 6 (the per-token
    form) at batch 4 (dynamic w8a8 runs only under CFG) at every level,
    beside the same products alone and the static form on the same x and
    weights."""
    import torch.nn.functional as F

    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.ops.fused_geglu import (
        fused_geglu, fused_geglu_w8a8, fused_geglu_w8a8_pt,
        reference_geglu_w8a8, reference_geglu_w8a8_pt)

    randn = randn_on(dev, seed=0)
    rows = []
    for n, c, per_image in ((n, c, t) for n in Q8_BATCHES
                            for c, t in FF_LEVELS):
        h, tokens = 4 * c, n * per_image
        x, w1, b1, w2, b2 = geglu_case(randn, n, c, per_image)
        shape = f"[{tokens},{c}]x[{c},{2 * h}]"
        ops = 6 * tokens * c * h
        q8 = (*quant.weight_q8_matrix(w1), b1, *quant.weight_q8_matrix(w2),
              b2)
        s1 = amax_scale(x)
        a, gate = F.linear(x.float(), w1.float(), b1.float()).chunk(2, dim=-1)
        s2 = amax_scale(a * F.gelu(gate))
        xq = quant.quantize_activation(x, s1)[0].reshape(tokens, c)
        hq = quant.quantize_activation(a * F.gelu(gate), s2)[0].reshape(
            tokens, h)
        per_forward = 1 if per_image == 16 else FF_PER_FORWARD[c]

        def products():
            return quant.int_mm(xq, q8[0]), quant.int_mm(hq, q8[3])

        if static:
            row = compare_q8(
                "fused_geglu_w8a8", lambda: fused_geglu_w8a8(x, *q8, s1, s2),
                lambda: reference_geglu_w8a8(x, *q8, s1, s2),
                reference_geglu_w8a8(x, *q8, s1, s2, out_dtype=torch.float32),
                shape, bound(ops, "int8", 2 * nbytes(x) + nbytes(*q8, s1, s2)),
                products=products,
                bf16_geglu=lambda: fused_geglu(x, w1, b1, w2, b2))
            rows.append({**row, "launches_per_forward": per_forward})
        if n != 4 or not per_token:
            continue
        row = compare_q8(
            "fused_geglu_w8a8_pt", lambda: fused_geglu_w8a8_pt(x, *q8),
            lambda: reference_geglu_w8a8_pt(x, *q8),
            reference_geglu_w8a8_pt(x, *q8, out_dtype=torch.float32), shape,
            bound(ops, "int8", 2 * nbytes(x) + nbytes(*q8)),
            products=products,
            static=lambda: fused_geglu_w8a8(x, *q8, s1, s2))
        rows.append({**row, "launches_per_forward": per_forward})
    return rows


# GroupNorm+SiLU's shapes: the UNet's level widths (incl. the up path's
# concat widths) as (C, H = W), and every shape of a VAE decode (the mid
# block and up block 0 at 32², then 64², 128² and 256², each level's
# first resnet at the wider input)
UNET_GN = ((320, 32), (960, 32), (640, 16), (1280, 8), (2560, 4))
VAE_GN = ((512, 32), (512, 64), (512, 128), (256, 128), (256, 256),
          (128, 256))
# every shape of a VAE encode at 256px (the LoRA train step's, batch 8):
# 128 channels at 256² and 128², 256 at 128² and 64², 512 at 64² and 32²
ENCODER_GN = ((128, 256), (128, 128), (256, 128), (256, 64), (512, 64),
              (512, 32))
# the UNet's batches: CFG 4, distilled 16 and 32; the VAE's: CFG 2,
# distilled 16
UNET_BATCHES = (4, 16, 32)
VAE_BATCHES = (2, 16)


def gn_rows(dev: torch.device) -> list[dict]:
    """Row 3: GN+SiLU at the UNet's shapes at the batches 4 (CFG), 16 and
    32 (distilled), at every VAE decode shape at the VAE's batches 2
    (CFG) and 16 (distilled), and at every VAE encode shape at the train
    batch 8; the int8 epilogue at the UNet's shapes at the
    w8a8_static batches. About 10 fp32 operations an element (two sums,
    normalise, affine, SiLU): bound by bytes by far."""
    from polyp_tpu_torch.ops.fused_gn import fused_group_norm, group_norm

    randn = randn_on(dev, seed=0)
    rows = []
    for n, c, hw, eps in ([(n, c, hw, 1e-5) for n in UNET_BATCHES
                           for c, hw in UNET_GN]
                          + [(n, c, hw, 1e-6) for n in VAE_BATCHES
                             for c, hw in VAE_GN]
                          + [(TRAIN_BATCH, c, hw, 1e-6)
                             for c, hw in ENCODER_GN]):
        x = randn(n, c, hw, hw, scale=2.0, shift=0.3)
        gamma = randn(c, scale=0.1, shift=1.0).float()
        beta = randn(c, scale=0.1).float()
        shape = f"[{n},{c},{hw},{hw}]"
        rows.append(compare(
            "fused_group_norm",
            lambda: fused_group_norm(x, gamma, beta, 32, eps, "silu"),
            lambda: group_norm(x, gamma, beta, 32, eps, "silu"),
            group_norm(x.float(), gamma, beta, 32, eps, "silu"), shape,
            bound(10 * x.numel(), "fp32", 2 * nbytes(x) + nbytes(gamma,
                                                                   beta))))
        if eps != 1e-5 or n not in Q8_BATCHES:
            continue  # the VAE is not quantized, nor any batch-16 path
        rows.append(gn_q8_row(x, gamma, beta, 32, eps, "silu", shape))
    return rows


def gn_q8_row(x, gamma, beta, groups: int, eps: float, act, shape: str
              ) -> dict:
    """Row 3's int8 epilogue on `x` against reference_gn_q8, at the scale
    of the plain output's absolute maximum (so the codes fill [-127, 127]):
    at most one code apart, in at most GN_Q8_SHARE of the elements."""
    from polyp_tpu_torch.ops.fused_gn import (
        fused_group_norm, group_norm, reference_gn_q8)

    s = amax_scale(group_norm(x.float(), gamma, beta, groups, eps, act))
    got = fused_group_norm(x, gamma, beta, groups, eps, act, act_scale=s)
    want = reference_gn_q8(x, gamma, beta, s, groups, eps, act)
    diff = (got.int() - want.int()).abs()
    row = {"name": "fused_group_norm_q8", "shape": shape,
           "max_abs_err": diff.max().item(),
           "codes_differing": (diff > 0).float().mean().item(),
           "share_tolerance": GN_Q8_SHARE,
           "ms": time_ms(lambda: fused_group_norm(
               x, gamma, beta, groups, eps, act, act_scale=s)),
           "event_ms": event_ms(lambda: fused_group_norm(
               x, gamma, beta, groups, eps, act, act_scale=s)),
           "plain_ms": time_ms(lambda: reference_gn_q8(
               x, gamma, beta, s, groups, eps, act)),
           "library_ms": None,
           **bound(12 * x.numel(), "fp32",
                   nbytes(x, gamma, beta, s) + x.numel())}
    print(f"[check] fused_group_norm_q8 {shape}: codes differing "
          f"{row['codes_differing']:.3e} (tol {GN_Q8_SHARE:.0e}), max "
          f"{row['max_abs_err']} code; kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    if row["max_abs_err"] > 1 or row["codes_differing"] > GN_Q8_SHARE:
        raise AssertionError(f"GroupNorm int8 epilogue {shape}: {row}")
    return row


class ShapeRecorder:
    """Inside `with recorder:`, every call the models make to each named
    kernel wrapper (flash from ops/attention.py, the others from
    unet_blocks) is counted under `keys[name](*args)` (its shape and
    arguments), then passed on to the wrapper unchanged."""

    def __init__(self, keys: dict):
        from polyp_tpu_torch.models import unet_blocks
        from polyp_tpu_torch.ops import attention

        self.keys = keys
        self.owners = {name: attention if name == "flash_attention"
                       else unet_blocks for name in keys}
        self.seen = {name: Counter() for name in keys}

    def __enter__(self):
        self.wrappers = {name: getattr(self.owners[name], name)
                         for name in self.keys}
        for name, fn in self.wrappers.items():
            setattr(self.owners[name], name, self._counted(name, fn))
        return self

    def _counted(self, name: str, fn):
        def call(*args, **kwargs):
            self.seen[name][self.keys[name](*args, **kwargs)] += 1
            return fn(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for name, fn in self.wrappers.items():
            setattr(self.owners[name], name, fn)


def gn_key(x, weight, bias, num_groups=32, eps=1e-5, act=None,
           act_scale=None) -> tuple:
    """(shape, dtype, groups, eps, act, int8 epilogue) of a GroupNorm
    call."""
    return (tuple(x.shape), x.dtype, num_groups, eps, act,
            act_scale is not None)


def flash_key(q, k, v, *args, **kwargs) -> tuple:
    """(q's shape, k's shape, dtype) of a flash attention call (BTHD)."""
    return tuple(q.shape), tuple(k.shape), q.dtype


def sdpa(q, k, v):
    """F.scaled_dot_product_attention on BTHD tensors, as the port's
    attention takes them."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2)).transpose(1, 2)


def dense_key(x, w, *args, **kwargs) -> tuple:
    """(M, C, N, int8 x) of a dense call on x [..., C] with w [N, C]."""
    c = x.shape[-1]
    return x.numel() // c, c, w.shape[0], x.dtype == torch.int8


def recorded_rows(seen: dict, dev: torch.device) -> list[dict]:
    """compare() of GN(+SiLU) (recorded under gn_key; an int8 epilogue
    call held to reference_gn_q8 as gn_rows holds it), the bf16 GEGLU
    (under its x's shape), the W8A8 dense (under dense_key) and flash
    attention (under flash_key) at every recorded shape, on inputs drawn
    as gn_rows, gemm_rows and check_kernels draw them, each row with the
    path's launches at its shape."""
    from polyp_tpu_torch.ops.flash_attention import (
        flash_attention, reference_attention)
    from polyp_tpu_torch.ops.fused_geglu import fused_geglu, reference_geglu
    from polyp_tpu_torch.ops.fused_gn import fused_group_norm, group_norm

    randn = randn_on(dev, seed=0)
    rows = []
    for (qs, ks, dtype), calls in sorted(
            seen.get("flash_attention", {}).items(), key=str):
        q = randn(*qs).to(dtype)
        k, v = (randn(*ks).to(dtype) for _ in range(2))
        n, tq, h, d = qs
        rows.append({**compare(
            "flash_attention", lambda: flash_attention(q, k, v),
            lambda: reference_attention(q, k, v),
            reference_attention(q.float(), k.float(), v.float()),
            str(list(qs)), bound(4 * n * h * tq * ks[1] * d, "bf16",
                                 nbytes(q, k, v) + nbytes(q)),
            library_fn=lambda: sdpa(q, k, v)), "path_launches": calls})
    for (shape, dtype, groups, eps, act, q8), calls in sorted(
            seen.get("fused_group_norm", {}).items(), key=str):
        x = randn(*shape, scale=2.0, shift=0.3).to(dtype)
        gamma = randn(shape[1], scale=0.1, shift=1.0).float()
        beta = randn(shape[1], scale=0.1).float()
        label = f"{list(shape)} eps {eps:g}{' +SiLU' if act else ''}"
        if q8:
            rows.append({**gn_q8_row(x, gamma, beta, groups, eps, act,
                                     label), "path_launches": calls})
            continue
        rows.append({**compare(
            "fused_group_norm",
            lambda: fused_group_norm(x, gamma, beta, groups, eps, act),
            lambda: group_norm(x, gamma, beta, groups, eps, act),
            group_norm(x.float(), gamma, beta, groups, eps, act), label,
            bound(10 * x.numel(), "fp32",
                  2 * nbytes(x) + nbytes(gamma, beta))),
            "path_launches": calls})
    for shape, calls in sorted(seen.get("fused_geglu", {}).items()):
        *lead, c = shape
        n, per_image = lead[0], math.prod(lead[1:])
        h, tokens = 4 * c, n * per_image
        x, w1, b1, w2, b2 = geglu_case(randn, n, c, per_image)
        args = (x.reshape(shape), w1, b1, w2, b2)
        rows.append({**compare(
            "fused_geglu", lambda: fused_geglu(*args),
            lambda: reference_geglu(*args),
            reference_geglu(*(t.float() for t in args)),
            f"[{tokens},{c}]x[{c},{2 * h}]",
            bound(6 * tokens * c * h, "bf16",
                  2 * nbytes(x) + nbytes(w1, b1, w2, b2))),
            "path_launches": calls})
    for (m, c, o, int8_in), calls in sorted(
            seen.get("fused_w8a8_dense", {}).items()):
        rows.append({**dense_row(randn, m, c, o, int8_in, "recorded"),
                     "path_launches": calls})
    return rows


def int8_layers(card_model, cpu_model, forward, bank, t: torch.Tensor
                ) -> dict:
    """One w8a8_static forward of `card_model` (`forward(model, device)`,
    under quant.override with `bank` at timesteps `t`), every call of a
    quantizable layer in it (convs, linears, feed-forwards, GroupNorm int8
    epilogues) captured with its inputs and output, and each re-run on the
    CPU in fp32 (`cpu_model`'s layer, plain versions) from the card's
    input: the worst relative L2 of a layer and the share of GroupNorm
    int8 codes that differ. Returns the counts and the card's output."""
    from polyp_tpu_torch.models.unet_blocks import (
        FeedForward, GroupNorm, QConv2d, QLinear)
    from polyp_tpu_torch.ops import quant

    calls = []

    def capture(name):
        def hook(module, args, output):
            if isinstance(module, GroupNorm) and (len(args) < 2
                                                  or args[1] is None):
                return  # a GroupNorm without the int8 epilogue
            calls.append((name, [a.detach().to("cpu", copy=True)
                                 for a in args],
                          output.detach().to("cpu", copy=True)))
        return hook

    dev = next(card_model.parameters()).device
    hooks = [m.register_forward_hook(capture(name))
             for name, m in card_model.named_modules()
             if isinstance(m, (QConv2d, QLinear, FeedForward, GroupNorm))]
    try:
        with torch.no_grad(), quant.override("w8a8_static", scales=bank,
                                             t=t.to(dev)):
            got = forward(card_model, dev)
    finally:
        for h in hooks:
            h.remove()
    worst, worst_name, codes, flipped, max_code = 0.0, "", 0, 0, 0
    with torch.no_grad(), quant.override("w8a8_static", scales=bank,
                                         t=t.cpu()):
        for name, args, out in calls:
            args = [a.float() if a.is_floating_point() else a
                    for a in args]
            want = cpu_model.get_submodule(name)(*args)
            if out.dtype == torch.int8:
                diff = (out.int() - want.int()).abs()
                codes += diff.numel()
                flipped += int((diff > 0).sum())
                max_code = max(max_code, int(diff.max()))
                continue
            err = rel_l2(out, want)
            if err > worst:
                worst, worst_name = err, name
    expected = sum(isinstance(m, (QConv2d, FeedForward))
                   for m in card_model.modules())
    out = {"layers_checked": len(calls), "layer_max_rel_l2": worst,
           "worst_layer": worst_name,
           "gn_q8_codes_differing": flipped / max(codes, 1),
           "gn_q8_max_code_diff": max_code, "output": got}
    # every quantized conv and feed-forward must have been seen
    if len(calls) < expected or not worst <= LAYER_REL_L2:
        raise AssertionError(f"int8 layer {worst_name}: rel L2 {worst} > "
                             f"{LAYER_REL_L2} ({len(calls)} calls, "
                             f"{expected} expected)")
    if max_code > 1 or out["gn_q8_codes_differing"] > GN_Q8_SHARE:
        raise AssertionError(f"GN int8 codes: {out}")
    return out


def check_against_cpu(stack, dev: torch.device, scales: dict) -> dict:
    """One UNet forward (latents 32×32, CFG batch 2) and one VAE decode
    (8×8 latents) with the kernels, vs the same weights in fp32 on the CPU
    running the plain versions; and one w8a8_static UNet forward with
    `scales`, whose every quantized layer is re-run on the CPU from the
    card's input to it (int8_layers)."""
    from polyp_tpu_torch.models import AutoencoderKL, sd14_unet
    from polyp_tpu_torch.ops import quant

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
    bank = quant.ScaleBank(scales)

    def forward(unet, device):
        return unet(x.to(device), t.to(device), ctx.to(device))

    with torch.no_grad():
        want_unet = unet_cpu(x, t, ctx)
        with quant.override("w8a8_static", scales=bank, t=t):
            want_q8 = unet_cpu(x, t, ctx)
        want_img = vae_cpu.decode(z)
        got_unet = stack.unet(x.to(dev), t.to(dev), ctx.to(dev))
        got_img = stack.vae.decode(z.to(dev))
    layers = int8_layers(stack.unet, unet_cpu, forward, bank, t)
    got_q8 = layers.pop("output")
    worst, worst_name = layers["layer_max_rel_l2"], layers["worst_layer"]
    max_code = layers["gn_q8_max_code_diff"]
    out = {"unet_rel_l2": rel_l2(got_unet, want_unet),
           "vae_rel_l2": rel_l2(got_img, want_img),
           "w8a8_static_layers_checked": layers["layers_checked"],
           "w8a8_static_layer_max_rel_l2": worst,
           "w8a8_static_worst_layer": worst_name,
           "gn_q8_codes_differing": layers["gn_q8_codes_differing"],
           "gn_q8_max_code_diff": max_code,
           "unet_w8a8_static_rel_l2": rel_l2(got_q8, want_q8),
           "cpu_int8_vs_fp32_rel_l2": rel_l2(want_q8, want_unet),
           "card_int8_vs_bf16_rel_l2": rel_l2(got_q8, got_unet)}
    print(f"[check] card bf16 vs cpu fp32: UNet rel L2 "
          f"{out['unet_rel_l2']:.3e}, VAE decode rel L2 "
          f"{out['vae_rel_l2']:.3e} (tol {REL_L2_TOLERANCE:.0e})", flush=True)
    print(f"[check] card w8a8_static UNet forward, layer by layer vs cpu fp32 "
          f"from the card's inputs: {layers['layers_checked']} layer calls, "
          f"max rel L2 "
          f"{worst:.3e} ({worst_name}; tol {LAYER_REL_L2:.0e}); GN int8 "
          f"codes differing {out['gn_q8_codes_differing']:.3e}, max "
          f"{max_code} (tol {GN_Q8_SHARE:.0e})", flush=True)
    print(f"[check] whole w8a8_static forward: card vs cpu rel L2 "
          f"{out['unet_w8a8_static_rel_l2']:.3e}; int8 vs fp32 on the cpu "
          f"{out['cpu_int8_vs_fp32_rel_l2']:.3e}, int8 vs bf16 on the card "
          f"{out['card_int8_vs_bf16_rel_l2']:.3e} (tol "
          f"{INT8_FORWARD_NOISE} x the cpu's)", flush=True)
    for key in ("unet_rel_l2", "vae_rel_l2"):
        if not out[key] <= REL_L2_TOLERANCE:
            raise AssertionError(f"{key} {out[key]} > {REL_L2_TOLERANCE}")
    if not out["unet_w8a8_static_rel_l2"] <= (
            INT8_FORWARD_NOISE * out["cpu_int8_vs_fp32_rel_l2"]):
        raise AssertionError(f"int8 forward: {out}")
    return out


def check_tiny_decoder(tiny, dev: torch.device) -> float:
    """One tiny-decoder forward on the card (bf16 convs) vs the same
    converted weights in fp32 on the CPU, from the same scaled latents."""
    from polyp_tpu_torch.models.tiny_decoder import load_tiny_decoder

    cpu, _ = load_tiny_decoder(dtype=torch.float32, device="cpu")
    z = torch.randn(2, 4, 32, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = tiny(z.to(dev)), cpu(z)
    rel = rel_l2(got, want)
    print(f"[check] tiny decoder, card bf16 vs cpu fp32 on [2,4,32,32] "
          f"latents: rel L2 {rel:.3e} (tol {REL_L2_TOLERANCE:.0e})",
          flush=True)
    if not (got.shape == (2, 3, 256, 256) and rel <= REL_L2_TOLERANCE):
        raise AssertionError(f"tiny decoder {tuple(got.shape)}: rel L2 {rel}")
    return rel


# kernel families a profile sums by name, each kernel into the first family
# it matches: this tree's kernels and the earlier ones they replaced (the
# same names in a parent's profile); the int8 GEGLUs' second launches run
# the dense's policies under names of their own, GegluQ8Down (static) and
# GegluQ8PtDown (per-token, whose earlier kernels were geglu_q8_pt_partial
# and geglu_q8_pt_reduce)
FAMILIES = {"w8a8_dense": ("Dense<", "dense_q8_kernel"),
            "bf16_geglu": ("GegluUp<", "GegluDown<", "geglu_partial_kernel",
                           "geglu_reduce_kernel"),
            "int8_geglu_pt": ("GegluQ8Pt", "geglu_q8_pt"),
            "int8_geglu": ("GegluQ8", "geglu_q8", "geglu_w8a8"),
            "group_norm": ("group_norm", "gn_"),
            "attention": ("flash_fwd", "fused_mha", "kv_project")}


def profile_loop(sampler, batch: int) -> dict:
    """Device time of one batch's sampling loop (`sampler.denoise`, CFG or
    folded) from torch.profiler's kernel events: the total, the sums of the
    kernel FAMILIES (ms, calls) and the largest items."""
    dev = sampler.device
    cond = sampler.encode_prompt(PROMPT)
    uncond = (None if sampler.guidance_scale is None
              else sampler.encode_prompt(""))
    out = profile_device(lambda: sampler.denoise(
        cond, uncond, batch, torch.Generator(dev).manual_seed(0)))
    return {**out, "steps": sampler.num_steps}


ANNOTATION = re.compile(r"[\w.]+#[\w.]+")


def profile_device(fn) -> dict:
    """torch.profiler's kernel events of one call of `fn`: the device
    time, the sums of the kernel FAMILIES (ms, calls) and the largest
    items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # "range#name" entries (torch.optim's "Optimizer.step#Adam.step") are
    # annotations spanning kernels already counted, not kernels (a kernel's
    # name has no such form: "{lambda()#1}" sits among "::" and brackets)
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and not ANNOTATION.fullmatch(e.key)),
                     key=us, reverse=True)
    families = {fam: [0.0, 0] for fam in FAMILIES}
    for e in kernels:
        fam = next((f for f, keys in FAMILIES.items()
                    if any(k in e.key for k in keys)), None)
        if fam:
            families[fam][0] += us(e) / 1e3
            families[fam][1] += e.count
    return {"device_s": sum(us(e) for e in kernels) / 1e6,
            "families": families,
            "top": [[e.key[:60], us(e) / 1e3, e.count] for e in kernels[:8]]}


def gemm_key(x: torch.Tensor, n: int) -> str:
    """[M, C]x[C, N] of a GEGLU or dense call on x [..., C], int8 x
    marked."""
    c = x.shape[-1]
    int8 = " int8" if x.dtype == torch.int8 else ""
    return f"[{x.numel() // c},{c}]x[{c},{n}]{int8}"


def shape_census(stack, dev: torch.device, scales: dict) -> dict:
    """Launches by shape of the bf16 GEGLU and the W8A8 dense in a UNet
    forward (one bf16 and one w8a8_static forward, CFG batch 4, 32×32
    latents; [M, C]x[C, N], int8 x marked), and of GroupNorm+SiLU in one
    VAE decode at the CFG batch 2 ([N, C, H, W]): the wrappers that
    unet_blocks calls, counted per shape."""
    from polyp_tpu_torch.ops import quant

    forward = ShapeRecorder({  # w1 is [2N, C]; the dense's w [N, C]
        "fused_geglu": lambda x, w, *args: gemm_key(x, w.shape[0] // 2),
        "fused_w8a8_dense": lambda x, w, *args, **kwargs: gemm_key(
            x, w.shape[0])})
    decode = ShapeRecorder({"fused_group_norm": lambda x, *args, **kwargs:
                            str(list(x.shape))})
    g = torch.Generator("cpu").manual_seed(3)
    x = torch.randn(4, 4, 32, 32, generator=g).to(dev, torch.bfloat16)
    t = torch.full((4,), 500, device=dev)
    ctx = torch.randn(4, 77, 768, generator=g).to(dev, torch.bfloat16)
    z = torch.randn(2, 4, 32, 32, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        with forward:
            stack.unet(x, t, ctx)
            with quant.override("w8a8_static", scales=quant.ScaleBank(scales),
                                t=t):
                stack.unet(x, t, ctx)
        with decode:
            stack.vae.decode(z)
    return {name: dict(sorted(c.items()))
            for name, c in {**forward.seen, **decode.seen}.items()}


def split_timed(sampler, spent: dict):
    """The batch function of `sampler.for_prompt(PROMPT)` (the sampling
    loop, then the decode), with the two timed apart on synchronised host
    clocks and added to spent["unet_s"] and spent["decode_s"], as
    bench.py::bench_distilled splits them."""
    cond = sampler.encode_prompt(PROMPT)
    uncond = sampler.encode_prompt("")

    def fn(batch_size: int, seed: int) -> torch.Tensor:
        gen = torch.Generator(sampler.device).manual_seed(seed)
        torch.cuda.synchronize()
        start = time.perf_counter()
        z = sampler.denoise(cond, uncond, batch_size, gen)
        torch.cuda.synchronize()
        mid = time.perf_counter()
        images = sampler.decode(z)
        torch.cuda.synchronize()
        spent["unet_s"] += mid - start
        spent["decode_s"] += time.perf_counter() - mid
        return images
    return fn


def run_path(fn, out_dir: Path, n_images: int, batch: int
             ) -> tuple[float, torch.Tensor]:
    """generate_to_dir of `n_images` from seed 0 through the batch function
    `fn`; checks the images and PNGs, returns (seconds, images)."""
    from PIL import Image

    from polyp_tpu_torch.pipeline import generate_to_dir

    kept = []

    def checked(batch_size: int, seed: int) -> torch.Tensor:
        images = fn(batch_size, seed)
        if images.shape != (batch_size, 3, 256, 256):
            raise AssertionError(f"images {tuple(images.shape)}")
        if not torch.isfinite(images).all():
            raise AssertionError("non-finite images")
        kept.append(images.float().cpu())
        return images

    start = time.perf_counter()
    written = generate_to_dir(checked, n_images, out_dir,
                              eval_batch_size=batch, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    pngs = sorted(out_dir.glob("*.png"))
    if written != n_images or len(pngs) != n_images:
        raise AssertionError(f"{written} written, {len(pngs)} PNGs")
    for p in pngs:
        with Image.open(p) as im:
            if im.size != (256, 256) or im.mode != "RGB":
                raise AssertionError(f"{p.name}: {im.size} {im.mode}")
    return seconds, torch.cat(kept)


# the serving phase's prompts: the first two for the base model and the
# last two for the student (routing); the load generator cycles all four
SERVE_PROMPTS = ("a realistic photo of colon polyp",
                 "a realistic photo of adenomatous colon polyp",
                 "a realistic photo of hyperplastic colon polyp",
                 "a realistic photo of sessile serrated colon polyp")
# the services' launch size (serve.py's default max_batch), and the closed
# loop's clients and seconds for each of the coalesced and solo services
SERVE_BATCH = 8
LOAD_CLIENTS, LOAD_SECONDS = 8, 10.0


def http_json(url: str, payload: dict | None = None):
    """GET (payload None) or POST a JSON body: (status, body, headers),
    HTTP errors included."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def in_threads(calls: list) -> list:
    """Each zero-argument call on a thread of its own, all started at
    once; their results in order. A call that raised fails the run."""
    import threading

    results, errors = [None] * len(calls), []

    def run(i, fn):
        try:
            results[i] = fn()
        except Exception as e:  # raised again below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"request threads failed: {errors}")
    return results


def png_pixels(data: bytes):
    import io

    import numpy as np
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def serving_phase(stack, tiny, card: str, reset_counts, read_counts,
                  tmp: Path) -> dict:
    """The serving slice at full width. Services over make_sampler's bf16
    stack at the service defaults (UniPC, 25 steps, CFG 7.5, max_batch 8)
    and over a 4-step student (tiny decoder, fused MHA), behind the HTTP
    server on a loopback port: health, 8 concurrent requests coalesced into
    at most 2 launches, a solo request's PNG pixel-equal to its coalesced
    twin, routing across two models, shedding with 429, the kernels' launches
    per request of every service (the int8 ones too), the load generator
    coalesced vs solo, and generate_to_dir's host seconds an image before
    and after its overlap. Every count is set to 0 just before each run and
    read just after."""
    import base64

    import numpy as np

    from polyp_tpu_torch.cli.distill_sd import make_student_sampler
    from polyp_tpu_torch.cli.sd_common import make_sampler
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.data.native import encode_png, png_encoder
    from polyp_tpu_torch.pipeline import generate_to_dir, to_uint8
    from polyp_tpu_torch.serve import GenerationService, serve
    from polyp_tpu_torch.tools.bench_serve import run_load

    out: dict = {"card": card}

    def launched(sampler, pad):
        return lambda prompts, ids: sampler.generate_batch(prompts, ids,
                                                           pad_to=pad)

    def per_request(counts):
        return {k: v / SERVE_BATCH for k, v in counts.items()}

    def need(what, counts, kernels):
        for kernel in kernels:
            if counts[kernel] <= 0:
                raise AssertionError(f"{what} never launched {kernel}")

    base = make_sampler(stack, DiffusionConfig(image_size=256))
    if (base.sampler, base.num_steps, base.guidance_scale) != (
            "unipc", 25, 7.5):
        raise AssertionError("make_sampler does not give the service "
                             "defaults")
    student = make_student_sampler(stack, stack.unet, num_steps=4,
                                   decoder=tiny, fused_mha=True)

    # the base service behind HTTP: health, 8 concurrent 1-image requests,
    # then one of them again alone
    service = GenerationService(launched(base, SERVE_BATCH), SERVE_BATCH,
                                warm_prompt=PROMPT)
    server = serve(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health, _ = http_json(url + "/healthz")
        if status != 200 or not health["warm"]:
            raise AssertionError(f"/healthz {status}: {health}")
        asks = [{"prompt": SERVE_PROMPTS[i % 2], "num_images": 1,
                 "seed": 100 + i} for i in range(SERVE_BATCH)]
        before = service.snapshot()["launches"]
        reset_counts()
        start = time.perf_counter()
        answers = in_threads([functools.partial(
            http_json, url + "/generate", a) for a in asks])
        coalesced_s = time.perf_counter() - start
        counts = read_counts()
        launches = service.snapshot()["launches"] - before
        if any(s != 200 for s, _, _ in answers) or launches > 2:
            raise AssertionError(f"8 requests: {launches} launches, "
                                 f"answers {[b for _, b, _ in answers]}")
        reset_counts()
        status, solo, _ = http_json(url + "/generate", asks[3])
        solo_counts = read_counts()
        if status != 200 or solo["batched_samples"] != 1:
            raise AssertionError(f"solo request {status}: {solo}")
    finally:
        server.shutdown()
        service.close()
    a = png_pixels(base64.b64decode(solo["images"][0]))
    b = png_pixels(base64.b64decode(answers[3][1]["images"][0]))
    differ = int((a != b).any(axis=-1).sum())
    out["base"] = {
        "healthz": health, "requests": SERVE_BATCH, "launches": launches,
        "seconds": coalesced_s,
        "batched_samples": sorted({r["batched_samples"]
                                   for _, r, _ in answers}),
        "kernel_launches": counts, "launches_per_request": per_request(counts),
        "solo_kernel_launches": solo_counts, "image_shape": list(a.shape),
        "solo_vs_coalesced_pixels_differing": differ,
        "solo_vs_coalesced_max_abs": int(np.abs(a.astype(int)
                                                - b.astype(int)).max())}
    print(f"[serving] base service (UniPC, 25 steps, CFG 7.5, max_batch 8): "
          f"8 concurrent requests in {launches} launch(es), "
          f"{coalesced_s:.2f} s; a solo request vs its coalesced twin: "
          f"{differ} pixels differ; kernel launches {counts}", flush=True)
    if differ or a.shape != (256, 256, 3):
        raise AssertionError(f"a sample differs solo and coalesced: "
                             f"{out['base']}")
    need("the base service", counts,
         ("flash_attention", "fused_geglu", "fused_group_norm"))

    # what the slot-invariant convolutions cost: one base launch (8 rows,
    # 25 steps) inside and outside ops.conv.slot_invariant_region, in
    # turns (outside, inside, inside, outside), each synchronised
    from polyp_tpu_torch.ops import conv
    pairs = [(p, (7, i)) for i, p in enumerate(SERVE_PROMPTS * 2)]
    cond = torch.cat([base.encode_prompt(p) for p, _ in pairs])
    latents, _ = base.draw_latents([ids for _, ids in pairs])
    region_s = {"inside": [], "outside": []}
    for where in ("outside", "inside", "inside", "outside"):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with conv.slot_invariant_region(where == "inside"), torch.no_grad():
            base.generate(cond, base.encode_prompt(""), SERVE_BATCH,
                          init=latents)
        torch.cuda.synchronize()
        region_s[where].append(time.perf_counter() - start)
    out["base"]["launch_s_by_conv_region"] = region_s
    print(f"[serving] one base launch (8 rows, 25 steps), convs inside the "
          f"slot-invariant region {region_s['inside']} s, outside "
          f"{region_s['outside']} s on {card}", flush=True)

    # the int8 services and the student alone: each kernel's launches for 8
    # coalesced requests (after a warm launch)
    services = {"w8a8_static": (make_sampler(stack, DiffusionConfig(
                    image_size=256, quantize="w8a8_static",
                    quant_fp_head=5)), ("fused_w8a8_dense",
                                        "fused_geglu_w8a8",
                                        "fused_group_norm_q8")),
                "w8a8": (make_sampler(stack, DiffusionConfig(
                    image_size=256, quantize="w8a8")),
                    ("fused_w8a8_dense", "fused_geglu_w8a8_pt")),
                "student": (student, ("fused_mha", "fused_geglu"))}
    for name, (sampler, kernels) in services.items():
        service = GenerationService(launched(sampler, SERVE_BATCH),
                                    SERVE_BATCH, warm_prompt=PROMPT)
        try:
            before = service.snapshot()["launches"]
            reset_counts()
            answers = in_threads([functools.partial(
                service.generate, p, 1, seed=i)
                for i, p in enumerate(SERVE_PROMPTS * 2)])
            counts = read_counts()
            launches = service.snapshot()["launches"] - before
            solo = service.generate(SERVE_PROMPTS[3], 1, seed=3)
        finally:
            service.close()
        a = png_pixels(base64.b64decode(solo["images"][0]))
        b = png_pixels(base64.b64decode(answers[3]["images"][0]))
        differ = int((a != b).any(axis=-1).sum())
        out[name] = {"requests": SERVE_BATCH, "launches": launches,
                     "kernel_launches": counts,
                     "launches_per_request": per_request(counts),
                     "solo_vs_coalesced_pixels_differing": differ}
        print(f"[serving] {name} service: 8 requests in {launches} "
              f"launch(es); a solo request vs its coalesced twin: {differ} "
              f"pixels differ; kernel launches {counts}", flush=True)
        need(f"the {name} service", counts, kernels)
        # the contract holds for bf16; dynamic w8a8 scales each activation
        # by the whole launch's amax, and w8a8_static is measured here
        if name == "student" and differ:
            raise AssertionError(f"a student sample differs solo and "
                                 f"coalesced: {out[name]}")

    # two models behind one service: each request reaches its own
    routed = {"base": set(), "student": set()}

    def recording(name, sampler):
        fn = launched(sampler, SERVE_BATCH)

        def call(prompts, ids):
            routed[name].update(prompts)
            return fn(prompts, ids)
        return call

    service = GenerationService({"base": recording("base", base),
                                 "student": recording("student", student)},
                                SERVE_BATCH)
    try:
        reset_counts()
        answers = in_threads([functools.partial(
            service.generate, SERVE_PROMPTS[i % 4], 1, seed=i,
            model="base" if i % 4 < 2 else "student")
            for i in range(2 * SERVE_BATCH)])
        counts = read_counts()
        stats = service.snapshot()
    finally:
        service.close()
    out["routing"] = {"launches_by_model": stats["launches_by_model"],
                      "prompts_by_model": {k: sorted(v)
                                           for k, v in routed.items()},
                      "kernel_launches": counts}
    print(f"[serving] routing: launches by model "
          f"{stats['launches_by_model']}, prompts by model "
          f"{out['routing']['prompts_by_model']}; kernel launches {counts}",
          flush=True)
    if (any(r["model"] != ("base" if r["prompt"] in SERVE_PROMPTS[:2]
                           else "student") for r in answers)
            or routed["base"] != set(SERVE_PROMPTS[:2])
            or routed["student"] != set(SERVE_PROMPTS[2:])
            or min(stats["launches_by_model"].values()) < 1):
        raise AssertionError(f"routing: {out['routing']}")
    need("the student model", counts, ("fused_mha",))

    # shedding: max_pending 1 under a burst of 8
    service = GenerationService(launched(student, SERVE_BATCH), SERVE_BATCH,
                                max_pending=1)
    server = serve(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        burst = in_threads([functools.partial(
            http_json, url + "/generate",
            {"prompt": SERVE_PROMPTS[2], "num_images": 1, "seed": i})
            for i in range(SERVE_BATCH)])
        _, health, _ = http_json(url + "/healthz")
    finally:
        server.shutdown()
        service.close()
    codes = sorted(s for s, _, _ in burst)
    out["shedding"] = {"status_codes": codes, "stats": health["stats"],
                       "retry_after": sorted({h.get("Retry-After")
                                              for s, _, h in burst
                                              if s == 429})}
    print(f"[serving] max_pending 1, a burst of 8: status {codes}, stats "
          f"{health['stats']}", flush=True)
    if (429 not in codes or 200 not in codes or set(codes) - {200, 429}
            or health["stats"]["shed"] != codes.count(429)
            or out["shedding"]["retry_after"] != ["1"]):
        raise AssertionError(f"shedding: {out['shedding']}")

    # the load generator on the student, coalesced vs solo
    out["load"] = {}
    for mode, max_batch in (("coalesced", SERVE_BATCH), ("solo", 1)):
        service = GenerationService(launched(student, max_batch), max_batch,
                                    warm_prompt=PROMPT)
        try:
            for p in SERVE_PROMPTS:
                service.generate(p, 1, seed=0)
            stats = run_load(service, LOAD_CLIENTS, LOAD_SECONDS,
                             prompts=list(SERVE_PROMPTS))
        finally:
            service.close()
        out["load"][mode] = {**stats, "max_batch": max_batch}
        print(f"[serving] load, student (4 steps, tiny decoder, fused MHA), "
              f"{mode} (max_batch {max_batch}), {LOAD_CLIENTS} clients, "
              f"{stats['duration_s']:.1f} s: "
              f"{stats['throughput_samples_per_s']:.2f} samples/s, p50 "
              f"{stats['p50_s']:.3f} s, p95 {stats['p95_s']:.3f} s, mean "
              f"occupancy {stats['mean_batch_occupancy']:.2f} on {card}",
              flush=True)
    out["load"]["coalescing_speedup"] = (
        out["load"]["coalesced"]["throughput_samples_per_s"]
        / out["load"]["solo"]["throughput_samples_per_s"])

    # generate_to_dir on distilled_bf16_tiny: the host seconds an image
    # beyond the sampling alone, serial (a yardstick kept here only: sample,
    # fetch, encode, then the next batch) and overlapped (pipeline.py), in
    # turns; the native encoder where `make` builds it here, else PIL
    make = subprocess.run(["make", "-C", str(ROOT / "native"),
                           "libpolyp_png.so"], capture_output=True, text=True)
    if make.returncode != 0:
        print(f"[serving] `make -C native libpolyp_png.so` failed, so PIL "
              f"encodes: {make.stdout[-400:]} {make.stderr[-800:]}",
              flush=True)
    encoder = png_encoder()
    n_images, batch = 96, 32
    fn = make_student_sampler(stack, stack.unet, num_steps=4, decoder=tiny,
                              fused_mha=True).for_prompt(PROMPT)

    def sampling_only(_: Path) -> None:
        for b in range(n_images // batch):
            fn(batch, b)

    def serial(out_dir: Path) -> None:
        out_dir.mkdir()
        for b in range(n_images // batch):
            for i, img in enumerate(to_uint8(fn(batch, b))):
                (out_dir / f"{b * batch + i + 1}.png").write_bytes(
                    encode_png(img, level=4))

    def overlapped(out_dir: Path) -> None:
        generate_to_dir(fn, n_images, out_dir, eval_batch_size=batch)

    forms = {"sampling": sampling_only, "serial": serial,
             "overlapped": overlapped}
    runs = {k: [] for k in forms}
    dirs = []
    sampling_only(tmp)  # warm
    for turn, kind in enumerate(("serial", "overlapped", "overlapped",
                                 "serial")):
        for name in ("sampling", kind):
            out_dir = tmp / f"to_dir_{turn}_{name}"
            torch.cuda.synchronize()
            start = time.perf_counter()
            forms[name](out_dir)
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - start)
        dirs.append(tmp / f"to_dir_{turn}_{kind}")
    for out_dir in dirs[1:]:
        for i in range(1, n_images + 1):
            if not np.array_equal(
                    png_pixels((dirs[0] / f"{i}.png").read_bytes()),
                    png_pixels((out_dir / f"{i}.png").read_bytes())):
                raise AssertionError(f"{out_dir.name}/{i}.png differs from "
                                     f"{dirs[0].name}")
    sampling_s = sum(runs["sampling"]) / len(runs["sampling"])
    host = {k: [(w - sampling_s) / n_images for w in runs[k]]
            for k in ("serial", "overlapped")}
    out["conv_plans"] = {
        f"x{list(key[2])} w{list(key[3])} stride {key[4][0]}": plan
        for key, plan in conv._PLANS.items()}
    print(f"[serving] conv shapes probed for slot invariance: "
          f"{len(conv._PLANS)}, run as unfold + GEMM: "
          f"{sorted(k for k, v in out['conv_plans'].items() if v == 'unfold')}",
          flush=True)
    out["generate_to_dir"] = {
        "path": "distilled_bf16_tiny", "images": n_images, "batch": batch,
        "png_encoder": encoder, "make_returncode": make.returncode,
        "runs_s": runs, "sampling_s": sampling_s, "host_s_per_image": host}
    print(f"[serving] generate_to_dir, distilled_bf16_tiny ({n_images} "
          f"images, batch {batch}, PNG encoder: {encoder}): sampling alone "
          f"{sampling_s:.3f} s; host seconds an image beyond it, serial "
          f"{host['serial']}, overlapped {host['overlapped']} on {card}",
          flush=True)
    return out


class FixedDraws:
    """A train step's draws, fixed on the host and copied to where the
    step runs, so the card and the CPU compute the same step."""

    def __init__(self, n: int, latent_shape, keep_masks=None, seed=0):
        g = torch.Generator().manual_seed(seed)
        self.values = {
            "flip": torch.rand(n, generator=g) < 0.5,
            "posterior": torch.randn(latent_shape, generator=g),
            "noise": torch.randn(latent_shape, generator=g),
            "timesteps": torch.randint(0, 1000, (n,), generator=g)}
        self.device = "cpu"

    def to(self, device):
        self.device = device
        return self

    def flip(self, n):
        return self.values["flip"].to(self.device)

    def normal(self, what, shape):
        return self.values[what].to(self.device)

    def timesteps(self, n, high):
        return self.values["timesteps"].to(self.device)

    def keep_mask(self, stream, name, rows, keep):
        raise AssertionError("the comparison runs without dropout")


def base_weights(stack) -> dict:
    """Copies of every parameter and buffer of the stack's modules."""
    return {(m, k): v.detach().clone()
            for m in ("unet", "vae", "text")
            for k, v in getattr(stack, m).state_dict().items()}


def check_base_unchanged(stack, before: dict, when: str) -> None:
    for (m, k), v in before.items():
        if not torch.equal(getattr(stack, m).state_dict()[k], v):
            raise AssertionError(f"{when}: the stack's {m}.{k} changed")


def train_vs_cpu(stack, dev: torch.device) -> dict:
    """One step's loss and LoRA gradients at batch 1 on the card (bf16,
    kernels) and on the CPU (fp32 copies of the same weights, plain
    versions), with the same draws and an adapter whose B is not 0 (so
    every factor has a gradient)."""
    import numpy as np

    from polyp_tpu_torch.cli.sd_common import make_components
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.lora import LoRAConfig, init_lora
    from polyp_tpu_torch.cli.common import build_modules
    from polyp_tpu_torch.train import sd_finetune as sf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves, tree_map

    cfg = DiffusionConfig(learning_rate=1e-4, num_epochs=1, lora_rank=8,
                          lora_alpha=8, lora_dropout=0.0).with_schedule(1)
    lcfg = LoRAConfig(8, 8, 0.0, cfg.modules_lora)
    g = torch.Generator(dev).manual_seed(3)
    adapter = init_lora(stack.unet, lcfg, g)
    for f in adapter.values():
        f["lora_B"] = torch.randn(f["lora_B"].shape, generator=g,
                                  device=dev) * 1e-3
    bundle = sf.init_trainable(adapter)
    frozen = make_components(stack, bundle)
    images = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, TRAIN_PX, TRAIN_PX, 3), dtype=np.uint8))
    ids = torch.as_tensor(stack.tokenizer([PROMPT]))
    lat = (1, 4, TRAIN_PX // 8, TRAIN_PX // 8)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)

    def run(frozen, state, device):
        return sf.sd_lora_loss_and_grads(
            state, frozen, schedule, images.to(device), ids.to(device), None,
            FixedDraws(1, lat).to(device), lcfg)

    card_loss, card_grads = run(frozen, sf.create_sd_train_state(cfg, bundle),
                                dev)
    unet, vae, text = (m.to_empty(device="cpu") for m in build_modules(
        stack.tiny, torch.float32, "meta"))
    for cpu, card in ((unet, stack.unet), (vae, stack.vae),
                      (text, stack.text)):
        cpu.load_state_dict(card.state_dict())
        cpu.eval()
    cpu_frozen = sf.SDComponents(
        unet, vae, text, tree_map(lambda t: t.cpu(), frozen.unet_params))
    cpu_bundle = tree_map(lambda t: t.cpu(), bundle)
    cpu_loss, cpu_grads = run(cpu_frozen,
                              sf.create_sd_train_state(cfg, cpu_bundle),
                              "cpu")
    flat = [torch.cat([t.float().cpu().reshape(-1)
                       for t in tree_leaves(tree)])
            for tree in (card_grads, cpu_grads)]
    out = {"loss_card": card_loss.item(), "loss_cpu": cpu_loss.item(),
           "loss_rel": abs(card_loss.item() - cpu_loss.item())
           / abs(cpu_loss.item()),
           "grad_rel_l2": rel_l2(flat[0], flat[1]),
           "grad_values": flat[1].numel(),
           "loss_tolerance": REL_L2_TOLERANCE,
           "grad_tolerance": LORA_GRAD_REL_L2}
    print(f"[train] one step at batch 1, card bf16 vs cpu fp32, same "
          f"draws: loss {out['loss_card']:.6f} vs {out['loss_cpu']:.6f} "
          f"(rel {out['loss_rel']:.3e}, tol {REL_L2_TOLERANCE:.0e}); LoRA "
          f"gradients ({out['grad_values']} values) rel L2 "
          f"{out['grad_rel_l2']:.3e} (tol {LORA_GRAD_REL_L2:.0e})",
          flush=True)
    if not (out["loss_rel"] <= REL_L2_TOLERANCE
            and out["grad_rel_l2"] <= LORA_GRAD_REL_L2):
        raise AssertionError(f"train step, card vs cpu: {out}")
    return out


def training_phase(stack, dev: torch.device, card: str, reset_counts,
                   read_counts, tmp: Path) -> dict:
    """SD LoRA training at full SD-v1-4 width through train_sd_lora:
    the default run (48 images, batch 8, 256px, rank 8, α 8, dropout 0,
    the `attention` preset, lr 1e-4, 6 steps), every count set to 0 just
    before it and read just after, and per step; a run with every flag on
    (text LoRA, DreamBooth `sks`, visual influence, unfrozen attention
    projections, dropout 0.3, accumulation 2) over two updates; one step
    on the card against the CPU; the bundle saved, reloaded, merged and
    sampled. The stack's weights are held bit-equal throughout."""
    import numpy as np

    from PIL import Image

    from polyp_tpu_torch.cli.sd_common import (
        make_components, make_sampler, merged_stack)
    from polyp_tpu_torch.configs import LORA_MODULE_PRESETS, DiffusionConfig
    from polyp_tpu_torch.data.pipeline import Loader
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.lora import (
        LoRAConfig, init_lora, load_lora, save_lora)
    from polyp_tpu_torch.models.unet_blocks import GroupNorm
    from polyp_tpu_torch.pipeline import generate_to_dir
    from polyp_tpu_torch.train import dreambooth as db
    from polyp_tpu_torch.train import sd_finetune as sf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves, tree_map

    before = base_weights(stack)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)
    encode_gn = sum(isinstance(m, GroupNorm)
                    for m in stack.vae.encoder.modules())
    if encode_gn != ENCODE_GN:
        raise AssertionError(f"the encoder has {encode_gn} GroupNorms")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (TRAIN_IMAGES, TRAIN_PX, TRAIN_PX, 3),
                          dtype=np.uint8)
    labels = np.zeros(TRAIN_IMAGES, np.int64)
    ids = np.asarray(stack.tokenizer([PROMPT]))
    out: dict = {"card": card}

    # the default run
    loader = Loader(images, labels, TRAIN_BATCH, seed=0, device=dev)
    cfg = DiffusionConfig(image_size=TRAIN_PX, train_batch_size=TRAIN_BATCH,
                          num_epochs=1, learning_rate=1e-4, lora_rank=8,
                          lora_alpha=8, lora_dropout=0.0,
                          lora_preset="attention").with_schedule(len(loader))
    lcfg = LoRAConfig(cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout,
                      cfg.modules_lora)
    bundle = sf.init_trainable(init_lora(stack.unet, lcfg,
                                         torch.Generator(dev).manual_seed(0)))
    frozen = make_components(stack, bundle)
    state = sf.create_sd_train_state(cfg, bundle)
    steps: list[dict] = []
    last = {"t": 0.0, "counts": None}

    def per_step(epoch, step, state, loss):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), read_counts()
        prev = last["counts"]
        steps.append({
            "loss": loss.item(), "seconds": now - last["t"],
            "launches": {k: v - (prev[k] if prev else 0)
                         for k, v in counts.items()},
            "lora_B_abs_sum": sum(f["lora_B"].abs().sum().item()
                                  for f in state.trainable[
                                      "unet_lora"].values())})
        last["t"], last["counts"] = time.perf_counter(), counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    last["t"] = time.perf_counter()
    state, result = sf.train_sd_lora(cfg, state, frozen, schedule, loader,
                                     ids, lcfg, step_callback=per_step)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    timed = [s["seconds"] for s in steps[1:]]
    out["default"] = {
        "images": TRAIN_IMAGES, "batch": TRAIN_BATCH, "px": TRAIN_PX,
        "rank": 8, "alpha": 8, "preset": "attention", "steps": len(steps),
        "per_step": steps, "loss_hist": result.loss_hist,
        "launches": launches,
        "launches_per_step": {k: v / len(steps) for k, v in launches.items()},
        "step_s": sum(timed) / len(timed), "first_step_s": steps[0]["seconds"],
        "images_per_s": TRAIN_BATCH * len(timed) / sum(timed),
        "max_memory_allocated": peak,
        "lora_params": sum(f["lora_A"].numel() + f["lora_B"].numel()
                           for f in bundle["unet_lora"].values()),
        "fp32_base_params": sum(t.numel()
                                for t in frozen.unet_params.values())}
    d = out["default"]
    print(f"[train] default: {d['steps']} steps of batch {TRAIN_BATCH} at "
          f"{TRAIN_PX}px, rank 8, α 8, `attention` ({d['lora_params']} "
          f"LoRA params over {d['fp32_base_params']} fp32 base weights): "
          f"losses {[round(s['loss'], 4) for s in steps]}; "
          f"{d['step_s']:.4f} s a step (steps 2-{len(steps)}; step 1 "
          f"{d['first_step_s']:.2f} s), {d['images_per_s']:.2f} train "
          f"images/s, max_memory_allocated {peak / 2 ** 30:.2f} GiB, on "
          f"{card}; launches a step {d['launches_per_step']}", flush=True)
    if len(steps) != TRAIN_IMAGES // TRAIN_BATCH:
        raise AssertionError(f"{len(steps)} steps")
    if not all(np.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"non-finite losses: {steps}")
    if not (steps[0]["lora_B_abs_sum"] == 0.0
            and steps[1]["lora_B_abs_sum"] > 0.0):
        raise AssertionError("lora_B must stay 0 after step 1 (lr 0) and "
                             "move at step 2")
    for s in steps:
        got = s["launches"]
        if (got["flash_attention"] != STEP_FLASH
                or got["fused_group_norm"] != ENCODE_GN
                or got["fused_geglu"] != 0):
            raise AssertionError(f"launches a train step {got}: want "
                                 f"{STEP_FLASH} flash, {ENCODE_GN} "
                                 "GroupNorm (one VAE encode), 0 GEGLU")
    check_base_unchanged(stack, before, "default training run")

    # where a step's device time goes: one more step under the profiler
    batch = torch.from_numpy(images[:TRAIN_BATCH]).to(dev)
    prof = profile_device(lambda: sf.sd_lora_train_step(
        state, frozen, schedule, batch, torch.as_tensor(ids, device=dev),
        None, sf.step_draws(cfg.seed, 1, 0, dev), lcfg))
    prof["busy_share"] = prof["device_s"] / d["step_s"]
    d["profile"] = prof
    print(f"[train] profiled step: device {prof['device_s']:.4f} s of a "
          f"{d['step_s']:.4f} s step (busy share {prof['busy_share']:.2f}); "
          "per family (ms, calls): " + "; ".join(
              f"{k} {v[0]:.3f} ({v[1]})" for k, v in prof["families"].items())
          + "; top: " + "; ".join(f"{k} {ms:.1f} ({n})"
                                  for k, ms, n in prof["top"][:6]),
          flush=True)

    # every flag on: two updates of two micro-steps each
    acc_cfg = DiffusionConfig(image_size=TRAIN_PX, num_epochs=1,
                              learning_rate=1e-4, lora_dropout=0.3,
                              accumulation_steps=2).with_schedule(4)
    acc_lcfg = LoRAConfig(8, 8, 0.3, acc_cfg.modules_lora)
    tcfg = LoRAConfig(8, 8, 0.3, LORA_MODULE_PRESETS["text_encoder"])
    g = torch.Generator(dev).manual_seed(1)
    stack.tokenizer.add_tokens(["sks"])
    sid = stack.tokenizer.convert_tokens_to_ids("sks")
    table = db.resize_token_embeddings(
        stack.text.get_parameter(sf.TOKEN_TABLE), len(stack.tokenizer), g)
    row = db.dreambooth_token_init(table, stack.tokenizer, "AD")
    unfrozen = stack.fp32_params("unet", [
        n for n, _ in stack.unet.named_parameters()
        if any(s in n for s in ("to_q", "to_k", "to_v", "to_out"))])
    flags_bundle = sf.init_trainable(
        init_lora(stack.unet, acc_lcfg, g), init_lora(stack.text, tcfg, g),
        sf.init_proj_params(g, 4, stack.text.config.width), row[None],
        unfrozen)
    flags_frozen = make_components(stack, flags_bundle, token_table=table)
    flags_state = sf.create_sd_train_state(acc_cfg, flags_bundle)
    start = tree_leaves(tree_map(torch.detach, flags_state.trainable))
    start = [t.clone() for t in start]
    prompt_ids = torch.as_tensor(stack.tokenizer([db.dreambooth_prompt(
        "AD", False, False, True)]), device=dev)
    flag_losses = []
    for micro in range(4):
        batch = torch.from_numpy(images[micro * TRAIN_BATCH:
                                        (micro + 1) * TRAIN_BATCH]).to(dev)
        flags_state, loss = sf.sd_lora_train_step(
            flags_state, flags_frozen, schedule, batch, prompt_ids,
            torch.tensor([sid], device=dev), sf.step_draws(0, 0, micro, dev),
            acc_lcfg, tcfg, acc_cfg.weight_img, acc_cfg.weight_text)
        flag_losses.append(loss.item())
    names = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            names.append(path)

    walk(flags_state.trainable, "")
    unmoved = [n for n, a, b in zip(names, start,
                                    tree_leaves(flags_state.trainable))
               if torch.equal(a, b.detach())]
    out["all_flags"] = {"losses": flag_losses, "leaves": len(names),
                        "unmoved_leaves": unmoved,
                        "updates": flags_state.opt_state["count"]}
    print(f"[train] every flag on (text LoRA, DreamBooth 'sks', visual "
          f"influence, unfrozen attention projections, dropout 0.3, "
          f"accumulation 2): losses {[round(x, 4) for x in flag_losses]}; "
          f"{len(names) - len(unmoved)} of {len(names)} trainable leaves "
          f"moved after the 2nd update (the first real one, lr > 0)",
          flush=True)
    if not np.isfinite(flag_losses).all() or unmoved or \
            flags_state.opt_state["count"] != 2:
        raise AssertionError(f"all-flags run: {out['all_flags']}")
    del flags_state, flags_frozen, flags_bundle, unfrozen
    check_base_unchanged(stack, before, "all-flags run")

    out["card_vs_cpu"] = train_vs_cpu(stack, dev)

    # the default run's bundle saved, reloaded, merged and sampled
    path = tmp / "lora_AD.pt"
    save_lora(path, state.trainable)
    reloaded = load_lora(path, tree_map(torch.detach, state.trainable))
    for a, b in zip(tree_leaves(reloaded), tree_leaves(state.trainable)):
        if not torch.equal(a, b.detach()):
            raise AssertionError("the reloaded bundle differs")
    merged = merged_stack(stack, frozen, reloaded, lcfg)
    sampler = make_sampler(merged, DiffusionConfig(image_size=TRAIN_PX))
    sample_dir = tmp / "lora_samples"
    generate_to_dir(sampler.for_prompt(PROMPT), 2, sample_dir,
                    eval_batch_size=2, seed=0)
    pngs = sorted(sample_dir.glob("*.png"))
    arrays = [np.asarray(Image.open(p)) for p in pngs]
    if len(arrays) != 2 or any(a.shape != (TRAIN_PX, TRAIN_PX, 3)
                               for a in arrays):
        raise AssertionError(f"samples {[a.shape for a in arrays]}")
    out["samples"] = {"pngs": len(pngs), "shape": list(arrays[0].shape),
                      "sampler": sampler.sampler, "steps": sampler.num_steps}
    print(f"[train] saved ({path.stat().st_size} bytes), reloaded and "
          f"merged the bundle; {len(pngs)} PNGs of {arrays[0].shape} "
          f"through StableDiffusionSampler ({sampler.sampler}, "
          f"{sampler.num_steps} steps)", flush=True)
    check_base_unchanged(stack, before, "merged sampling")
    out["base_weights_bit_equal"] = len(before)
    return out


# the augmentation loop phase: a corpus fabricated in the reference's
# layout (seeded random RGB .tif images at 288×352, resized to 224 by the
# data layer) in the reference's class imbalance, cut to size
LOOP_CLASSES = ("AD", "HP", "ASS")
LOOP_COUNTS = {"train": {"AD": 32, "HP": 8, "ASS": 8},
               "valid": {"AD": 4, "HP": 4, "ASS": 4},
               "test": {"AD": 8, "HP": 8, "ASS": 8}}
LOOP_PX = 224          # the per-class CLI's default --image_size
LOOP_QUOTA = 8         # a cut of get_num_images_to_generate's quotas
LOOP_EPOCHS = 1        # LoRA epochs a class (the reference CLI's 200, cut)
CLS_BATCH = 16         # bench.py:345's classifier configuration
CLS_EPOCHS = 3         # the classifier CLIs' 100, cut
# the classifier on the card (bf16 stem, TF32 convs: the module's and
# PyTorch's defaults) against the same weights and inputs on the CPU (bf16
# stem, fp32): TF32 keeps 10 mantissa bits (2^-11 relative rounding of
# each conv's inputs), about 5e-4 of each of B0's ~50 convs' outputs, which
# BatchNorm rescales but does not remove, and the bf16 stem rounds to
# other values where its products sum in another order. A wrong layout,
# padding, statistic or dtype gives O(1).
CLS_FORWARD_REL_L2 = 1e-2
CLS_LOSS_REL = 1e-2
# the gradients pass that rounding twice (forward activations, then the
# backward's own TF32 products), as the LoRA gradients do
CLS_GRAD_REL_L2 = 2 * CLS_FORWARD_REL_L2
# the step's move of the running statistics (0.1 × the batch statistics)
CLS_STATS_REL_L2 = CLS_FORWARD_REL_L2


def fabricate_corpus(root: Path, seed: int = 0) -> None:
    """The reference's corpus layout (cli/common.py::DataLayout) under
    `root`: seeded random RGB .tif images and each split's labels CSV
    (image_id,cls) in a seeded order."""
    import numpy as np
    from PIL import Image

    from polyp_tpu_torch.cli.common import DataLayout

    layout = DataLayout(root)
    rng = np.random.default_rng(seed)
    for split, images, csv in (
            ("train", layout.train_images, layout.train_csv),
            ("valid", layout.val_images, layout.val_csv),
            ("test", layout.test_images, layout.test_csv)):
        images.mkdir(parents=True)
        rows = [(f"{split}_{cls}_{i:03d}", cls)
                for cls, n in LOOP_COUNTS[split].items() for i in range(n)]
        rows = [rows[i] for i in rng.permutation(len(rows))]
        for image_id, _ in rows:
            Image.fromarray(rng.integers(0, 256, (288, 352, 3),
                                         dtype=np.uint8)).save(
                images / f"{image_id}.tif")
        csv.write_text("image_id,cls\n"
                       + "".join(f"{i},{c}\n" for i, c in rows))


def calibrated_b0(seed: int = 0):
    """A B0 classifier in fp32 on the CPU from `seed`, its BatchNorm
    statistics set to one training forward's batch statistics over 8
    random images (random running averages (0, 1) would wash the signal
    out within a few blocks and make every comparison trivial)."""
    import numpy as np

    from polyp_tpu_torch.configs import ClassificationConfig
    from polyp_tpu_torch.data.transforms import augment_classifier_batch
    from polyp_tpu_torch.models.efficientnet import BatchNorm
    from polyp_tpu_torch.train import classifier as tc

    state = tc.create_classifier_state(ClassificationConfig(), 3, "cpu")
    model = state.model
    images = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 256, (8, LOOP_PX, LOOP_PX, 3), dtype=np.uint8))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    model.eval()
    for bn in bns:  # batch statistics, and no stochastic depth
        bn.train()
        bn.decay = 0.0
    with torch.no_grad():
        model.backbone(augment_classifier_batch(images, None,
                                                torch.float32))
    for bn in bns:
        bn.decay = 0.9
    return state


def classifier_vs_cpu(dev: torch.device) -> dict:
    """The full B0 at 224 px on the card against the same weights and
    inputs on the CPU: an evaluation forward at batch 2 (pooled features
    and logits), and one train step at batch 4 with the same draws (the
    loss, every gradient, the running statistics' move)."""
    import copy

    import numpy as np

    from polyp_tpu_torch.data.transforms import augment_classifier_batch
    from polyp_tpu_torch.train import classifier as tc

    cpu = calibrated_b0()
    model = copy.deepcopy(cpu.model).to(dev)
    card = tc.ClassifierState(
        model, type(cpu.optimizer)(model.parameters(),
                                  **cpu.optimizer.defaults),
        cpu.dtype)
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(
        0, 256, (4, LOOP_PX, LOOP_PX, 3), dtype=np.uint8))
    out: dict = {}
    feats, logits = {}, {}
    for name, state in (("card", card), ("cpu", cpu)):
        device = state.device
        model = state.model.eval()
        with torch.no_grad():
            x = augment_classifier_batch(images[:2].to(device), None,
                                         state.dtype)
            feats[name] = model.backbone(x).cpu()
            logits[name] = model(x).cpu()
    # how far the two images' features are apart, beside the card's error
    spread = rel_l2(feats["cpu"][0], feats["cpu"][1])
    out["forward"] = {"features_rel_l2": rel_l2(feats["card"], feats["cpu"]),
                      "logits_rel_l2": rel_l2(logits["card"], logits["cpu"]),
                      "image_to_image_rel_l2": spread,
                      "tolerance": CLS_FORWARD_REL_L2}
    draws = tc.draw_step(cpu.model, 4, torch.Generator().manual_seed(4))
    labels = torch.tensor([0, 1, 2, 0])
    step = {}
    for name, state in (("card", card), ("cpu", cpu)):
        device = state.device
        before = {k: v.clone() for k, v in state.model.named_buffers()}
        on = tc.ClassifierDraws(
            draws.flip.to(device),
            {k: v.to(device) for k, v in draws.drop_path.items()},
            draws.dropout.to(device))
        loss, _ = tc.train_step(state, images.to(device), labels.to(device),
                                on)
        step[name] = {
            "loss": loss.item(),
            "grads": torch.cat([p.grad.float().cpu().reshape(-1)
                                for p in state.model.parameters()]),
            "stats": torch.cat([(v - before[k]).float().cpu().reshape(-1)
                                for k, v in state.model.named_buffers()])}
    out["train_step"] = {
        "loss_card": step["card"]["loss"], "loss_cpu": step["cpu"]["loss"],
        "loss_rel": abs(step["card"]["loss"] - step["cpu"]["loss"])
        / abs(step["cpu"]["loss"]),
        "grad_rel_l2": rel_l2(step["card"]["grads"], step["cpu"]["grads"]),
        "stats_move_rel_l2": rel_l2(step["card"]["stats"],
                                    step["cpu"]["stats"]),
        "tolerances": {"loss": CLS_LOSS_REL, "grads": CLS_GRAD_REL_L2,
                       "stats": CLS_STATS_REL_L2}}
    f, t = out["forward"], out["train_step"]
    print(f"[loop] B0 at {LOOP_PX}px, card (bf16 stem, TF32) vs cpu (bf16 "
          f"stem, fp32): forward at batch 2, features rel L2 "
          f"{f['features_rel_l2']:.3e}, logits {f['logits_rel_l2']:.3e} "
          f"(tol {CLS_FORWARD_REL_L2:.0e}; the two images' features "
          f"{f['image_to_image_rel_l2']:.3f} apart); train step at batch 4, loss "
          f"{t['loss_card']:.6f} vs {t['loss_cpu']:.6f} (rel "
          f"{t['loss_rel']:.2e}, tol {CLS_LOSS_REL:.0e}), gradients rel L2 "
          f"{t['grad_rel_l2']:.3e} (tol {CLS_GRAD_REL_L2:.0e}), running "
          f"statistics' move {t['stats_move_rel_l2']:.3e} (tol "
          f"{CLS_STATS_REL_L2:.0e})", flush=True)
    if not (f["features_rel_l2"] <= CLS_FORWARD_REL_L2
            and f["logits_rel_l2"] <= CLS_FORWARD_REL_L2
            and t["loss_rel"] <= CLS_LOSS_REL
            and t["grad_rel_l2"] <= CLS_GRAD_REL_L2
            and t["stats_move_rel_l2"] <= CLS_STATS_REL_L2):
        raise AssertionError(f"classifier, card vs cpu: {out}")
    return out


def classifier_speed(dev: torch.device, card: str) -> dict:
    """B0 at 224 px, batch 16 (bench.py:345): the seconds a train step
    (host clock around synchronised steps 2-6), train images/s, eval
    images/s (steps 2-6 of eval_step), max_memory_allocated, and one more
    train step under the profiler."""
    import numpy as np

    from polyp_tpu_torch.configs import ClassificationConfig
    from polyp_tpu_torch.train import classifier as tc

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)  # what earlier phases hold
    torch.cuda.reset_peak_memory_stats(dev)
    state = tc.create_classifier_state(ClassificationConfig(), 3, dev)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(
        0, 256, (CLS_BATCH, LOOP_PX, LOOP_PX, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 3, CLS_BATCH)).to(dev)
    valid = torch.ones(CLS_BATCH, dtype=torch.bool, device=dev)

    def timed(fn, n=6) -> list[float]:
        out = []
        for i in range(n):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - start)
        return out

    train = timed(lambda i: tc.train_step(
        state, images, labels,
        tc.step_draws(0, 0, i, state.model, CLS_BATCH, dev)))
    peak = torch.cuda.max_memory_allocated(dev)
    evals = timed(lambda i: tc.eval_step(state, images, labels, valid))
    step_s = sum(train[1:]) / len(train[1:])
    eval_s = sum(evals[1:]) / len(evals[1:])
    prof = profile_device(lambda: tc.train_step(
        state, images, labels,
        tc.step_draws(0, 0, 6, state.model, CLS_BATCH, dev)))
    prof["busy_share"] = prof["device_s"] / step_s
    out = {"batch": CLS_BATCH, "px": LOOP_PX, "step_s": step_s,
           "first_step_s": train[0], "train_images_per_s":
           CLS_BATCH / step_s, "eval_batch_s": eval_s,
           "eval_images_per_s": CLS_BATCH / eval_s,
           "max_memory_allocated": peak, "resident_before": resident,
           "classifier_peak": peak - resident, "profile": prof}
    print(f"[loop] classifier B0, batch {CLS_BATCH}, {LOOP_PX}px: "
          f"{step_s:.4f} s a train step (steps 2-6; step 1 "
          f"{train[0]:.2f} s) = {out['train_images_per_s']:.1f} train "
          f"images/s; eval {out['eval_images_per_s']:.1f} images/s; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB, of which the "
          f"classifier's {(peak - resident) / 2 ** 30:.2f} GiB; profiled "
          f"step: "
          f"device {prof['device_s']:.4f} s (busy share "
          f"{prof['busy_share']:.2f}); top: " + "; ".join(
              f"{k} {ms:.1f} ({n})" for k, ms, n in prof["top"][:5])
          + f"; on {card}", flush=True)
    return out


def augmentation_loop_phase(dev: torch.device, card: str, reset_counts,
                            read_counts, tmp: Path) -> dict:
    """The generate → augment → retrain → F1 loop through the port's CLIs
    on a fabricated corpus: polyp-lora-per-class (full-width SD-v1-4 from
    seed 0, AD HP ASS, 224 px, one epoch, LOOP_QUOTA images a class),
    again with one sample a class deleted (the resume branch: nothing
    trained, each class topped up to its quota under the same names), then
    polyp-train-classifier and polyp-eval-augmentation (B0, 224 px, batch
    16, CLS_EPOCHS epochs, weighted sampling). Every count is set to 0
    just before each class and read just after; the CLIs' SD stack is held
    bit-equal; the metrics must be finite and in [0, 1]. Then the
    classifier's speed and its card-vs-CPU checks."""
    import numpy as np

    from PIL import Image

    from polyp_tpu_torch.cli import (
        eval_augmentation, lora_per_class, train_classifier)

    root = tmp / "loop"
    data = root / "data"
    fabricate_corpus(data)
    run = root / "run"
    common = ["--data-root", str(data), "--cache-dir", str(root / "cache"),
              "--tracker-root", str(root / "mlruns")]
    lora_argv = common + [
        "--folder", str(run), "--classes_to_train", *LOOP_CLASSES,
        "--num_imgs_to_generate", *[str(LOOP_QUOTA)] * len(LOOP_CLASSES),
        "--num_epochs", str(LOOP_EPOCHS), "--image_size", str(LOOP_PX)]
    held: dict = {}
    per_class: dict = {}
    real = {name: getattr(lora_per_class, name)
            for name in ("load_sd_stack", "train_class", "resume_class")}

    def load(*args, **kwargs):
        stack = real["load_sd_stack"](*args, **kwargs)
        held["stack"], held["before"] = stack, base_weights(stack)
        return stack

    def counted(name: str, cls_at: int):
        def call(*args, **kwargs):
            reset_counts()
            start = time.perf_counter()
            result = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            if result is not None:
                per_class.setdefault(held["run"], {})[args[cls_at]] = {
                    **result, "seconds": time.perf_counter() - start,
                    "launches": read_counts()}
            return result
        return call

    out: dict = {"card": card}
    # the user's defaults for the loop (cuDNN TF32 on); the other phases'
    # comparisons run with TF32 off
    torch.backends.cudnn.allow_tf32 = True
    cwd = os.getcwd()
    os.chdir(root)  # the CLIs' relative defaults (./results) land here
    # every shape the per-class CLI gives GroupNorm and the GEGLU (224 px:
    # maps of 28, 14, 7 and 4 in the UNet, 224 down to 28 in the VAE)
    recorder = ShapeRecorder({"fused_group_norm": gn_key,
                              "fused_geglu": lambda x, *args:
                              tuple(x.shape)})
    try:
        lora_per_class.load_sd_stack = load
        lora_per_class.train_class = counted("train_class", 4)
        lora_per_class.resume_class = counted("resume_class", 3)
        held["run"] = "first"
        start = time.perf_counter()
        with recorder:
            first = lora_per_class.main(lora_argv)
        first_s = time.perf_counter() - start
        names = {c: sorted(p.name for p in (run / "samples" / c).iterdir())
                 for c in LOOP_CLASSES}
        for i, c in enumerate(LOOP_CLASSES):
            (run / "samples" / c / f"{i + 2}.png").unlink()
        held["run"] = "resume"
        start = time.perf_counter()
        with recorder:
            second = lora_per_class.main(lora_argv)
        resume_s = time.perf_counter() - start
        check_base_unchanged(held["stack"], held["before"],
                             "the per-class CLI (both runs)")
        out["stack_bit_equal"] = len(held["before"])
        del held["stack"], held["before"]

        start = time.perf_counter()
        baseline = train_classifier.main(common + [
            "--num_epochs", str(CLS_EPOCHS), "--batch_size", str(CLS_BATCH),
            "--image_size", str(LOOP_PX), "--weighted_sampling",
            "--output-dir", str(root / "models"),
            "--register", str(root / "results" / "register.csv")])
        baseline_s = time.perf_counter() - start
        start = time.perf_counter()
        augmented = eval_augmentation.main(common + [
            "--path_model", str(run), "--run_id", first["run_id"],
            "--num_epochs", str(CLS_EPOCHS), "--batch_size", str(CLS_BATCH),
            "--image_size", str(LOOP_PX)])
        augmented_s = time.perf_counter() - start
    finally:
        os.chdir(cwd)
        for name, fn in real.items():
            setattr(lora_per_class, name, fn)
        torch.backends.cudnn.allow_tf32 = False

    for c in LOOP_CLASSES:
        got = sorted(p.name for p in (run / "samples" / c).iterdir())
        if got != names[c] or len(got) != LOOP_QUOTA:
            raise AssertionError(f"samples/{c}: {got}, first run {names[c]}")
        for f in got:
            a = np.asarray(Image.open(run / "samples" / c / f))
            if a.shape != (LOOP_PX, LOOP_PX, 3):
                raise AssertionError(f"samples/{c}/{f}: {a.shape}")
        if not first["classes"][c]["trained"] or \
                second["classes"][c]["trained"]:
            raise AssertionError(f"{c}: first {first['classes'][c]}, "
                                 f"resume {second['classes'][c]}")
        launches = per_class["first"][c]["launches"]
        if (launches["flash_attention"] != 0
                or launches["fused_group_norm"] <= 0
                or launches["fused_geglu"] <= 0):
            raise AssertionError(f"{c} launches {launches}: want flash 0 "
                                 "(28×28 = 784 tokens < 1024), GroupNorm "
                                 "and GEGLU > 0")
    for name, metrics in (("baseline", baseline), ("augmented", augmented)):
        for k in ("accuracy", "precision", "recall", "f1_score"):
            if not (np.isfinite(metrics[k]) and 0.0 <= metrics[k] <= 1.0):
                raise AssertionError(f"{name} {k} = {metrics[k]}")
    frechet = augmented["frechet"]["per_class"]
    if sorted(frechet) != sorted(LOOP_CLASSES) or not all(
            np.isfinite(v) for v in frechet.values()):
        raise AssertionError(f"Fréchet distances {frechet}")
    want_train = sum(LOOP_COUNTS["train"].values()) + \
        LOOP_QUOTA * len(LOOP_CLASSES)
    if augmented["train_size"] != want_train:
        raise AssertionError(f"augmented train set {augmented['train_size']}"
                             f", want {want_train}")

    # each kernel against its plain version at every shape the loop gave
    # it, at the tolerances of the other check rows
    with torch.no_grad():
        out["kernel_checks"] = recorded_rows(recorder.seen, dev)
    print(f"[loop] kernel checks at the loop's shapes: " + "; ".join(
        f"{r['name']} {r['shape']} ({r['path_launches']} launches, "
        f"max|err| {r['max_abs_err']:.2e})" for r in out["kernel_checks"]),
        flush=True)

    classes = {}
    for c in LOOP_CLASSES:
        t, r = per_class["first"][c], per_class["resume"][c]
        classes[c] = {
            "class_s": t["seconds"], "train_s": t["train_s"],
            "steps": t["steps"],
            "generate_s": t["generate_s"],
            "generated_images_per_s": t["images"] / t["generate_s"],
            "launches": t["launches"], "resume_images": r["images"],
            "resume_class_s": r["seconds"],
            "resume_generate_s": r["generate_s"],
            "resume_launches": r["launches"]}
        print(f"[loop] {c}: {t['seconds']:.2f} s the class (data, LoRA, "
              f"save, sampling, Fréchet); LoRA {t['steps']} steps in "
              f"{t['train_s']:.2f} s "
              f"({LOOP_EPOCHS} epoch, {LOOP_PX}px, full-width SD-v1-4), "
              f"{t['images']} images in {t['generate_s']:.2f} s = "
              f"{classes[c]['generated_images_per_s']:.2f} generated "
              f"images/s (UniPC 25 steps, CFG 7.5); launches a class "
              f"{t['launches']}; resume: {r['images']} images in "
              f"{r['generate_s']:.2f} s, nothing trained; on {card}",
              flush=True)
    pick = ("accuracy", "precision", "recall", "f1_score")
    out.update({
        "corpus": LOOP_COUNTS, "px": LOOP_PX, "quota": LOOP_QUOTA,
        "lora_epochs": LOOP_EPOCHS, "classifier_epochs": CLS_EPOCHS,
        "classes": classes, "per_class_cli_s": first_s,
        "resume_cli_s": resume_s, "train_classifier_cli_s": baseline_s,
        "eval_augmentation_cli_s": augmented_s,
        "baseline": {k: baseline[k] for k in pick},
        "augmented": {k: augmented[k] for k in pick},
        "augmented_train_size": augmented["train_size"],
        "frechet": augmented["frechet"]})
    print(f"[loop] per-class CLI {first_s:.1f} s, resume {resume_s:.1f} s; "
          f"train-classifier CLI ({CLS_EPOCHS} epochs) {baseline_s:.1f} s: "
          f"{out['baseline']}; eval-augmentation CLI {augmented_s:.1f} s "
          f"(train set {augmented['train_size']}): {out['augmented']}; "
          f"Fréchet ({augmented['frechet']['extractor']}): {frechet}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["classifier"] = classifier_speed(dev, card)
        out["classifier_vs_cpu"] = classifier_vs_cpu(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return out


# the scratch DDPM phase: polyp-train-scratch at the reference's width
# (polyp_scratch_unet, 113,664,003 parameters, bf16 compute over fp32
# masters) on the loop phase's corpus, cut to one epoch (the CLI's 200),
# 25 DDIM sample steps (its 1,000 ancestral) and the quotas that
# --ad_minimum 36 gives that corpus (AD 4, HP 19, ASS 19)
SCRATCH_PX, SCRATCH_BATCH, SCRATCH_STEPS = 224, 8, 25
SCRATCH_AD_MINIMUM = 36
# the size of the scratch path's card-vs-CPU checks (the CPU runs fp32):
# 112 px still meets an odd map (7 → 4 → 7) on the way
SCRATCH_CHECK_PX = 112
# launches a scratch UNet forward: GroupNorm in 32 resnets (2 each), 6
# attentions and conv_norm_out; under w8a8_static, 64 of them with the
# int8 epilogue (every resnet conv is quantized) and 44 W8A8 denses (20
# 1×1 shortcuts, 24 attention projections); flash never (196 tokens at
# most, below its 1,024)
SCRATCH_FORWARD = {"fused_group_norm": 71, "fused_group_norm_q8": 0,
                   "fused_w8a8_dense": 0, "flash_attention": 0}
SCRATCH_FORWARD_Q8 = {"fused_group_norm": 71, "fused_group_norm_q8": 64,
                      "fused_w8a8_dense": 44, "flash_attention": 0}


def scratch_vs_cpu(state, dev: torch.device) -> tuple[dict, object]:
    """The trained scratch UNet at SCRATCH_CHECK_PX on the card (bf16,
    kernels) against its fp32 masters on the CPU (plain versions): one
    forward at batch 2 (rel L2 within REL_L2_TOLERANCE) and one train step
    at batch 1 with the same draws (the loss within REL_L2_TOLERANCE, the
    gradients of every parameter within LORA_GRAD_REL_L2, the LoRA step's
    bounds). Returns the comparison and the fp32 CPU model."""
    import numpy as np

    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.models.unet2d import polyp_scratch_unet
    from polyp_tpu_torch.train import scratch_ddpm as sd

    px = SCRATCH_CHECK_PX
    cpu = polyp_scratch_unet(dtype=torch.float32, device="cpu").eval()
    cpu.load_state_dict({k: v.detach().cpu() for k, v in
                         state.params.items()})
    cpu_state = sd.DDPMState(0, {k: v.detach().cpu().clone()
                                 .requires_grad_()
                                 for k, v in state.params.items()},
                             {}, None, cpu)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 3, px, px, generator=g)
    t = torch.tensor([40, 900])
    with torch.no_grad():
        want = cpu(x, t)
        got = state.load_into_model()(x.to(dev), t.to(dev))
    schedule = DiffusionSchedule.create(1000)
    images = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (1, px, px, 3), dtype=np.uint8))

    def step(st, device):
        return sd.ddpm_loss_and_grads(
            st, schedule, images.to(device),
            FixedDraws(1, (1, 3, px, px)).to(device))

    card_loss, card_grads = step(state, dev)
    cpu_loss, cpu_grads = step(cpu_state, "cpu")
    flat = [torch.cat([g.float().cpu().reshape(-1) for g in grads.values()])
            for grads in (card_grads, cpu_grads)]
    out = {"forward_rel_l2": rel_l2(got, want),
           "loss_card": card_loss.item(), "loss_cpu": cpu_loss.item(),
           "loss_rel": abs(card_loss.item() - cpu_loss.item())
           / abs(cpu_loss.item()),
           "grad_rel_l2": rel_l2(flat[0], flat[1]),
           "grad_values": flat[1].numel(), "px": px}
    if not (out["forward_rel_l2"] <= REL_L2_TOLERANCE
            and out["loss_rel"] <= REL_L2_TOLERANCE
            and out["grad_rel_l2"] <= LORA_GRAD_REL_L2):
        raise AssertionError(f"scratch UNet, card vs cpu: {out}")
    return out, cpu


def scratch_speed(dev: torch.device, reset_counts, read_counts) -> dict:
    """The scratch train step at full width, 224 px, batch 8 (ddpm_train_step,
    the CLI's step): seconds a step over steps 2-6 (synchronised host
    clock), train images/s, peak memory, the launches of our kernels a
    step (none: GroupNorm and attention run their plain versions under
    autograd) and one more step under torch.profiler."""
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.models.unet2d import polyp_scratch_unet
    from polyp_tpu_torch.train import scratch_ddpm as sd

    model = polyp_scratch_unet(device=dev)
    cfg = DiffusionConfig(num_epochs=1).with_schedule(7)
    state = sd.create_ddpm_state(cfg, model,
                                 torch.Generator(dev).manual_seed(0))
    g = torch.Generator(dev).manual_seed(1)
    images = torch.randint(0, 256, (SCRATCH_BATCH, SCRATCH_PX, SCRATCH_PX, 3),
                           generator=g, device=dev, dtype=torch.uint8)
    schedule = DiffusionSchedule.create(1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    reset_counts()
    for step in range(6):
        start = time.perf_counter()
        state, loss = sd.ddpm_train_step(state, schedule, images,
                                         sd.ddpm_draws(0, 0, step, dev))
        losses.append(loss.item())  # synchronises
        times.append(time.perf_counter() - start)
    launches = read_counts()
    step_s = sum(times[1:]) / len(times[1:])
    prof = profile_device(lambda: sd.ddpm_train_step(
        state, schedule, images, sd.ddpm_draws(0, 0, 6, dev)))
    out = {"step_s": step_s, "step_s_each": times,
           "train_images_per_s": SCRATCH_BATCH / step_s,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches_per_step": {
               k: v / 6 for k, v in launches.items()},
           "profile": {**prof, "busy_share": prof["device_s"] / step_s}}
    if not all(math.isfinite(v) for v in losses) or any(launches.values()):
        raise AssertionError(f"scratch train steps: {out}")
    del state, model
    return out


def scratch_phase(dev: torch.device, card: str, reset_counts, read_counts,
                  tmp: Path, data: Path) -> dict:
    """The scratch DDPM path through polyp-train-scratch's main on the
    fabricated corpus (SCRATCH_* above; every count set to 0 just before
    it and read just after: GroupNorm exactly 71 a sampling forward,
    nothing else); the samples and saved models; its GroupNorm shapes
    (recorded on the path) against the plain version; the launches of one
    sampling forward; the train step's speed; the card against the CPU;
    and the --quantize w8a8_static sampler over the trained UNet
    (calibrated without conditioning): its dense and GroupNorm shapes
    against their plain versions, its launches, and one int8 forward layer
    by layer against the CPU."""
    import numpy as np
    from PIL import Image

    from polyp_tpu_torch.cli import train_scratch
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.pipeline import PixelDiffusionSampler

    out_dir = tmp / "scratch"
    argv = ["--data-root", str(data), "--cache-dir", str(tmp / "scratch_cache"),
            "--tracker-root", str(tmp / "scratch_mlruns"),
            "--num_epochs", "1", "--image_size", str(SCRATCH_PX),
            "--sample_steps", str(SCRATCH_STEPS),
            "--ad_minimum", str(SCRATCH_AD_MINIMUM),
            "--output-dir", str(out_dir)]
    generated = {}
    real = train_scratch.generate_to_dir

    def timed(sampler, n, out, *args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        written = real(sampler, n, out, *args, **kwargs)
        torch.cuda.synchronize()
        generated[Path(out).name] = {
            "images": written, "seconds": time.perf_counter() - start}
        return written

    recorder = ShapeRecorder({"fused_group_norm": gn_key})
    train_scratch.generate_to_dir = timed
    start = time.perf_counter()
    reset_counts()
    try:
        with recorder:
            states = train_scratch.main(argv)
        torch.cuda.synchronize()
    finally:
        train_scratch.generate_to_dir = real
    cli_s = time.perf_counter() - start
    launches = read_counts()
    forwards = SCRATCH_STEPS * sum(-(-v["images"] // 20)
                                   for v in generated.values())
    want = {k: v * forwards for k, v in SCRATCH_FORWARD.items()}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"scratch CLI launches {launches}, want {want}")
    for cls, info in generated.items():
        pngs = sorted((out_dir / "samples" / cls).glob("*.png"))
        if len(pngs) != info["images"] or not (
                out_dir / "models" / f"model_{cls}").exists():
            raise AssertionError(f"scratch {cls}: {len(pngs)} PNGs, "
                                 f"{info}")
        for p in pngs:
            a = np.asarray(Image.open(p))
            if a.shape != (SCRATCH_PX, SCRATCH_PX, 3):
                raise AssertionError(f"scratch {cls}/{p.name}: {a.shape}")
    with torch.no_grad():
        rows = recorded_rows(recorder.seen, dev)

    state = states.pop("ASS")
    states.clear()
    model = state.load_into_model()
    x = torch.randn(SCRATCH_BATCH, 3, SCRATCH_PX, SCRATCH_PX, device=dev)
    t = torch.full((SCRATCH_BATCH,), 500, device=dev)
    reset_counts()
    with torch.no_grad():
        model(x, t)
    torch.cuda.synchronize()
    forward = {k: read_counts()[k] for k in SCRATCH_FORWARD}
    if forward != SCRATCH_FORWARD:
        raise AssertionError(f"a scratch forward launched {forward}, want "
                             f"{SCRATCH_FORWARD}")

    speed = scratch_speed(dev, reset_counts, read_counts)
    agreement, cpu = scratch_vs_cpu(state, dev)

    # the --quantize w8a8_static sampler the CLI builds over the trained
    # UNet: calibrated without conditioning, on the card
    schedule = DiffusionSchedule.create(1000)
    start = time.perf_counter()
    q8 = PixelDiffusionSampler(model, schedule, SCRATCH_PX, sampler="ddim",
                               num_steps=SCRATCH_STEPS,
                               quantize="w8a8_static")
    torch.cuda.synchronize()
    calibration_s = time.perf_counter() - start
    q8_recorder = ShapeRecorder({"fused_group_norm": gn_key,
                                 "fused_w8a8_dense": dense_key})
    reset_counts()
    start = time.perf_counter()
    with q8_recorder:
        q8_images = q8(SCRATCH_BATCH, 0)
    torch.cuda.synchronize()
    q8_s = time.perf_counter() - start
    q8_launches = read_counts()
    want = {k: v * SCRATCH_STEPS for k, v in SCRATCH_FORWARD_Q8.items()}
    if {k: q8_launches[k] for k in want} != want or not torch.isfinite(
            q8_images).all():
        raise AssertionError(f"w8a8_static scratch sampler launches "
                             f"{q8_launches}, want {want}")
    with torch.no_grad():
        rows += recorded_rows(q8_recorder.seen, dev)
    px = SCRATCH_CHECK_PX
    xq = torch.randn(2, 3, px, px, generator=torch.Generator().manual_seed(9))
    tq = torch.tensor([500, 500])
    # the CPU holds the card's own (bf16) weights here, so each layer's
    # int8 weight codes are the card's
    cpu.load_state_dict(model.state_dict())
    layers = int8_layers(model, cpu, lambda m, d: m(xq.to(d), tq.to(d)),
                         quant.ScaleBank(q8.quant_scales), tq)
    layers.pop("output")
    out = {"card": card, "px": SCRATCH_PX, "batch": SCRATCH_BATCH,
           "sample_steps": SCRATCH_STEPS, "cli_s": cli_s,
           "cli_launches": launches, "generated": {
               c: {**v, "images_per_s": v["images"] / v["seconds"]}
               for c, v in generated.items()},
           "forward_launches": forward,
           "w8a8_static": {"calibration_s": calibration_s,
                           "calibrated_layers": len(q8.quant_scales),
                           "images_per_s": SCRATCH_BATCH / q8_s,
                           "launches_per_forward": {
                               k: q8_launches[k] / SCRATCH_STEPS
                               for k in SCRATCH_FORWARD_Q8},
                           **layers},
           "speed": speed, "card_vs_cpu": agreement, "kernel_checks": rows}
    print(f"[scratch] polyp-train-scratch (full width, {SCRATCH_PX} px, batch "
          f"{SCRATCH_BATCH}, 1 epoch, {SCRATCH_STEPS} DDIM steps): "
          f"{cli_s:.1f} s; generated images/s " + ", ".join(
              f"{c} {v['images_per_s']:.2f} ({v['images']})"
              for c, v in out["generated"].items())
          + f"; launches {launches}; a sampling forward {forward} on {card}",
          flush=True)
    prof = speed["profile"]
    print(f"[scratch] train step at batch {SCRATCH_BATCH}, {SCRATCH_PX} px: "
          f"{speed['step_s']:.4f} s (steps 2-6) = "
          f"{speed['train_images_per_s']:.1f} train images/s, peak "
          f"{speed['peak_memory_gib']:.2f} GiB, launches a step "
          f"{speed['launches_per_step']}; profiled step device "
          f"{prof['device_s']:.4f} s (busy {prof['busy_share']:.2f}); top "
          + "; ".join(f"{k} {ms:.1f} ({n})" for k, ms, n in prof["top"][:5])
          + f" on {card}", flush=True)
    print(f"[scratch] card bf16 vs cpu fp32 at {px} px: forward rel L2 "
          f"{agreement['forward_rel_l2']:.3e}, train step loss rel "
          f"{agreement['loss_rel']:.3e} (tol {REL_L2_TOLERANCE:.0e}), "
          f"gradients ({agreement['grad_values']} values) rel L2 "
          f"{agreement['grad_rel_l2']:.3e} (tol {LORA_GRAD_REL_L2:.0e})",
          flush=True)
    print(f"[scratch] w8a8_static sampler (cond=None): calibrated "
          f"{len(q8.quant_scales)} layers in {calibration_s:.2f} s; "
          f"{SCRATCH_BATCH / q8_s:.2f} images/s; launches a forward "
          f"{out['w8a8_static']['launches_per_forward']}; layer by layer "
          f"vs cpu fp32: {layers['layers_checked']} calls, max rel L2 "
          f"{layers['layer_max_rel_l2']:.3e} ({layers['worst_layer']}; tol "
          f"{LAYER_REL_L2:.0e}), GN int8 codes differing "
          f"{layers['gn_q8_codes_differing']:.3e} on {card}", flush=True)
    print(f"[scratch] kernel checks at the scratch path's shapes on {card}: "
          + "; ".join(f"{r['name']} {r['shape']} ({r['path_launches']} "
                      f"launches, {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f})"
                      for r in rows), flush=True)
    return out


# the SD CLIs phase: polyp-lora-all-classes at its defaults (224 px, all
# three classes) with one epoch and --generate_subsamples (5 images a
# class); polyp-finetune-pretrained at its 256 px with one epoch (6 steps
# over the corpus' 48 training images) and a grid of FT_GRID images
FT_GRID = 4
FT_STEPS = 25          # its --num_inference_steps default (UniPC, CFG 7.5)
ATTENTION_MODULES = 128  # to_q/k/v/out of SD-v1-4's 32 attentions


def sd_clis_phase(dev: torch.device, card: str, reset_counts, read_counts,
                  tmp: Path, data: Path) -> dict:
    """polyp-lora-all-classes, polyp-finetune-pretrained and
    polyp-inspect-lora through their mains on the fabricated corpus at
    full SD-v1-4 width: counts set to 0 just before each and read just
    after (the finetune CLI's train loop and its sampling apart): flash 0
    at 224 px (784 tokens), exactly STEP_FLASH a train step and 5 a
    sampling forward at 256 px; the PNGs; the adapter's modules and
    rank; and GroupNorm and the bf16 GEGLU against their plain versions
    at every shape the two training CLIs gave them (recorded on the
    path)."""
    import numpy as np
    from PIL import Image

    from polyp_tpu_torch.cli import (
        finetune_pretrained, inspect_lora, lora_all_classes)

    root = tmp / "sd_clis"
    common = ["--data-root", str(data), "--cache-dir", str(root / "cache"),
              "--tracker-root", str(root / "mlruns")]
    out: dict = {"card": card}

    def pngs(d: Path, n: int, px: int) -> None:
        files = sorted(d.glob("*.png"))
        if len(files) != n or any(np.asarray(Image.open(f)).shape
                                  != (px, px, 3) for f in files):
            raise AssertionError(f"{d}: {[f.name for f in files]}")

    # lora-all-classes: CFG batch 10 (5 images) at 224 px, its VAE decode
    # at batch 5, its encode at the train batch; finetune-pretrained: CFG
    # batch 2 * FT_GRID at 256 px, its decode at FT_GRID
    recorder = ShapeRecorder({"fused_group_norm": gn_key,
                              "fused_geglu": lambda x, *args:
                              tuple(x.shape)})
    reset_counts()
    start = time.perf_counter()
    with recorder:
        result = lora_all_classes.main(common + [
            "--folder", str(root / "all"), "--generate_subsamples",
            "--num_epochs", "1", "--image_size", str(LOOP_PX)])
    torch.cuda.synchronize()
    out["lora_all_classes"] = {
        "seconds": time.perf_counter() - start, "launches": read_counts(),
        "classes": {c: {k: v for k, v in r.items()}
                    for c, r in result["classes"].items()}}
    for c in result["classes"]:
        pngs(root / "all" / "samples" / c, 5, LOOP_PX)
    if out["lora_all_classes"]["launches"]["flash_attention"] != 0:
        raise AssertionError(f"lora-all-classes launched flash at 224 px: "
                             f"{out['lora_all_classes']}")

    spent: dict = {}
    real = {n: getattr(finetune_pretrained, n)
            for n in ("train_sd_lora", "generate_to_dir")}

    def counted(name):
        def call(*args, **kwargs):
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = {"seconds": time.perf_counter() - start,
                           "launches": read_counts()}
            return result
        return call

    try:
        for name in real:
            setattr(finetune_pretrained, name, counted(name))
        start = time.perf_counter()
        with recorder:
            ft = finetune_pretrained.main(common + [
                "--output-dir", str(root / "ft"), "--num_epochs", "1",
                "--eval_batch_size", str(FT_GRID)])
        ft_s = time.perf_counter() - start
    finally:
        for name, fn in real.items():
            setattr(finetune_pretrained, name, fn)
    pngs(ft["samples"], FT_GRID, 256)
    train, sample = spent["train_sd_lora"], spent["generate_to_dir"]
    flash = {"a train step": train["launches"]["flash_attention"]
             / ft["steps"],
             "a sampling forward": sample["launches"]["flash_attention"]
             / FT_STEPS}
    # the five level-0 self-attentions of a UNet forward, in the train
    # step (forward only: the backward is plain) and in each sampling
    # forward
    if flash != {"a train step": STEP_FLASH,
                 "a sampling forward": STEP_FLASH}:
        raise AssertionError(f"finetune-pretrained flash launches {flash}")
    listing = io.StringIO()  # its 128 module lines go to the JSON
    with contextlib.redirect_stdout(listing):
        report = inspect_lora.main([str(root / "ft" / "lora_weights")])
    if len(report["modules"]) != ATTENTION_MODULES or report["ranks"] != [4]:
        raise AssertionError(f"inspect-lora: {report}")
    out["finetune_pretrained"] = {
        "seconds": ft_s, "steps": ft["steps"], "loss_hist": ft["loss_hist"],
        "train": train, "sample": sample, "flash": flash,
        "grid_images_per_s": FT_GRID / sample["seconds"]}
    out["inspect_lora"] = {**{k: report[k] for k in ("ranks", "params")},
                           "printed": listing.getvalue()}
    with torch.no_grad():
        out["kernel_checks"] = rows = recorded_rows(recorder.seen, dev)
    la = out["lora_all_classes"]
    print(f"[sd-clis] lora-all-classes --generate_subsamples ({LOOP_PX} px, 1 "
          f"epoch, 5 images a class): {la['seconds']:.1f} s, launches "
          f"{la['launches']}; " + "; ".join(
              f"{c} {r['steps']} steps {r['train_s']:.2f} s, 5 images "
              f"{r['generate_s']:.2f} s" for c, r in la["classes"].items())
          + f" on {card}", flush=True)
    print(f"[sd-clis] finetune-pretrained (256 px, 1 epoch = {ft['steps']} "
          f"steps in {train['seconds']:.2f} s, grid of {FT_GRID} in "
          f"{sample['seconds']:.2f} s = "
          f"{out['finetune_pretrained']['grid_images_per_s']:.2f} images/s): "
          f"{ft_s:.1f} s; flash {flash}; inspect-lora: "
          f"{len(report['modules'])} modules, rank {report['ranks']}, "
          f"{report['params']:,} params on {card}", flush=True)
    print(f"[sd-clis] kernel checks at the two CLIs' shapes on {card}: "
          + "; ".join(f"{r['name']} {r['shape']} ({r['path_launches']} "
                      f"launches, {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f})"
                      for r in rows), flush=True)
    return out


# the distill phase: polyp-distill-sd-torch over sd_clis_phase's three
# LoRA bundles at the 40 → 20 phase's shapes (bench.py:455-530: SD-v1-4,
# 256 px, batch 8), cut to one 8 → 4 phase of 4 steps a class (the
# reference CLI's 40 → 10 at 2,000 steps a phase); its reparam warmup once
# through distill_progressive; polyp-distill-torch over scratch_phase's
# models at 224 px (100 → 25 at 2,000, cut to 8 → 4 at 4); and
# polyp-distill-vae-torch at 256 px (2,000 steps, cut to 20)
DISTILL_PX, DISTILL_BATCH, DISTILL_STEPS = 256, 8, 4
DISTILL_GENERATE, STUDENT_IMAGES = 8, 16
SCRATCH_DISTILL_GENERATE, VAE_DISTILL_STEPS = 4, 20
# launches a step: the SD step's teacher runs two CFG forwards (5 flash, 16
# GEGLU, 61 GroupNorm each) and its student one forward under autograd
# (flash only: GEGLU and GroupNorm take their plain versions); a reparam
# warmup step has one teacher forward; the scratch teacher's two forwards
# run 71 GroupNorms each; the VAE step is the teacher's decode
KERNEL_NAMES = ("flash_attention", "fused_geglu", "fused_group_norm",
                "fused_w8a8_dense", "fused_geglu_w8a8", "fused_geglu_w8a8_pt",
                "fused_group_norm_q8", "fused_mha")


def launches_of(**counts) -> dict:
    return {k: counts.get(k, 0) for k in KERNEL_NAMES}


# a bf16 UNet forward at 256 px and a VAE decode (PERF.md §6)
UNET_FORWARD = launches_of(flash_attention=5, fused_geglu=16,
                           fused_group_norm=61)
VAE_DECODE = launches_of(fused_group_norm=30)
SD_DISTILL_STEP = launches_of(flash_attention=15, fused_geglu=32,
                              fused_group_norm=122)
REPARAM_STEP = launches_of(flash_attention=10, fused_geglu=16,
                           fused_group_norm=61)
SCRATCH_DISTILL_STEP = launches_of(fused_group_norm=142)
VAE_DISTILL_STEP = launches_of(fused_group_norm=30)


class StepMeter:
    """Wraps a train step: each call synchronised and timed on the host
    clock, its launches the change of every count over it; the call at
    index `profile_at` runs through profile_device."""

    def __init__(self, read_counts, profile_at: int | None = None):
        self.read_counts, self.profile_at = read_counts, profile_at
        self.steps: list[dict] = []
        self.profile: dict | None = None

    def wrap(self, step, **info):
        def call(*args, **kwargs):
            before = self.read_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            if len(self.steps) == self.profile_at:
                box = []
                self.profile = profile_device(
                    lambda: box.append(step(*args, **kwargs)))
                out = box[0]
            else:
                out = step(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            after = self.read_counts()
            self.steps.append({**info, "s": seconds, "launches": {
                k: after[k] - before[k] for k in after}})
            return out
        return call

    def check(self, what: str, want: dict, **match) -> list[dict]:
        """The steps with `match` in their info, each launching exactly
        `want`."""
        steps = [st for st in self.steps
                 if all(st.get(k) == v for k, v in match.items())]
        bad = [st["launches"] for st in steps if st["launches"] != want]
        if not steps or bad:
            raise AssertionError(f"{what}: {len(steps)} steps, launches "
                                 f"{bad or None}, want {want}")
        return steps


class _Recorded:
    """An optimizer stand-in that keeps a step's gradients."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        self.grads = grads


def distill_vs_cpu(stack, dev: torch.device) -> dict:
    """One SD distill step (CFG 7.5 folded, the 2-substep target) at batch
    1 on the card (bf16, kernels) and on the CPU (fp32 copies of the same
    weights, plain versions), with the same draws and the same fp32
    masters: the loss and every student gradient."""
    from polyp_tpu_torch.cli.distill_sd import sd_schedule
    from polyp_tpu_torch.models import sd14_unet
    from polyp_tpu_torch.train import distill as td

    schedule = sd_schedule()
    grid = td.distill_grid(schedule, 4)
    with torch.no_grad():
        cond, uncond = (stack.text(torch.as_tensor(
            stack.tokenizer([p]), device=dev)).float().cpu()
            for p in (PROMPT, ""))
    g = torch.Generator().manual_seed(11)
    lat = (1, 4, TRAIN_PX // 8, TRAIN_PX // 8)
    x0, noise = torch.randn(lat, generator=g), torch.randn(lat, generator=g)

    class Fixed(td.DistillDraws):
        def __init__(self, device):
            self.device = device

        def idx(self, n, high):
            return torch.tensor([1], device=self.device)

        def noise(self, shape):
            return noise.to(self.device)

    def run(model, device):
        applies = td.make_applies(model, 7.5, cond.to(device),
                                  uncond.to(device))
        tx = _Recorded()
        state = td.init_distill_state(
            {k: v.float() for k, v in model.named_parameters()}, tx)
        step = td.make_distill_step(applies.student, applies.teacher,
                                    schedule, schedule, grid)
        _, loss = step(state, applies.cast(state.params), x0.to(device),
                       Fixed(device))
        return loss.item(), tx.grads

    card_loss, card_grads = run(stack.unet, dev)
    cpu = sd14_unet(dtype=torch.float32, device="meta").to_empty(
        device="cpu")
    cpu.load_state_dict(stack.unet.state_dict())
    cpu_loss, cpu_grads = run(cpu.eval(), "cpu")
    diff = sum((card_grads[k].float().cpu() - g).square().sum().item()
               for k, g in cpu_grads.items())
    norm = sum(g.square().sum().item() for g in cpu_grads.values())
    out = {"loss_card": card_loss, "loss_cpu": cpu_loss,
           "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "grad_rel_l2": math.sqrt(diff / norm),
           "grad_values": sum(g.numel() for g in cpu_grads.values()),
           "loss_tolerance": REL_L2_TOLERANCE,
           "grad_tolerance": LORA_GRAD_REL_L2}
    print(f"[distill] one SD distill step at batch 1, card bf16 vs cpu "
          f"fp32, same draws and masters: loss {card_loss:.6f} vs "
          f"{cpu_loss:.6f} (rel {out['loss_rel']:.3e}, tol "
          f"{REL_L2_TOLERANCE:.0e}); student gradients "
          f"({out['grad_values']} values) rel L2 {out['grad_rel_l2']:.3e} "
          f"(tol {LORA_GRAD_REL_L2:.0e})", flush=True)
    if not (out["loss_rel"] <= REL_L2_TOLERANCE
            and out["grad_rel_l2"] <= LORA_GRAD_REL_L2):
        raise AssertionError(f"distill step, card vs cpu: {out}")
    return out


def distill_phase(stack, dev: torch.device, card: str, reset_counts,
                  read_counts, tmp: Path, data: Path) -> dict:
    """Distillation training at full width and its students served:
    polyp-distill-sd-torch's main over sd_clis_phase's three LoRA bundles
    (DISTILL_* above; the exact launches of every step, s a step over steps
    2-4, train images/s, peak memory, a profiled step's busy share, the
    saves' seconds); its reparam warmup once through distill_progressive (a
    v-prediction student, 2 warmup and 2 phase steps, one class);
    load_student_sampler on a saved student (STUDENT_IMAGES images at
    their own batch); polyp-serve-torch's service over --distilled-dir
    with --distilled-class all behind HTTP (8 requests across the three
    students, each solo twin pixel-equal); polyp-distill-torch over
    scratch_phase's models and polyp-distill-vae-torch with mixed latents
    (their exact launches a step; the tiny decoder reloaded and decoding);
    one SD distill step on the card against the CPU; and every kernel call
    of these paths against its plain version at its own shape (recorded
    on the path). Every count is set to 0 just before each run and read
    just after."""
    import base64

    import numpy as np
    from PIL import Image

    from polyp_tpu_torch import serve as serve_mod
    from polyp_tpu_torch.cli import distill, distill_sd, distill_vae
    from polyp_tpu_torch.cli.sd_common import (
        fp32_unet_params, load_class_bundle)
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.models.tiny_decoder import load_tiny_decoder
    from polyp_tpu_torch.pipeline import generate_to_dir
    from polyp_tpu_torch.train import distill as td
    from polyp_tpu_torch.train import distill_vae as tdv

    root = tmp / "distill"
    common = ["--data-root", str(data), "--cache-dir", str(root / "cache"),
              "--tracker-root", str(root / "mlruns")]
    lora_dir = tmp / "sd_clis" / "all"
    recorder = ShapeRecorder({"fused_group_norm": gn_key,
                              "fused_geglu": lambda x, *args: tuple(x.shape),
                              "flash_attention": flash_key})
    out: dict = {"card": card}

    def pngs(d: Path, n: int, px: int) -> None:
        files = sorted(d.glob("*.png"))
        if len(files) != n or any(np.asarray(Image.open(f)).shape
                                  != (px, px, 3) for f in files):
            raise AssertionError(f"{d}: {[f.name for f in files]}")

    # polyp-distill-sd-torch: 3 classes × 4 steps; the last step profiled
    meter = StepMeter(read_counts, profile_at=3 * DISTILL_STEPS - 1)
    real_step = td.make_distill_step
    td.make_distill_step = lambda *args, **kwargs: meter.wrap(
        real_step(*args, **kwargs), reparam=kwargs.get("reparam", False))
    sd_out = root / "sd"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    try:
        with recorder:
            classes = distill_sd.main(common + [
                "--model-dir", str(lora_dir), "--output-dir", str(sd_out),
                "--image_size", str(DISTILL_PX),
                "--train_batch_size", str(DISTILL_BATCH),
                "--start_steps", "8", "--end_steps", "4",
                "--steps_per_phase", str(DISTILL_STEPS),
                "--generate", str(DISTILL_GENERATE)])
        torch.cuda.synchronize()
    finally:
        td.make_distill_step = real_step
    sd_s = time.perf_counter() - start
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = meter.check("the SD distill steps", SD_DISTILL_STEP)
    if len(steps) != 3 * DISTILL_STEPS:
        raise AssertionError(f"{len(steps)} SD distill steps")
    step_s = sum(st["s"] for st in steps[1:DISTILL_STEPS]) / (
        DISTILL_STEPS - 1)
    prof = meter.profile
    prof["busy_share"] = prof["device_s"] / step_s
    for cls, r in classes.items():
        pngs(sd_out / "samples" / cls, DISTILL_GENERATE, DISTILL_PX)
        if r["num_steps"] != 4 or not np.isfinite(r["losses"]).all():
            raise AssertionError(f"distill-sd {cls}: {r}")
    out["sd"] = {
        "seconds": sd_s, "launches": launches, "classes": classes,
        "steps": steps, "step_s": step_s,
        "train_images_per_s": DISTILL_BATCH / step_s,
        "peak_memory_gib": peak, "profile": prof,
        "launches_per_step": SD_DISTILL_STEP,
        "save_s": {c: r["save_s"] for c, r in classes.items()}}
    print(f"[distill] polyp-distill-sd-torch (SD-v1-4 full width, "
          f"{DISTILL_PX} px, batch {DISTILL_BATCH}, 8 -> 4 at "
          f"{DISTILL_STEPS} steps, 3 classes, {DISTILL_GENERATE} samples a "
          f"class): {sd_s:.1f} s; a step {step_s:.4f} s (steps 2-4) = "
          f"{DISTILL_BATCH / step_s:.1f} train images/s, peak {peak:.2f} "
          f"GiB, launches a step {SD_DISTILL_STEP}; profiled step device "
          f"{prof['device_s']:.4f} s (busy {prof['busy_share']:.2f}); top "
          + "; ".join(f"{k} {ms:.1f} ({n})" for k, ms, n in prof["top"][:5])
          + "; saves " + ", ".join(f"{c} {r['save_s']:.2f} s"
                                   for c, r in classes.items())
          + f"; launches {launches} on {card}", flush=True)

    # the reparam warmup (ε teacher → v student) through
    # distill_progressive at the same shapes, one class
    config = DiffusionConfig()
    bundle = load_class_bundle(stack, lora_dir, "AD")
    teacher = fp32_unet_params(stack, config, bundle)
    del bundle
    g = torch.Generator(dev).manual_seed(13)
    x0 = torch.randn(DISTILL_BATCH, 4, DISTILL_PX // 8, DISTILL_PX // 8,
                     generator=g, device=dev)
    with torch.no_grad():
        cond, uncond = (stack.text(torch.as_tensor(
            stack.tokenizer([p]), device=dev)).float() for p in (PROMPT, ""))
    meter = StepMeter(read_counts)
    td.make_distill_step = lambda *args, **kwargs: meter.wrap(
        real_step(*args, **kwargs), reparam=kwargs.get("reparam", False))
    reset_counts()
    start = time.perf_counter()
    try:
        with recorder:
            result = td.distill_progressive(
                stack.unet, teacher, distill_sd.sd_schedule(), lambda: [x0],
                start_steps=8, end_steps=4, steps_per_phase=2,
                reparam_steps=2, student_prediction_type="v_prediction",
                guidance_scale=7.5, cond=cond, uncond=uncond)
        torch.cuda.synchronize()
    finally:
        td.make_distill_step = real_step
    reparam_s = time.perf_counter() - start
    reparam_launches = read_counts()
    warm = meter.check("the reparam warmup steps", REPARAM_STEP,
                       reparam=True)
    meter.check("the v student's phase steps", SD_DISTILL_STEP,
                reparam=False)
    del teacher
    if len(warm) != 2 or result.prediction_type != "v_prediction":
        raise AssertionError(f"reparam run: {meter.steps}")
    out["reparam"] = {"seconds": reparam_s, "launches": reparam_launches,
                      "steps": meter.steps,
                      "losses": [p.losses for p in result.phases]}
    del result
    print(f"[distill] reparam warmup through distill_progressive (v "
          f"student, 2 warmup + 2 phase steps, batch {DISTILL_BATCH}): "
          f"{reparam_s:.1f} s; launches a warmup step {REPARAM_STEP}, a "
          f"phase step {SD_DISTILL_STEP}; warmup steps "
          + ", ".join(f"{st['s']:.4f}" for st in warm) + f" s on {card}",
          flush=True)

    # a saved student through load_student_sampler, at its own batch
    student = distill_sd.load_student_sampler(stack, sd_out, "AD",
                                              image_size=DISTILL_PX)
    prompt = json.loads((sd_out / "models" / "distilled_AD_meta.json")
                        .read_text())["prompt"]
    reset_counts()
    start = time.perf_counter()
    with recorder:
        generate_to_dir(student.for_prompt(prompt), STUDENT_IMAGES,
                        root / "student", STUDENT_IMAGES, 0)
    torch.cuda.synchronize()
    student_s = time.perf_counter() - start
    student_launches = read_counts()
    pngs(root / "student", STUDENT_IMAGES, DISTILL_PX)
    forwards = student.num_steps
    want = {k: UNET_FORWARD[k] * forwards + VAE_DECODE[k]
            for k in KERNEL_NAMES}
    if student_launches != want or student.guidance_scale is not None:
        raise AssertionError(f"load_student_sampler: launches "
                             f"{student_launches}, want {want}")
    del student
    out["student"] = {"images": STUDENT_IMAGES, "seconds": student_s,
                      "images_per_s": STUDENT_IMAGES / student_s,
                      "steps": forwards, "launches": student_launches}
    print(f"[distill] load_student_sampler (AD, {forwards} steps, folded "
          f"guidance): {STUDENT_IMAGES} images at batch {STUDENT_IMAGES} in "
          f"{student_s:.2f} s = {STUDENT_IMAGES / student_s:.2f} images/s; "
          f"launches {student_launches} on {card}", flush=True)

    # the three students behind polyp-serve-torch --distilled-dir
    args = argparse.Namespace(
        distilled_dir=str(sd_out), distilled_class="all",
        pretrained_dir=None, tiny=False, device="cuda",
        image_size=DISTILL_PX, steps=25, quantize=None, quant_fp_head=0,
        quant_fp_tail=0, vae_decoder="full", tiny_decoder_dir=None,
        max_batch=SERVE_BATCH, batch_window_ms=50.0, pipeline_depth=1,
        max_pending=64, request_timeout_s=None)
    start = time.perf_counter()
    with recorder:
        service = serve_mod.service_from_args(args)
    warm_s = time.perf_counter() - start
    server = serve_mod.serve(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    models = ["AD", "ASS", "HP"]
    prompts = {m: json.loads((sd_out / "models" / f"distilled_{m}_meta.json")
                             .read_text())["prompt"] for m in models}
    asks = [{"prompt": prompts[models[i % 3]], "num_images": 1,
             "seed": 200 + i, "model": models[i % 3]}
            for i in range(SERVE_BATCH)]
    try:
        status, health, _ = http_json(url + "/healthz")
        if status != 200 or health["models"] != models or not health["warm"]:
            raise AssertionError(f"/healthz {status}: {health}")
        before = service.snapshot()
        reset_counts()
        start = time.perf_counter()
        with recorder:
            answers = in_threads([functools.partial(
                http_json, url + "/generate", a) for a in asks])
        served_s = time.perf_counter() - start
        served_launches = read_counts()
        after = service.snapshot()
        with recorder:
            solos = [http_json(url + "/generate", a) for a in asks[:3]]
    finally:
        server.shutdown()
        service.close()
    del service
    if any(st != 200 or body["model"] != a["model"]
           for (st, body, _), a in zip(answers + solos, asks + asks[:3])):
        raise AssertionError(f"distilled requests: {answers + solos}")
    differ = []
    for (_, solo, _), (_, twin, _) in zip(solos, answers[:3]):
        a = png_pixels(base64.b64decode(solo["images"][0]))
        b = png_pixels(base64.b64decode(twin["images"][0]))
        if a.shape != (DISTILL_PX, DISTILL_PX, 3):
            raise AssertionError(f"served image {a.shape}")
        differ.append(int((a != b).any(axis=-1).sum()))
    by_model = {m: after["launches_by_model"][m]
                - before["launches_by_model"][m] for m in models}
    out["serving"] = {
        "warm_s": warm_s, "requests": SERVE_BATCH, "seconds": served_s,
        "launches_by_model": by_model, "kernel_launches": served_launches,
        "batched_samples": sorted({b["batched_samples"]
                                   for _, b, _ in answers}),
        "solo_vs_coalesced_pixels_differing": differ}
    print(f"[distill] polyp-serve-torch --distilled-dir --distilled-class "
          f"all: {models} warm in {warm_s:.1f} s; {SERVE_BATCH} concurrent "
          f"requests across them in {served_s:.2f} s, launches by model "
          f"{by_model}, kernel launches {served_launches}; 3 solo twins vs "
          f"coalesced: {differ} pixels differ on {card}", flush=True)
    if any(differ) or not all(by_model.values()):
        raise AssertionError(f"distilled serving: {out['serving']}")

    # polyp-distill-torch over scratch_phase's models
    meter = StepMeter(read_counts)
    td.make_distill_step = lambda *args, **kwargs: meter.wrap(
        real_step(*args, **kwargs))
    reset_counts()
    start = time.perf_counter()
    try:
        with recorder:
            scratch = distill.main(common + [
                "--model-dir", str(tmp / "scratch"),
                "--output-dir", str(root / "scratch"),
                "--image_size", str(SCRATCH_PX),
                "--train_batch_size", str(DISTILL_BATCH),
                "--start_steps", "8", "--end_steps", "4",
                "--steps_per_phase", str(DISTILL_STEPS),
                "--generate", str(SCRATCH_DISTILL_GENERATE)])
        torch.cuda.synchronize()
    finally:
        td.make_distill_step = real_step
    scratch_s = time.perf_counter() - start
    scratch_launches = read_counts()
    steps = meter.check("the scratch distill steps", SCRATCH_DISTILL_STEP)
    for cls in scratch:
        pngs(root / "scratch" / "samples" / cls, SCRATCH_DISTILL_GENERATE,
             SCRATCH_PX)
    scratch_step_s = sum(st["s"] for st in steps[1:DISTILL_STEPS]) / (
        DISTILL_STEPS - 1)
    out["scratch"] = {"seconds": scratch_s, "launches": scratch_launches,
                      "steps": steps, "step_s": scratch_step_s,
                      "classes": scratch,
                      "launches_per_step": SCRATCH_DISTILL_STEP}
    print(f"[distill] polyp-distill-torch (polyp_scratch_unet, "
          f"{SCRATCH_PX} px, batch {DISTILL_BATCH}, 8 -> 4 at "
          f"{DISTILL_STEPS} steps, 3 classes, {SCRATCH_DISTILL_GENERATE} "
          f"samples a class): {scratch_s:.1f} s; a step "
          f"{scratch_step_s:.4f} s (steps 2-4); launches a step "
          f"{SCRATCH_DISTILL_STEP}; launches {scratch_launches} on {card}",
          flush=True)

    # polyp-distill-vae-torch with mixed latents
    meter = StepMeter(read_counts)
    real_vae_step = tdv.distill_vae_step
    tdv.distill_vae_step = meter.wrap(real_vae_step)
    reset_counts()
    start = time.perf_counter()
    try:
        with recorder:
            vae = distill_vae.main(common + [
                "--output-dir", str(root / "tiny_decoder"),
                "--image_size", str(DISTILL_PX),
                "--batch", str(DISTILL_BATCH),
                "--steps", str(VAE_DISTILL_STEPS)])
        torch.cuda.synchronize()
    finally:
        tdv.distill_vae_step = real_vae_step
    vae_s = time.perf_counter() - start
    vae_launches = read_counts()
    steps = meter.check("the VAE distill steps", VAE_DISTILL_STEP)
    decoder, meta = load_tiny_decoder(root / "tiny_decoder", device=dev)
    with torch.no_grad():
        images = decoder(x0)
    if (len(steps) != VAE_DISTILL_STEPS or meta["latent_source"] != "mixed"
            or images.shape != (DISTILL_BATCH, 3, DISTILL_PX, DISTILL_PX)
            or not torch.isfinite(images).all()):
        raise AssertionError(f"distill-vae: {meta}, {images.shape}")
    vae_step_s = sum(st["s"] for st in steps[1:]) / (len(steps) - 1)
    out["vae"] = {"seconds": vae_s, "launches": vae_launches,
                  "steps": steps, "step_s": vae_step_s, "meta": meta,
                  "launches_per_step": VAE_DISTILL_STEP}
    print(f"[distill] polyp-distill-vae-torch ({DISTILL_PX} px, batch "
          f"{DISTILL_BATCH}, {VAE_DISTILL_STEPS} steps, mixed latents): "
          f"{vae_s:.1f} s; a step {vae_step_s:.4f} s (steps 2-"
          f"{VAE_DISTILL_STEPS}); launches a step {VAE_DISTILL_STEP}; "
          f"holdout rel L2 {meta['rel_l2']:.4f} (random weights: a number, "
          f"not a quality claim); reloaded and decoded {tuple(images.shape)} "
          f"on {card}", flush=True)

    out["card_vs_cpu"] = distill_vs_cpu(stack, dev)
    with torch.no_grad():
        out["kernel_checks"] = rows = recorded_rows(recorder.seen, dev)
    print(f"[distill] kernel checks at the distill paths' shapes on {card}: "
          + "; ".join(f"{r['name']} {r['shape']} ({r['path_launches']} "
                      f"launches, {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f})"
                      for r in rows), flush=True)
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
    from polyp_tpu_torch.ops.fused_dense import fused_w8a8_dense
    from polyp_tpu_torch.ops.fused_geglu import (
        fused_geglu, fused_geglu_w8a8, fused_geglu_w8a8_pt)
    from polyp_tpu_torch.ops.fused_gn import fused_group_norm
    from polyp_tpu_torch.cli.distill_sd import make_student_sampler
    from polyp_tpu_torch.models.tiny_decoder import load_tiny_decoder
    from polyp_tpu_torch.ops.fused_mha import fused_mha
    from polyp_tpu_torch.pipeline import StableDiffusionSampler

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phases, clock = {}, [time.perf_counter()]

    def phase(name: str) -> None:
        """Seconds since the last phase ended (host clock)."""
        now = time.perf_counter()
        phases[name], clock[0] = now - clock[0], now
        print(f"[time] {name}: {phases[name]:.1f} s", flush=True)

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
        if any(k in line for k in ("registers", "spill", "warning")):
            print(f"[ptxas] {line.strip()}")
    # registers, spills and shared memory a block of the attention and GEMM
    # kernels (the GEMM kernels' shared memory depends on the shape)
    lib = _build.library()
    kernel_resources = ptxas_report(log.read_text())
    for name, res in kernel_resources.items():
        d = res["head_dim"]
        if name.startswith("flash"):
            res["dynamic_smem_bytes"] = lib.polyp_flash_smem(d)
        elif name.startswith("fused_mha"):  # the UNet's 8 heads, Co = 8d
            res["dynamic_smem_bytes"] = lib.polyp_fused_mha_smem(8, d, 8 * d)
        print(f"[regs] {name}: {res}", flush=True)
    phase("card and build")

    # each row's launch count: its wrapper's counter, read after the path
    # that runs it; the GN epilogue has a counter of its own
    counters = {
        "flash_attention": (flash_attention, "launches"),
        "fused_geglu": (fused_geglu, "launches"),
        "fused_group_norm": (fused_group_norm, "launches"),
        "fused_w8a8_dense": (fused_w8a8_dense, "launches"),
        "fused_geglu_w8a8": (fused_geglu_w8a8, "launches"),
        "fused_geglu_w8a8_pt": (fused_geglu_w8a8_pt, "launches"),
        "fused_group_norm_q8": (fused_group_norm, "q8_launches"),
        "fused_mha": (fused_mha, "launches")}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}

    with torch.no_grad():
        rows = check_kernels(dev)
    phase("kernel checks")

    # as a user calls it: with no device, the stack is built on the card
    stack = load_sd_stack(None, dtype=torch.bfloat16, seed=0)
    if next(stack.unet.parameters()).device != dev:
        raise AssertionError("load_sd_stack did not build on the card")
    n_params = sum(p.numel() for p in stack.unet.parameters())
    if n_params != SD14_UNET_PARAMS:
        raise AssertionError(f"UNet has {n_params} params")
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085, 0.012)
    phase("SD stack on the card")

    def sampler_for(**quant_kw):
        return StableDiffusionSampler(
            stack.unet, stack.vae, stack.text, stack.tokenizer, schedule,
            image_size=256, num_steps=20, guidance_scale=7.5,
            sampler="ddim", **quant_kw)

    paths, images = {}, {}

    def drive(name: str, sampler, n_images: int, batch: int, **info):
        """generate_to_dir twice from seed 0: the first run through
        for_prompt, counted (every count set to 0 just before it, read just
        after), the second timed, with its sampling loops and decodes timed
        apart (split_timed)."""
        reset_counts()
        cold_s, _ = run_path(sampler.for_prompt(PROMPT), tmp / f"{name}_cold",
                             n_images, batch)
        launches = read_counts()
        spent = {"unet_s": 0.0, "decode_s": 0.0}
        warm_s, images[name] = run_path(split_timed(sampler, spent),
                                        tmp / f"{name}_warm", n_images, batch)
        forwards = sampler.num_steps * -(-n_images // batch)
        paths[name] = {
            "images": n_images, "batch": batch, "steps": sampler.num_steps,
            "first_run_s": cold_s, "second_run_s": warm_s,
            "images_per_s": n_images / warm_s, "launches": launches,
            "launches_per_unet_forward": {
                k: v / forwards for k, v in launches.items()},
            **spent, "decode_share": spent["decode_s"] / (
                spent["unet_s"] + spent["decode_s"]), **info}

    def calibrate(sampler) -> dict:
        start = time.perf_counter()
        sampler.for_prompt(PROMPT)  # calibrates
        torch.cuda.synchronize()
        info = {"calibration_s": time.perf_counter() - start,
                "calibrated_layers": len(sampler.quant_scales)}
        print(f"[calibrate] w8a8_static scales for "
              f"{info['calibrated_layers']} layers "
              f"({min(8, sampler.num_steps)}-point "
              f"{'folded' if sampler.guidance_scale is None else 'CFG'} "
              f"trajectory) in {info['calibration_s']:.2f} s", flush=True)
        return info

    def profile_denoise(name: str, sampler, batch: int) -> None:
        """profile_loop() of one batch's sampling loop, with its share of the
        unprofiled loop's wall time (the timed run's, one batch)."""
        path = paths[name]
        prof = profile_loop(sampler, batch)
        # the CFG paths' timed run has n_images / batch loops
        loops = path["images"] // path["batch"]
        prof["busy_share"] = prof["device_s"] * loops / path["unet_s"]
        path["profile"] = prof
        print(f"[profile] {name}: device {prof['device_s']:.4f} s a loop, "
              f"busy share {prof['busy_share']:.2f}; per family (ms, calls):"
              f" " + "; ".join(f"{k} {v[0]:.3f} ({v[1]})"
                               for k, v in prof["families"].items())
              + "; top: " + "; ".join(f"{k} {ms:.1f} ({n})"
                                      for k, ms, n in prof["top"][:5]),
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # calibration is cached by weight fingerprint: a fresh cache here,
        # so this run calibrates and writes nothing outside the checkout
        os.environ["POLYP_TORCH_QUANT_CACHE"] = str(tmp / "quant_cache")

        # the CFG paths: 20 DDIM steps, batch 2
        drive("bf16", sampler_for(), 4, 2)
        static = sampler_for(quantize="w8a8_static", quant_fp_head=5)
        drive("w8a8_static", static, 4, 2, fp_head=5, **calibrate(static))
        # the int8 loop's device time, and the dense's share of it
        profile_denoise("w8a8_static", static, 2)
        dynamic = sampler_for(quantize="w8a8")
        drive("w8a8", dynamic, 2, 2)
        # the dynamic int8 loop, and the per-token GEGLU's share of it
        profile_denoise("w8a8", dynamic, 2)
        # the port's defaults, as a user who names no sampler gets them:
        # UniPC, 25 steps, CFG 7.5, 256px
        default = StableDiffusionSampler(stack.unet, stack.vae, stack.text,
                                         stack.tokenizer, schedule)
        if default.sampler != "unipc":
            raise AssertionError(f"default sampler {default.sampler!r}")
        drive("bf16_unipc", default, 2, 2, sampler_name=default.sampler)
        census = shape_census(stack, dev, static.quant_scales)
        print(f"[census] launches per CFG UNet forward by shape (GEGLU, "
              f"dense) and per VAE decode at batch 2 (GroupNorm): {census}",
              flush=True)
        phase("CFG paths")

        # the distilled paths (the full-width UNet stands in for a student:
        # same program, random weights): folded guidance, trailing grid
        tiny, meta = load_tiny_decoder(device=dev)
        student = functools.partial(make_student_sampler, stack, stack.unet)
        q8 = student(num_steps=4, quantize="w8a8_static", decoder=tiny)
        distilled = [
            ("distilled_bf16", student(num_steps=8, fused_mha=True), 16,
             {"decoder": "vae", "fused_mha": True}),
            ("distilled_bf16_unfused", student(num_steps=8), 16,
             {"decoder": "vae", "fused_mha": False}),
            ("distilled_bf16_tiny", student(num_steps=4, fused_mha=True,
                                            decoder=tiny), 32,
             {"decoder": "tiny", "fused_mha": True}),
            ("distilled_int8_tiny", q8, 32,
             {"decoder": "tiny", "fp_head": 0, **calibrate(q8)})]
        for name, sampler, batch, info in distilled:
            drive(name, sampler, batch, batch, **info)
            # the pair that decides the fused MHA's opt-in (PERF.md), and
            # the int8 loop
            if name in ("distilled_bf16", "distilled_bf16_unfused",
                        "distilled_int8_tiny"):
                profile_denoise(name, sampler, batch)
        phase("distilled paths")

        serving = serving_phase(stack, tiny, card, reset_counts,
                                read_counts, tmp)
        phase("serving")

        training = training_phase(stack, dev, card, reset_counts,
                                  read_counts, tmp)
        phase("LoRA training")

        loop = augmentation_loop_phase(dev, card, reset_counts, read_counts,
                                       tmp)
        phase("augmentation loop")

        # the scratch path and the SD CLIs on the loop's corpus
        scratch = scratch_phase(dev, card, reset_counts, read_counts, tmp,
                                tmp / "loop" / "data")
        phase("scratch DDPM")
        sd_clis = sd_clis_phase(dev, card, reset_counts, read_counts, tmp,
                                tmp / "loop" / "data")
        phase("SD CLIs")
        distilling = distill_phase(stack, dev, card, reset_counts,
                                   read_counts, tmp, tmp / "loop" / "data")
        phase("distill")

    for name, path in paths.items():
        split = (f"; UNet only {path['unet_s']:.3f} s, decode only "
                 f"{path['decode_s']:.3f} s, decode share "
                 f"{path['decode_share']:.3f}")
        print(f"[main] {name}: {path['images']} images, 256px, "
              f"{path['steps']} steps, batch {path['batch']}: first run "
              f"{path['first_run_s']:.2f} s, second "
              f"{path['second_run_s']:.2f} s = {path['images_per_s']:.3f} "
              f"images/s{split} on {card}; launches {path['launches']}",
              flush=True)
    # (images, the images of the same seeds they are held to, bound)
    pairs = {"w8a8_static": ("bf16", INT8_IMAGE_REL_L2),
             "distilled_bf16_unfused": ("distilled_bf16", FUSED_IMAGE_REL_L2),
             "distilled_int8_tiny": ("distilled_bf16_tiny",
                                     INT8_IMAGE_REL_L2)}
    for name, (ref, limit) in pairs.items():
        rel = rel_l2(images[name], images[ref])
        paths[name]["image_rel_l2_vs"] = {ref: rel}
        print(f"[main] {name} images vs {ref} images, same seeds: rel L2 "
              f"{rel:.4f} (tol {limit})", flush=True)
        if not rel <= limit:
            raise AssertionError(f"{name} images differ from {ref} images "
                                 f"by {rel} > {limit}")
    # each path must have run each of its kernels
    need = {"bf16": ("flash_attention", "fused_geglu", "fused_group_norm"),
            "bf16_unipc": ("flash_attention", "fused_geglu",
                           "fused_group_norm"),
            "w8a8_static": ("flash_attention", "fused_w8a8_dense",
                            "fused_geglu_w8a8", "fused_group_norm_q8"),
            "w8a8": ("flash_attention", "fused_w8a8_dense",
                     "fused_geglu_w8a8_pt"),
            "distilled_bf16": ("fused_mha", "fused_geglu",
                               "fused_group_norm"),
            "distilled_bf16_unfused": ("flash_attention", "fused_geglu"),
            "distilled_bf16_tiny": ("fused_mha", "fused_geglu"),
            "distilled_int8_tiny": ("flash_attention", "fused_w8a8_dense",
                                    "fused_geglu_w8a8",
                                    "fused_group_norm_q8")}
    for name, kernels in need.items():
        for kernel in kernels:
            if paths[name]["launches"][kernel] <= 0:
                raise AssertionError(f"{name} path never launched {kernel}")
    # five level-0 self-attentions per forward at 256px, 8 steps, one batch:
    # all through the fused kernel when it is enabled, all through flash
    # when not, and never under int8 (the kernel is bf16-only)
    exact = {"distilled_bf16": {"fused_mha": 40, "flash_attention": 0},
             "distilled_bf16_unfused": {"fused_mha": 0,
                                        "flash_attention": 40},
             "distilled_int8_tiny": {"fused_mha": 0}}
    for name, want in exact.items():
        got = {k: paths[name]["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"{name} launches {got}, want {want}")

    # the attention kernels keep their state in registers without spilling
    # at every head dim a path runs (d <= 80), and the GEMM kernels their
    # accumulators at every width
    spilled = {name: res for name, res in kernel_resources.items()
               if res.get("spill_bytes", 1) > 0
               and (res["head_dim"] or 0) <= 80}
    if spilled or not any(n.startswith("gemm_kernel")
                          for n in kernel_resources):
        raise AssertionError(f"kernels spill (or no GEMM kernel in the "
                             f"log): {spilled}")

    decoder_rel = check_tiny_decoder(tiny, dev)
    agreement = check_against_cpu(stack, dev, static.quant_scales)
    agreement["tiny_decoder_rel_l2"] = decoder_rel
    agreement["tiny_decoder_meta"] = meta
    phase("checks against the CPU")

    sources = {
        "flash_attention": ("bf16", "polyp_tpu_torch/csrc/flash_attention.cu",
                            "polyp_tpu/ops/flash_attention.py:185"),
        "fused_geglu": ("bf16", "polyp_tpu_torch/csrc/fused_geglu.cu",
                        "polyp_tpu/ops/fused_geglu.py:139"),
        "fused_group_norm": ("bf16", "polyp_tpu_torch/csrc/fused_gn.cu",
                             "polyp_tpu/ops/fused_gn.py:136"),
        "fused_w8a8_dense": ("w8a8_static",
                             "polyp_tpu_torch/csrc/fused_dense.cu",
                             "polyp_tpu/ops/fused_dense.py:97"),
        "fused_geglu_w8a8": ("w8a8_static",
                             "polyp_tpu_torch/csrc/fused_geglu_w8a8.cu",
                             "polyp_tpu/ops/fused_geglu.py:256"),
        "fused_geglu_w8a8_pt": ("w8a8",
                                "polyp_tpu_torch/csrc/fused_geglu_w8a8.cu",
                                "polyp_tpu/ops/fused_geglu.py:398"),
        "fused_group_norm_q8": ("w8a8_static",
                                "polyp_tpu_torch/csrc/fused_gn.cu",
                                "polyp_tpu/ops/fused_gn.py:136"),
        "fused_mha": ("distilled_bf16", "polyp_tpu_torch/csrc/fused_mha.cu",
                      "polyp_tpu/ops/fused_mha.py:241")}
    rows += (loop["kernel_checks"] + scratch["kernel_checks"]
             + sd_clis["kernel_checks"] + distilling["kernel_checks"])
    table = []
    per_train_step = training["default"]["launches_per_step"]
    per_loop_class = {c: v["launches"] for c, v in loop["classes"].items()}
    for name, (path, source, replaces) in sources.items():
        mine = [r for r in rows if r["name"] == name]
        head = mine[0]  # first row: the main path's headline shape
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": paths[path]["launches"][name],
                      "max_abs_err": max(r["max_abs_err"] for r in mine),
                      "ms": head["ms"], "plain_ms": head["plain_ms"],
                      "bound_ms": head["bound_ms"],
                      "bound_by": head["bound_by"],
                      "library_ms": head["library_ms"],
                      "launches_per_train_step": per_train_step[name],
                      "launches_per_loop_class": {
                          c: v[name] for c, v in per_loop_class.items()},
                      "launches_per_scratch_forward": {
                          "bf16": scratch["forward_launches"].get(name, 0),
                          "w8a8_static": scratch["w8a8_static"][
                              "launches_per_forward"].get(name, 0)},
                      "launches_per_distill_step": {
                          "sd": SD_DISTILL_STEP[name],
                          "sd_reparam": REPARAM_STEP[name],
                          "scratch": SCRATCH_DISTILL_STEP[name],
                          "vae": VAE_DISTILL_STEP[name]}})
    detail = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "phases_s": phases, "checks": rows, "main_paths": paths,
              "shape_census": census, "serving": serving,
              "training": training, "augmentation_loop": loop,
              "scratch": scratch, "sd_clis": sd_clis,
              "distill": distilling,
              "attention_kernel_resources": kernel_resources,
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
