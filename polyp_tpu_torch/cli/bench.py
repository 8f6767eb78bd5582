"""polyp-bench-torch: the port's benchmark entry point, the twin of the
repo-root bench.py (`polyp-bench`) on the H100.

256 px image generation through the SD-v1-4 stack (random weights from
seed 0): 50-step DDIM over the 860M UNet with CFG (2× batch) + VAE
decode, on one card. Prints ONE JSON line, key for key the reference's,
plus `card` (the card's name and power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them, or
"cpu"):
  {"metric": ..., "value": N, "unit": "samples/sec/chip", "vs_baseline": N,
   ..., "card": "..."}

`vs_baseline` compares against the measured PyTorch-CPU reference
throughput vendored in `tools/reference_baseline.json` (package data: the
SD UNet + VAE decoder in torch fp32, 25-step CFG, 0.007655 samples/s on
one thread); `vs_baseline_16core_bound` scales it to 16 cores with
perfect linearity, a lower bound on the speedup.

The measurements (each builds its own models, as the reference's do):
* `bench_sampling`: N-step CFG sampling + VAE decode, bf16 or int8 with
  the hybrid-precision split (pipeline.py::_precision_split);
* `bench_distilled`: folded-guidance few-step trailing DDIM + decode
  (the VAE, its int8 form `quantize_vae`, or the tiny decoder), split
  into UNet-loop and decode seconds, with the int8 fidelity probes;
* `bench_classifier_train`, `bench_sd_lora_train`, `bench_distill_train`:
  chained training steps, one data-dependent scalar fetch at a chain's
  end; the distill step falls back adamw → adafactor → half batch on
  `torch.OutOfMemoryError`.

Timing: one warm-up call (`compile_sec`: on the card the first call's
seconds, which hold a kernel build at first use, cuDNN's autotune and the
allocator's growth), then the best of `repeats`; a call ends with
`.float().mean().item()` of its output, which cannot return before every
element is computed.

The run's default line: the headline is the gate-passing quant config
(ops/quant.py::promoted_config) with bf16 as its companion, or, when the
gate demotes it, bf16 with the w8a8_static companion at batch 16; the
distilled companions (8 steps × 16, 4 × 32, VAE and tiny decoder) ride
along. A companion that fails writes its `*_error` key on the line, so
the measured headline is kept, and the run exits 1.

Flags: bench.py's (--steps --batch --image-size --sampler --quick --train
--train-diffusion --quantize --quant-fp-head --quant-fp-tail --distilled
--quantize-vae --tiny-decoder --tiny-decoder-dir --watchdog) and
`--device` (default cuda; the benches run on the card unless given cpu).
Run as `polyp-bench-torch` or `python -m polyp_tpu_torch.cli.bench`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

BASELINE_PATH = (Path(__file__).resolve().parents[1] / "tools"
                 / "reference_baseline.json")
SD_SCHEDULE = (1000, "scaled_linear", 0.00085, 0.012)
GUIDANCE = 7.5
# A realistic reference deployment is a multi-core node, not the one-core
# host the baseline was measured on. 16 cores with PERFECT linear scaling
# is an upper bound on the baseline's throughput, so the ratio against it
# is a lower bound on the speedup; both ratios travel in the JSON line.
REFERENCE_NORMALIZED_CORES = 16


def _reference_baseline(path: Path = BASELINE_PATH) -> tuple[float, int]:
    """The measured torch-CPU reference samples/s and the thread count it
    was measured with. A missing or malformed file raises."""
    d = json.loads(Path(path).read_text())
    rate, threads = float(d["torch_cpu_samples_per_sec"]), int(d["threads"])
    if not (rate > 0 and threads > 0):
        raise ValueError(f"{path}: baseline rate {rate}, threads {threads}")
    return rate, threads


REFERENCE_CPU_SAMPLES_PER_SEC, REFERENCE_CPU_THREADS = _reference_baseline()


def card_name(device: torch.device | str) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _sync_mean(out: torch.Tensor) -> float:
    """The mean of every element, fetched to the host: returns only once
    the whole output is computed."""
    return out.float().mean().item()


# ---------------------------------------------------------------------------
# Models (seeded random weights; the training benches' factories are module
# functions so tests can swap in the tiny ones)
# ---------------------------------------------------------------------------

def _filled(module: torch.nn.Module, device, generator: torch.Generator):
    from polyp_tpu_torch.cli.common import init_weights_

    module = module.to_empty(device=device)
    init_weights_(module, generator)
    return module.eval()


def sd_models(quick: bool, device, dtype: torch.dtype = torch.bfloat16
              ) -> tuple[torch.nn.Module, torch.nn.Module, int]:
    """(UNet, VAE, context width): SD-v1-4's, or the tiny pair under
    `quick`, filled by the reference's init scheme from one generator
    seeded 0 on `device`."""
    from polyp_tpu_torch.models import (AutoencoderKL, sd14_unet,
                                        tiny_condition_unet, tiny_vae)

    gen = torch.Generator(device).manual_seed(0)
    if quick:
        unet, vae, ctx_dim = (tiny_condition_unet(dtype, "meta"),
                              tiny_vae(dtype, "meta"), 32)
    else:
        unet, vae, ctx_dim = (sd14_unet(dtype, "meta"),
                              AutoencoderKL(dtype=dtype, device="meta"), 768)
    return _filled(unet, device, gen), _filled(vae, device, gen), ctx_dim


def sd_unet(device) -> tuple[torch.nn.Module, int]:
    """The full-size UNet (bf16, seed 0) and its context width: the
    distill train bench's model."""
    from polyp_tpu_torch.models import sd14_unet

    gen = torch.Generator(device).manual_seed(0)
    return _filled(sd14_unet(torch.bfloat16, "meta"), device, gen), 768


def sd_stack(device):
    """The full-size stack (bf16, seed 0): the LoRA train bench's. Its
    loader's notice goes to stderr: stdout carries only the JSON line."""
    from polyp_tpu_torch.cli.common import load_sd_stack

    with contextlib.redirect_stdout(sys.stderr):
        return load_sd_stack(device=device)


def classifier_config(image_size: int, batch_size: int):
    """The classifier bench's configuration: EfficientNet-B0 (the
    ClassificationConfig defaults) at `image_size` and `batch_size`."""
    from polyp_tpu_torch.configs import ClassificationConfig

    return ClassificationConfig(image_size=image_size, batch_size=batch_size)


def _schedule():
    from polyp_tpu_torch.diffusion import DiffusionSchedule

    return DiffusionSchedule.create(*SD_SCHEDULE)


def _embedding(gen: torch.Generator, ctx_dim: int, dtype) -> torch.Tensor:
    return torch.randn((1, 77, ctx_dim), generator=gen,
                       device=gen.device).to(dtype)


# ---------------------------------------------------------------------------
# The timed callables (factories the tests hold against the JAX package's
# composition of the same functions)
# ---------------------------------------------------------------------------

def _quantized(unet, mode, bank):
    """unet(z, t, emb) under `quant.override(mode, scales=bank, t=t)`."""
    from polyp_tpu_torch.ops import quant

    def raw(z, t, emb):
        with quant.override(mode, scales=bank, t=t):
            return unet(z, t, emb)
    return raw


def make_sampling_fn(unet, vae, schedule, cond: torch.Tensor,
                     uncond: torch.Tensor, batch_size: int, image_size: int,
                     steps: int, sampler_name: str,
                     quantize: str | None = None,
                     split: tuple[int, int] | None = None,
                     scales: dict | None = None
                     ) -> Callable[..., torch.Tensor]:
    """`generate(generator, init=None)`: CFG 7.5 sampling of `batch_size`
    latents (from `generator`, or `init` [B, 4, s/8, s/8] fp32) with the
    UNet under `quantize` (an fp head / tail of `split` in full
    precision), then the VAE decode of latents cast to the VAE's dtype:
    fp32 NCHW images (bench.py:321-342)."""
    from polyp_tpu_torch.diffusion import sample, with_cfg
    from polyp_tpu_torch.models.vae import SD_VAE_SCALING
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.pipeline import _precision_segments

    bank = quant.ScaleBank(scales) if scales is not None else None
    latent = image_size // 8
    dtype = vae.decoder.dtype

    @torch.no_grad()
    def generate(generator: torch.Generator | None,
                 init: torch.Tensor | None = None) -> torch.Tensor:
        model_fn = with_cfg(_quantized(unet, quantize, bank), cond, uncond,
                            GUIDANCE)
        if split is not None:
            fp_model = with_cfg(_quantized(unet, None, None), cond, uncond,
                                GUIDANCE)
            model_fn = _precision_segments(model_fn, fp_model, steps, split)
        latents = sample(sampler_name, model_fn, schedule,
                         (batch_size, 4, latent, latent), generator, steps,
                         init=init)
        return vae.decode(latents.to(dtype) / SD_VAE_SCALING)

    return generate


def make_decoder(vae, tiny=None) -> Callable[..., torch.Tensor]:
    """`decode(z, mode)` of scaled latents to fp32 images (bench.py:463-472):
    mode "tiny" through `tiny` (which takes them as they are), else the
    VAE after the unscaling, its convs and projections under
    `quant.override(mode)` ("w8a8" quantizes the decoder's wide layers
    with dynamic scales; None is full precision)."""
    from polyp_tpu_torch.models.vae import SD_VAE_SCALING
    from polyp_tpu_torch.ops import quant

    dtype = vae.decoder.dtype

    @torch.no_grad()
    def decode(z: torch.Tensor, mode: str | None) -> torch.Tensor:
        if mode == "tiny":
            return tiny(z.to(dtype))
        with quant.override(mode):
            return vae.decode(z.to(dtype) / SD_VAE_SCALING)

    return decode


def make_denoiser(unet, schedule, cond: torch.Tensor, batch_size: int,
                  image_size: int, steps: int, quantize: str | None = None,
                  scales: dict | None = None) -> Callable[..., torch.Tensor]:
    """`denoise(generator, init=None)` of the folded-guidance student path
    (bench.py:432-440): cond-only (1× batch) `steps`-step trailing DDIM
    with the UNet under `quantize`; fp32 scaled latents."""
    from polyp_tpu_torch.diffusion import sample, with_cfg
    from polyp_tpu_torch.ops import quant

    bank = quant.ScaleBank(scales) if scales is not None else None
    latent = image_size // 8

    @torch.no_grad()
    def denoise(generator: torch.Generator | None,
                init: torch.Tensor | None = None) -> torch.Tensor:
        model_fn = with_cfg(_quantized(unet, quantize, bank), cond, None,
                            None)
        return sample("ddim", model_fn, schedule,
                      (batch_size, 4, latent, latent), generator, steps,
                      init=init, spacing="trailing", steps_offset=0)

    return denoise


def _static_scales(unet, schedule, latent: int, cond, uncond,
                   guidance: float | None, points: int,
                   extras: tuple) -> dict:
    """w8a8_static's calibrated scales (diffusion/calibrate.py, cached on
    disk by weight fingerprint and `extras`)."""
    from polyp_tpu_torch.diffusion.calibrate import ensure_scales

    scales, _ = ensure_scales(unet, schedule, (2, 4, latent, latent), cond,
                              uncond, num_steps=points,
                              guidance_scale=guidance,
                              fingerprint_extras=extras)
    return scales


def _seeded(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Sampling benches
# ---------------------------------------------------------------------------

def bench_sampling(batch_size: int, image_size: int, steps: int,
                   sampler_name: str, quick: bool, repeats: int = 3,
                   quantize: str | None = None,
                   quant_fp_head: int = 0, quant_fp_tail: int = 0,
                   device: torch.device | str = "cuda") -> dict:
    """Samples/s of `steps`-step CFG sampling + VAE decode at
    `batch_size` (bench.py:70-168)."""
    from polyp_tpu_torch.pipeline import _precision_split

    dtype = torch.bfloat16
    unet, vae, ctx_dim = sd_models(quick, device, dtype)
    latent = image_size // 8
    gen = _seeded(device, 0)
    cond = _embedding(gen, ctx_dim, dtype)
    uncond = torch.zeros_like(cond)
    schedule = _schedule()

    scales = None
    if quantize == "w8a8_static":
        t0 = time.perf_counter()
        # the fingerprint holds the guidance mode and prediction type, so
        # guided and folded calibrations of the same weights never collide
        scales = _static_scales(unet, schedule, latent, cond, uncond,
                                GUIDANCE, 8,
                                (image_size, 1000, GUIDANCE, "epsilon"))
        # stderr: stdout carries only the JSON line
        print(f"# calibrated {len(scales)} scales in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr,
              flush=True)
    quantize, split = _precision_split(steps, quantize, quant_fp_head,
                                       quant_fp_tail)
    generate = make_sampling_fn(unet, vae, schedule, cond, uncond,
                                batch_size, image_size, steps, sampler_name,
                                quantize, split, scales)

    t0 = time.perf_counter()
    checksum = _sync_mean(generate(_seeded(device, 1)))
    compile_s = time.perf_counter() - t0
    if not math.isfinite(checksum):
        raise AssertionError("non-finite sample output")
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        _sync_mean(generate(_seeded(device, 2 + i)))
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"samples_per_sec": batch_size / best, "sec_per_batch": best,
            "compile_sec": compile_s, "batch_size": batch_size}


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = got.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def bench_distilled(batch_size: int, image_size: int, steps: int,
                    quick: bool = False, repeats: int = 3,
                    quantize: str | None = None,
                    quantize_vae: bool = False,
                    tiny_decoder: bool = False,
                    tiny_decoder_dir: str | None = None,
                    device: torch.device | str = "cuda") -> dict:
    """Folded-guidance few-step sampling, the distilled-student serving
    path (bench.py:171-342): cond-only UNet at 1× batch, `steps`-step
    trailing DDIM, decode per image, with the run split into UNet-loop
    and decode seconds (the few-step Amdahl term). A student has the same
    FLOPs as the random-init model, so throughput needs no trained
    weights. `quantize_vae` decodes under w8a8 and reports the int8
    decode's rel-L2 against the bf16 decode of the same latents
    (`vae_q_rel_l2`); `quantize` reports the quantized trajectory's
    images against the bf16 trajectory's (`quant_rel_l2`);
    `tiny_decoder` decodes through the tiny decoder (default: the port's
    shipped weights, whose meta gives `tiny_rel_l2`). The tiny decoder and
    the int8 VAE are alternative decode levers: asking for both raises."""
    if tiny_decoder and quantize_vae:
        raise ValueError("tiny_decoder and quantize_vae are alternative "
                         "decode levers; pick one")
    dtype = torch.bfloat16
    unet, vae, ctx_dim = sd_models(quick, device, dtype)
    latent = image_size // 8
    cond = _embedding(_seeded(device, 0), ctx_dim, dtype)
    schedule = _schedule()

    scales = None
    if quantize == "w8a8_static":
        # calibrated on the folded trajectory this bench measures, with
        # the guidance mode in the fingerprint, so bench_sampling's guided
        # tables of the same weights are never handed back
        scales = _static_scales(unet, schedule, latent, cond, None, None,
                                min(8, steps),
                                (image_size, 1000, None, "epsilon"))

    tiny = tiny_meta = None
    vae_mode = "w8a8" if quantize_vae else None
    if tiny_decoder:
        from polyp_tpu_torch.models.tiny_decoder import (DEFAULT_DIR,
                                                         load_tiny_decoder)
        tiny, tiny_meta = load_tiny_decoder(tiny_decoder_dir or DEFAULT_DIR,
                                            dtype=dtype, device=device)
        vae_mode = "tiny"
    denoise = make_denoiser(unet, schedule, cond, batch_size, image_size,
                            steps, quantize, scales)
    decode = make_decoder(vae, tiny)

    def generate(generator):
        return decode(denoise(generator), vae_mode)

    def timed(fn, args: Callable[[], tuple]) -> float:
        """Best seconds of `repeats` calls fn(*args()) after a warm-up."""
        _sync_mean(fn(*args()))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            _sync_mean(fn(*args()))
            best = min(best, time.perf_counter() - t0)
        return best

    def key():
        return (_seeded(device, 3),)

    z = torch.randn((batch_size, 4, latent, latent),
                    generator=_seeded(device, 3), device=device).to(dtype)
    z = z * 0.18215
    e2e = timed(generate, key)
    unet_s = timed(denoise, key)
    vae_s = timed(decode, lambda: (z, vae_mode))
    out = {"samples_per_sec": batch_size / e2e, "sec_per_batch": e2e,
           "unet_scan_sec": unet_s, "vae_decode_sec": vae_s,
           "vae_share": vae_s / (unet_s + vae_s), "batch_size": batch_size,
           "steps": steps}
    if tiny_decoder:
        out["decoder"] = "tiny"
        if "rel_l2" in tiny_meta:
            out["tiny_rel_l2"] = tiny_meta["rel_l2"]
    if quantize_vae:
        out["vae_q_rel_l2"] = _rel_l2(decode(z, "w8a8"), decode(z, None))
    if quantize is not None:
        # the quantized trajectory's images against the bf16 trajectory's,
        # both through the bf16 VAE decode
        ref_denoise = make_denoiser(unet, schedule, cond, batch_size,
                                    image_size, steps)
        ref = decode(ref_denoise(_seeded(device, 3)), None)
        got = decode(denoise(_seeded(device, 3)), None)
        out["quant_rel_l2"] = _rel_l2(got, ref)
    return out


# ---------------------------------------------------------------------------
# Training benches
# ---------------------------------------------------------------------------

def _chain_rate(run_chain: Callable[[str], None], chain: int,
                repeats: int) -> tuple[float, float]:
    """(compile seconds, best seconds a step): a warm-up chain, then the
    best of `repeats` chains of `chain` steps."""
    t0 = time.perf_counter()
    run_chain("warmup")
    compile_s = time.perf_counter() - t0
    times = []
    for r in range(repeats):
        t0 = time.perf_counter()
        run_chain(f"rep{r}")
        times.append((time.perf_counter() - t0) / chain)
    return compile_s, min(times)


def _fetch_total(losses: list[torch.Tensor], what: str) -> float:
    """One scalar fetch that depends on every step of a chain."""
    total = torch.stack([loss.float() for loss in losses]).sum().item()
    if not math.isfinite(total):
        raise AssertionError(f"non-finite {what} loss")
    return total


def bench_classifier_train(batch_size: int = 16, image_size: int = 224,
                           repeats: int = 3, chain: int = 10,
                           device: torch.device | str = "cuda") -> dict:
    """Steady-state classifier training throughput (bench.py:345-379):
    `chain` back-to-back steps with no host sync, timed with one
    data-dependent scalar fetch at the end."""
    from polyp_tpu_torch.train import classifier as tc
    from polyp_tpu_torch.utils.rng import stream_generator

    state = tc.create_classifier_state(
        classifier_config(image_size, batch_size), 3, device)
    images = torch.zeros((batch_size, image_size, image_size, 3),
                         dtype=torch.uint8, device=device)
    labels = torch.zeros((batch_size,), dtype=torch.long, device=device)

    def run_chain(tag: str) -> None:
        losses = []
        for i in range(chain):
            draws = tc.draw_step(state.model, batch_size, stream_generator(
                0, "bench_classifier", tag, i, device=device))
            losses.append(tc.train_step(state, images, labels, draws)[0])
        _fetch_total(losses, "training")

    _, sec = _chain_rate(run_chain, chain, repeats)
    return {"train_images_per_sec": batch_size / sec}


def bench_sd_lora_train(batch_size: int = 8, image_size: int = 256,
                        repeats: int = 3, chain: int = 5,
                        device: torch.device | str = "cuda") -> dict:
    """The SD-v1-4 LoRA fine-tune step (frozen VAE encode + frozen CLIP +
    860M UNet forward/backward with rank-8 adapters on q/k/v/out +
    the optimizer) at the reference's pretrained-path configuration (256
    px, batch 8; bench.py:382-452), chained as bench_classifier_train."""
    from polyp_tpu_torch.cli.sd_common import make_components
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.lora.surgery import LoRAConfig, init_lora
    from polyp_tpu_torch.train import sd_finetune as sf
    from polyp_tpu_torch.utils.rng import stream_generator

    stack = sd_stack(device)
    cfg = DiffusionConfig(image_size=image_size,
                          train_batch_size=batch_size).with_schedule(100)
    lcfg = LoRAConfig(rank=8, alpha=8.0, dropout=0.0)
    trainable = sf.init_trainable(init_lora(stack.unet, lcfg,
                                            _seeded(device, 1)))
    frozen = make_components(stack, trainable)
    state = sf.create_sd_train_state(cfg, trainable)
    schedule = _schedule()
    images = torch.zeros((batch_size, image_size, image_size, 3),
                         dtype=torch.uint8, device=device)
    ids = torch.zeros((1, stack.text.config.max_length), dtype=torch.long,
                      device=device)

    def run_chain(tag: str) -> None:
        losses = []
        for i in range(chain):
            draws = sf.StepDraws(stream_generator(0, "bench_sd_lora", tag, i,
                                                  device=device))
            losses.append(sf.sd_lora_train_step(
                state, frozen, schedule, images, ids, None, draws, lcfg)[1])
        _fetch_total(losses, "SD LoRA training")

    compile_s, sec = _chain_rate(run_chain, chain, repeats)
    return {"sd_lora_train_images_per_sec": batch_size / sec,
            "compile_sec": compile_s}


def make_distill_optimizer(name: str):
    """The distill bench's optimizer: "adamw" (clip_by_global_norm(1.0) +
    adamw(1e-4, weight_decay=1e-2), train/sd_finetune.py::SDOptimizer) or
    "adafactor" (clip_by_global_norm(1.0) + adafactor(1e-4),
    train/adafactor.py)."""
    from polyp_tpu_torch.train.adafactor import Adafactor
    from polyp_tpu_torch.train.sd_finetune import SDOptimizer

    if name == "adamw":
        return SDOptimizer(lambda count: 1e-4, weight_decay=1e-2)
    if name == "adafactor":
        return Adafactor(1e-4)
    raise ValueError(f"unknown optimizer {name!r}")


def bench_distill_train(batch_size: int = 8, image_size: int = 256,
                        repeats: int = 2, chain: int = 3,
                        optimizer: str = "adamw",
                        student_steps: int = 20,
                        device: torch.device | str = "cuda") -> dict:
    """Distill-phase training throughput at full SD size (bench.py:455-572):
    one step is the teacher's two CFG substeps (2 forwards at 2× batch,
    guidance folded) + the student's forward/backward + the optimizer
    over every UNet parameter, train/distill.py::make_distill_step over
    make_applies as polyp-distill-sd-torch drives it for the 40 → 20
    phase. Distillation trains all 860M parameters: on
    `torch.OutOfMemoryError` (and only that) the bench empties the
    allocator's cache and falls back adamw → adafactor (factored second
    moment) → half batch → quarter batch, reporting what fit and the
    attempts that did not (`fallbacks`)."""
    from polyp_tpu_torch.train import distill as td
    from polyp_tpu_torch.utils.rng import stream_generator

    unet, ctx_dim = sd_unet(device)
    latent = image_size // 8
    cond = _embedding(_seeded(device, 1), ctx_dim, torch.bfloat16)
    uncond = _embedding(_seeded(device, 2), ctx_dim, torch.bfloat16)
    schedule = _schedule()
    grid = td.distill_grid(schedule, student_steps)
    applies = td.make_applies(unet, GUIDANCE, cond, uncond)
    teacher = {k: p.detach() for k, p in unet.named_parameters()}

    def attempt(opt_name: str, bs: int) -> dict:
        # the student holds its own fp32 copy of the teacher's weights
        state = td.init_distill_state(teacher,
                                      make_distill_optimizer(opt_name))
        step = td.make_distill_step(applies.student, applies.teacher,
                                    schedule, schedule, grid)
        x0 = torch.randn((bs, 4, latent, latent),
                         generator=_seeded(device, 3), device=device)

        def run_chain(tag: str) -> None:
            losses = []
            for i in range(chain):
                draws = td.DistillDraws(stream_generator(
                    0, "bench_distill", tag, i, device=device))
                losses.append(step(state, teacher, x0, draws)[1])
            _fetch_total(losses, "distill")

        compile_s, sec = _chain_rate(run_chain, chain, repeats)
        return {"distill_train_images_per_sec": bs / sec,
                "sec_per_step": sec, "batch": bs, "optimizer": opt_name,
                "compile_sec": compile_s,
                # the product decision the number prices: a 2,000-step
                # halving phase (polyp-distill-sd-torch's default)
                "minutes_per_2000step_phase": round(2000 * sec / 60, 1)}

    attempts: list[dict] = []
    for opt_name, bs in [(optimizer, batch_size),
                         ("adafactor", batch_size),
                         ("adafactor", max(batch_size // 2, 1)),
                         ("adafactor", max(batch_size // 4, 1))]:
        if (opt_name, bs) in [(a["optimizer"], a["batch"])
                              for a in attempts]:
            continue
        try:
            out = attempt(opt_name, bs)
        except torch.OutOfMemoryError:
            attempts.append({"optimizer": opt_name, "batch": bs})
        else:
            out["fallbacks"] = [f"{a['optimizer']}@{a['batch']}: OOM"
                                for a in attempts]
            return out
        # the failed attempt's tensors are free once its frame is gone
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    raise RuntimeError(f"distill step OOM at every config: {attempts}")


# ---------------------------------------------------------------------------
# The watchdog and main
# ---------------------------------------------------------------------------

def _arm_watchdog(seconds: int, card: str = "the card"):
    """A daemon thread that, once `seconds` pass without main() finishing,
    prints a parseable JSON line and exits 2: the partial result with a
    `watchdog_error` field when a phase was already measured, else an
    error line. The deadline covers every phase (headline, companions,
    training). Returns (disarm_event, partial): set() the event when done;
    keep `partial["out"]` at the best output so far."""
    done = threading.Event()
    partial: dict = {"out": None}

    def fire():
        if not done.wait(seconds):
            err = (f"phase exceeded the {seconds}s watchdog: {card} "
                   "unresponsive (a hung launch or copy); rerun")
            out = partial["out"]
            if out is not None:
                print(json.dumps({**out, "watchdog_error": err}), flush=True)
            else:
                print(json.dumps({"metric": "bench watchdog", "value": None,
                                  "unit": "error", "error": err}),
                      flush=True)
            os._exit(2)

    threading.Thread(target=fire, daemon=True).start()
    return done, partial


def _error(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"[:200]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="polyp-bench-torch", description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--sampler", default="ddim")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--train-diffusion", action="store_true")
    parser.add_argument("--quantize", default=None,
                        choices=["w8a8", "w8a8_static", "promoted"],
                        help="W8A8 UNet sampling (ops/quant.py); default "
                             "off. 'promoted' = the gate-passing config "
                             "(ops/quant_gate.json), distilled-aware, as "
                             "on every other CLI surface")
    parser.add_argument("--quant-fp-head", type=int, default=0,
                        help="with --quantize: the FIRST N sampling steps in "
                             "full precision (hybrid-precision trajectory)")
    parser.add_argument("--quant-fp-tail", type=int, default=0,
                        help="with --quantize: the final N sampling steps in "
                             "full precision (hybrid-precision trajectory)")
    parser.add_argument("--distilled", type=int, default=0, metavar="STEPS",
                        help="standalone distilled-student bench: "
                             "folded-guidance (cond-only, 1x batch) "
                             "STEPS-step trailing DDIM + VAE decode "
                             "(bench_distilled; composes with --quantize)")
    parser.add_argument("--quantize-vae", action="store_true",
                        help="with --distilled: w8a8 the VAE decoder too "
                             "(the few-step Amdahl term; reports the int8 "
                             "decode's fidelity as vae_q_rel_l2)")
    parser.add_argument("--tiny-decoder", action="store_true",
                        help="with --distilled: decode through the "
                             "distilled TinyDecoder "
                             "(models/tiny_decoder.py); its meta's rel_l2 "
                             "rides on the line")
    parser.add_argument("--tiny-decoder-dir", default=None,
                        help="a polyp-distill-vae-torch output dir; "
                             "default: the port's shipped weights")
    parser.add_argument("--watchdog", type=int, default=3600,
                        help="fail loudly if the run has not finished "
                             "within N seconds total (0 disables)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the benches run on the card "
                             "unless given a CPU")
    return parser


def _distilled_main(args, card: str, watchdog) -> int:
    # refuse silently-ignored flag combinations loudly: the few-step
    # folded bench has no hybrid-precision split, and the train benches
    # live on the default run
    if args.quant_fp_head or args.quant_fp_tail:
        raise SystemExit("--distilled does not support --quant-fp-head/"
                         "--quant-fp-tail (few-step folded sampling has "
                         "no hybrid-precision split; the measured "
                         "distilled verdict is pure w8a8_static)")
    if args.train or args.train_diffusion:
        raise SystemExit("--distilled is a standalone bench; run "
                         "--train/--train-diffusion without it")
    if args.tiny_decoder and args.quantize_vae:
        raise SystemExit("--tiny-decoder and --quantize-vae are "
                         "alternative decode levers; pick one")
    d = bench_distilled(args.batch, args.image_size, args.distilled,
                        args.quick, quantize=args.quantize,
                        quantize_vae=args.quantize_vae,
                        tiny_decoder=args.tiny_decoder,
                        tiny_decoder_dir=args.tiny_decoder_dir,
                        device=args.device)
    out = {
        "metric": f"{args.image_size}px distilled samples/sec/chip "
                  f"({args.distilled}-step folded-CFG DDIM"
                  + (f", {args.quantize}" if args.quantize else "")
                  + (", w8a8-vae" if args.quantize_vae else "")
                  + (", tiny-decoder" if args.tiny_decoder else "") + ")",
        "value": round(d["samples_per_sec"], 4),
        "unit": "samples/sec/chip",
        "vs_baseline": round(d["samples_per_sec"]
                             / REFERENCE_CPU_SAMPLES_PER_SEC, 2),
        "baseline_threads": REFERENCE_CPU_THREADS,
        "distilled_steps": d["steps"],
        "unet_scan_sec": round(d["unet_scan_sec"], 4),
        "vae_decode_sec": round(d["vae_decode_sec"], 4),
        "vae_share": round(d["vae_share"], 4),
    }
    for key in ("vae_q_rel_l2", "quant_rel_l2", "tiny_rel_l2"):
        if key in d:
            out[key] = round(d[key], 4)
    out["card"] = card
    if watchdog is not None:
        watchdog.set()
    print(json.dumps(out), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    """The bench's CLI; returns the exit code (1 when a companion failed
    after the headline was measured)."""
    from polyp_tpu_torch.ops.quant import (promoted_config,
                                           resolve_quantize_arg)

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.quantize == "promoted":
        # distilled-aware, as every other surface: --distilled resolves to
        # the few-step verdict, the full trajectory to its fp-head hybrid
        # (exits, naming the gate file, when the verdict is demoted)
        args.quantize, args.quant_fp_head, args.quant_fp_tail = (
            resolve_quantize_arg("promoted", args.quant_fp_head,
                                 args.quant_fp_tail,
                                 distilled=bool(args.distilled)))
    card = card_name(args.device)
    if args.watchdog:
        watchdog, partial = _arm_watchdog(args.watchdog, card)
    else:
        watchdog, partial = None, {"out": None}
    if args.distilled:
        return _distilled_main(args, card, watchdog)

    def line(value: float, metric: str) -> dict:
        return {
            "metric": metric,
            "value": round(value, 4),
            "unit": "samples/sec/chip",
            "vs_baseline": round(value / REFERENCE_CPU_SAMPLES_PER_SEC, 2),
            "baseline_threads": REFERENCE_CPU_THREADS,
            f"vs_baseline_{REFERENCE_NORMALIZED_CORES}core_bound": round(
                value / (REFERENCE_CPU_SAMPLES_PER_SEC
                         * REFERENCE_NORMALIZED_CORES
                         / REFERENCE_CPU_THREADS), 2),
            "card": card,
        }

    dev = args.device
    companions_ok = True
    promo = (promoted_config()
             if args.quantize is None and not args.quick else None)
    if promo is not None:
        # headline = the gate-passing quant config; bf16 at the requested
        # batch rides as the companion. The verdict's measured batch
        # applies only to the default batch: an explicit --batch wins.
        default_batch = parser.get_default("batch")
        promo_batch = (int(promo.get("batch", args.batch))
                       if args.batch == default_batch else args.batch)
        q = bench_sampling(promo_batch, args.image_size, args.steps,
                           args.sampler, args.quick, quantize=promo["mode"],
                           quant_fp_head=int(promo.get("quant_fp_head", 0)),
                           quant_fp_tail=int(promo.get("quant_fp_tail", 0)),
                           device=dev)
        ptail = (f"+fp_head{promo['quant_fp_head']}"
                 if promo.get("quant_fp_head") else "")
        out = line(q["samples_per_sec"],
                   f"{args.image_size}px diffusion samples/sec/chip "
                   f"({args.steps}-step {args.sampler.upper()}, "
                   f"{promo['mode']}{ptail} — gate-passing, "
                   f"rel_l2 {promo.get('rel_l2_25step')})")
        out["quant_batch"] = q["batch_size"]
        partial["out"] = dict(out)
        try:
            b = bench_sampling(args.batch, args.image_size, args.steps,
                               args.sampler, args.quick, device=dev)
            out["bf16_value"] = round(b["samples_per_sec"], 4)
            out["bf16_batch"] = b["batch_size"]
        except Exception as e:  # keep the headline, exit 1 at the end
            out["bf16_error"] = _error(e)
            companions_ok = False
        partial["out"] = dict(out)
    else:
        result = bench_sampling(args.batch, args.image_size, args.steps,
                                args.sampler, args.quick,
                                quantize=args.quantize,
                                quant_fp_head=args.quant_fp_head,
                                quant_fp_tail=args.quant_fp_tail,
                                device=dev)
        tail = ""
        if args.quantize and args.quant_fp_head:
            tail += f"+fp_head{args.quant_fp_head}"
        if args.quantize and args.quant_fp_tail:
            tail += f"+fp_tail{args.quant_fp_tail}"
        out = line(result["samples_per_sec"],
                   f"{args.image_size}px diffusion samples/sec/chip "
                   f"({args.steps}-step {args.sampler.upper()}"
                   + (f", {args.quantize}{tail}" if args.quantize else "")
                   + ")")
        partial["out"] = dict(out)  # headline measured: a hang keeps it
        if args.quantize is None and not args.quick:
            # no gate-passing config: bf16 is the headline and the best
            # opt-in int8 config (batch 16) rides as the companion
            try:
                q = bench_sampling(max(args.batch, 16), args.image_size,
                                   args.steps, args.sampler, args.quick,
                                   quantize="w8a8_static", device=dev)
                out["w8a8_static_value"] = round(q["samples_per_sec"], 4)
                out["w8a8_batch"] = q["batch_size"]
            except Exception as e:
                out["w8a8_static_error"] = _error(e)
                companions_ok = False
            partial["out"] = dict(out)
    if args.quantize is None and not args.quick:
        # the distilled-student companions at their measured batch optima
        # (8 steps × 16, 4 × 32), running the distilled verdict's int8
        # mode when the gate passes it; a malformed gate file raises
        dq = promoted_config(distilled=True)
        mode = dq["mode"] if dq else None
        try:
            d8 = bench_distilled(16, args.image_size, 8, args.quick,
                                 quantize=mode, device=dev)
            out["distilled_value"] = round(d8["samples_per_sec"], 4)
            out["distilled_steps"] = 8
            out["distilled_batch"] = d8["batch_size"]
            out["distilled_vae_share"] = round(d8["vae_share"], 4)
            if mode:
                out["distilled_quantize"] = mode
                out["distilled_quant_rel_l2"] = round(d8["quant_rel_l2"], 4)
            d4 = bench_distilled(32, args.image_size, 4, args.quick,
                                 quantize=mode, device=dev)
            out["distilled_4step_value"] = round(d4["samples_per_sec"], 4)
            out["distilled_4step_batch"] = d4["batch_size"]
            out["distilled_4step_vae_share"] = round(d4["vae_share"], 4)
            if mode:
                out["distilled_4step_quant_rel_l2"] = round(
                    d4["quant_rel_l2"], 4)
        except Exception as e:
            out["distilled_error"] = _error(e)
            companions_ok = False
        partial["out"] = dict(out)
        # the tiny-decoder companions: the same operating points with the
        # VAE decode swapped for the distilled TinyDecoder
        try:
            dt8 = bench_distilled(16, args.image_size, 8, args.quick,
                                  quantize=mode, tiny_decoder=True,
                                  tiny_decoder_dir=None, device=dev)
            out["distilled_tinydec_value"] = round(dt8["samples_per_sec"], 4)
            out["distilled_tinydec_vae_share"] = round(dt8["vae_share"], 4)
            dt4 = bench_distilled(32, args.image_size, 4, args.quick,
                                  quantize=mode, tiny_decoder=True,
                                  tiny_decoder_dir=None, device=dev)
            out["distilled_4step_tinydec_value"] = round(
                dt4["samples_per_sec"], 4)
            out["distilled_4step_tinydec_vae_share"] = round(
                dt4["vae_share"], 4)
            if "tiny_rel_l2" in dt4:
                out["tinydec_rel_l2"] = round(dt4["tiny_rel_l2"], 4)
        except Exception as e:
            out["tinydec_error"] = _error(e)
            companions_ok = False
        partial["out"] = dict(out)
    if args.train:
        out["classifier_train_images_per_sec"] = round(
            bench_classifier_train(device=dev)["train_images_per_sec"], 2)
        partial["out"] = dict(out)
    if args.train_diffusion:
        out["sd_lora_train_images_per_sec"] = round(bench_sd_lora_train(
            device=dev)["sd_lora_train_images_per_sec"], 2)
    if watchdog is not None:
        watchdog.set()
    print(json.dumps(out), flush=True)
    return 0 if companions_ok else 1


if __name__ == "__main__":
    sys.exit(main())
