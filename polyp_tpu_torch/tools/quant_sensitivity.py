"""Per-layer-family W8A8 sensitivity sweep and the quant gate's
measurements on the port: the twin of tools/quant_sensitivity.py.

For the fixed-seed SD sampling workload (DDIM, CFG 7.5, the scaled_linear
schedule, random weights from `seed`) it measures the image-space damage
each quantized layer family causes alone (`quant.override(...,
only=...)`), full quantization with the worst k families excluded
(`skip=...`), the calibrated static mode (8 calibration points), and the
hybrid-precision splits (`run_split_sweep`: the first or last N steps in
bf16). The gate's quality half is GATE_REL_L2: fixed-seed image rel-L2
against the bf16 images below it. Its throughput half, which this port
adds: every aggregate configuration's samples/s beside bf16's, taken in
the same call as the median of TIMED_RUNS timed runs after a warm-up run
(whose images give the rel-L2), the configurations called in turn within
each round, because host-clock rates move between calls.

    python -m polyp_tpu_torch.tools.quant_sensitivity [--quick] [--batch 4]
        [--steps 25] [--image-size 256] [--forward-only]
        [--fp-split 1,2,3,5,8 [--mode w8a8_static]] [--device cuda]
    # the promoted entry of ops/quant_gate.json from two split sweeps:
    python -m polyp_tpu_torch.tools.quant_sensitivity \\
        --verdict SPLITS_25.json SPLITS_50.json

Prints one JSON report (`--out` also writes it to a file). Runs on the
card unless given `--device cpu`.

Layer families are the reference's path substrings. The port's module
paths are state-dict names ("...ff.net.0.proj" where the reference has
".../ff_net_0_proj"), so `port_patterns` translates the two families whose
names differ; every other family is a substring of the port's names as it
is.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path
from typing import Callable

import numpy as np
import torch

# layer families addressable by path substring (the reference's names)
FAMILIES = ("conv1", "conv2", "conv_shortcut", "proj_in", "proj_out",
            "to_q", "to_k", "to_v", "to_out",
            "ff_net_0_proj", "ff_net_2", "downsample", "upsample")
# the port's module names of the families whose names differ
PORT_FAMILY = {"ff_net_0_proj": "ff.net.0.proj", "ff_net_2": "ff.net.2"}

# go/no-go: fixed-seed image rel L2 vs bf16 must beat this for a quant mode
# to be promotable beyond opt-in
GATE_REL_L2 = 0.05
GUIDANCE_SCALE = 7.5
CALIBRATION_POINTS = 8
TIMED_RUNS = 3


def port_patterns(families) -> tuple[str, ...] | None:
    """The port's path substrings of the reference's family names."""
    if families is None:
        return None
    return tuple(PORT_FAMILY.get(f, f) for f in families)


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None
    where there is no card."""
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def median_rates(runs: dict[str, Callable[[], torch.Tensor]], batch: int,
                 timed_runs: int = TIMED_RUNS
                 ) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
    """({name: the warm-up run's output}, {name: samples/s}): one warm-up
    call of each run, then `timed_runs` rounds calling each in turn, each
    call bracketed by utils/profiling.Throughput with a sync; samples/s is
    the median over the rounds."""
    from polyp_tpu_torch.utils.profiling import Throughput

    outputs = {}
    for name, fn in runs.items():
        outputs[name] = fn()
        Throughput.sync(outputs[name])
    rates: dict[str, list[float]] = {name: [] for name in runs}
    for _ in range(timed_runs):
        for name, fn in runs.items():
            tp = Throughput()
            with tp.measure(batch):
                tp.sync(fn())
            rates[name].append(tp.samples_per_sec)
    return outputs, {k: statistics.median(v) for k, v in rates.items()}


def _sweep_context(batch: int, image_size: int, steps: int, quick: bool,
                   seed: int, device: str | torch.device = "cuda", *,
                   stack=None, cond: torch.Tensor | None = None,
                   init: torch.Tensor | None = None) -> dict:
    """Shared sweep plumbing: the SD stack in bf16 (random weights from
    `seed`, or `stack`'s modules), a random cond embedding and zero
    uncond, the initial latents, the fixed-seed bf16 reference images,
    and `generate(mode, ...)` / `images(mode, ...)` / `rel_l2(img)`
    closures. `cond` ([1, 77, D]) and `init` ([batch, 4, s/8, s/8]) replace
    the ones drawn from `seed` and `seed + 1`."""
    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.diffusion import DiffusionSchedule, sample, with_cfg
    from polyp_tpu_torch.models.vae import SD_VAE_SCALING
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.pipeline import _precision_segments

    if stack is None:
        stack = load_sd_stack(None, torch.bfloat16, tiny=quick,
                              device=device, seed=seed)
    unet, vae = stack.unet, stack.vae
    dev = next(unet.parameters()).device
    dtype = next(unet.parameters()).dtype
    # the cross-attention width (768 for SD-v1-4, 32 for the tiny stack)
    ctx_dim = next(m.in_features for n, m in unet.named_modules()
                   if n.endswith("attn2.to_k"))
    latent = image_size // 8
    if cond is None:
        cond = torch.randn((1, 77, ctx_dim), device=dev,
                           generator=torch.Generator(dev).manual_seed(seed))
    cond = cond.to(dev, dtype)
    uncond = torch.zeros_like(cond)
    if init is None:
        init = torch.randn((batch, 4, latent, latent), device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               seed + 1))
    init = init.to(dev, torch.float32)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085, 0.012)

    def make_generate(mode, scales=None, skip=(), only=None, split=None):
        bank = None if scales is None else quant.ScaleBank(scales)
        skip, only = port_patterns(skip), port_patterns(only)

        def guided(m):
            def raw(z, tt, emb):
                with quant.override(m, scales=bank, skip=skip, only=only,
                                    t=tt):
                    return unet(z, tt, emb)
            return with_cfg(raw, cond, uncond, GUIDANCE_SCALE)

        model_fn = guided(mode)
        if split is not None:
            # hybrid-precision trajectory (pipeline._precision_split)
            model_fn = _precision_segments(model_fn, guided(None), steps,
                                           split)

        @torch.no_grad()
        def generate() -> torch.Tensor:
            latents = sample("ddim", model_fn, schedule,
                             (batch, 4, latent, latent), None, steps,
                             init=init)
            return vae.decode(latents.to(dtype) / SD_VAE_SCALING)
        return generate

    def images(mode, **kw) -> np.ndarray:
        return make_generate(mode, **kw)().float().cpu().numpy()

    ref = images(None)

    def rel_l2(img) -> float:
        img = np.asarray(img.float().cpu() if torch.is_tensor(img) else img,
                         np.float32)
        return float(np.linalg.norm(img - ref) / np.linalg.norm(ref))

    return {"stack": stack, "unet": unet, "vae": vae, "cond": cond,
            "uncond": uncond, "init": init, "schedule": schedule,
            "latent": latent, "dtype": dtype, "device": dev, "ref": ref,
            "make_generate": make_generate, "images": images,
            "rel_l2": rel_l2}


def _calibrate(ctx: dict) -> dict:
    from polyp_tpu_torch.diffusion.calibrate import calibrate_unet_scales

    latent = ctx["latent"]
    return calibrate_unet_scales(
        ctx["unet"], ctx["schedule"], (2, 4, latent, latent), ctx["cond"],
        ctx["uncond"], num_steps=CALIBRATION_POINTS,
        guidance_scale=GUIDANCE_SCALE)


def run_sweep(batch: int = 4, image_size: int = 256, steps: int = 25,
              quick: bool = False, seed: int = 0,
              forward_only: bool = False, device: str = "cuda",
              ctx: dict | None = None,
              timed_runs: int = TIMED_RUNS) -> dict:
    """The family sweep (reference `run_sweep`). `forward_only=True`
    scores each family by the rel-L2 of ONE UNet forward (a noisy latent at
    t = 500) instead of a full sampling run; full-trajectory deltas are
    still measured for the aggregate configurations (full w8a8, skip-worst-k,
    static), each with its samples/s beside bf16's (`samples_per_sec`).
    `ctx`: a `_sweep_context` to reuse."""
    from polyp_tpu_torch.ops import quant

    ctx = ctx or _sweep_context(batch, image_size, steps, quick, seed, device)
    unet, latent, dtype, dev = (ctx["unet"], ctx["latent"], ctx["dtype"],
                                ctx["device"])
    make_generate, rel_l2 = ctx["make_generate"], ctx["rel_l2"]

    report: dict = {"gate_rel_l2": GATE_REL_L2, "batch": batch,
                    "steps": steps, "image_size": image_size,
                    "quick": quick, "forward_only": forward_only,
                    "card": card_line()}

    per_family = {}
    if forward_only:
        gen = torch.Generator(dev).manual_seed(seed + 2)
        x_mid = torch.randn((batch, 4, latent, latent), device=dev,
                            generator=gen).to(dtype)
        t_mid = torch.full((batch,), 500, device=dev, dtype=torch.long)
        ctx_mid = ctx["cond"].expand(batch, *ctx["cond"].shape[-2:])

        @torch.no_grad()
        def fwd(mode, **kw):
            with quant.override(mode, **kw):
                return unet(x_mid, t_mid, ctx_mid).float().cpu().numpy()

        fref = fwd(None)
        for fam in FAMILIES:
            out = fwd("w8a8", only=port_patterns((fam,)))
            per_family[fam] = float(np.linalg.norm(out - fref)
                                    / np.linalg.norm(fref))
            print(f"# only={fam}: fwd rel_l2={per_family[fam]:.4f}",
                  flush=True)
    else:
        for fam in FAMILIES:
            per_family[fam] = rel_l2(ctx["images"]("w8a8", only=(fam,)))
            print(f"# only={fam}: rel_l2={per_family[fam]:.4f}", flush=True)
    report["per_family_rel_l2"] = dict(
        sorted(per_family.items(), key=lambda kv: -kv[1]))
    worst = list(report["per_family_rel_l2"])

    scales = _calibrate(ctx)
    report["n_calibrated_layers"] = len(scales)
    runs = {"bf16": make_generate(None), "full_w8a8": make_generate("w8a8")}
    for k in (1,) if forward_only else (1, 2, 3):
        runs[f"w8a8_skip_worst{k}"] = make_generate(
            "w8a8", skip=tuple(worst[:k]))
    runs["w8a8_static"] = make_generate("w8a8_static", scales=scales)
    for k in () if forward_only else (1, 2):
        runs[f"w8a8_static_skip_worst{k}"] = make_generate(
            "w8a8_static", scales=scales, skip=tuple(worst[:k]))
    outputs, rates = median_rates(runs, batch, timed_runs)
    report["samples_per_sec"] = rates

    report["full_w8a8_rel_l2"] = rel_l2(outputs["full_w8a8"])
    report["w8a8_static_rel_l2"] = rel_l2(outputs["w8a8_static"])
    for name in runs:
        if "skip_worst" in name:
            k = int(name[-1])
            report[name] = {"skip": tuple(worst[:k]),
                            "rel_l2": rel_l2(outputs[name])}
    for name in ("full_w8a8", "w8a8_static"):
        report[f"{name}_gate_pass"] = report[f"{name}_rel_l2"] < GATE_REL_L2
        print(f"# {name}: rel_l2={report[f'{name}_rel_l2']:.4f}, "
              f"{rates[name]:.3f} samples/s (bf16 {rates['bf16']:.3f})",
              flush=True)
    return report


def run_split_sweep(batch: int = 4, image_size: int = 256, steps: int = 25,
                    quick: bool = False, seed: int = 0,
                    splits: tuple[int, ...] = (1, 2, 3, 5, 8),
                    mode: str = "w8a8_static", device: str = "cuda",
                    ctx: dict | None = None,
                    timed_runs: int = TIMED_RUNS) -> dict:
    """The hybrid-precision sweep (reference `run_split_sweep`): fixed-seed
    image rel-L2 against bf16 with the first N (fp_head) or last N
    (fp_tail) steps in full precision, for N in `splits` and the pure mode
    ("0"). `gate_pass` keys are the rel-L2 half of the gate, as in the
    reference; beside each rel-L2 stands the configuration's samples/s,
    and `bf16` holds bf16's (its rel-L2 against the reference images is
    that of a second bf16 run: 0 on a deterministic device)."""
    from polyp_tpu_torch.pipeline import _precision_split

    report = {"gate_rel_l2": GATE_REL_L2, "batch": batch, "steps": steps,
              "image_size": image_size, "quick": quick, "mode": mode,
              "card": card_line(), "splits": {}}
    ctx = ctx or _sweep_context(batch, image_size, steps, quick, seed, device)
    scales = _calibrate(ctx) if mode == "w8a8_static" else None

    def configured(fp_head, fp_tail):
        eff_mode, split = _precision_split(steps, mode, fp_head, fp_tail)
        return ctx["make_generate"](eff_mode, scales=scales, split=split)

    runs = {"bf16": ctx["make_generate"](None), "0": configured(0, 0)}
    for n in splits:
        runs[f"head{n}"] = configured(n, 0)
        runs[f"tail{n}"] = configured(0, n)
    outputs, rates = median_rates(runs, batch, timed_runs)
    rel = {name: ctx["rel_l2"](img) for name, img in outputs.items()}

    report["bf16"] = {"rel_l2": rel["bf16"],
                      "samples_per_sec": rates["bf16"]}
    report["splits"]["0"] = {"rel_l2": rel["0"],
                             "gate_pass": rel["0"] < GATE_REL_L2,
                             "samples_per_sec": rates["0"]}
    print(f"# pure {mode}: rel_l2={rel['0']:.4f}, {rates['0']:.3f} "
          f"samples/s (bf16 {rates['bf16']:.3f})", flush=True)
    for n in splits:
        rh, rt = rel[f"head{n}"], rel[f"tail{n}"]
        report["splits"][str(n)] = {
            "head_rel_l2": rh, "head_gate_pass": rh < GATE_REL_L2,
            "head_samples_per_sec": rates[f"head{n}"],
            "tail_rel_l2": rt, "tail_gate_pass": rt < GATE_REL_L2,
            "tail_samples_per_sec": rates[f"tail{n}"]}
        print(f"# fp_head={n}: rel_l2={rh:.4f} "
              f"gate={'PASS' if rh < GATE_REL_L2 else 'fail'} "
              f"{rates[f'head{n}']:.3f} samples/s   fp_tail={n}: "
              f"rel_l2={rt:.4f} {rates[f'tail{n}']:.3f} samples/s",
              flush=True)
    return report


def promoted_entry(reports: list[dict]) -> tuple[dict, dict]:
    """The gate file's `promoted` entry and its `rejected` splits from
    split sweeps of one mode and batch at several step counts: the
    smallest fp_head whose rel-L2 passes at every step count (else the
    split with the smallest worst rel-L2), with each count's rel-L2 and
    samples/s beside bf16's; `gate_pass` follows both halves of the rule
    (ops/quant.py::gate_passes)."""
    from polyp_tpu_torch.ops.quant import gate_passes

    modes = {r["mode"] for r in reports}
    batches = {r["batch"] for r in reports}
    if len(modes) != 1 or len(batches) != 1:
        raise ValueError(f"split sweeps of modes {modes}, batches {batches}")
    heads = sorted(int(n) for n in reports[0]["splits"] if n != "0")

    def numbers(n: int) -> dict:
        out = {}
        for r in reports:
            s, tag = r["splits"][str(n)], f"{r['steps']}step"
            if n == 0:
                out[f"rel_l2_{tag}"] = s["rel_l2"]
                out[f"samples_per_sec_{tag}"] = s["samples_per_sec"]
            else:
                out[f"rel_l2_{tag}"] = s["head_rel_l2"]
                out[f"samples_per_sec_{tag}"] = s["head_samples_per_sec"]
            out[f"bf16_samples_per_sec_{tag}"] = r["bf16"]["samples_per_sec"]
        return out

    def worst_rel(n: int) -> float:
        return max(v for k, v in numbers(n).items() if k.startswith("rel"))

    passing = [n for n in heads if worst_rel(n) < GATE_REL_L2]
    head = passing[0] if passing else min(heads, key=worst_rel)
    entry = {"mode": modes.pop(), "quant_fp_head": head, "quant_fp_tail": 0,
             "batch": batches.pop(), "sampler": "ddim", **numbers(head)}
    entry["gate_pass"] = gate_passes(entry, GATE_REL_L2)
    rejected = {}
    for n in [0] + [h for h in heads if h < head]:
        rejected[f"{entry['mode']}_fp_head{n}"] = dict(
            numbers(n), gate_pass=False)
    return entry, rejected


def write_verdict(report_paths: list[str], gate_path: Path) -> dict:
    """Merge `promoted_entry` of the split reports into the gate file at
    `gate_path` (its other entries kept) and return the file's content."""
    reports = [json.loads(Path(p).read_text()) for p in report_paths]
    entry, rejected = promoted_entry(reports)
    gate = (json.loads(gate_path.read_text()) if gate_path.exists()
            else {"gate_rel_l2": GATE_REL_L2})
    gate["promoted"] = entry
    gate.setdefault("rejected", {}).update(rejected)
    cards = {r.get("card") for r in reports}
    if len(cards) == 1 and None not in cards:
        gate["measured_on"] = dict(gate.get("measured_on", {}),
                                   card=cards.pop())
    gate_path.write_text(json.dumps(gate, indent=2) + "\n")
    return gate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--quick", action="store_true",
                    help="the tiny stack (smoke runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--forward-only", action="store_true",
                    help="score families on one UNet forward instead of a "
                         "full sampling run")
    ap.add_argument("--fp-split", type=str, default=None,
                    help="comma-separated split sizes to sweep instead of "
                         "the family sweep (each N as fp_head=N and "
                         "fp_tail=N), e.g. '1,2,3,5,8'")
    ap.add_argument("--mode", default="w8a8_static",
                    choices=["w8a8", "w8a8_static"],
                    help="quant mode for the --fp-split sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--verdict", nargs="+", default=None, metavar="REPORT",
                    help="write the promoted entry of ops/quant_gate.json "
                         "from these --fp-split reports (no sampling)")
    ap.add_argument("--gate", default=None,
                    help="with --verdict: the gate file to update "
                         "(default: the package's)")
    args = ap.parse_args(argv)
    if args.verdict is not None:
        from polyp_tpu_torch.ops import quant
        gate = write_verdict(args.verdict,
                             Path(args.gate) if args.gate else quant.GATE_PATH)
        print(json.dumps(gate))
        return
    if args.fp_split is not None:
        splits = tuple(int(v) for v in args.fp_split.split(",") if v)
        report = run_split_sweep(args.batch, args.image_size, args.steps,
                                 args.quick, args.seed, splits=splits,
                                 mode=args.mode, device=args.device)
    else:
        report = run_sweep(args.batch, args.image_size, args.steps,
                           args.quick, args.seed,
                           forward_only=args.forward_only,
                           device=args.device)
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
