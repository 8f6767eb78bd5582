"""Kernel-family census of the SD UNet step on the card: the twin of
tools/profile_census.py. Traces a chained UNet loop (the SD-v1-4 UNet at
its published widths, random weights from seed 0; batch 16, 32×32
latents, as the CFG batch of 8 images at 256 px) with torch.profiler
(utils/profiling.py::trace), then buckets the trace's device time by
kernel family.

    python -m polyp_tpu_torch.tools.profile_census [--mode bf16|w8a8_static]
        [--iters 10] [--out report.json]

`summarize(trace)` reads a Chrome trace (a path, `.json` or `.json.gz`, or
the loaded dict) and sums the duration of its device events (kernels,
memcpy, memset) by family, each event in the first family that names it:
the port's kernels by name (`PORTED_FAMILIES`), then layout copies
(cuDNN's NCHW↔NHWC transposes among them), cuDNN convolutions, cuBLAS /
CUTLASS GEMMs, reductions, elementwise kernels and memcpy / memset
(`LIBRARY_FAMILIES`); anything else is "other". It returns and prints the
totals and the top kernels by name.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

# the port's kernels (csrc/), by the names their launches carry; the GEMM
# core's instantiations are told apart by their policy names
PORTED_FAMILIES = {
    "flash_attention": ("flash_fwd",),
    "fused_mha": ("fused_mha", "kv_project"),
    "int8_geglu_pt": ("GegluQ8Pt",),
    "int8_geglu": ("GegluQ8",),
    "bf16_geglu": ("GegluUp<", "GegluDown<"),
    "w8a8_dense": ("Dense<",),
    "group_norm": ("group_norm",),
}
# everything else the card runs, by library and kind; the layout copies
# first, since cuDNN's own NCHW↔NHWC transposes carry its namespace
LIBRARY_FAMILIES = {
    "layout_copy": ("nchwToNhwc", "nhwcToNchw", "copy", "Copy", "transpose",
                    "Transpose", "CatArray", "index", "gather", "permute"),
    "cudnn_conv": ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm",
                   "cudnn"),
    "cublas_gemm": ("gemm", "Gemm", "nvjet", "cublas", "cutlass",
                    "sm90_xmma", "ampere_", "Kernel2"),
    "reduction": ("reduce", "Reduce", "softmax", "Softmax", "norm", "Norm"),
    "elementwise": ("elementwise", "Elementwise", "vectorized", "unrolled",
                    "pointwise"),
}
DEVICE_CATEGORIES = {"kernel": None, "gpu_memcpy": "memcpy",
                     "gpu_memset": "memcpy"}


def family(name: str, category: str = "kernel") -> str:
    """The family of a device event (first match wins)."""
    fixed = DEVICE_CATEGORIES.get(category)
    if fixed is not None:
        return fixed
    for table in (PORTED_FAMILIES, LIBRARY_FAMILIES):
        for fam, keys in table.items():
            if any(k in name for k in keys):
                return fam
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy"
    return "other"


def _load(trace) -> dict:
    if isinstance(trace, dict):
        return trace
    path = Path(trace)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize(trace, top: int = 20, quiet: bool = False) -> dict:
    """Device time of a Chrome trace by family: {"total_ms", "events",
    "families": {family: [ms, events]}, "top": [[name, ms, events]]}."""
    events = _load(trace).get("traceEvents", [])
    fam_ms: collections.Counter = collections.Counter()
    fam_n: collections.Counter = collections.Counter()
    name_ms: collections.Counter = collections.Counter()
    name_n: collections.Counter = collections.Counter()
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE_CATEGORIES:
            continue
        ms = float(e.get("dur", 0.0)) / 1e3
        name = e.get("name", "")
        fam = family(name, cat)
        fam_ms[fam] += ms
        fam_n[fam] += 1
        name_ms[name] += ms
        name_n[name] += 1
    total = sum(fam_ms.values())
    report = {"total_ms": total, "events": sum(fam_n.values()),
              "families": {f: [fam_ms[f], fam_n[f]]
                           for f, _ in fam_ms.most_common()},
              "top": [[n[:90], ms, name_n[n]]
                      for n, ms in name_ms.most_common(top)]}
    if not quiet:
        print(f"total device time: {total:.3f} ms over "
              f"{report['events']} events")
        for f, (ms, n) in report["families"].items():
            share = 100 * ms / total if total else 0.0
            print(f"  {f:16s} {ms:10.3f} ms  {share:5.1f}%  ({n} events)")
        print("top kernels:")
        for n, ms, k in report["top"]:
            print(f"  {ms:10.3f} ms  ({k:4d})  {n}")
    return report


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(0)


def sd_unet(device) -> torch.nn.Module:
    """The SD-v1-4 UNet in bf16 on `device`, seeded random weights."""
    from polyp_tpu_torch.cli.common import init_weights_
    from polyp_tpu_torch.models import sd14_unet

    unet = sd14_unet(dtype=torch.bfloat16, device="meta").to_empty(
        device=device)
    init_weights_(unet, torch.Generator(device).manual_seed(0))
    return unet.eval()


def static_scales(unet, latent: int, ctx: torch.Tensor) -> dict:
    """w8a8_static's calibrated scales for `unet` on a CFG trajectory of
    `ctx` (diffusion/calibrate.py)."""
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.diffusion.calibrate import ensure_scales

    sched = DiffusionSchedule.create(1000, "scaled_linear", 0.00085, 0.012)
    return ensure_scales(unet, sched, (2, 4, latent, latent), ctx[:1],
                         torch.zeros_like(ctx[:1]),
                         fingerprint_extras=(latent * 8, 1000, "census"))[0]


@torch.no_grad()
def census(mode: str = "bf16", batch: int = 16, latent: int = 32,
           iters: int = 10, logdir: str | None = None, top: int = 20
           ) -> dict:
    """Trace `iters` chained UNet forwards at (batch, 4, latent, latent)
    in `mode` ("bf16" or "w8a8_static") and summarize the trace."""
    from polyp_tpu_torch.ops import quant
    from polyp_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    unet = sd_unet(dev)
    gen = torch.Generator(dev).manual_seed(1)
    lat = torch.randn((batch, 4, latent, latent), generator=gen, device=dev)
    ctx = torch.randn((batch, 77, 768), generator=gen,
                      device=dev).to(torch.bfloat16)
    t = torch.full((batch,), 500, device=dev)
    qmode = None if mode == "bf16" else mode
    bank = quant.ScaleBank(static_scales(unet, latent, ctx)) \
        if qmode == "w8a8_static" else None

    def chain(h):
        for _ in range(iters):
            with quant.override(qmode, scales=bank, t=t):
                eps = unet(h, t, ctx)
            h = h * 0.98 + eps.float() * 0.01
        return h

    chain(lat)  # warm-up: cuDNN plans, kernel loads
    torch.cuda.synchronize()
    logdir = logdir or tempfile.mkdtemp(prefix="polyp-census-")
    with trace(logdir):
        start = time.perf_counter()
        chain(lat + 1e-3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    report = summarize(Path(logdir) / "trace.json", top=top)
    report.update(mode=mode, batch=batch, latent=latent, iters=iters,
                  host_ms_per_step=wall / iters * 1e3,
                  device_ms_per_step=report["total_ms"] / iters,
                  card=card())
    print(f"mode={mode}  UNet step at batch {batch}: "
          f"{report['device_ms_per_step']:.3f} ms device, "
          f"{report['host_ms_per_step']:.3f} ms host (traced)")
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=["bf16", "w8a8_static"],
                        default="bf16")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--latent", type=int, default=32)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--logdir", type=str, default=None)
    parser.add_argument("--out", type=str, default=None,
                        help="write the JSON report here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the census traces the card and no card is present")
    with tempfile.TemporaryDirectory(prefix="polyp-census-cache-") as cache:
        os.environ.setdefault("POLYP_TORCH_QUANT_CACHE", cache)
        report = census(args.mode, args.batch, args.latent, args.iters,
                        args.logdir, args.top)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
