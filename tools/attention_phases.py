#!/usr/bin/env python3
"""Where the fused MHA kernel's time goes, phase by phase, on a CUDA card.

    python3 tools/attention_phases.py      # from the repository root

Builds the kernel library of polyp_tpu_torch/csrc/ as it is ("full") and in
copies with one phase of csrc/fused_mha.cu's block kernel cut out
("no_q_projection", "no_attention", "no_out_projection"; the outputs of a
cut copy are wrong and only its time is read), each into its own directory
under build/attention_phases/. For each it times, with CUDA events (mean of
20 calls after 3), the fused MHA entry point at x [B, 1024, C] for the
distilled batches 16 and 32, the CFG batch 4 and the 512px level-1 shape
(C = 640, 8 x 80), and the flash kernel at [N, 1024, 8, 40]; and, from
torch.profiler, the device time of the K/V projection launch and of the
block kernel apart. A phase's cost is full minus the copy without it (the
phases overlap across blocks, so the costs need not add up to the whole).
Prints one line per measurement and writes chiprun_out/attention_phases.json
with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from polyp_tpu_torch import _build  # noqa: E402

# (name, [(text in csrc/fused_mha.cu, its replacement)])
CUTS = {
    "full": [],
    "no_q_projection": [("const int n_c = (C + kChunk - 1) / kChunk;",
                         "const int n_c = 0 * C;")],
    "no_attention": [("const int n_k = (Tk + kKeys - 1) / kKeys;",
                      "const int n_k = 0 * Tk;")],
    "no_out_projection": [
        ("for (int n0 = c_begin; n0 < c_end; n0 += wo_rows) {",
         "for (int n0 = c_begin; n0 < 0 * c_end; n0 += wo_rows) {")],
}
KERNEL = re.compile(r"kv_project_kernel|fused_mha_kernel")
MHA_SHAPES = ((16, 320, 40), (32, 320, 40), (4, 320, 40), (4, 640, 80))


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


def build_copy(name: str, cuts) -> ctypes.CDLL:
    root = ROOT / "build" / "attention_phases" / name
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for src in _build.CSRC.iterdir():
        text = src.read_text()
        if src.name == "fused_mha.cu":
            for old, new in cuts:
                if old not in text:
                    raise SystemExit(f"{name}: {old!r} is not in fused_mha.cu")
                text = text.replace(old, new)
        (root / "csrc" / src.name).write_text(text)
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "out"
    try:
        lib = ctypes.CDLL(str(_build.build()))
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    for fn in ("polyp_fused_mha", "polyp_flash_attention_fwd"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_phases: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    results = {"card": card, "phases": {}}
    for name, cuts in CUTS.items():
        lib = build_copy(name, cuts)
        rows = results["phases"][name] = {}
        for b, c, d in MHA_SHAPES:
            h, t = 8, 1024
            x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
            w = [(torch.randn(*s, generator=g, device=dev) * s[1] ** -0.5)
                 .bfloat16() for s in ((h * d, c),) * 3 + ((c, h * d),)]
            k_ws = torch.empty(b, t, h * d, dtype=torch.bfloat16, device=dev)
            v_ws = torch.empty_like(k_ws)
            out = torch.empty(b, t, c, dtype=torch.bfloat16, device=dev)

            def run():
                err = lib.polyp_fused_mha(
                    x.data_ptr(), x.data_ptr(), *(u.data_ptr() for u in w),
                    k_ws.data_ptr(), v_ws.data_ptr(), out.data_ptr(), b, t,
                    t, c, c, h, d, c, 1 / math.sqrt(d), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            ms = time_ms(run)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            split = {KERNEL.search(e.key).group(0):
                     getattr(e, "self_device_time_total", 0) / e.count / 1e3
                     for e in prof.key_averages()
                     if getattr(e, "device_type", None) == DeviceType.CUDA
                     and KERNEL.search(e.key)}
            key = f"fused_mha x[{b},1024,{c}] 8x{d}"
            rows[key] = {"ms": ms, "kernels_ms": split}
            print(f"[phase] {name} {key}: {ms:.4f} ms; "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()),
                  flush=True)
        if name != "full":
            continue
        for n in (4, 16, 32):
            q, k, v = (torch.randn(n, 1024, 8, 40, generator=g, device=dev)
                       .bfloat16() for _ in range(3))
            o = torch.empty_like(q)
            ms = time_ms(lambda: lib.polyp_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), n, 8,
                1024, 1024, 40, 1 / math.sqrt(40), stream))
            rows[f"flash [{n},1024,8,40]"] = {"ms": ms}
            print(f"[phase] full flash [{n},1024,8,40]: {ms:.4f} ms",
                  flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "attention_phases.json").write_text(
        json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
