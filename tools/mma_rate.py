#!/usr/bin/env python3
"""The card's mma.sync rate, as the fp32 flash form and the fp32 GEGLU use
it: m16n8k8 with tf32 operands and fp32 accumulators, beside an FFMA
loop (the CUDA cores' fp32 rate).

    python3 tools/mma_rate.py

Needs a CUDA card and nvcc. Each probe is one kernel in which every warp
issues only that instruction, on ACC independent accumulators (so the pipe,
not one chain's latency, sets the pace), for many iterations, over
enough warps to fill every SM; the rate is the work of all the
instructions over the CUDA-event time of one launch (after a warm-up).
The probe's source is compiled into build/mma_rate/; the results are
printed, one line a probe, and written to chiprun_out/mma_rate.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rate"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int ACC = 8;

__global__ void tf32_probe(float* out, int iters) {
  float c[ACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-6f * (i + 1));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_probe(float* out, int iters) {
  float c[ACC * 4];
  const float a = 1.0f + threadIdx.x * 1e-7f, b = 1e-7f;
  for (int j = 0; j < ACC * 4; ++j) c[j] = j;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC * 4; ++j) c[j] = fmaf(c[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < ACC * 4; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch(int which, float* out, int blocks, int threads, int iters) {
  void (*k)(float*, int) = which == 0 ? tf32_probe : ffma_probe;
  k<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""

# (name, flops an instruction a warp, instructions a warp an iteration)
PROBES = (("mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8, 8),
          ("ffma fp32", 2 * 32, 32))


def main() -> int:
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "mma_rate.cu", OUT / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {"card": card, "sms": sms, "probes": []}
    iters = 4096
    for which, (name, flops, per_iter) in enumerate(PROBES):
        for warps in (4, 8, 16):  # warps an SM: 1, 2, 4 a scheduler
            blocks, threads = 4 * sms, 32 * warps // 4
            out = torch.empty(blocks * threads, device="cuda")

            def run():
                err = lib.launch(which, out.data_ptr(), blocks, threads,
                                 iters)
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")

            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            total = flops * per_iter * iters * blocks * threads // 32
            row = {"probe": name, "warps_an_sm": warps, "ms": ms,
                   "tflops": total / ms / 1e9}
            results["probes"].append(row)
            print(f"[mma_rate] {name}, {warps} warps an SM: {ms:.4f} ms, "
                  f"{row['tflops']:.1f} TFLOP/s", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "mma_rate.json").write_text(json.dumps(results, indent=1))
    print(f"[mma_rate] {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
