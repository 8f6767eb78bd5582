"""Build and load the port's hand-written CUDA kernels.

`nvcc` compiles every source under `csrc/` for Hopper (`sm_90a`), at first
use, one process per source, all started together, and links the objects
into one shared library with a plain C interface in
`build/polyp_tpu_torch/` at the repository root; `ctypes` loads it. The
library's file name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a stale library is never loaded. The compiler's
`-Xptxas -v` report (registers, shared memory, spills per kernel) is kept
beside the library as `<name>.log`.

A failed build raises: there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "polyp_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argument types. Every entry returns a cudaError_t.
SIGNATURES = {
    # q, k, v, o, n, h, tq, tk, d, scale, stream
    "polyp_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # the same, all fp32
    "polyp_flash_attention_f32_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                      _P],
    # x, w1, b1, w2, b2, workspace, out, t, c, h, stream
    "polyp_fused_geglu": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # the same, all fp32, without a workspace
    "polyp_fused_geglu_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, gamma, beta, y, n, c, hw, groups, eps, silu, is_bf16, act_scale,
    # stream
    "polyp_group_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P],
    # x, x_is_int8, wq, sw, bias, act_scale, out, m, c, o, stream
    "polyp_w8a8_dense": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # the same with fp32 x (or int8 x), an fp32 bias and an fp32 out
    "polyp_w8a8_dense_f32": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, wq1, sw1, b1, wq2, sw2, b2, act_scale1, act_scale2, workspace, out,
    # t, c, h, stream
    "polyp_geglu_w8a8": [_P] * 11 + [_I, _I, _I, _P],
    # the same with fp32 x, b1, b2 and out
    "polyp_geglu_w8a8_f32": [_P] * 11 + [_I, _I, _I, _P],
    # x, wq1, sw1, b1, wq2, sw2, b2, workspace, out, t, c, h, block_h, stream
    "polyp_geglu_w8a8_pt": [_P] * 9 + [_I, _I, _I, _I, _P],
    # the same with fp32 x, b1, b2 and out
    "polyp_geglu_w8a8_pt_f32": [_P] * 9 + [_I, _I, _I, _I, _P],
    # x, wq1, sw1, b1, workspace, t, c, h, block_h, stream: the per-token
    # form's first launch alone (codes, then sh, in the workspace)
    "polyp_geglu_w8a8_pt_up": [_P] * 5 + [_I, _I, _I, _I, _P],
    # x, ctx, wq, wk, wv, wo, k_ws, v_ws, out, b, tq, tk, c, ckv, h, d, co,
    # scale, stream
    "polyp_fused_mha": [_P] * 9 + [_I] * 8 + [_F, _P],
    # the same, all fp32 (workspaces fp32)
    "polyp_fused_mha_f32": [_P] * 9 + [_I] * 8 + [_F, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists;
    returns its path."""
    lib = BUILD_DIR / f"libpolyp_tpu_torch_{source_hash()}.so"
    if lib.exists():
        return lib
    objs = BUILD_DIR / f"{lib.stem}.{os.getpid()}.objs"
    objs.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = [(cu, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
         str(objs / f"{cu.stem}.o"), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cu in sorted(CSRC.glob("*.cu"))]
    reports = [(cu, proc.communicate()[0], proc.returncode)
               for cu, proc in procs]
    failed = [(cu, out, rc) for cu, out, rc in reports if rc != 0]
    if failed:
        shutil.rmtree(objs, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{cu.name} (exit code {rc}):\n{out[-12000:]}"
            for cu, out, rc in failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp),
         *(str(objs / f"{cu.stem}.o") for cu, _, _ in reports)],
        capture_output=True, text=True)
    shutil.rmtree(objs, ignore_errors=True)
    if link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"linking the kernels failed with exit code "
                           f"{link.returncode}:\n{link.stderr[-12000:]}")
    lib.with_suffix(".log").write_text(
        "".join(f"== {cu.name}\n{out}" for cu, out, _ in reports))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.polyp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.polyp_cuda_error_string.restype = ctypes.c_char_p
    # device -> the most dynamic shared memory a block may take there
    lib.polyp_smem_optin.argtypes = [_I]
    lib.polyp_smem_optin.restype = ctypes.c_longlong
    # t, c, h -> bf16 elements of the GEGLU's h workspace [t, h]
    lib.polyp_fused_geglu_workspace.argtypes = [_I, _I, _I]
    lib.polyp_fused_geglu_workspace.restype = ctypes.c_longlong
    # t, c, h, out[4] -> the GEGLU fp32 form's launch: tokens a block, the
    # cluster's blocks, the panel's columns, shared memory bytes a block
    lib.polyp_fused_geglu_f32_plan.argtypes = [_I, _I, _I,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.polyp_fused_geglu_f32_plan.restype = ctypes.c_int
    # t, c, h, block_h (0: static form) -> bytes of int8 GEGLU workspace
    lib.polyp_geglu_w8a8_workspace.argtypes = [_I, _I, _I, _I]
    lib.polyp_geglu_w8a8_workspace.restype = ctypes.c_longlong
    # d (flash); h, d, co (fused MHA) -> bytes of dynamic shared memory a block
    lib.polyp_flash_smem.argtypes = [_I]
    lib.polyp_flash_smem.restype = ctypes.c_longlong
    lib.polyp_flash_f32_smem.argtypes = [_I]
    lib.polyp_flash_f32_smem.restype = ctypes.c_longlong
    # d, out[6] -> the fp32 flash form's plan: query rows a block, keys a
    # tile, threads a block, key groups, shared memory bytes a block, row
    # tiles a warp
    lib.polyp_flash_f32_plan.argtypes = [_I, ctypes.POINTER(ctypes.c_longlong)]
    lib.polyp_flash_f32_plan.restype = ctypes.c_int
    lib.polyp_fused_mha_smem.argtypes = [_I, _I, _I]
    lib.polyp_fused_mha_smem.restype = ctypes.c_longlong
    lib.polyp_fused_mha_f32_smem.argtypes = [_I, _I, _I]
    lib.polyp_fused_mha_f32_smem.restype = ctypes.c_longlong
    # c, hw, groups, is_bf16, out[4] -> GroupNorm's plan: cluster, the
    # largest slice's vectors, those kept in shared memory, threads a block
    lib.polyp_group_norm_plan.argtypes = [
        _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    lib.polyp_group_norm_plan.restype = None
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = library().polyp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on `t`'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
