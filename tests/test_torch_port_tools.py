"""The port's measurement tools on the CPU: polyp_tpu_torch/tools/
profile_census.py's `summarize` on a fabricated Chrome trace whose
buckets are known, and tools/roofline.py's work count of a tiny UNet step
against torch's FlopCounterMode over the plain CPU forward (the count is
made from shapes because FlopCounterMode cannot see the kernels on the
card; on the CPU every kernel runs its plain version, which it does see).
"""

from __future__ import annotations

import gzip
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from polyp_tpu_torch.models import tiny_condition_unet, tiny_vae
from polyp_tpu_torch.tools import profile_census, roofline


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file (and its spawned ranks, which
    split this process's threads): the tiny models' many small CPU ops
    each open an OpenMP region, which waits for cores when the suite's
    parallel workers each run a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _event(name, ms, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "dur": ms * 1e3,
            "pid": 0, "tid": 7, "ts": 0}


TRACE = {"traceEvents": [
    _event("void flash_fwd_kernel<40>(Params)", 2.0),
    _event("void gemm_kernel<GegluUp<128, 128> >(GemmArgs)", 3.0),
    _event("void gemm_kernel<GegluDown<128, 128> >(GemmArgs)", 1.0),
    _event("void gemm_kernel<GegluQ8Up<128> >(GemmArgs)", 0.5),
    _event("void gemm_kernel<GegluQ8PtUp<64> >(GemmArgs)", 0.25),
    _event("void gemm_kernel<Dense<160, 1> >(GemmArgs)", 0.75),
    _event("void group_norm_kernel<true>(GnArgs)", 1.5),
    _event("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32", 10.0),
    _event("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 4.0),
    _event("void at::native::reduce_kernel<512, 1>(ReduceOp)", 0.5),
    _event("void at::native::vectorized_elementwise_kernel<4>(add)", 0.2),
    _event("void cudnn::engines_precompiled::nchwToNhwcKernel<"
           "__nv_bfloat16, __nv_bfloat16, float, false>(int)", 0.3),
    _event("nvjet_tst_128x160_64x5_2x1_v_bz_NNT", 0.6),
    _event("Memcpy HtoD (Pageable -> Device)", 0.1, "gpu_memcpy"),
    _event("Memset (Device)", 0.05, "gpu_memset"),
    _event("mystery_kernel", 0.4),
    # host events are not device time
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 9e6},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "dur": 9e6},
]}


@pytest.mark.parametrize("gz", [False, True])
def test_summarize_buckets_a_known_trace(tmp_path, gz):
    path = tmp_path / ("trace.json.gz" if gz else "trace.json")
    with (gzip.open if gz else open)(path, "wt") as f:
        json.dump(TRACE, f)
    report = profile_census.summarize(path, top=5, quiet=True)
    fams = {k: round(v[0], 6) for k, v in report["families"].items()}
    assert fams == {"cudnn_conv": 10.0, "cublas_gemm": 4.6,
                    "bf16_geglu": 4.0, "flash_attention": 2.0,
                    "group_norm": 1.5, "w8a8_dense": 0.75,
                    "reduction": 0.5, "int8_geglu": 0.5, "other": 0.4,
                    "layout_copy": 0.3, "int8_geglu_pt": 0.25,
                    "elementwise": 0.2, "memcpy": 0.15}
    assert report["families"]["bf16_geglu"][1] == 2
    assert report["events"] == 16
    assert report["total_ms"] == pytest.approx(25.15)
    assert [row[0][:22] for row in report["top"][:2]] == [
        "sm90_xmma_fprop_implic", "sm90_xmma_gemm_bf16bf1"]


def _flop_counter(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("cfg", [True, False])
def test_roofline_counts_the_unet_step_as_flop_counter(cfg):
    """The count includes the ported ops (attention products, the GEGLU's
    two products) and equals FlopCounterMode over the plain forward within
    1%."""
    torch.manual_seed(0)
    unet = tiny_condition_unet().eval()
    work = roofline.unet_step(unet, 2, 8, cfg=cfg, context=(16, 32),
                              device="cpu")
    assert work["by_op"]["attention"] > 0 and work["by_op"]["geglu"] > 0
    assert work["by_op"]["conv"] > 0 and work["bytes"] > 0
    n = 4 if cfg else 2
    x, t = torch.zeros(n, 4, 8, 8), torch.zeros(n, dtype=torch.long)
    ctx = torch.zeros(n, 16, 32)
    want = _flop_counter(lambda: unet(x, t, ctx))
    assert work["flops"] == pytest.approx(want, rel=0.01)


def test_roofline_counts_the_vae_decode_as_flop_counter():
    torch.manual_seed(0)
    vae = tiny_vae().eval()
    z = torch.zeros(2, 4, 4, 4)
    work = roofline.count_work(roofline._Decode(vae), z)
    want = _flop_counter(lambda: vae.decode(z))
    assert work["flops"] == pytest.approx(want, rel=0.01)
