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


# ---------------------------------------------------------------------------
# the training steps' counter (roofline.count_step) against FlopCounterMode
# ---------------------------------------------------------------------------

STEP_PX = 64
STEP_BATCH = 2


def _counted_by_both(step, modules, trained):
    """(count_step's work, FlopCounterMode's FLOPs) of one run of `step`,
    FlopCounterMode around the counter: the same ops seen twice."""
    counter = FlopCounterMode(display=False)
    with counter:
        work = roofline.count_step(step, modules, trained)
    return work, counter.get_total_flops()


@pytest.mark.parametrize("remat", [False, True])
def test_count_step_matches_flop_counter_on_the_lora_step(remat):
    """The SD LoRA step on the tiny stack at 64 px (the attention
    projections, rank 4): every product's forward, dX where a gradient
    flows, dW of the merged (LoRA-trained) kernels, the merge's A·B and its
    two gradients, nothing for the no_grad VAE encode's and CLIP's
    backward, and with `remat` the UNet's forward again in the backward:
    FlopCounterMode's count exactly."""
    import numpy as np

    from polyp_tpu_torch.cli.common import load_sd_stack
    from polyp_tpu_torch.cli.sd_common import make_components
    from polyp_tpu_torch.configs import DiffusionConfig
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.lora.surgery import LoRAConfig, init_lora
    from polyp_tpu_torch.train import sd_finetune as sf
    from polyp_tpu_torch.utils.checkpoint import tree_leaves

    stack = load_sd_stack(None, torch.float32, tiny=True, device="cpu")
    lcfg = LoRAConfig(rank=4, alpha=4.0, dropout=0.0)
    trainable = sf.init_trainable(init_lora(
        stack.unet, lcfg, torch.Generator().manual_seed(1)))
    frozen = make_components(stack, trainable)
    if remat:
        frozen = frozen.with_remat()
    cfg = DiffusionConfig(image_size=STEP_PX,
                          train_batch_size=STEP_BATCH).with_schedule(10)
    state = sf.create_sd_train_state(cfg, trainable)
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (STEP_BATCH, STEP_PX, STEP_PX, 3), dtype=np.uint8))
    ids = torch.as_tensor(stack.tokenizer(["a colon polyp"]))
    work, want = _counted_by_both(
        lambda: sf.sd_lora_train_step(
            state, frozen, DiffusionSchedule.create(50), images, ids, None,
            sf.step_draws(0, 0, 0, "cpu"), lcfg),
        (stack.unet, stack.vae, stack.text), tree_leaves(state.trainable))
    assert work["flops"] == want
    assert work["by_op"]["lora_merge"] > 0
    assert (work["by_pass"]["recompute"] > 0) == remat
    assert work["trained_elements"] == sum(
        t.numel() for t in tree_leaves(state.trainable))


def _grouped_weight_grad_excess(model, *args):
    """FlopCounterMode's weight-gradient count of a grouped convolution
    is the count of the same convolution with groups = 1 (its formula
    takes the weight's per-group input width as the batch of a
    convolution over the whole input): (groups − 1) × the true count.
    Summed over `model`'s grouped convolutions on a forward of `args`."""
    from polyp_tpu_torch.models.efficientnet import ConvBNAct

    excess = []

    def hook(m, inputs, out):
        c = m.conv
        true = 2 * out.numel() * (c.in_channels // c.groups) * \
            c.kernel_size[0] * c.kernel_size[1]
        excess.append((c.groups - 1) * true)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ConvBNAct) and m.conv.groups > 1]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    assert excess
    return sum(excess)


def test_count_step_matches_flop_counter_on_the_classifier_step():
    """B0's train step at 64 px: count_step's FLOPs are FlopCounterMode's
    less one named term, the excess its formula counts for the depthwise
    convolutions' weight gradients (`_grouped_weight_grad_excess`)."""
    import numpy as np

    from polyp_tpu_torch.configs import ClassificationConfig
    from polyp_tpu_torch.train import classifier as tc

    cfg = ClassificationConfig(image_size=STEP_PX, batch_size=STEP_BATCH,
                               mixed_precision="fp32")
    state = tc.create_classifier_state(cfg, 3, "cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (STEP_BATCH, STEP_PX, STEP_PX, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 3, STEP_BATCH))
    excess = _grouped_weight_grad_excess(
        state.model.backbone, torch.zeros(STEP_BATCH, 3, STEP_PX, STEP_PX),
        tc.step_draws(0, 0, 0, state.model, STEP_BATCH, "cpu"))
    work, want = _counted_by_both(
        lambda: tc.train_step(state, images, labels, tc.step_draws(
            0, 0, 0, state.model, STEP_BATCH, "cpu")),
        [state.model], list(state.model.parameters()))
    assert work["flops"] == want - excess
    assert work["by_pass"]["backward"] > work["by_pass"]["forward"]


def test_count_step_matches_flop_counter_on_the_distill_step():
    """The distill step on the tiny UNet at 64 px, guidance folded at 7.5:
    the teacher's two substeps at 2× batch (no backward), the student's
    forward and every weight's gradient: FlopCounterMode's count."""
    from polyp_tpu_torch.diffusion import DiffusionSchedule
    from polyp_tpu_torch.train import distill as td
    from polyp_tpu_torch.train.sd_finetune import SDOptimizer

    torch.manual_seed(0)
    unet = tiny_condition_unet().eval()
    cond, uncond = torch.randn(1, 16, 32), torch.randn(1, 16, 32)
    applies = td.make_applies(unet, 7.5, cond, uncond)
    schedule = DiffusionSchedule.create(1000, "scaled_linear", 0.00085,
                                        0.012)
    step = td.make_distill_step(applies.student, applies.teacher, schedule,
                                schedule, td.distill_grid(schedule, 4))
    teacher = {k: p.detach() for k, p in unet.named_parameters()}
    state = td.init_distill_state(teacher, SDOptimizer(lambda c: 1e-4))
    x0 = torch.randn(STEP_BATCH, 4, STEP_PX // 8, STEP_PX // 8)
    work, want = _counted_by_both(
        lambda: step(state, teacher, x0, td.distill_draws("phase", 0, 0,
                                                          "cpu")),
        [unet], list(state.params.values()))
    assert work["flops"] == want
    # the teacher's 2 substeps × 2× batch forwards, then the student's
    fwd = roofline.unet_step(unet, STEP_BATCH, STEP_PX // 8, cfg=False,
                             context=(16, 32), device="cpu")["flops"]
    assert work["by_pass"]["forward"] == 5 * fwd


def test_count_step_names_the_flash_backwards_recompute():
    """Where the flash path runs under autograd (1,024 tokens, head dim
    40), its plain backward recomputes the forward before its four
    products: count_step counts that recompute (the forward's FLOPs
    again) and so equals FlopCounterMode."""
    from polyp_tpu_torch.models.unet_blocks import Attention

    torch.manual_seed(0)
    attn = Attention(40, 1, 40)
    x = torch.randn(1, 1024, 40, requires_grad=True)

    def step():
        attn(x).sum().backward()

    work, want = _counted_by_both(step, [attn], list(attn.parameters()))
    products = 4 * 1024 * 1024 * 40
    assert work["by_pass"]["recompute"] == products
    assert work["flops"] == want


def test_optimizer_bytes_on_one_layer_are_the_hand_count():
    """One Linear(8 → 4) trained on a [2, 8] input: its forward (x, W, b,
    y), its weight gradient (dY, x, dW; no dX: x needs none), and 28 bytes
    an element for the optimizer (parameter, gradient and two moments
    read, parameter and moments written, fp32)."""
    torch.manual_seed(0)
    layer = torch.nn.Linear(8, 4)
    x = torch.randn(2, 8)
    opt = torch.optim.Adam(layer.parameters())

    def step():
        layer(x).sum().backward()
        opt.step()

    work = roofline.count_step(step, [layer], list(layer.parameters()))
    assert work["optimizer_bytes"] == 28 * (32 + 4)
    fp32 = 4
    forward = (16 + 32 + 4 + 8) * fp32
    weight_grad = (8 + 16 + 32) * fp32
    assert work["bytes"] == forward + weight_grad + 28 * 36
    assert work["flops"] == 2 * (2 * 2 * 8 * 4)


def test_image_size_sets_the_levels():
    assert roofline.levels(512) == [(64, 320), (32, 640), (16, 1280),
                                    (8, 1280)]
    assert roofline.levels()[0] == (32, 320)
    with pytest.raises(ValueError):
        roofline.levels(200)


@pytest.mark.parametrize("mode", [[], ["--few-step"], ["--train"],
                                  ["--distill"], ["--image-size", "512"]])
def test_main_without_a_card_exits(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        roofline.main(mode)
