"""Fused GEGLU feed-forward: the twin of polyp_tpu/ops/fused_geglu.py.

Three kernels, each launched on CUDA tensors by its wrapper and replaced by
its plain version on CPU tensors:

* `fused_geglu` — `csrc/fused_geglu.cu` on the GEMM core
  `csrc/gemm_core.cuh`, replacing the Pallas kernel `fused_geglu`
  (polyp_tpu/ops/fused_geglu.py:139); plain `reference_geglu`. bf16, any
  token count, C and H multiples of 8; fp32 inputs and weights (the fp32
  models the Pallas kernel also took) take the same file's fp32 form, one
  launch with the hidden dimension split over a thread-block cluster,
  counted apart (`fused_geglu.f32_launches`), any T, C and H.
* `fused_geglu_w8a8` — `csrc/fused_geglu_w8a8.cu` (static form) on the
  GEMM core, replacing `fused_geglu_w8a8` (:256): the static-scale int8 FF
  in two launches, h's int8 codes [T, H] (plain `reference_geglu_w8a8_codes`)
  and then the W8A8 dense's int8-input path over them; plain
  `reference_geglu_w8a8`. C up to what its panel of quantized x in shared
  memory allows (the kernel refuses wider, with an error).
* `fused_geglu_w8a8_pt` — the same file's per-token form on the GEMM
  core, replacing `fused_geglu_w8a8_pt` (:398): the per-token dynamic int8
  FF, whose h is quantized per (row, group of `block_h(C, H)` hidden
  units), the reference's tiles, in two launches: h's int8 codes [T, H]
  and group scales [T, H / block_h] (plain `reference_geglu_w8a8_pt_codes`),
  then the groups' products added in fp32 in order (plain
  `reference_geglu_w8a8_pt_down`); plain `reference_geglu_w8a8_pt`. C up to
  what its panel allows (2,432; the kernel refuses wider, with an error).

Weights are in torch's Linear layout: w1 [2H, C] with a = rows :H and gate
= rows H: (diffusers' `chunk(2)`), w2 [C, H]; the int8 kernels take them
quantized once outside (`quant.module_weight_q8`), any token count, and C
and H multiples of 16. Their x and biases are all bf16, or all fp32: the
fp32 forms (the same file, counted apart as `f32_launches`) return fp32,
as the Pallas kernels compute in and return x's dtype.

Inference only, as in the reference (ops/dispatch.py): FeedForward takes
these paths only when autograd is off, and the wrappers raise if asked to
record a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from polyp_tpu_torch import _build
from polyp_tpu_torch.ops import quant

# block_h of the reference's _BLOCKS (:518) per SD channel width, default
# DEFAULT_BLOCK_H (:47): it fixes the groups the per-token form quantizes h
# over
_BLOCK_H = {320: 1024, 640: 512, 1280: 512}
DEFAULT_BLOCK_H = 512


def _tile(total: int, want: int, unit: int) -> int:
    """Largest divisor of `total` that is ≤ want and a multiple of `unit`
    (`total` when none exists): the reference's _tile (:50)."""
    want = min(want, total)
    for cand in range(want, unit - 1, -1):
        if total % cand == 0 and cand % unit == 0:
            return cand
    return total


def block_h(c: int, hidden: int) -> int:
    """Hidden units per h-quantization group of the per-token form: 640 at
    C=320, 512 at 640 and 1280 (reference :442, :470-471)."""
    return _tile(hidden, _BLOCK_H.get(c, DEFAULT_BLOCK_H), 128)


def reference_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version, in the kernel's (and the TPU kernel's) order: a and
    gate in fp32, h = a * gelu_erf(gate) rounded to x's dtype, the second
    product in fp32, one rounding to x's dtype at the end. For fp32 inputs
    that is plain fp32 math; float64 inputs are computed in float64 (what
    the fp32 form is held to)."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    a, gate = F.linear(x.to(f), w1.to(f), b1.to(f)).chunk(2, dim=-1)
    h = (a * F.gelu(gate)).to(x.dtype)
    return F.linear(h.to(f), w2.to(f), b2.to(f)).to(x.dtype)


def fused_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x: [..., C]; w1: [2H, C]; b1: [2H]; w2: [C, H]; b2: [C].
    Returns [..., C] == reference_geglu to rounding."""
    args = (x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("the fused GEGLU kernel is inference-only; call it "
                           "under torch.no_grad()")
    if x.device.type == "cpu":
        return reference_geglu(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_geglu: no kernel for device {x.device}")
    dtypes = {t.dtype for t in args}
    if dtypes not in ({torch.bfloat16}, {torch.float32}):
        raise ValueError(f"the GEGLU kernel takes bf16 or fp32 inputs and "
                         f"weights, all of one dtype; got {dtypes}")
    c = x.shape[-1]
    hidden = w2.shape[1]
    if (w1.shape != (2 * hidden, c) or b1.shape != (2 * hidden,)
            or w2.shape != (c, hidden) or b2.shape != (c,)):
        raise ValueError(f"GEGLU shapes do not match: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if x.dtype == torch.float32:
        return _geglu_f32(x, w1, b1, w2, b2)
    if c % 8 or hidden % 8:
        raise ValueError(f"GEGLU kernel needs C and H divisible by 8, got "
                         f"C={c} H={hidden}")
    xf = x.reshape(-1, c).contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    if any(t.data_ptr() % 16 for t in (xf, w1, b1, w2, b2)):
        raise ValueError("GEGLU kernel needs 16-byte aligned x, w1, b1, w2 "
                         "and b2")
    t = xf.shape[0]
    out = torch.empty_like(xf)
    lib = _build.library()
    with torch.cuda.device(x.device):
        # h = bf16(a * gelu(gate)) [T, H], made by the first launch and read
        # by the second
        workspace = torch.empty(
            lib.polyp_fused_geglu_workspace(t, c, hidden),
            dtype=torch.bfloat16, device=x.device)
        err = lib.polyp_fused_geglu(
            xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), workspace.data_ptr(), out.data_ptr(), t, c,
            hidden, _build.stream_of(x))
    _build.check(err, "fused GEGLU kernel")
    fused_geglu.launches += 1
    return out.reshape(x.shape)


def _geglu_f32(x, w1, b1, w2, b2) -> torch.Tensor:
    """The fp32 form's launch (shapes checked by fused_geglu)."""
    c, hidden = x.shape[-1], w2.shape[1]
    xf = x.reshape(-1, c).contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    t = xf.shape[0]
    out = torch.empty_like(xf)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.polyp_fused_geglu_f32(
            xf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), t, c, hidden, _build.stream_of(x))
    _build.check(err, "fused GEGLU kernel (fp32)")
    fused_geglu.f32_launches += 1
    return out.reshape(x.shape)


fused_geglu.launches = 0
fused_geglu.f32_launches = 0


def reference_geglu_w8a8(x: torch.Tensor, wq1: torch.Tensor,
                         sw1: torch.Tensor, b1: torch.Tensor,
                         wq2: torch.Tensor, sw2: torch.Tensor,
                         b2: torch.Tensor, act_scale1: torch.Tensor,
                         act_scale2: torch.Tensor,
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the static int8 FF, the TPU kernel's math
    (_geglu_q_kernel): a, gate and h in fp32, h quantized with act_scale2,
    the int32 second product dequantized once, rounded once to `out_dtype`
    (default x's dtype)."""
    hq = reference_geglu_w8a8_codes(x, wq1, sw1, b1, act_scale1, act_scale2)
    out = quant.int_mm(hq, wq2).float() * (act_scale2 * sw2) + b2.float()
    return out.to(out_dtype or x.dtype).reshape(x.shape)


def reference_geglu_w8a8_codes(x: torch.Tensor, wq1: torch.Tensor,
                               sw1: torch.Tensor, b1: torch.Tensor,
                               act_scale1: torch.Tensor,
                               act_scale2: torch.Tensor) -> torch.Tensor:
    """The static form's first half, the plain version of its first launch:
    [a | gate] = q(x) · wq1ᵀ in int32, · (act_scale1 · sw1) + b1 in fp32,
    h = a · gelu_erf(gate), and h's int8 codes with act_scale2: [T, H]."""
    c = x.shape[-1]
    xq = quant.quantize_activation(x, act_scale1)[0].reshape(-1, c)
    h1 = quant.int_mm(xq, wq1).float() * (act_scale1 * sw1) + b1.float()
    a, gate = h1.chunk(2, dim=-1)
    return quant.quantize_activation(a * F.gelu(gate), act_scale2)[0]


def row_codes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-token form's x codes: each row of x [..., C] (in fp32)
    quantized with its own scale sx = max(|x[t, :]|, 1e-12) / 127. Returns
    (codes [T, C] int8, sx [T, 1] fp32)."""
    x32 = x.reshape(-1, x.shape[-1]).float()
    sxr = x32.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.clamp(torch.round(x32 / sxr), -127, 127).to(torch.int8), sxr


def reference_geglu_w8a8_pt_codes(x: torch.Tensor, wq1: torch.Tensor,
                                  sw1: torch.Tensor, b1: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-token form's first half, the plain version of its first
    launch: row scales sx = max(|x[t, :]|, 1e-12) / 127, [a | gate] =
    q(x) · wq1ᵀ in int32, · (sx · sw1) + b1 in fp32, h = a · gelu_erf(gate),
    and h's int8 codes per (row, group of `block_h` hidden units) with the
    group's row scales. Returns (codes [T, H] int8, sh [T, H / block_h]
    fp32)."""
    c = x.shape[-1]
    hidden = wq1.shape[0] // 2
    bh = block_h(c, hidden)
    xq, sxr = row_codes(x)
    h1 = quant.int_mm(xq, wq1).float() * (sxr * sw1) + b1.float()
    a, gate = h1.chunk(2, dim=-1)
    h = a * F.gelu(gate)
    codes, scales = [], []
    for j0 in range(0, hidden, bh):
        ht = h[:, j0:j0 + bh]
        shr = ht.abs().amax(dim=1, keepdim=True).clamp(min=1e-12) / 127.0
        codes.append(torch.clamp(torch.round(ht / shr), -127, 127
                                 ).to(torch.int8))
        scales.append(shr)
    return torch.cat(codes, dim=1), torch.cat(scales, dim=1)


def reference_geglu_w8a8_pt_down(hq: torch.Tensor, sh: torch.Tensor,
                                 wq2: torch.Tensor, sw2: torch.Tensor,
                                 b2: torch.Tensor, out_dtype: torch.dtype
                                 ) -> torch.Tensor:
    """The per-token form's second half, the plain version of its second
    launch: out = Σ_g float(hq_g · wq2_gᵀ) · (sh[:, g] · sw2) over the
    groups of H / G hidden units, added in fp32 in order g = 0, 1, ...,
    then + b2, rounded once to `out_dtype`. hq [T, H] int8, sh [T, G]."""
    hidden = hq.shape[1]
    bh = hidden // sh.shape[1]
    out = torch.zeros(hq.shape[0], wq2.shape[0], dtype=torch.float32,
                      device=hq.device)
    for g, j0 in enumerate(range(0, hidden, bh)):
        out = out + (quant.int_mm(hq[:, j0:j0 + bh], wq2[:, j0:j0 + bh])
                     .float() * (sh[:, g:g + 1] * sw2))
    return (out + b2.float()).to(out_dtype)


def reference_geglu_w8a8_pt(x: torch.Tensor, wq1: torch.Tensor,
                            sw1: torch.Tensor, b1: torch.Tensor,
                            wq2: torch.Tensor, sw2: torch.Tensor,
                            b2: torch.Tensor,
                            out_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """Plain version of the per-token int8 FF, the TPU kernel's math
    (_geglu_q_pt_kernel; its oracle reference_geglu_w8a8_pt): row scales
    for x, h quantized per (row, block_h group), each group's product
    dequantized with its row scales and the groups added in fp32, in
    order — the codes (reference_geglu_w8a8_pt_codes), then the grouped
    product (reference_geglu_w8a8_pt_down), as the kernel's two launches."""
    hq, sh = reference_geglu_w8a8_pt_codes(x, wq1, sw1, b1)
    out = reference_geglu_w8a8_pt_down(hq, sh, wq2, sw2, b2,
                                       out_dtype or x.dtype)
    return out.reshape(x.shape)


def _check_q8_geglu(name: str, x, wq1, sw1, b1, wq2, sw2, b2) -> None:
    c = x.shape[-1]
    hidden = wq2.shape[1]
    dtypes = {t.dtype for t in (x, b1, b2)}
    if dtypes not in ({torch.bfloat16}, {torch.float32}):
        raise ValueError(f"the {name} kernel takes x and biases all bf16 or "
                         f"all fp32, got {sorted(map(str, dtypes))}")
    if (wq1.dtype != torch.int8 or wq2.dtype != torch.int8
            or wq1.shape != (2 * hidden, c) or wq2.shape != (c, hidden)
            or sw1.shape != (2 * hidden,) or sw2.shape != (c,)
            or b1.shape != (2 * hidden,) or b2.shape != (c,)):
        raise ValueError(f"{name} shapes do not match: x {tuple(x.shape)}, "
                         f"wq1 {tuple(wq1.shape)}, wq2 {tuple(wq2.shape)}")
    if c % 16 or hidden % 16:
        raise ValueError(f"the {name} kernel needs C and H divisible by 16, "
                         f"got C={c} H={hidden}")
    if sw1.dtype != torch.float32 or sw2.dtype != torch.float32:
        raise ValueError(f"{name} weight scales must be fp32")


def _q8_geglu_launch(name: str, entry: str, x: torch.Tensor, weights,
                     scales, group: int) -> torch.Tensor:
    """Launch either int8 GEGLU form, bf16 or (fp32 x: `entry` + "_f32")
    fp32: contiguity and alignment, the workspace that the C side sizes in
    bytes (`group` = 0 for the static form's h codes, else block_h for the
    per-token form's codes, group scales and first-launch slots), the error
    check."""
    wq1, sw1, b1, wq2, sw2, b2 = (t.contiguous() for t in weights)
    c = x.shape[-1]
    hidden = wq2.shape[1]
    xf = x.reshape(-1, c).contiguous()
    if any(t.data_ptr() % 16 for t in (xf, wq1, sw1, b1, wq2, sw2, b2)):
        raise ValueError(f"the {name} kernel needs 16-byte aligned x, "
                         "weights, scales and biases")
    t = xf.shape[0]
    out = torch.empty_like(xf)
    lib = _build.library()
    with torch.cuda.device(x.device):
        workspace = torch.empty(
            lib.polyp_geglu_w8a8_workspace(t, c, hidden, group),
            dtype=torch.uint8, device=x.device)
        ptrs = [p.data_ptr() for p in (xf, wq1, sw1, b1, wq2, sw2, b2,
                                       *scales)]
        sizes = (t, c, hidden, group) if group else (t, c, hidden)
        f32 = x.dtype == torch.float32
        err = getattr(lib, entry + ("_f32" if f32 else ""))(
            *ptrs, workspace.data_ptr(), out.data_ptr(), *sizes,
            _build.stream_of(x))
    _build.check(err, f"{name} kernel" + (" (fp32)" if f32 else ""))
    return out.reshape(x.shape)


def _count(fn, x: torch.Tensor) -> None:
    """One launch of `fn`'s bf16 or fp32 form."""
    if x.dtype == torch.float32:
        fn.f32_launches += 1
    else:
        fn.launches += 1


def fused_geglu_w8a8(x: torch.Tensor, wq1: torch.Tensor, sw1: torch.Tensor,
                     b1: torch.Tensor, wq2: torch.Tensor, sw2: torch.Tensor,
                     b2: torch.Tensor, act_scale1: torch.Tensor,
                     act_scale2: torch.Tensor) -> torch.Tensor:
    """Static int8 FF. x: [..., C]; wq1: [2H, C] int8, sw1: [2H]; wq2:
    [C, H] int8, sw2: [C]; act_scale1/2: the calibrated 0-d fp32 scales of
    ff.net.0.proj's and ff.net.2's inputs. == reference_geglu_w8a8 to
    rounding."""
    quant._inference_only(x, b1, b2)
    weights = (wq1, sw1, b1, wq2, sw2, b2)
    if x.device.type == "cpu":
        return reference_geglu_w8a8(x, *weights, act_scale1, act_scale2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_geglu_w8a8: no kernel for device {x.device}")
    _check_q8_geglu("static W8A8 GEGLU", x, *weights)
    for s in (act_scale1, act_scale2):
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != x.device:
            raise ValueError("W8A8 GEGLU act scales must be 0-d fp32 on x's "
                             "device")
    out = _q8_geglu_launch("static W8A8 GEGLU", "polyp_geglu_w8a8", x,
                           weights, (act_scale1, act_scale2), 0)
    _count(fused_geglu_w8a8, x)
    return out


def fused_geglu_w8a8_pt(x: torch.Tensor, wq1: torch.Tensor,
                        sw1: torch.Tensor, b1: torch.Tensor,
                        wq2: torch.Tensor, sw2: torch.Tensor,
                        b2: torch.Tensor) -> torch.Tensor:
    """Per-token int8 FF (shapes as `fused_geglu_w8a8`, no activation
    scales). == reference_geglu_w8a8_pt to rounding."""
    quant._inference_only(x, b1, b2)
    weights = (wq1, sw1, b1, wq2, sw2, b2)
    if x.device.type == "cpu":
        return reference_geglu_w8a8_pt(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_geglu_w8a8_pt: no kernel for device "
                         f"{x.device}")
    _check_q8_geglu("per-token W8A8 GEGLU", x, *weights)
    group = block_h(x.shape[-1], wq2.shape[1])
    out = _q8_geglu_launch("per-token W8A8 GEGLU", "polyp_geglu_w8a8_pt", x,
                           weights, (), group)
    _count(fused_geglu_w8a8_pt, x)
    return out


fused_geglu_w8a8.launches = 0
fused_geglu_w8a8.f32_launches = 0
fused_geglu_w8a8_pt.launches = 0
fused_geglu_w8a8_pt.f32_launches = 0
