"""W8A8 quantization for the diffusion sampling path: the twin of
polyp_tpu/ops/quant.py.

Three modes, set around a UNet call with `override(...)` as in the
reference:

* ``"w8a8"`` — dynamic per-tensor activation scales (one amax reduction per
  quantized op; the FF takes the per-token GEGLU kernel instead).
* ``"w8a8_static"`` — calibrated per-layer scales, floats or per-timestep
  tables (`scales`, keyed by the port's module paths). A table's entry is
  gathered on the device at the current timestep `t` (one gather per UNet
  forward for all layers), so no scale ever crosses to the host on the
  sampling path: every kernel reads its scale through a pointer.
* ``"w8a8_calib"`` — calibration: ops run full precision while each
  quantizable layer records its activation amax into the override's
  `stats` (the reference's "quant_stats" collection);
  `scales_from_stats` / `scale_tables_from_stats` fold them into scales.

`skip`/`only` select layers by path substring. Scales are fp32 0-d tensors
on the activation's device. Rounding is half-to-even (`torch.round`; the
kernels use `rintf`), as `jnp.round`.

Inference only: the reference refuses differentiation at backward time
(its `_inference_only` custom_vjp, :270-289). PyTorch runs eagerly, so the
port refuses at once: quantizing a tensor that records a gradient raises.

Weights are quantized once per module and cached (`module_weight_q8`),
re-quantized only when the weight changes — the port's form of XLA
hoisting the loop-invariant weight quantize out of each sampling scan.

Under tensor parallelism a row-parallel layer holds a slice of its input
features, so each of its amaxes (a weight row's, a dynamic activation's, a
calibration record's) is taken over the slice and then as the model
group's max (`parallel.model_max`): the scales, and so the codes, are the
one-process ones.

`--quantize promoted` resolves through `promoted_config` /
`resolve_quantize_arg` (reference :85-134) to the verdict in
`quant_gate.json` beside this module, which the port measures on its own
card (tools/quant_sensitivity.py, cli/verify_assets.py). It never reads
the reference's file, a TPU verdict. A missing file means demoted, as in
the reference; a file that is there but does not parse, or whose entry
lacks its mode, raises ValueError naming the file, where the reference
would demote silently.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Literal, Mapping, Sequence

import numpy as np
import torch

from polyp_tpu_torch.parallel.mesh import model_max

Mode = Literal["w8a8", "w8a8_static", "w8a8_calib"] | None

# don't quantize thin layers (conv_in 4→320, conv_out →4, tiny test models)
MIN_QUANT_CHANNELS = 64

# the port's own promotion verdict (package data); tests point it elsewhere
GATE_PATH = Path(__file__).parent / "quant_gate.json"


def gate_passes(entry: Mapping[str, Any], gate_rel_l2: float) -> bool:
    """The gate's rule for one entry: every rel-L2 it records
    (`rel_l2*`) is below `gate_rel_l2`, and every samples/s it records
    (`samples_per_sec*`) is above the bf16 samples/s measured beside it
    (`bf16_samples_per_sec*`). An entry with no rel-L2 fails."""
    rels = [v for k, v in entry.items()
            if k.startswith("rel_l2") and v is not None]
    rates = [(v, entry.get(f"bf16_{k}")) for k, v in entry.items()
             if k.startswith("samples_per_sec") and v is not None]
    return (bool(rels) and all(r < gate_rel_l2 for r in rels)
            and all(bf16 is not None and v > bf16 for v, bf16 in rates))


def _gate_entry(key: str) -> dict | None:
    """The entry `key` of the file at GATE_PATH, or None when the file is
    absent. Raises ValueError when the file does not parse or the entry
    lacks its mode."""
    try:
        text = GATE_PATH.read_text()
    except FileNotFoundError:
        return None
    try:
        gate = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"{GATE_PATH} does not parse: {e}") from None
    if not isinstance(gate, dict):
        raise ValueError(f"{GATE_PATH} holds no JSON object")
    entry = gate.get(key)
    if entry is None:
        return None
    if not isinstance(entry, dict) or "mode" not in entry:
        raise ValueError(f"{GATE_PATH}: entry {key!r} has no 'mode'")
    return entry


def promoted_config(distilled: bool = False) -> dict | None:
    """The gate-passing quantization config, if one exists: the entry
    `promoted` (full-trajectory CFG sampling, 25/50 steps) or, with
    `distilled`, `promoted_distilled` (few-step folded-guidance sampling)
    of the file at GATE_PATH, when its `gate_pass` is true; else None.
    Demotion is data: delete the file or flip `gate_pass`."""
    entry = _gate_entry("promoted_distilled" if distilled else "promoted")
    return entry if entry is not None and entry.get("gate_pass") else None


def resolve_quantize_arg(quantize: str | None, fp_head: int, fp_tail: int,
                         distilled: bool = False
                         ) -> tuple[str | None, int, int]:
    """`--quantize promoted` → the gate-passing (mode, fp_head, fp_tail) of
    `promoted_config(distilled)`; explicit modes pass through untouched.
    Raises SystemExit, naming the file, the entry's measured numbers and
    the tool, when promotion is asked for and nothing passes."""
    if quantize != "promoted":
        return quantize, fp_head, fp_tail
    promo = promoted_config(distilled=distilled)
    if promo is None:
        key = "promoted_distilled" if distilled else "promoted"
        entry = _gate_entry(key)
        measured = ("the file is absent" if not GATE_PATH.exists() else
                    f"entry {key!r} is absent" if entry is None else
                    f"entry {key!r} has gate_pass false: " + ", ".join(
                        f"{k} {v}" for k, v in entry.items()
                        if k.startswith(("rel_l2", "samples_per_sec",
                                         "bf16_samples_per_sec"))))
        raise SystemExit(
            f"--quantize promoted: no gate-passing config in {GATE_PATH} "
            f"({measured}); pick an explicit mode (w8a8 | w8a8_static) or "
            "re-judge with python -m polyp_tpu_torch.tools.quant_sensitivity"
            " and polyp-verify-assets-torch")
    return (promo["mode"], int(promo.get("quant_fp_head", 0)),
            int(promo.get("quant_fp_tail", 0)))


class ScaleBank:
    """Calibrated static scales ({path: float | per-timestep table}) held
    as one fp32 matrix [layers, timesteps], copied once to each device that
    asks. A float becomes a constant row."""

    def __init__(self, scales: Mapping[str, Any]):
        self.rows = {path: i for i, path in enumerate(scales)}
        tables = [np.asarray(v, np.float32).reshape(-1)
                  for v in scales.values()]
        lengths = {len(v) for v in tables if len(v) > 1}
        if len(lengths) > 1:
            raise ValueError(f"scale tables of different lengths {lengths}")
        self.per_timestep = bool(lengths)
        width = lengths.pop() if lengths else 1
        self.values = torch.from_numpy(np.stack(
            [np.broadcast_to(v, (width,)) for v in tables])
            if tables else np.zeros((0, width), np.float32))
        self._on: dict[torch.device, torch.Tensor] = {}

    def at(self, t, device: torch.device) -> torch.Tensor:
        """Every layer's scale at timestep `t` ([N] tensor or int; the first
        element is taken, clipped to the table): one [layers] gather."""
        values = self._on.get(device)
        if values is None:
            values = self._on[device] = self.values.to(device)
        if not self.per_timestep:
            return values[:, 0]
        if t is None:
            raise ValueError(
                "per-timestep static quantization scales need the current "
                "diffusion timestep: pass quant.override(..., t=t) where t "
                "is the timestep the model is being applied at")
        idx = torch.as_tensor(t, device=device).reshape(-1)[:1].long()
        return values[:, idx.clamp(0, values.shape[1] - 1)].reshape(-1)


@dataclass
class QuantState:
    """What `override` sets for its region. `stats` collects calibration
    amaxes ({path: fp32 0-d tensor}, max over the region's forwards)."""

    mode: Mode
    scales: ScaleBank | None = None
    skip: tuple[str, ...] = ()
    only: tuple[str, ...] | None = None
    t: Any = None
    stats: dict[str, torch.Tensor] = field(default_factory=dict)
    _at_t: dict[torch.device, torch.Tensor] = field(default_factory=dict)


_STATE: contextvars.ContextVar[QuantState | None] = contextvars.ContextVar(
    "polyp_torch_quantization", default=None)


def quantization() -> Mode:
    """The active quantization mode (None = full precision)."""
    state = _STATE.get()
    return None if state is None else state.mode


def calibrating() -> bool:
    return quantization() == "w8a8_calib"


@contextlib.contextmanager
def override(mode: Mode, scales: Mapping[str, Any] | ScaleBank | None = None,
             skip: Sequence[str] = (), only: Sequence[str] | None = None,
             t: Any = None):
    """Set the quantization mode for a region; yields its `QuantState`.
    `scales` (a dict or a prepared `ScaleBank`) is required for
    "w8a8_static"; `t` is the current timestep, required when any scale is
    a per-timestep table."""
    if mode not in (None, "w8a8", "w8a8_static", "w8a8_calib"):
        raise ValueError(f"unknown quantization mode: {mode!r}")
    if mode == "w8a8_static" and scales is None:
        raise ValueError("w8a8_static needs calibrated scales "
                         "(ops.quant.scales_from_stats); an empty dict is "
                         "allowed and leaves every layer full-precision")
    if scales is not None and not isinstance(scales, ScaleBank):
        scales = ScaleBank(scales)
    state = QuantState(mode, scales, tuple(skip),
                       tuple(only) if only is not None else None, t)
    token = _STATE.set(state)
    try:
        yield state
    finally:
        _STATE.reset(token)


def layer_selected(path: str | None) -> bool:
    """Does the skip/only filter allow quantizing this layer?"""
    state = _STATE.get()
    skip, only = (state.skip, state.only) if state else ((), None)
    if path is None:
        return only is None and not skip
    if only is not None and not any(p in path for p in only):
        return False
    return not any(p in path for p in skip)


def static_scale(path: str | None,
                 device: torch.device | str = "cpu") -> torch.Tensor | None:
    """The calibrated activation scale of a layer (a 0-d fp32 tensor on
    `device`), or None. Tables are gathered at the override's `t` once per
    region and device for all layers together."""
    state = _STATE.get()
    if state is None or state.scales is None or path is None:
        return None
    row = state.scales.rows.get(path)
    if row is None:
        return None
    device = torch.device(device)
    at_t = state._at_t.get(device)
    if at_t is None:
        at_t = state._at_t[device] = state.scales.at(state.t, device)
    return at_t[row]


def record_amax(path: str | None, x: torch.Tensor, mesh=None) -> None:
    """Calibration hook: fold max|x| into the region's stats for `path`
    (the model group's max when `mesh` is given: x is a slice)."""
    state = _STATE.get()
    if state is None or path is None:
        return
    amax = model_max(x.detach().abs().amax().float(), mesh)
    prev = state.stats.get(path)
    state.stats[path] = amax if prev is None else torch.maximum(prev, amax)


def scales_from_stats(stats: Sequence[Mapping[str, Any]],
                      margin: float = 1.0) -> dict[str, float]:
    """Fold one or more calibration `stats` dicts into {path: scale}.
    Scale = max-over-points amax × margin / 127."""
    amax: dict[str, float] = {}
    for point in stats:
        for path, value in point.items():
            v = float(torch.as_tensor(value).float().max())
            amax[path] = max(amax.get(path, 0.0), v)
    return {p: max(v * margin, 1e-12) / 127.0 for p, v in amax.items()}


def scale_tables_from_stats(points: Sequence[tuple[int, Sequence[Mapping]]],
                            num_train_timesteps: int,
                            margin: float = 1.0) -> dict[str, list[float]]:
    """Per-timestep calibration stats → per-layer scale tables over
    [0, num_train_timesteps), linearly interpolated between points; a layer
    missing at a point takes its max over the points where it was seen."""
    if not points:
        return {}
    per_point = sorted(((int(t), scales_from_stats(s, margin))
                        for t, s in points), key=lambda p: p[0])
    ts = np.asarray([t for t, _ in per_point], np.float64)
    paths = set().union(*(d.keys() for _, d in per_point))
    grid = np.arange(num_train_timesteps, dtype=np.float64)
    tables: dict[str, list[float]] = {}
    for path in sorted(paths):
        fallback = max(d[path] for _, d in per_point if path in d)
        vals = np.asarray([d.get(path, fallback) for _, d in per_point])
        tables[path] = np.interp(grid, ts, vals).tolist()
    return tables


def _inference_only(*tensors: torch.Tensor | None) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "w8a8 quantization is inference-only (zero gradient through "
            "int8 rounding); disable quant.override(...) for training or "
            "run under torch.no_grad()")


def quantize_weight(w: torch.Tensor, reduce_dims: Sequence[int],
                    mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization. `reduce_dims` are the
    non-output dims ((1,) for a torch Linear [out, in], (1, 2, 3) for an
    OIHW conv). Returns (int8 weights, fp32 scales with the reduced dims
    kept). `mesh`: `w` is a row-parallel slice of its input features, and
    each row's amax is the model group's."""
    _inference_only(w)
    w32 = w.float()
    amax = model_max(w32.abs().amax(dim=tuple(reduce_dims), keepdim=True),
                     mesh)
    scale = amax.clamp(min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return wq, scale


def dynamic_scale(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The per-tensor scale of dynamic w8a8: max(|x|max, 1e-12) / 127, as a
    0-d fp32 tensor on x's device (no host sync); the model group's max
    when `mesh` is given (x is a slice)."""
    amax = model_max(x.detach().abs().amax().float(), mesh)
    return amax.clamp(min=1e-12) / 127.0


def quantize_activation(x: torch.Tensor, scale: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 activation quantization with a static scale, or the dynamic
    per-tensor one when `scale` is None. Returns (int8, scale)."""
    _inference_only(x)
    if scale is None:
        scale = dynamic_scale(x)
    xq = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return xq.to(torch.int8), scale


def weight_q8_matrix(w: torch.Tensor, mesh=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_weight` of a Linear [out, in] or OIHW conv weight, as a
    matrix [out, in·kh·kw] (conv columns ordered (kh, kw, in), the patch
    order of `conv_patches`) and [out] fp32 scales."""
    wq, sw = quantize_weight(w, tuple(range(1, w.ndim)), mesh)
    if w.ndim == 4:
        wq = wq.permute(0, 2, 3, 1)
    return wq.reshape(w.shape[0], -1).contiguous(), sw.reshape(-1)


def module_weight_q8(module: torch.nn.Module
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`weight_q8_matrix` of a module's weight, computed once and reused
    until the weight changes (its storage or version); a row-parallel
    layer's scales are its model group's (`row_tp`)."""
    w = module.weight
    key = (w.data_ptr(), w._version, w.device, w.dtype)
    hit = getattr(module, "_q8_weight", None)
    if hit is None or hit[0] != key:
        hit = module._q8_weight = (key, *weight_q8_matrix(
            w, getattr(module, "row_tp", None)))
    return hit[1], hit[2]


# `torch._int_mm` on a CUDA tensor takes M > 16 only
_INT_MM_MIN_ROWS = 17


def int_mm(a: torch.Tensor, b_rows: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] × s8 [N, K]ᵀ → s32 [M, N] (`torch._int_mm`). On a CUDA
    tensor `_int_mm` needs M > 16 and K, N multiples of 8: an M ≤ 16 is
    padded with rows of zeros to 17 and the result cut back to M rows
    (rows are independent, so exact: the one-sample int8 conv at a 4×4
    level); K or N that is no multiple of 8 raises rather than fall
    back."""
    m, k = a.shape
    n = b_rows.shape[0]
    if a.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8 matmul [{m},{k}]x[{k},{n}] on CUDA needs "
                         "K, N multiples of 8")
    if a.is_cuda and m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, k)])
        return torch._int_mm(a, b_rows.contiguous().t())[:m]
    return torch._int_mm(a.contiguous(), b_rows.contiguous().t())


def w8a8_dense(x: torch.Tensor, weight: torch.Tensor,
               out_dtype: torch.dtype,
               act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """int8 x [..., in] @ weight [out, in]ᵀ (torch layout) with a dynamic or
    static activation scale and per-output-channel weight scales; returns
    `out_dtype`, no bias (reference :346)."""
    wq, sw = quantize_weight(weight, (1,))
    xq, sa = quantize_activation(x, act_scale)
    y = int_mm(xq.reshape(-1, x.shape[-1]), wq)
    out = (y.float() * (sa * sw.reshape(1, -1))).to(out_dtype)
    return out.reshape(*x.shape[:-1], weight.shape[0])


def conv_patches(x: torch.Tensor, kernel_size: tuple[int, int],
                 stride: tuple[int, int], padding: tuple[int, int]
                 ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """NCHW `x` (any dtype, int8 included) → the patch matrix
    [N·Ho·Wo, kh·kw·C], columns ordered (kh, kw, C), by zero padding and
    strided slices (no `unfold`, which takes floats only). Returns it with
    (N, Ho, Wo)."""
    n, _, h, w = x.shape
    kh, kw = kernel_size
    (sh, sw), (ph, pw) = stride, padding
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    xp = torch.nn.functional.pad(x.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
    cols = [xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    patches = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return patches.reshape(n * ho * wo, -1), (n, ho, wo)


def w8a8_conv(x: torch.Tensor, weight: torch.Tensor,
              stride: tuple[int, int], padding: tuple[int, int],
              out_dtype: torch.dtype,
              act_scale: torch.Tensor | None = None,
              q8: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> torch.Tensor:
    """int8 NCHW conv of an OIHW `weight`, no bias (reference :319). An int8
    `x` is a producer-side pre-quantized activation and `act_scale` is then
    the scale it was quantized with. `q8` passes the weight already
    quantized (`module_weight_q8`). s8×s8→s32 through the patch matrix and
    `int_mm`, then the per-channel dequantize. Returns NCHW (a
    channels-last view)."""
    if x.dtype == torch.int8:
        if act_scale is None:
            raise ValueError("pre-quantized int8 conv input needs its "
                             "activation scale")
        xq, sa = x, act_scale
    else:
        xq, sa = quantize_activation(x, act_scale)
    wq, sw = q8 if q8 is not None else weight_q8_matrix(weight)
    patches, (n, ho, wo) = conv_patches(xq, tuple(weight.shape[2:]), stride,
                                        padding)
    y = int_mm(patches, wq)
    out = (y.float() * (sa * sw.reshape(1, -1))).to(out_dtype)
    return out.reshape(n, ho, wo, -1).permute(0, 3, 1, 2)


def quantizable(cin: int, cout: int, path: str | None) -> bool:
    """Does the active mode quantize a layer of these widths at `path`?
    (The reference's conv_quantizable / dense_quantizable.)"""
    mode = quantization()
    if mode not in ("w8a8", "w8a8_static"):
        return False
    if min(cin, cout) < MIN_QUANT_CHANNELS or not layer_selected(path):
        return False
    # no calibration record for this layer → stay full precision
    return mode == "w8a8" or _STATE.get().scales.rows.get(path) is not None
