"""polyp_tpu_torch/tools/quant_sensitivity.py against the JAX package's
tools/quant_sensitivity.py, and polyp_tpu_torch/utils/profiling.py.

The layer families select the same layers by path in both packages (each
package's own quantizable-layer hook records what it quantizes, on the
tiny UNet with the width floor lowered to 1 in both, so every layer is a
candidate and only the filter decides); the bf16 reference images of the
reference's `_sweep_context(quick=True)` are reproduced by the port's on
the same weights, cond and initial latents; the reports carry the
reference's keys. int8 rel-L2 values are not compared between the
packages: a rounding tie broken the other way cascades (ROADMAP.md, "How
to compare int8 paths")."""

from __future__ import annotations

import importlib.util
import json
import time
import types
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyp_tpu.ops.quant as jq
from polyp_tpu.models import tiny_condition_unet as j_tiny_unet
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models import tiny_condition_unet, tiny_vae
from polyp_tpu_torch.ops import quant as tq
from polyp_tpu_torch.tools import quant_sensitivity as qs
from polyp_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file. The tiny stacks' many small CPU ops
    (bf16 through oneDNN) each open an OpenMP region; when the suite's
    parallel workers each run a thread per core, every region waits for
    cores, and these tests took 100 times longer than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def reference_tool():
    """tools/quant_sensitivity.py as a module. Its import points the
    process's JAX compilation cache at /tmp; that setting is put back."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "reference_quant_sensitivity", ROOT / "tools" / "quant_sensitivity.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return module


def test_families_and_gate_equal_the_reference(reference_tool):
    assert qs.FAMILIES == reference_tool.FAMILIES
    assert qs.GATE_REL_L2 == reference_tool.GATE_REL_L2 == 0.05


@pytest.fixture(scope="module")
def tiny_unets():
    """The reference's tiny UNet and its parameter shapes (no values: the
    layers are recorded while tracing), and the port's tiny UNet."""
    unet = j_tiny_unet(dtype=jnp.float32)
    shapes = jax.eval_shape(
        unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)))["params"]
    return unet, shapes, tiny_condition_unet().eval()


def _reference_layers(unet, shapes, family, monkeypatch) -> set[str]:
    """The paths the reference quantizes under override("w8a8",
    only=(family,)), recorded by its `_quantizable` while tracing."""
    seen, real = set(), jq._quantizable

    def record(cin, cout, path):
        out = real(cin, cout, path)
        if out:
            seen.add(path)
        return out

    monkeypatch.setattr(jq, "_quantizable", record)

    def forward(params):
        with jq.override("w8a8", only=(family,)):
            return unet.apply({"params": params}, jnp.zeros((2, 8, 8, 4)),
                              jnp.zeros((2,), jnp.int32),
                              jnp.zeros((2, 77, 32)))

    jax.eval_shape(forward, shapes)
    return seen


def _port_layers(unet, family, monkeypatch) -> tuple[set[str], int]:
    """The reference paths (importers.jax_module_path) of the layers the
    port quantizes under the tool's override for `family`, and the number
    of fused int8 GEGLU calls."""
    from polyp_tpu_torch.models import unet_blocks

    seen, fused, real = set(), [], tq.quantizable

    def record(cin, cout, path):
        out = real(cin, cout, path)
        if out:
            seen.add(timp.jax_module_path(path))
        return out

    monkeypatch.setattr(tq, "quantizable", record)
    monkeypatch.setattr(unet_blocks, "fused_geglu_w8a8_pt",
                        lambda *a: fused.append(1))
    with torch.no_grad(), tq.override("w8a8",
                                      only=qs.port_patterns((family,))):
        unet(torch.zeros(2, 4, 8, 8), torch.zeros(2, dtype=torch.long),
             torch.zeros(2, 77, 32))
    return seen, len(fused)


@pytest.mark.parametrize("family", qs.FAMILIES)
def test_family_quantizes_the_same_layers(family, tiny_unets, monkeypatch):
    """only=(family,) quantizes the same layers, by path, in both
    packages. The trap: ff_net_0_proj alone sends the GEGLU down the
    per-layer route in both (reference unet_blocks.py:382-385), so the
    port's fused int8 GEGLU never runs and ff_net_2 stays full
    precision."""
    unet, shapes, t_unet = tiny_unets
    monkeypatch.setattr(jq, "MIN_QUANT_CHANNELS", 1)
    monkeypatch.setattr(tq, "MIN_QUANT_CHANNELS", 1)
    want = _reference_layers(unet, shapes, family, monkeypatch)
    got, fused = _port_layers(t_unet, family, monkeypatch)
    assert want and got == want
    assert all(family in path for path in want)
    assert fused == 0
    if family == "ff_net_0_proj":
        assert {p.rsplit("/", 1)[1] for p in got} == {"ff_net_0_proj"}


def test_reference_images_match_the_reference(reference_tool, monkeypatch):
    """The reference images of `_sweep_context(quick=True)` (32 px, 2 DDIM
    steps, CFG 7.5, batch 2) in both packages, on the reference context's
    weights, cond embedding and initial latents (its DDIM draws them from
    split(PRNGKey(seed + 1))[1]): within 5e-3 on images mapped to [0, 1]
    as the pipeline maps them. In fp32 on both sides: the test's copy of
    the reference module gets a `jnp` whose bfloat16 is float32, so the
    reference's own code runs. (In bf16 each package's images are 0.035 to
    0.052 rel-L2 from its own fp32 images on the CPU, so two bf16 runs
    cannot agree to 5e-3; in fp32 they agree to about 5e-6.)"""
    fp32_jnp = types.ModuleType("jnp_fp32")
    fp32_jnp.__dict__.update(vars(jnp))
    fp32_jnp.bfloat16 = jnp.float32
    monkeypatch.setattr(reference_tool, "jnp", fp32_jnp)
    jctx = reference_tool._sweep_context(2, 32, 2, True, 0)
    assert jctx["dtype"] == jnp.float32
    want = np.asarray(jctx["images"](None), np.float64)
    unet, vae = tiny_condition_unet(), tiny_vae()
    unet.load_state_dict(timp.unet_from_jax(jctx["uparams"]), strict=True)
    vae.load_state_dict(timp.vae_from_jax(jctx["vparams"]["params"]),
                        strict=True)
    stack = SimpleNamespace(unet=unet.eval(), vae=vae.eval())
    init = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(1))[1], (2, 4, 4, 4)))
    ctx = qs._sweep_context(
        2, 32, 2, True, 0, "cpu", stack=stack,
        cond=torch.from_numpy(np.asarray(jctx["cond"], np.float32)),
        init=torch.from_numpy(init.transpose(0, 3, 1, 2).copy()))
    got = ctx["ref"].transpose(0, 2, 3, 1).astype(np.float64)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert np.abs(np.clip((got + 1) / 2, 0, 1)
                  - np.clip((want + 1) / 2, 0, 1)).max() <= 5e-3


# the reference's report keys (tools/quant_sensitivity.py run_sweep with
# forward_only, and run_split_sweep)
SWEEP_KEYS = {"gate_rel_l2", "batch", "steps", "image_size", "quick",
              "forward_only", "per_family_rel_l2", "full_w8a8_rel_l2",
              "w8a8_skip_worst1", "n_calibrated_layers",
              "w8a8_static_rel_l2", "full_w8a8_gate_pass",
              "w8a8_static_gate_pass"}
SPLIT_KEYS = {"gate_rel_l2", "batch", "steps", "image_size", "quick", "mode",
              "splits"}


@pytest.fixture(scope="module")
def quick_ctx():
    return qs._sweep_context(2, 32, 2, True, 0, "cpu")


def test_split_sweep_report_has_the_reference_keys(quick_ctx):
    """run_split_sweep's report: the reference's keys, each split's
    samples/s beside bf16's, and bf16 against its own reference images
    exactly 0 (a deterministic second run)."""
    report = qs.run_split_sweep(2, 32, 2, True, splits=(1,), device="cpu",
                                ctx=quick_ctx, timed_runs=1)
    assert SPLIT_KEYS <= set(report)
    assert set(report["splits"]) == {"0", "1"}
    assert {"rel_l2", "gate_pass"} <= set(report["splits"]["0"])
    assert {"head_rel_l2", "head_gate_pass", "tail_rel_l2",
            "tail_gate_pass"} <= set(report["splits"]["1"])
    assert report["bf16"]["rel_l2"] == 0.0
    assert all(v > 0 for v in (report["bf16"]["samples_per_sec"],
                               report["splits"]["0"]["samples_per_sec"],
                               report["splits"]["1"]["head_samples_per_sec"]))
    json.dumps(report)


def test_family_sweep_report_has_the_reference_keys(quick_ctx):
    report = qs.run_sweep(2, 32, 2, True, forward_only=True, device="cpu",
                          ctx=quick_ctx, timed_runs=1)
    assert SWEEP_KEYS <= set(report)
    assert set(report["per_family_rel_l2"]) == set(qs.FAMILIES)
    assert set(report["samples_per_sec"]) == {
        "bf16", "full_w8a8", "w8a8_skip_worst1", "w8a8_static"}
    assert report["n_calibrated_layers"] > 0
    assert all(np.isfinite(v) for v in report["per_family_rel_l2"].values())
    json.dumps(report)


def _splits_report(steps: int, rels: dict, rates: dict, bf16: float) -> dict:
    splits = {"0": {"rel_l2": rels[0], "samples_per_sec": rates[0]}}
    for n in (1, 3, 5):
        splits[str(n)] = {"head_rel_l2": rels[n],
                          "head_samples_per_sec": rates[n]}
    return {"mode": "w8a8_static", "batch": 16, "steps": steps,
            "splits": splits, "bf16": {"samples_per_sec": bf16},
            "card": "NVIDIA X, 700.00 W"}


def test_verdict_takes_the_smallest_head_passing_at_every_step_count(
        tmp_path):
    """The promoted entry: the smallest head under the gate at both step
    counts (3: head 1 fails at 50 steps), its rel-L2 and samples/s beside
    bf16's at each; gate_pass needs the throughput half too. The smaller
    heads are recorded as rejected."""
    r25 = _splits_report(25, {0: 0.1, 1: 0.04, 3: 0.03, 5: 0.02},
                         {0: 9.0, 1: 9.0, 3: 8.5, 5: 8.0}, 8.0)
    r50 = _splits_report(50, {0: 0.12, 1: 0.06, 3: 0.035, 5: 0.03},
                         {0: 5.0, 1: 5.0, 3: 4.5, 5: 4.0}, 4.2)
    entry, rejected = qs.promoted_entry([r25, r50])
    assert entry["quant_fp_head"] == 3 and entry["quant_fp_tail"] == 0
    assert entry["rel_l2_25step"] == 0.03 and entry["rel_l2_50step"] == 0.035
    assert entry["bf16_samples_per_sec_50step"] == 4.2
    assert entry["gate_pass"] is True
    assert set(rejected) == {"w8a8_static_fp_head0", "w8a8_static_fp_head1"}
    r50["bf16"]["samples_per_sec"] = 4.6  # int8 slower: demoted
    assert qs.promoted_entry([r25, r50])[0]["gate_pass"] is False
    paths = []
    for r in (r25, r50):
        paths.append(tmp_path / f"r{r['steps']}.json")
        paths[-1].write_text(json.dumps(r))
    gate_path = tmp_path / "gate.json"
    gate_path.write_text(json.dumps({"gate_rel_l2": 0.05,
                                     "promoted_distilled": {"mode": "x"}}))
    gate = qs.write_verdict([str(p) for p in paths], gate_path)
    assert json.loads(gate_path.read_text()) == gate
    assert gate["promoted_distilled"] == {"mode": "x"}
    assert gate["measured_on"]["card"] == "NVIDIA X, 700.00 W"


def test_throughput_counts_samples_over_seconds():
    tp = profiling.Throughput()
    assert tp.samples_per_sec == 0.0
    for _ in range(2):
        with tp.measure(n_samples=8):
            time.sleep(0.02)
            tp.sync({"a": [torch.ones(2)], "b": (torch.zeros(1),)})
    assert tp.total_samples == 16
    assert 0.04 <= tp.total_seconds < 1.0
    assert tp.samples_per_sec == pytest.approx(16 / tp.total_seconds)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_debug_nans_raises_on_a_nan_made_in_a_backward():
    """torch's anomaly mode, on only inside the region: sqrt's backward
    at 0 makes an inf that times 0 is a NaN."""
    def backward():
        x = torch.zeros(3, requires_grad=True)
        (torch.sqrt(x) * 0).sum().backward()
        return x.grad

    assert torch.isnan(backward()).all()
    with profiling.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            backward()
    assert not torch.is_anomaly_enabled()
