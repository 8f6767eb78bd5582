"""The port's quant gate (polyp_tpu_torch/ops/quant.py: promoted_config,
resolve_quantize_arg; DiffusionConfig's expansion of "promoted") against
polyp_tpu's on the same gate contents, written to a temporary file that
both packages read: the port through its GATE_PATH, the reference through
its module's `__file__` (promoted_config reads it at call time), so
nothing in polyp_tpu changes. Then the one deliberate deviation (a file
that is there but does not parse raises in the port), the contract of the
port's own vendored verdict (ops/quant_gate.json, measured on the card),
and the surfaces that take `--quantize promoted`: add_common_flags,
polyp-serve-torch's main, tools/bench_serve's main and
load_student_sampler. Everything here is CPU and milliseconds, but the
last test (a tiny stack)."""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import pytest
import torch

import polyp_tpu.ops.quant as jq
from polyp_tpu.configs import DiffusionConfig as JConfig
from polyp_tpu_torch import serve as tserve
from polyp_tpu_torch.cli import distill_sd
from polyp_tpu_torch.cli.common import add_common_flags, load_sd_stack
from polyp_tpu_torch.configs import DiffusionConfig as TConfig
from polyp_tpu_torch.ops import quant as tq
from polyp_tpu_torch.tools import bench_serve as tbench
from polyp_tpu_torch.utils.checkpoint import save_pytree

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


# the reference's verdict, read as data only (a TPU verdict: the port
# never reads it at run time)
REFERENCE_GATE = json.loads(
    Path(jq.__file__).with_name("quant_gate.json").read_text())


def _variant(name: str) -> dict | None:
    gate = copy.deepcopy(REFERENCE_GATE)
    if name == "promoted_demoted":
        gate["promoted"]["gate_pass"] = False
    elif name == "no_distilled":
        del gate["promoted_distilled"]
    elif name == "absent":
        return None
    return gate


VARIANTS = ("reference", "promoted_demoted", "no_distilled", "absent")


def _point_both_at(content, tmp_path: Path, monkeypatch) -> Path:
    """Write `content` (None: no file) where both packages look for it."""
    path = tmp_path / "quant_gate.json"
    if content is not None:
        path.write_text(json.dumps(content))
    monkeypatch.setattr(tq, "GATE_PATH", path)
    monkeypatch.setattr(jq, "__file__", str(tmp_path / "quant.py"))
    return path


def _outcome(fn):
    """("ok", value) or ("exit",): the two packages' exit messages name
    their own files, so only the fact of the exit is compared."""
    try:
        return ("ok", fn())
    except SystemExit:
        return ("exit",)


def _config_fields(cfg) -> tuple:
    return (cfg.quantize, cfg.quant_fp_head, cfg.quant_fp_tail,
            cfg.quant_promoted)


@pytest.mark.parametrize("quantize", [None, "w8a8", "w8a8_static",
                                      "promoted"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_resolution_matches_the_reference(variant, quantize, tmp_path,
                                          monkeypatch):
    """For every (head, tail, distilled): promoted_config,
    resolve_quantize_arg and DiffusionConfig(quantize=...)'s (quantize,
    head, tail, quant_promoted) are equal in both packages, or both
    exit."""
    _point_both_at(_variant(variant), tmp_path, monkeypatch)
    for distilled in (False, True):
        assert (tq.promoted_config(distilled=distilled)
                == jq.promoted_config(distilled=distilled))
        for head, tail in ((0, 0), (2, 0), (0, 3), (5, 1)):
            assert (_outcome(lambda: tq.resolve_quantize_arg(
                        quantize, head, tail, distilled=distilled))
                    == _outcome(lambda: jq.resolve_quantize_arg(
                        quantize, head, tail, distilled=distilled)))
    for head, tail in ((0, 0), (2, 0), (0, 3), (5, 1)):
        kw = dict(quantize=quantize, quant_fp_head=head, quant_fp_tail=tail)
        got = _outcome(lambda: _config_fields(TConfig(**kw)))
        assert got == _outcome(lambda: _config_fields(JConfig(**kw)))
        if quantize == "promoted" and got[0] == "ok":
            assert got[1][3] is True


def test_demoted_exit_names_the_ports_file_and_numbers(tmp_path,
                                                       monkeypatch):
    """A demoted entry exits naming the port's file, the entry's measured
    numbers and the port's tool; never the reference's file."""
    gate = _variant("promoted_demoted")
    path = _point_both_at(gate, tmp_path, monkeypatch)
    with pytest.raises(SystemExit) as e:
        tq.resolve_quantize_arg("promoted", 0, 0)
    msg = str(e.value)
    assert str(path) in msg and "polyp_tpu/ops" not in msg
    assert "polyp_tpu_torch.tools.quant_sensitivity" in msg
    assert f"rel_l2_25step {gate['promoted']['rel_l2_25step']}" in msg
    assert "samples_per_sec_50step" in msg


@pytest.mark.parametrize("text", ["{not json", '["a list"]',
                                  '{"promoted": {"gate_pass": true}}'])
def test_malformed_file_raises_where_the_reference_demotes(text, tmp_path,
                                                          monkeypatch):
    """The deliberate deviation: a file that is there but does not parse,
    holds no object, or whose entry lacks its mode raises ValueError
    naming the file. The reference's `except Exception: return None`
    demotes the first two silently (and hands the third to a KeyError
    later)."""
    path = _point_both_at(None, tmp_path, monkeypatch)
    path.write_text(text)
    with pytest.raises(ValueError, match=str(path)):
        tq.promoted_config()
    with pytest.raises(ValueError, match=str(path)):
        TConfig(quantize="promoted")
    if "gate_pass" in text:
        assert jq.promoted_config() == {"gate_pass": True}
    else:
        assert jq.promoted_config() is None


def test_vendored_verdict_contract():
    """polyp_tpu_torch/ops/quant_gate.json, the port's own verdict: measured
    on an NVIDIA card whose power limit it names; gate_rel_l2 0.05; each
    entry's gate_pass is the rule of ops/quant.py::gate_passes (every
    rel-L2 below the gate and every samples/s above the bf16 samples/s
    beside it); a passing entry has no bf16 tail (and the distilled one no
    head); a failing one records the numbers that failed. The counterpart
    of tests/test_quant.py:655-725, with the card's numbers."""
    gate = json.loads(tq.GATE_PATH.read_text())
    card = gate["measured_on"]["card"]
    assert "NVIDIA" in card and card.rstrip().endswith("W")
    assert gate["measured_on"]["commands"]
    assert gate["gate_rel_l2"] == 0.05
    for key in ("promoted", "promoted_distilled"):
        entry = gate[key]
        assert entry["mode"] in ("w8a8", "w8a8_static")
        rels = {k: v for k, v in entry.items() if k.startswith("rel_l2")}
        rates = {k: (v, entry[f"bf16_{k}"]) for k, v in entry.items()
                 if k.startswith("samples_per_sec")}
        assert rels and rates
        assert entry["gate_pass"] == tq.gate_passes(entry, 0.05)
        if entry["gate_pass"]:
            assert all(v < 0.05 for v in rels.values())
            assert all(v > bf16 for v, bf16 in rates.values())
            assert entry["quant_fp_tail"] == 0
            if key == "promoted_distilled":
                assert entry["quant_fp_head"] == 0
        else:
            assert (any(v >= 0.05 for v in rels.values())
                    or any(v <= bf16 for v, bf16 in rates.values()))
        # the resolution follows the file
        want = entry if entry["gate_pass"] else None
        assert tq.promoted_config(distilled=key != "promoted") == want
    assert tq.resolve_quantize_arg("w8a8", 1, 2) == ("w8a8", 1, 2)
    assert tq.resolve_quantize_arg(None, 0, 0) == (None, 0, 0)


@pytest.fixture
def passing_gate(tmp_path, monkeypatch) -> dict:
    """A temporary verdict whose two entries pass (distinct heads, so the
    full-trajectory and the distilled resolutions tell apart)."""
    gate = {"gate_rel_l2": 0.05,
            "promoted": {"mode": "w8a8_static", "quant_fp_head": 3,
                         "quant_fp_tail": 0, "gate_pass": True},
            "promoted_distilled": {"mode": "w8a8", "quant_fp_head": 0,
                                   "quant_fp_tail": 0, "gate_pass": True}}
    _point_both_at(gate, tmp_path, monkeypatch)
    return gate


def test_common_flags_take_promoted(passing_gate):
    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    args = parser.parse_args(["--quantize", "promoted"])
    assert args.quantize == "promoted"
    cfg = TConfig(quantize=args.quantize, quant_fp_head=args.quant_fp_head,
                  quant_fp_tail=args.quant_fp_tail)
    assert _config_fields(cfg) == ("w8a8_static", 3, 0, True)


class _Built(Exception):
    """Raised by a patched factory: the arguments reached it."""


@pytest.mark.parametrize("distilled", [False, True])
def test_serve_and_bench_serve_resolve_before_any_stack(distilled,
                                                        passing_gate,
                                                        monkeypatch):
    """polyp-serve-torch's and bench_serve's mains expand `--quantize
    promoted` before they build anything: the factory gets the concrete
    mode and head, the distilled verdict with --distilled-dir."""
    got = {}

    def factory(args):
        got["args"] = args
        raise _Built

    monkeypatch.setattr(tserve, "service_from_args", factory)
    monkeypatch.setattr(tbench, "sampler_from_args", factory)
    entry = passing_gate["promoted_distilled" if distilled else "promoted"]
    want = (entry["mode"], entry["quant_fp_head"], entry["quant_fp_tail"])
    argv = ["--quantize", "promoted", "--device", "cpu"]
    with pytest.raises(_Built):
        tserve.main(argv + (["--distilled-dir", "runs/d"] if distilled
                            else []))
    a = got.pop("args")
    assert (a.quantize, a.quant_fp_head, a.quant_fp_tail) == want
    if not distilled:  # bench_serve serves the base stack only
        with pytest.raises(_Built):
            tbench.main(argv)
        a = got.pop("args")
        assert (a.quantize, a.quant_fp_head, a.quant_fp_tail) == want


def test_load_student_sampler_takes_the_distilled_verdict(passing_gate,
                                                          tmp_path):
    """`quantize="promoted"`, and a config's `quant_promoted` (which
    expanded the full-trajectory verdict, head 3), give the distilled
    entry's mode with no bf16 head on the student's 2-step grid."""
    stack = load_sd_stack(None, torch.float32, tiny=True, device="cpu")
    models = tmp_path / "run" / "models"
    models.mkdir(parents=True)
    save_pytree(models / "distilled_AD",
                {"params": dict(stack.unet.state_dict())})
    (models / "distilled_AD_meta.json").write_text(json.dumps(
        {"num_steps": 2, "prediction_type": "epsilon",
         "num_train_timesteps": 1000, "prompt": "an AD polyp"}))
    cfg = TConfig(quantize="promoted")
    assert (cfg.quantize, cfg.quant_fp_head) == ("w8a8_static", 3)
    for kw in ({"quantize": "promoted"},
               {"quantize": cfg.quantize, "quant_fp_head": cfg.quant_fp_head,
                "quant_promoted": cfg.quant_promoted}):
        sampler = distill_sd.load_student_sampler(
            stack, tmp_path / "run", "AD", image_size=32, **kw)
        assert (sampler.quantize, sampler._split) == ("w8a8", None)
    plain = distill_sd.load_student_sampler(
        stack, tmp_path / "run", "AD", image_size=32, quantize="w8a8_static",
        quant_fp_head=1)
    assert (plain.quantize, plain._split) == ("w8a8_static", (1, 0))
