"""polyp_tpu_torch/tools/distill_ab.py and
polyp_tpu_torch/examples/classifier_walkthrough.py on the CPU at a tiny
budget: every row of the A/B (the teacher's own 4-step grid, each student
head, or the guard's REFUSED line) prints with a finite rel RMSE, in both
modes, and the walkthrough runs end to end on its synthetic mini-corpus.
The A/B's findings at its defaults are a measurement on the card
(chip_smoke.py's bench phase, PERF.md); the port's distillation itself is
held to polyp_tpu in tests/test_torch_port_distill.py."""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from polyp_tpu_torch.examples import classifier_walkthrough
from polyp_tpu_torch.tools import distill_ab

TINY = ["--train_steps", "4", "--steps_per_phase", "2", "--device", "cpu"]
ROW = re.compile(r"rel RMSE: ([0-9.eE+-]+|nan|inf)")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this file. The tiny models' many small CPU
    ops each open an OpenMP region; when the suite's parallel workers each
    run a thread per core, every region waits for cores (these tests took
    about 80 times longer in the 6-worker run than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", [[], ["--sd"]])
def test_distill_ab_rows_print_finite(mode, capsys):
    rows = distill_ab.main(TINY + mode)
    out = capsys.readouterr().out
    printed = [float(v) for v in ROW.findall(out)]
    refused = out.count("REFUSED by the convergence guard")
    assert set(rows) == {"teacher_4step", "epsilon", "v_prediction"}
    measured = [v for v in rows.values() if v is not None]
    assert len(printed) == len(measured) and len(printed) + refused == 3
    assert all(math.isfinite(v) and v > 0 for v in printed)
    assert np.allclose(sorted(printed), sorted(measured), rtol=1e-3,
                       atol=1e-4)
    assert "teacher-4step" in out and "total" in out


def test_distill_ab_data_is_seeded():
    a, b = distill_ab.make_data(8, 3), distill_ab.make_data(8, 3)
    assert a.shape == (8, 3, distill_ab.SIZE, distill_ab.SIZE)
    assert (a == b).all() and a.min() >= -1.0 and a.max() <= 1.0
    lat = distill_ab.make_latent_corpus(8, 3)
    assert lat.shape == (8, 4, 8, 8) and (lat == distill_ab.
                                          make_latent_corpus(8, 3)).all()
    assert not (lat == distill_ab.make_latent_corpus(8, 4)).all()


def test_classifier_walkthrough_runs(tmp_path, capsys):
    metrics = classifier_walkthrough.main(
        ["--data-root", str(tmp_path / "data"), "--epochs", "1",
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fabricating a synthetic mini-corpus" in out
    assert "label map" in out and "best val accuracy" in out
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert math.isfinite(metrics["f1_score"])
    assert np.asarray(metrics["confusion_matrix"]).sum() == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feed_forward_takes_the_geglu_wrapper(monkeypatch, dtype):
    """Without autograd every FF calls the GEGLU kernel's wrapper, bf16 or
    fp32 (distill_ab --sd's tiny conditional UNet is fp32; on the card the
    wrapper takes the kernel's fp32 form): the tiny UNet's four transformer
    blocks, one call each. Under autograd, the plain version."""
    from polyp_tpu_torch.cli.common import init_weights_
    from polyp_tpu_torch.models import unet_blocks
    from polyp_tpu_torch.models.unet_condition import tiny_condition_unet

    calls = []
    kernel = unet_blocks.fused_geglu

    def recorded(*args):
        calls.append(args[0].dtype)
        return kernel(*args)

    monkeypatch.setattr(unet_blocks, "fused_geglu", recorded)
    unet = tiny_condition_unet(dtype=dtype)
    init_weights_(unet, torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = unet(x.to(dtype), torch.tensor([10, 500]),
                   torch.zeros(2, 16, 32, dtype=dtype))
    assert torch.isfinite(out.float()).all()
    assert calls == [dtype] * 4
    with torch.enable_grad():
        unet(x.to(dtype), torch.tensor([10, 500]),
             torch.zeros(2, 16, 32, dtype=dtype))
    assert len(calls) == 4  # autograd: the plain version


def test_the_guard_raises_its_own_error():
    """check_reparam_converged refuses with ReparamGuardError, a
    RuntimeError (the reference's type), by both criteria."""
    from polyp_tpu_torch.train.distill import (ReparamGuardError,
                                               check_reparam_converged)

    assert issubclass(ReparamGuardError, RuntimeError)
    with pytest.raises(ReparamGuardError, match="did not close"):
        check_reparam_converged([1.0] * 60, rel_err=0.5)
    with pytest.raises(ReparamGuardError, match="has not converged"):
        check_reparam_converged([1.0] * 48 + [0.1] * 12)


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: an illegal "
                                                "memory access"),
                                   torch.OutOfMemoryError("out of memory")])
def test_distill_ab_lets_other_failures_through(monkeypatch, error):
    """Only the guard's refusal is a REFUSED row: a device or memory
    failure in a student's distillation ends the run."""
    def failing(*args, **kwargs):
        raise error

    monkeypatch.setattr(distill_ab, "distill_progressive", failing)
    with pytest.raises(type(error)):
        distill_ab.main(TINY)


def test_chip_smoke_reads_only_the_guards_refusals():
    """chip_smoke.py's reading of the printed rows: a REFUSED row stands
    for the guard only with the guard's own message."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rows = ("teacher-4step  vs teacher-16step rel RMSE: 0.0821\n"
            "epsilon      -4step vs teacher-16step rel RMSE: 0.0742  "
            "(phase losses [(8, 0.00013)])\n"
            "v_prediction : REFUSED by the convergence guard: reparam "
            "warmup did not close the head switch: student\n")
    assert chip_smoke.distill_ab_rows(rows) == {
        "teacher_4step": 0.0821, "epsilon": 0.0742, "v_prediction": None}
    with pytest.raises(AssertionError, match="not the reparam guard"):
        chip_smoke.distill_ab_rows(rows.replace(
            "reparam warmup did not close the head switch",
            "CUDA error: an illegal memory access"))
