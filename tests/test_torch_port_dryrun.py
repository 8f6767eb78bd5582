"""The port's multichip dry run (polyp_tpu_torch/parallel/dryrun.py) on the
CPU: `dryrun_multichip(2)` spawns two gloo ranks that run every phase of
the reference's dry run (two LoRA steps, the CFG UniPC fan-out,
generate_batch with pad_to, folded trailing DDIM, the promoted hybrid
w8a8_static with head 1, the distilled w8a8_static, one classifier step)
on the data mesh, and holds each to the same phase in one process within
the module's TOLERANCES (explained there); the trained parameters must be
bit-equal across the ranks. The dry run raises on any failure; each phase
is then checked here against its tolerance and for finiteness.

From 4 ranks the mesh is the reference's `data=2 × model=2`, held to
MODEL_AXIS_TOLERANCES; with Megatron's g skipped in the ranks
(polyp_tpu_torch/tools/dryrun_fault.py) every phase that runs the
sharded UNet must leave its limit.
"""

from __future__ import annotations

import pytest
import torch

from polyp_tpu_torch.parallel import dryrun
from polyp_tpu_torch.tools import dryrun_fault

PHASES = ["lora_loss", "lora_grad", "fan_out", "generate_batch", "folded",
          "promoted_hybrid", "distilled_w8a8", "classifier_loss",
          "classifier_grad"]


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


@pytest.fixture(scope="module")
def report():
    return dryrun.dryrun_multichip(2, device="cpu", timeout=600)


def test_the_dry_run_runs_two_gloo_ranks(report):
    assert report["ranks"] == 2 and report["backend"] == "gloo"
    assert sorted(report["errors"]) == sorted(PHASES)


@pytest.mark.parametrize("phase", PHASES)
def test_each_phase_matches_its_one_process_run(report, phase):
    err = report["errors"][phase]
    limit = dryrun.TOLERANCES.get(phase, dryrun.TOLERANCES["images"])
    assert 0.0 <= err <= limit, (phase, err, limit)


def test_compare_refuses_a_phase_past_its_tolerance():
    single = {"fan_out": torch.zeros(2, 3), "lora_checksum": 1}
    with pytest.raises(AssertionError, match="fan_out"):
        dryrun.compare({"fan_out": torch.full((2, 3), 1e-3)}, single)
    with pytest.raises(AssertionError, match="shape"):
        dryrun.compare({"fan_out": torch.zeros(3, 3)}, single)
    assert dryrun.compare({"fan_out": torch.zeros(2, 3)}, single) == {
        "fan_out": 0.0}


# the phases that run the model axis's sharded UNet
SHARDED = ["lora_grad", "fan_out", "generate_batch", "folded",
           "promoted_hybrid", "distilled_w8a8"]


def _limit(phase):
    return dryrun.MODEL_AXIS_TOLERANCES.get(
        phase, dryrun.MODEL_AXIS_TOLERANCES["images"])


def test_the_2x2_mesh_holds_every_phase_to_one_process():
    report = dryrun.dryrun_multichip(4, device="cpu", timeout=600)
    assert report["mesh"] == "data=2,model=2"
    assert report["tolerances"] == dryrun.MODEL_AXIS_TOLERANCES
    for phase in PHASES:
        assert 0.0 <= report["errors"][phase] <= _limit(phase), phase


@pytest.fixture(scope="module")
def skipped_g():
    return dryrun_fault.readings(4, "cpu", "skip_g", timeout=600)


@pytest.mark.parametrize("phase", SHARDED)
def test_a_skipped_g_leaves_the_model_axis_limit(skipped_g, phase):
    assert skipped_g["errors"][phase] > _limit(phase), (
        phase, skipped_g["errors"][phase])
