"""polyp-verify-assets-torch (polyp_tpu_torch/cli/verify_assets.py) on a
tiny diffusers-layout checkpoint fabricated with the reference's tiny
weights (test_torch_port_lora.write_diffusers_dir): the counterparts of
tests/test_verify_assets.py's cases, on the CPU. The quant gate is a
temporary verdict (the port's GATE_PATH pointed at it); its throughput
half is fed fixed rates (int8 above bf16), because host-clock rates on a
shared CPU are noise, so the runbook's verdict is decided by the measured
rel-L2 here."""

from __future__ import annotations

import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from polyp_tpu.cli import verify_assets as jverify
from polyp_tpu.models import importers as jimp
from polyp_tpu_torch.cli import verify_assets
from polyp_tpu_torch.cli.common import load_sd_stack
from polyp_tpu_torch.ops import quant as tq
from polyp_tpu_torch.tools import quant_sensitivity as qs
from test_torch_port_lora import jax_tiny_stack, write_diffusers_dir

TINY = ["--tiny", "--device", "cpu", "--image_size", "32", "--steps", "2"]
PACKAGE_GATE = tq.GATE_PATH

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
def checkpoint(tmp_path_factory):
    return write_diffusers_dir(tmp_path_factory.mktemp("sd"), "safetensors")


@pytest.fixture
def gate(tmp_path, monkeypatch):
    """A temporary verdict whose entries pass, and fixed rates."""
    path = tmp_path / "gate" / "quant_gate.json"
    path.parent.mkdir()
    path.write_text(json.dumps({
        "gate_rel_l2": 0.05,
        "promoted": {"mode": "w8a8_static", "quant_fp_head": 1,
                     "quant_fp_tail": 0, "gate_pass": True},
        "promoted_distilled": {"mode": "w8a8_static", "quant_fp_head": 0,
                               "quant_fp_tail": 0, "gate_pass": True}}))
    monkeypatch.setattr(tq, "GATE_PATH", path)
    monkeypatch.setenv("POLYP_TORCH_QUANT_CACHE", str(tmp_path / "qc"))

    def fixed(runs, batch, timed_runs=qs.TIMED_RUNS):
        return ({name: fn() for name, fn in runs.items()},
                {"bf16": 1.0, "q": 2.0})

    monkeypatch.setattr(qs, "median_rates", fixed)
    return path


def _rows(out) -> dict:
    return {r["check"]: r for r in json.loads((out / "report.json")
                                                .read_text())}


def test_runbook_passes_on_valid_fabricated_assets(checkpoint, gate,
                                                   tmp_path):
    out = tmp_path / "out"
    rc = verify_assets.main(["--pretrained-dir", str(checkpoint), *TINY,
                             "--gate_batch", "2", "--fixtures-dir", str(out)])
    by = _rows(out)
    assert rc == 0, by
    assert len(by) == 7
    assert by["checkpoint-leaves"]["status"] == "pass"
    assert by["sampler-fixtures"]["status"] == "pass"
    assert by["quant-gate"]["status"] == "pass"
    assert by["tokenizer-assets"]["status"] == "skip"
    assert by["text-golden"]["status"] == "skip"
    assert by["fid-calibration"]["status"] == "skip"
    assert by["downstream-f1"]["status"] == "skip"
    assert ("polyp-lora-per-class-torch" in by["downstream-f1"]["detail"]
            and "polyp-eval-augmentation-torch"
            in by["downstream-f1"]["detail"])
    fx = json.loads((out / "sampler_fixtures.json").read_text())
    assert fx["pretrained"] is True and len(fx["sha256_16"]) == 3
    assert len(set(fx["sha256_16"].values())) == 3
    assert (out / "sampler_seed0.npy").exists()
    regate = json.loads((out / "quant_gate_remeasured.json").read_text())
    assert regate["promoted"]["rel_l2_real"] < 0.05
    assert regate["promoted"]["samples_per_sec_real"] == 2.0
    assert regate["promoted_distilled"]["gate_pass"] is True
    assert {"rel_l2_8step_real", "rel_l2_4step_real",
            "samples_per_sec_8step_batch2",
            "bf16_samples_per_sec_4step_batch4"} <= set(
                regate["promoted_distilled"])


def test_runbook_fails_on_corrupt_checkpoint(checkpoint, tmp_path):
    broken = tmp_path / "broken"
    shutil.copytree(checkpoint, broken)
    path = broken / "unet" / "diffusion_pytorch_model.safetensors"
    path.unlink()
    sd = load_sd_stack(str(checkpoint), torch.float32, tiny=True,
                       device="cpu").unet.state_dict()
    sd[sorted(sd)[0]] = torch.zeros(3, 3, 3)  # wrong shape
    torch.save(sd, path.with_suffix(".bin"))
    out = tmp_path / "out"
    rc = verify_assets.main(["--pretrained-dir", str(broken), *TINY,
                             "--skip-quant-gate", "--skip-fixtures",
                             "--fixtures-dir", str(out)])
    assert rc == 1
    assert _rows(out)["checkpoint-leaves"]["status"] == "fail"


def test_missing_directory_is_a_fail_row(tmp_path):
    """load_sd_stack raises FileNotFoundError for a directory that is not
    there; the runbook reports it as a fail row and exits 1."""
    out = tmp_path / "out"
    rc = verify_assets.main(["--pretrained-dir", str(tmp_path / "nope"),
                             *TINY, "--skip-quant-gate", "--skip-fixtures",
                             "--fixtures-dir", str(out)])
    row = _rows(out)["checkpoint-leaves"]
    assert rc == 1 and row["status"] == "fail"
    assert "FileNotFoundError" in row["detail"]


def test_apply_gate_writes_only_the_ports_file(checkpoint, gate, tmp_path):
    package_bytes = PACKAGE_GATE.read_bytes()
    before = gate.read_text()
    out = tmp_path / "out"
    rc = verify_assets.main(["--pretrained-dir", str(checkpoint), *TINY,
                             "--gate_batch", "2", "--skip-fixtures",
                             "--apply-gate", "--fixtures-dir", str(out)])
    assert rc == 0
    after = json.loads(gate.read_text())
    assert gate.read_text() != before
    assert after == json.loads(
        (out / "quant_gate_remeasured.json").read_text())
    assert "rel_l2_real" in after["promoted"]
    assert PACKAGE_GATE.read_bytes() == package_bytes


def test_suspicious_leaf_rule_matches_the_reference(checkpoint, tmp_path,
                                                    monkeypatch):
    """One all-zero conv kernel in a copy of the checkpoint: the port's rule
    and the reference's check_checkpoint (its loader given the same
    directory's import) flag one leaf each, in the same part, of the same
    size; the 1-D zero biases of real checkpoints are not flagged."""
    zeroed = tmp_path / "zeroed"
    shutil.copytree(checkpoint, zeroed)
    path = zeroed / "unet" / "diffusion_pytorch_model.safetensors"
    sd = load_sd_stack(str(checkpoint), torch.float32, tiny=True,
                       device="cpu").unet.state_dict()
    name = "down_blocks.0.resnets.0.conv1.weight"
    sd[name] = torch.zeros_like(sd[name])
    sd["down_blocks.0.resnets.0.conv1.bias"] = torch.zeros_like(
        sd["down_blocks.0.resnets.0.conv1.bias"])
    path.unlink()
    torch.save(sd, path.with_suffix(".bin"))

    n, bad = verify_assets.suspicious_leaves(
        load_sd_stack(str(zeroed), tiny=True, device="cpu"))
    assert n > 0 and len(bad) == 1
    assert bad[0].startswith("unet: all-zero kernel " + name)

    _, up, _, vp, _, tp = jax_tiny_stack()
    loaded = jimp.load_sd_checkpoint(zeroed, unet_like=up, vae_like=vp,
                                     text_like=tp)
    monkeypatch.setattr(
        "polyp_tpu.cli.common.load_sd_stack",
        lambda *args, **kwargs: SimpleNamespace(
            pretrained=True, unet_params=loaded["unet"],
            vae_params=loaded["vae"], text_params=loaded["text"]))
    report: list = []
    jverify.check_checkpoint(SimpleNamespace(pretrained_dir=str(zeroed),
                                             tiny=True), report)
    (row,) = report
    assert row["status"] == "fail"
    assert row["detail"].startswith("1 suspicious leaves: ['unet: all-zero "
                                    "kernel (")
    shape = tuple(int(v) for v in row["detail"].split("(")[1].split(")")[0]
                  .split(","))
    assert sorted(shape) == sorted(sd[name].shape)
