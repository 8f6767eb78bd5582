"""The crash-recovery contract of the port's trainers, end to end: the
twin of tests/test_cli_smoke.py::TestKillResume.

A real training CLI process (`python -m polyp_tpu_torch.cli.
train_classifier` and `... .train_scratch`, on the CPU) is SIGKILLed right
after epoch 0's snapshot by `POLYP_TPU_CRASH_AT=epoch:0`
(polyp_tpu_torch/utils/faults.py), called again with the same flags, and
must end with the same final checkpoint as an uninterrupted twin run in a
fresh directory: every tensor of it bit-equal (torch.save's files differ
in their archive's serialization id, so the tensors' bytes are compared,
not the files'). The scratch CLI's samples, drawn after training, must
be byte-equal PNGs too. Every subprocess has a timeout.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

from polyp_tpu_torch.utils.checkpoint import load_pytree, tree_leaves
from test_torch_port_eval_loop import fabricate_corpus
from _torch_threads import _one_thread  # noqa: F401


REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def _run(module: str, args: list[str], workdir: Path,
         crash_at: str | None = None) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # one CPU thread a process: the models are tiny, and the suite runs
    # beside other workers
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("POLYP_TPU_CRASH_AT", None)
    if crash_at is not None:
        env["POLYP_TPU_CRASH_AT"] = crash_at
    return subprocess.run(
        [sys.executable, "-m", f"polyp_tpu_torch.cli.{module}", *args,
         "--device", "cpu"], cwd=workdir, env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)


def _kill_resume_twin(module: str, args, workdir: Path, resumed: Path,
                      twin: Path, ckpt: Path) -> None:
    """The three runs: armed (killed after epoch 0's snapshot), called
    again (resumes epoch 1 and finishes), and the twin without
    snapshots."""
    killed = _run(module, args(resumed) + ["--ckpt-every", "1"], workdir,
                  crash_at="epoch:0")
    assert killed.returncode == -9, (killed.returncode,
                                     killed.stderr[-2000:])
    assert (ckpt / "latest.json").exists(), "no snapshot before the kill"
    again = _run(module, args(resumed) + ["--ckpt-every", "1"], workdir)
    assert again.returncode == 0, again.stderr[-2000:]
    whole = _run(module, args(twin), workdir)
    assert whole.returncode == 0, whole.stderr[-2000:]


def _assert_bit_equal(a: Path, b: Path) -> None:
    la, lb = tree_leaves(load_pytree(a)), tree_leaves(load_pytree(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.numpy().tobytes() == y.numpy().tobytes()
        else:
            assert x == y


def test_classifier_cli_sigkill_then_resume_matches_uninterrupted(
        tmp_path):
    layout = fabricate_corpus(tmp_path / "data")

    def args(out: Path) -> list[str]:
        return ["--data-root", str(layout.root),
                "--cache-dir", str(tmp_path / "cache"),
                "--tracker-root", str(tmp_path / "runs"),
                "--image_size", "16", "--batch_size", "4",
                "--num_epochs", "2", "--hidden_features", "8",
                "--variant", "tiny", "--output-dir", str(out),
                "--register", str(tmp_path / "reg.csv")]

    resumed, twin = tmp_path / "resumed", tmp_path / "twin"
    _kill_resume_twin("train_classifier", args, tmp_path, resumed, twin,
                      resumed / "ckpt")

    def best(out: Path) -> Path:
        files = list(out.glob("classifier_*.pt"))
        assert len(files) == 1, files
        return files[0]

    _assert_bit_equal(best(resumed), best(twin))


def test_scratch_cli_sigkill_then_resume_matches_uninterrupted(tmp_path):
    layout = fabricate_corpus(tmp_path / "data")

    def args(out: Path) -> list[str]:
        return ["--data-root", str(layout.root),
                "--cache-dir", str(tmp_path / "cache"),
                "--tracker-root", str(tmp_path / "runs"),
                "--tiny", "--one_vs_rest", "--image_size", "16",
                "--num_epochs", "2", "--sample_steps", "2",
                "--ad_minimum", "15", "--output-dir", str(out)]

    resumed, twin = tmp_path / "resumed", tmp_path / "twin"
    # the kill lands in the first class (AD), before its final epoch
    _kill_resume_twin("train_scratch", args, tmp_path, resumed, twin,
                      resumed / "ckpt_AD")
    for cls in ("AD", "REST"):
        _assert_bit_equal(resumed / "models" / f"model_{cls}",
                          twin / "models" / f"model_{cls}")
        got = sorted((resumed / "samples" / cls).iterdir())
        want = sorted((twin / "samples" / cls).iterdir())
        assert [p.name for p in got] == [p.name for p in want] != []
        for g, w in zip(got, want):
            assert g.read_bytes() == w.read_bytes(), g.name
