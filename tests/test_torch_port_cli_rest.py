"""The port's remaining CLIs beside polyp_tpu's on the CPU:
polyp-train-scratch, polyp-lora-all-classes, polyp-finetune-pretrained,
polyp-inspect-lora and polyp-data-analysis, and `fid_between_dirs`.

Each pair runs through `main(argv)` on one fabricated corpus in the
reference's layout (tests/test_torch_port_eval_loop.py) with the tiny
models, and must write the same files: sample PNGs by name, model and
adapter entries by name (the reference writes orbax directories, the
port one file each), the same bundle entries and shapes (the reference's
carried by importers.trainable_from_jax), and the same tracker params.
Values are the parity tests' (test_torch_port_scratch.py,
test_torch_port_train.py): the two packages draw their initial weights
and noise from different generators, so the samples themselves differ.
On the reference's side the model work is stubbed, so that its CLIs' own
control flow (classes, quotas, file names, checkpoints, tracker calls)
runs without running its models op by op or compiling them: its models'
parameters are made from their shapes (`jax.eval_shape`, the tiny SD
stack of tests/test_torch_port_eval_loop.py) instead of an eager init,
its epoch loops return their state untrained (the scratch loop calling
its final-epoch hook, as the real loop does), and its samplers return
blank images (their updates and trajectories are
tests/test_torch_port_train_loop.py's, test_torch_port_scratch.py's and
test_torch_port_pipeline.py's). Both
packages' per-class Fréchet distance runs on one cheap feature
extractor. The port's CLIs run whole.

Tolerances: the analysis tables equal (integer counts, the same
divisions); the Fréchet distance 1e-9 relative (the same float64 numpy
on one feature extractor).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from polyp_tpu.cli import finetune_pretrained as jft
from polyp_tpu.cli import inspect_lora as jinspect
from polyp_tpu.cli import lora_all_classes as jlac
from polyp_tpu.cli import sd_common as jsd
from polyp_tpu.cli import train_scratch as jscratch
from polyp_tpu.eval import analysis as janalysis
from polyp_tpu.eval import fid as jfid
from polyp_tpu.lora import load_lora as jload_lora
from polyp_tpu.train import scratch_ddpm as jddpm
from polyp_tpu.train.sd_finetune import SDTrainResult
from polyp_tpu_torch.cli import (
    finetune_pretrained, inspect_lora, lora_all_classes, train_scratch)
from polyp_tpu_torch.eval import analysis
from polyp_tpu_torch.eval import fid as tfid
from polyp_tpu_torch.lora import load_lora
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.utils.checkpoint import load_pytree, tree_map
from test_torch_port_eval_loop import (
    _jax_sd_stack, _projection, _samples, fabricate_corpus)
from _torch_threads import _one_thread  # noqa: F401


def _untrained(monkeypatch, module):
    """The reference's LoRA epoch loop in `module`, returning its state as
    it came."""
    monkeypatch.setattr(module, "train_sd_lora", lambda config, state,
                        *args, **kwargs: (state, SDTrainResult()))


def _blank(size: int):
    """A reference batch sampler: (batch size, key) → blank NHWC images."""
    return lambda batch_size, key: jnp.zeros((batch_size, size, size, 3))


class _BlankSD:
    """The reference's StableDiffusionSampler, as `make_sampler` returns
    it, drawing blank images."""

    def __init__(self, stack, unet_params, text_params, config, *args,
                 **kwargs):
        self.size = config.image_size

    def for_prompt(self, prompt):
        return _blank(self.size)


def _listing(root: Path, keep=("samples",)) -> list[str]:
    """Top-level entries by name, and every file under `keep`
    directories by relative path."""
    return sorted({str(p.relative_to(root)) if p.is_file() and any(
        k in p.relative_to(root).parts for k in keep)
        else p.relative_to(root).parts[0] for p in root.rglob("*")})


def _run_params(tracker_root: Path) -> dict:
    """The params of the single run under a JSONL tracker root."""
    files = list(tracker_root.glob("*/*/params.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


def _common(tmp: Path, data: Path, name: str) -> list[str]:
    return ["--data-root", str(data), "--cache-dir", str(tmp / f"cache_{name}"),
            "--tracker-root", str(tmp / f"mlruns_{name}")]


def test_train_scratch_cli_matches_the_reference(tmp_path, monkeypatch):
    """polyp-train-scratch --tiny beside the reference's on one corpus
    (--one_vs_rest, 16 px, one epoch, 2 DDIM sample steps, quotas AD 5 /
    REST 2): the same sample files, model entries and tracker params."""
    layout = fabricate_corpus(tmp_path / "data")
    monkeypatch.chdir(tmp_path)

    def untrained(config, state, schedule, loader, text_embeddings=None,
                  log=None, epoch_callback=None, checkpointer=None):
        epoch_callback(config.num_epochs - 1, state)
        return state, jddpm.DDPMTrainResult()

    def shaped_state(config, model, rng, image_size=None, context_dim=None):
        size = image_size or config.image_size
        shapes = jax.eval_shape(model.init, {"params": rng},
                                jnp.zeros((1, size, size, 3)),
                                jnp.zeros((1,), jnp.int32))["params"]
        params = jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, a.dtype), shapes)
        tx = jddpm.make_ddpm_optimizer(config)
        return jddpm.DDPMState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params), tx=tx,
                               apply_fn=model.apply)

    monkeypatch.setattr(jscratch, "create_ddpm_state", shaped_state)
    monkeypatch.setattr(jscratch, "train_scratch_ddpm", untrained)
    monkeypatch.setattr(jscratch, "PixelDiffusionSampler",
                        lambda model, params, schedule, size, *args,
                        **kwargs: _blank(size))
    flags = ["--tiny", "--one_vs_rest", "--image_size", "16",
             "--num_epochs", "1", "--sample_steps", "2", "--ad_minimum", "15"]
    runs = {}
    for name, main in (("jax", jscratch.main), ("torch", train_scratch.main)):
        out = tmp_path / name
        argv = _common(tmp_path, layout.root, name) + flags + [
            "--output-dir", str(out)]
        main(argv + (["--device", "cpu"] if name == "torch" else []))
        runs[name] = out
    listing = {k: _listing(v) for k, v in runs.items()}
    assert listing["torch"] == listing["jax"]
    assert "samples/REST/2.png" in listing["jax"] and "models" in listing["jax"]
    assert sorted(p.name for p in (runs["jax"] / "models").iterdir()) == \
        sorted(p.name for p in (runs["torch"] / "models").iterdir()) == [
            "model_AD", "model_REST"]
    for cls, quota in (("AD", 5), ("REST", 2)):
        pngs = sorted((runs["torch"] / "samples" / cls).iterdir())
        assert len(pngs) == quota
        assert np.asarray(Image.open(pngs[0])).shape == (16, 16, 3)
        tree = load_pytree(runs["torch"] / "models" / f"model_{cls}")
        assert set(tree) == {"params"}
        assert all(np.isfinite(v.numpy()).all()
                   for v in tree["params"].values())
    assert _run_params(tmp_path / "mlruns_torch") == \
        _run_params(tmp_path / "mlruns_jax")


def test_sd_clis_match_the_reference(tmp_path, monkeypatch, capsys):
    """polyp-lora-all-classes --generate_subsamples (AD and REST, gradient
    accumulation 2) and polyp-finetune-pretrained (one grid of 2 images)
    on the tiny SD stack beside the reference's; then polyp-inspect-lora
    on each package's finetune adapter: the same modules (the port's names
    mapped to the reference's paths), ranks and parameter count."""
    layout = fabricate_corpus(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    _untrained(monkeypatch, jsd)
    _untrained(monkeypatch, jft)
    monkeypatch.setattr(jsd, "make_sampler", _BlankSD)
    monkeypatch.setattr(jft, "make_sampler", _BlankSD)
    for module in (jlac, jft):
        monkeypatch.setattr(module, "load_sd_stack",
                            lambda *args, **kwargs: _jax_sd_stack())
    # the port's quick-mode samples in 2 UniPC steps, not 25 (the CLI has
    # no flag for it): the files, not the images, are compared
    monkeypatch.setattr(lora_all_classes, "DiffusionConfig",
                        functools.partial(lora_all_classes.DiffusionConfig,
                                          num_inference_steps=2))
    # each class's Fréchet distance through one cheap extractor on both
    # sides, not B0 (compiling the reference's B0 would double this
    # test's time; the distances are test_torch_port_eval_loop.py's)
    for module in (jfid, tfid):
        monkeypatch.setattr(module, "efficientnet_extractor",
                            lambda *args, _m=module, **kwargs: _projection(
                                "proj", False, _m))
    size = ["--tiny", "--num_epochs", "1", "--image_size", "32"]
    runs = {}
    for name, main in (("jax", jlac.main), ("torch", lora_all_classes.main)):
        folder = tmp_path / name / "all"
        argv = _common(tmp_path, layout.root, f"all_{name}") + size + [
            "--folder", str(folder), "--one_vs_rest",
            "--generate_subsamples", "--accumulation_steps", "2"]
        main(argv + (["--device", "cpu"] if name == "torch" else []))
        runs[name] = folder
    listing = {k: _listing(v) for k, v in runs.items()}
    assert listing["torch"] == listing["jax"]
    assert "samples/REST/5.png" in listing["jax"]
    for cls in ("AD", "REST"):
        want = timp.trainable_from_jax(dict(jload_lora(
            runs["jax"] / f"lora_{cls}")))
        got = load_lora(runs["torch"] / f"lora_{cls}")
        shapes = lambda t: tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
        assert shapes(got) == shapes(want)

    grids = {}
    for name, main in (("jax", jft.main),
                       ("torch", finetune_pretrained.main)):
        out = tmp_path / name / "ft"
        argv = _common(tmp_path, layout.root, f"ft_{name}") + size + [
            "--output-dir", str(out), "--eval_batch_size", "2",
            "--num_inference_steps", "2"]
        main(argv + (["--device", "cpu"] if name == "torch" else []))
        grids[name] = out
    listing = {k: _listing(v) for k, v in grids.items()}
    assert listing["torch"] == listing["jax"] == [
        "lora_weights", "samples", "samples/0000/1.png",
        "samples/0000/2.png"]

    capsys.readouterr()
    jinspect.main([str(grids["jax"] / "lora_weights")])
    want = capsys.readouterr().out
    got = inspect_lora.main([str(grids["torch"] / "lora_weights")])
    jmodules = [line[2:] for line in want.splitlines()
                if line.startswith("- ")]
    assert sorted(timp.jax_module_path(m).replace("/", ".")
                  for m in got["modules"]) == jmodules
    assert f"rank(s) {got['ranks']}" in want and got["ranks"] == [4]
    assert f"{got['params']:,} adapter params" in want


def test_new_clis_default_to_the_card(tmp_path):
    """Without --device, the three CLIs that run models build on CUDA and
    raise where there is no card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    layout = fabricate_corpus(tmp_path / "data")
    common = _common(tmp_path, layout.root, "card") + ["--tiny"]
    for main, extra in (
            (train_scratch.main, ["--output-dir", str(tmp_path / "s")]),
            (lora_all_classes.main, ["--folder", str(tmp_path / "a")]),
            (finetune_pretrained.main, ["--output-dir", str(tmp_path / "f")])):
        with pytest.raises(RuntimeError, match="no card|CUDA"):
            main(common + extra)


def test_analysis_matches_the_reference(tmp_path, capsys):
    """split_stats (columns in first-appearance order, 0 where a split
    lacks a class), class_distribution (pandas' value_counts order, ties
    in first-appearance order) and imbalance_ratio against the
    reference's pandas on one corpus; main writes the pies (or their
    JSON)."""
    root = tmp_path / "data"
    layout = fabricate_corpus(root)
    # a split with a class missing, and a tie between two others
    layout.test_csv.write_text("image_id,cls\n1,HP\n2,ASS\n3,AD\n4,AD\n"
                               "5,ASS\n6,HP\n7,AD\n")
    layout.val_csv.write_text("image_id,cls\n1,HP\n2,HP\n3,ASS\n")
    csvs = {"train": layout.train_csv, "valid": layout.val_csv,
            "test": layout.test_csv}
    want = janalysis.split_stats(csvs)
    got = analysis.split_stats(csvs)
    assert [list(r) for r in got] == [list(want.columns)] * len(got)
    assert got == want.to_dict("records")
    for csv in csvs.values():
        want_d = janalysis.class_distribution(csv)
        got_d = analysis.class_distribution(csv)
        assert list(got_d.items()) == list(want_d.items())
        assert analysis.imbalance_ratio(csv) == janalysis.imbalance_ratio(csv)
    assert list(analysis.class_distribution(layout.test_csv)) == [
        "AD", "HP", "ASS"]
    rows = analysis.main(["--data-root", str(root), "--out",
                          str(tmp_path / "pies.png")])
    assert rows == got
    out = capsys.readouterr().out
    assert "train imbalance ratio: 2.50" in out
    assert (tmp_path / "pies.png").exists() or (
        tmp_path / "pies.json").exists()


def test_fid_between_dirs_matches_the_reference(tmp_path):
    """Both packages' fid_between_dirs over two sample directories with one
    feature extractor (a fixed projection of the pixels): the distance
    within 1e-9 relative, and the same extractor name, calibration flag
    and counts."""
    _samples(tmp_path / "a", {"x": 5}, seed=1)
    _samples(tmp_path / "b", {"x": 4}, seed=2)
    real, fake = tmp_path / "a" / "x", tmp_path / "b" / "x"
    want = jfid.fid_between_dirs(real, fake, _projection("proj", False, jfid),
                                 image_size=32)
    got = tfid.fid_between_dirs(real, fake, _projection("proj", False, tfid),
                                image_size=32)
    assert got["frechet_distance"] == pytest.approx(
        want["frechet_distance"], rel=1e-9)
    assert {k: v for k, v in got.items() if k != "frechet_distance"} == {
        k: v for k, v in want.items() if k != "frechet_distance"}
    assert got["n_real"] == 5 and got["n_fake"] == 4
