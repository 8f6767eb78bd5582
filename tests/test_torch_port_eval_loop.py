"""The generate → augment → retrain → F1 loop of polyp_tpu_torch on the CPU:
the Fréchet distance and its per-class form and the B0 feature extractor
against polyp_tpu's, `run_augmentation_eval` end to end against the
reference's (the same init, the same draws, the same feature extractor),
the per-class SD workflow (`train_class`, `resume_class`) on the tiny
stack, alone and against polyp_tpu's on the same stack and corpus, and the
three CLIs driving the loop.

Tolerances: Fréchet distances 1e-9 relative (the same float64 numpy);
extracted features 1e-5 relative L2 (fp32 products in another order);
the augmentation eval's losses 1e-5 relative and its metrics equal (the
arguments of a softmax agree far inside their gaps); a resumed top-up's
images within generate_batch's 5e-3 of [0, 1] (one uint8 level).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from polyp_tpu.cli import sd_common as jsd
from polyp_tpu.cli.common import DataLayout as JDataLayout
from polyp_tpu.cli.common import SDStack as JSDStack
from polyp_tpu.configs import ClassificationConfig as JConfig
from polyp_tpu.configs import DiffusionConfig as JDiffusionConfig
from polyp_tpu.eval import fid as jfid
from polyp_tpu.eval import harness as jharness
from polyp_tpu.lora import load_lora as jload_lora
from polyp_tpu.lora import save_lora as jsave_lora
from polyp_tpu.models.clip_text import TINY_TEXT_CONFIG as J_TINY_TEXT
from polyp_tpu.models.clip_tokenizer import HashTokenizer as JHashTokenizer
from polyp_tpu.track import JsonlTracker as JTracker
from polyp_tpu.train.sd_finetune import SDTrainResult
from polyp_tpu.train import classifier as jtc
from polyp_tpu.utils.rng import key_for
from polyp_tpu_torch.cli import (
    eval_augmentation, lora_per_class, sd_common, train_classifier)
from polyp_tpu_torch.cli.common import DataLayout, load_sd_stack
from polyp_tpu_torch.configs import ClassificationConfig, DiffusionConfig
from polyp_tpu_torch.eval import fid as tfid
from polyp_tpu_torch.eval import harness as tharness
from polyp_tpu_torch import pipeline as tpipe
from polyp_tpu_torch.lora import load_lora, save_lora
from polyp_tpu_torch.models import importers as timp
from polyp_tpu_torch.models.importers import efficientnet_from_jax
from polyp_tpu_torch.pipeline import count_samples
from polyp_tpu_torch.track import JsonlTracker
from polyp_tpu_torch.train import classifier as tc
from polyp_tpu_torch.train.dreambooth import resume_prompt
from polyp_tpu_torch.utils.checkpoint import tree_map
from test_torch_efficientnet_golden import fabricate_state_dict
from test_torch_port_classifier import jax_draws
from test_torch_port_lora import jax_tiny_stack, port_tiny_stack
from test_torch_port_train import _nudged

COUNTS = {"train": {"AD": 10, "HP": 4, "ASS": 4},
          "valid": {"AD": 2, "HP": 2, "ASS": 2},
          "test": {"AD": 3, "HP": 3, "ASS": 3}}


def fabricate_corpus(root: Path, seed: int = 0) -> DataLayout:
    """The reference's corpus layout with seeded random .tif images."""
    layout = DataLayout(root)
    rng = np.random.default_rng(seed)
    for split, images, csv in (
            ("train", layout.train_images, layout.train_csv),
            ("valid", layout.val_images, layout.val_csv),
            ("test", layout.test_images, layout.test_csv)):
        images.mkdir(parents=True)
        rows = [(f"{split}_{c}_{i}", c) for c, n in COUNTS[split].items()
                for i in range(n)]
        rows = [rows[i] for i in rng.permutation(len(rows))]
        for image_id, _ in rows:
            Image.fromarray(rng.integers(0, 256, (36, 44, 3), np.uint8)).save(
                images / f"{image_id}.tif")
        csv.write_text("image_id,cls\n" + "".join(
            f"{i},{c}\n" for i, c in rows))
    return layout


def _samples(root: Path, counts: dict, seed: int = 1) -> Path:
    rng = np.random.default_rng(seed)
    for cls, n in counts.items():
        (root / cls).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(
                root / cls / f"{i + 1}.png")
    return root


def _projection(name: str, calibrated: bool, module):
    """One feature extractor for both packages: a fixed random projection
    of the pixels (float64)."""
    w = np.random.default_rng(3).standard_normal((32 * 32 * 3, 6))

    def fn(images_u8):
        return np.asarray(images_u8, np.float64).reshape(
            len(images_u8), -1) @ w / 255.0

    return module.FeatureExtractor(fn, name=name, calibrated=calibrated)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 5))
    b = 0.5 * rng.standard_normal((30, 5)) + 0.3
    got = tfid.feature_statistics(a), tfid.feature_statistics(b)
    want = jfid.feature_statistics(a), jfid.feature_statistics(b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    d = tfid.frechet_distance(*got[0], *got[1])
    assert d == pytest.approx(jfid.frechet_distance(*want[0], *want[1]),
                              rel=1e-9)
    assert d > 0.1
    assert tfid.frechet_distance(*got[0], *got[0]) == pytest.approx(
        0.0, abs=1e-9)


def test_class_frechet_distances_matches_jax(tmp_path):
    """Per class, real training images against samples/{cls}; a class with
    one sample is skipped, an empty directory too."""
    layout = fabricate_corpus(tmp_path / "data")
    samples = _samples(tmp_path / "samples", {"AD": 3, "HP": 4, "ASS": 1})
    for ad_vs_rest in (False, True):
        got = tfid.class_frechet_distances(
            layout.train_images, layout.train_csv, samples, ad_vs_rest, 32,
            _projection("p", False, tfid))
        want = jfid.class_frechet_distances(
            layout.train_images, layout.train_csv, samples, ad_vs_rest, 32,
            _projection("p", False, jfid))
        assert sorted(got["per_class"]) == sorted(want["per_class"])
        for cls, v in want["per_class"].items():
            assert got["per_class"][cls] == pytest.approx(v, rel=1e-9)
        assert (got["extractor"], got["calibrated"]) == ("p", False)
    assert sorted(got["per_class"]) == ["AD"]  # REST: HP/ASS dirs unread


def test_efficientnet_extractor_runs_the_ports_b0(tmp_path):
    """The extractor's features are the port's B0 (whose forward and
    torchvision import the classifier tests hold to the reference's) in
    evaluation on the ImageNet-normalised images, calibrated from a
    torchvision state-dict file, and it names itself as the reference's
    does."""
    from polyp_tpu_torch.data.transforms import augment_classifier_batch
    from polyp_tpu_torch.models.efficientnet import EfficientNet
    from polyp_tpu_torch.models.importers import (
        efficientnet_from_torchvision)

    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in fabricate_state_dict(1).items()}
    torch.save(sd, tmp_path / "b0.pt")
    images = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3),
                                               np.uint8)
    extractor = tfid.efficientnet_extractor(32, str(tmp_path / "b0.pt"),
                                            device="cpu")
    model = EfficientNet("b0")
    model.load_state_dict(efficientnet_from_torchvision(sd))
    with torch.no_grad():
        want = model.eval()(augment_classifier_batch(
            torch.from_numpy(images), None, torch.float32)).numpy()
    # batches of 2 and 3 sum the same products in another order
    np.testing.assert_allclose(extractor(images, batch_size=2), want,
                               rtol=1e-5, atol=1e-6)
    assert (extractor.name, extractor.calibrated) == ("efficientnet_b0",
                                                      True)
    random_init = tfid.efficientnet_extractor(32, None, device="cpu")
    assert (random_init.name, random_init.calibrated) == (
        "efficientnet_b0_randominit", False)


def test_run_augmentation_eval_matches_jax(tmp_path, monkeypatch):
    """Retrain on real + generated, score on real, with stochastic depth
    and dropout on: both packages from the reference's init, with the
    reference's draws at every step and one feature extractor; the loss
    histories, the test metrics, the Fréchet distances, and the metrics
    logged into the generator's run."""
    layout = fabricate_corpus(tmp_path / "data")
    samples = _samples(tmp_path / "run" / "samples",
                       {"AD": 2, "HP": 3, "ASS": 3})
    dirs = [str(layout.train_images), str(layout.train_csv),
            str(layout.val_images), str(layout.val_csv),
            str(layout.test_images), str(layout.test_csv), str(samples)]
    kw = dict(image_size=32, batch_size=8, num_epochs=2, variant="tiny",
              mixed_precision="fp32", hidden_features=16)
    jcfg, cfg = JConfig(**kw), ClassificationConfig(**kw)
    jstate, jmodel = jtc.create_classifier_state(
        jcfg, 3, jax.random.PRNGKey(jcfg.seed))
    init = efficientnet_from_jax(jax.device_get(jstate.params),
                                 jax.device_get(jstate.batch_stats))
    create = tharness.create_classifier_state

    def create_from_jax_init(config, num_classes, device):
        state = create(config, num_classes, device)
        state.model.load_state_dict(init)
        return state

    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    monkeypatch.setattr(tharness, "create_classifier_state",
                        create_from_jax_init)
    monkeypatch.setattr(tc, "step_draws", lambda seed, epoch, step, model,
                        n, device: jax_draws(
                            jmodel, variables, (n, 32, 32, 3),
                            key_for(seed, "train", epoch, step), model))
    monkeypatch.setattr(tfid, "efficientnet_extractor",
                        lambda *a, **k: _projection("p", False, tfid))
    monkeypatch.setattr(jfid, "efficientnet_extractor",
                        lambda *a, **k: _projection("p", False, jfid))
    trackers = {}
    for name, mod, tracker_cls, config in (
            ("jax", jharness, JTracker, jcfg),
            ("torch", tharness, JsonlTracker, cfg)):
        tracker = tracker_cls(tmp_path / f"runs_{name}")
        with tracker.start_run(run_id="gen"):
            tracker.log_param("generator", "lora")
        kwargs = {} if name == "jax" else {"device": "cpu"}
        trackers[name] = (tracker, mod.run_augmentation_eval(
            config, mod.AugmentedDataDirs(*dirs), tracker, "gen",
            cache_dir=str(tmp_path / f"cache_{name}"), **kwargs))
    (jt, want), (tt, got) = trackers["jax"], trackers["torch"]
    for k in ("accuracy", "precision", "recall", "f1_score", "report",
              "labels", "train_size"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    assert got["train_size"] == 18 + 8
    assert got["frechet"]["per_class"] == pytest.approx(
        want["frechet"]["per_class"], rel=1e-9)
    logged = {n: {m["key"]: m["value"] for m in t.read_metrics("gen")}
              for n, t in (("jax", jt), ("torch", tt))}
    assert sorted(logged["torch"]) == sorted(logged["jax"])
    assert "f1_score" in logged["torch"] and "frechet_AD" in logged["torch"]
    for k, v in logged["jax"].items():
        assert logged["torch"][k] == pytest.approx(v, rel=1e-5), k


FLAGS = sd_common.SDFlags(train_text_encoder=True, dreambooth=True,
                          add_visual_influence=True, unfreeze_layers=True)


def _tiny_stack():
    return load_sd_stack(None, dtype=torch.float32, tiny=True, device="cpu",
                         seed=0)


def test_train_class_then_resume_class_in_a_new_process(tmp_path):
    """Two classes trained in one process with every flag on (their
    DreamBooth tokens get the ids base and base + 1); the files written and
    the bundle's keys; then a fresh stack (a new process's tokenizer, where
    HP's token gets id base) resumes HP with one sample deleted: nothing
    is trained, the sample is written again under its name, and the
    top-up's image is the one the training process's stack gives for the
    resume prompt (within 5e-3)."""
    layout = fabricate_corpus(tmp_path / "data")
    folder = tmp_path / "run"
    config = DiffusionConfig(image_size=32, num_epochs=1, eval_batch_size=2,
                             num_inference_steps=2)
    class_map = {"AD": ["AD"], "HP": ["HP"]}
    stack = _tiny_stack()
    tracker = JsonlTracker(tmp_path / "mlruns")
    with tracker.start_run(run_id="gen"):
        for cls, steps in (("AD", 2), ("HP", 1)):  # 12 and 6 images
            out = sd_common.train_class(stack, config, layout, folder, cls,
                                        class_map, 3, FLAGS, tracker)
            assert out["images"] == 3 and out["steps"] == steps
    for cls in ("AD", "HP"):
        assert sorted(p.name for p in (folder / "samples" / cls).iterdir()) \
            == ["1.png", "2.png", "3.png"]
        bundle = load_lora(folder / f"lora_{cls}")
        assert sorted(bundle) == ["proj", "special_ids", "special_rows",
                                  "text_lora", "unet_lora", "unfrozen"]
        assert (folder / f"loss_history_{cls}.png").exists() or (
            folder / f"loss_history_{cls}.json").exists()
    base = stack.tokenizer.convert_tokens_to_ids("sks")
    assert load_lora(folder / "lora_HP")["special_ids"].tolist() == [base + 1]
    params = tracker.read_params("gen")
    assert params["frechet_extractor"] == "efficientnet_b0_randominit"
    assert {m["key"] for m in tracker.read_metrics("gen")} >= {
        "train_loss_AD", "train_loss_HP", "frechet_AD", "frechet_HP"}

    # what the training process's stack gives for HP's resume prompt
    merged = sd_common.restore_class_params(stack, config, folder, "HP")
    sampler = sd_common.make_sampler(merged, config).for_prompt(
        resume_prompt("HP", False))
    from polyp_tpu_torch.pipeline import images_uint8
    want = images_uint8(sampler(1, config.seed + 1))[0].numpy()

    (folder / "samples" / "HP" / "3.png").unlink()
    fresh = _tiny_stack()
    before = {k: v.clone() for k, v in fresh.unet.state_dict().items()}
    out = sd_common.resume_class(fresh, config, folder, "HP", 3, FLAGS)
    assert out["images"] == 1
    assert fresh.tokenizer.convert_tokens_to_ids("zbt") == base
    assert sd_common.resume_class(fresh, config, folder, "AD", 3,
                                  FLAGS) == {"images": 0, "generate_s": 0.0}
    assert count_samples(folder / "samples" / "HP") == 3
    got = np.asarray(Image.open(folder / "samples" / "HP" / "3.png"))
    assert np.abs(got.astype(int) - want.astype(int)).max() / 255 <= 5e-3
    for k, v in fresh.unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert sd_common.resume_class(fresh, config, folder, "ASS", 3,
                                  FLAGS) is None


def _jax_sd_stack() -> JSDStack:
    """polyp_tpu's SDStack over the reference's tiny stack with the weights
    port_tiny_stack carries (fp32), with a fresh tokenizer."""
    unet, up, vae, vp, text, tp = jax_tiny_stack()
    arrays = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    return JSDStack(unet, arrays(up), vae, {"params": arrays(vp)}, text,
                    {"params": arrays(tp)},
                    JHashTokenizer(vocab_size=J_TINY_TEXT.vocab_size,
                                   max_length=J_TINY_TEXT.max_length), False)


def _reference_latents(monkeypatch):
    """The port's samplers start from the reference's initial latents for
    the seed of their generator: jax.random.normal(PRNGKey(seed), NHWC),
    handed over as NCHW."""
    generate = tpipe.StableDiffusionSampler.generate

    def from_reference(self, cond, uncond, batch_size, generator=None,
                       init=None):
        if init is None:
            s = self.image_size // 8
            a = np.asarray(jax.random.normal(
                jax.random.PRNGKey(generator.initial_seed()),
                (batch_size, s, s, 4), jnp.float32))
            init = torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
        return generate(self, cond, uncond, batch_size, generator, init)

    monkeypatch.setattr(tpipe.StableDiffusionSampler, "generate",
                        from_reference)


def test_train_class_and_resume_class_match_the_reference(tmp_path,
                                                          monkeypatch):
    """Both packages' train_class on the same tiny stack and corpus, AD
    then HP in one process with every flag on but the visual-influence
    projection (the reference's train_class sizes it for SD-v1-4's
    768-wide text, which the tiny stack's 32-wide text cannot take; the
    port's is tested above): the same files, the same bundle entries and
    shapes (the reference's carried by trainable_from_jax) and the same
    DreamBooth token ids (base, then base + 1). The adapters start from
    each package's own draws, so only their layout is compared, and the
    reference's epoch loop returns its state untrained (its updates are
    tests/test_torch_port_train_loop.py's; compiling it twice would
    triple this test's time).

    Then the reference's HP bundle, every entry moved off its init (so
    each merge and overlay changes the images), is resumed with one
    sample deleted by both packages' resume_class, each in a fresh stack
    (a new process's tokenizer: HP's token at base) from the same initial
    latents, the port's from the bundle carried to its layout: the
    regenerated batch's images agree within generate_batch's 5e-3 of
    [0, 1] (one uint8 level)."""
    layout = fabricate_corpus(tmp_path / "data")
    sizes = dict(image_size=32, num_epochs=1, eval_batch_size=2,
                 num_inference_steps=2)
    jcfg, cfg = JDiffusionConfig(**sizes), DiffusionConfig(**sizes)
    flags = dataclasses.replace(FLAGS, add_visual_influence=False)
    jflags = jsd.SDFlags(**dataclasses.asdict(flags))
    class_map = {"AD": ["AD"], "HP": ["HP"]}
    runs = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
    monkeypatch.setattr(jsd, "train_sd_lora", lambda config, state, *args,
                        **kwargs: (state, SDTrainResult()))
    jstack, stack = _jax_sd_stack(), port_tiny_stack()
    for cls in class_map:
        jsd.train_class(jstack, jcfg, JDataLayout(layout.root), runs["jax"],
                        cls, class_map, 2, jflags)
        sd_common.train_class(stack, cfg, layout, runs["torch"], cls,
                              class_map, 2, flags)
    listing = {name: sorted(str(p.relative_to(run) if p.is_file() else
                                p.relative_to(run).parts[0])
                            for p in run.rglob("*")
                            if p.parent == run or "samples" in p.parts)
               for name, run in runs.items()}
    assert listing["torch"] == listing["jax"]
    assert "samples/HP/2.png" in listing["jax"]
    base = J_TINY_TEXT.vocab_size
    for i, cls in enumerate(class_map):
        want = dict(jload_lora(runs["jax"] / f"lora_{cls}"))
        got = load_lora(runs["torch"] / f"lora_{cls}")
        assert sorted(got) == sorted(want)
        assert np.asarray(want.pop("special_ids")).tolist() == \
            got.pop("special_ids").tolist() == [base + i]
        shapes = functools.partial(tree_map, lambda t: tuple(t.shape))
        assert shapes(got) == shapes(timp.trainable_from_jax(want))

    bundle = dict(jload_lora(runs["jax"] / "lora_HP"))
    ids = np.asarray(bundle.pop("special_ids"))
    bundle = _nudged(bundle, 60)
    jsave_lora(runs["jax"] / "lora_HP", {**bundle, "special_ids": ids})
    resumed = tmp_path / "resume"
    save_lora(resumed / "lora_HP", {**timp.trainable_from_jax(bundle),
                                    "special_ids": torch.tensor(ids)})
    shutil.copytree(runs["jax"] / "samples" / "HP",
                    resumed / "samples" / "HP")
    for run in (runs["jax"], resumed):
        (run / "samples" / "HP" / "2.png").unlink()
    fresh = _jax_sd_stack()
    assert jsd.resume_class(fresh, jcfg, runs["jax"], "HP", 2, jflags)
    assert fresh.tokenizer.convert_tokens_to_ids("zbt") == base
    _reference_latents(monkeypatch)
    fresh = port_tiny_stack()
    # the partial batch is regenerated whole: 1.png and 2.png
    assert sd_common.resume_class(fresh, cfg, resumed, "HP", 2,
                                  flags)["images"] == 2
    assert fresh.tokenizer.convert_tokens_to_ids("zbt") == base
    for name in ("1.png", "2.png"):
        got, want = (np.asarray(Image.open(run / "samples" / "HP" / name),
                                dtype=int) for run in (resumed, runs["jax"]))
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got - want).max() / 255 <= 5e-3, name


def test_clis_run_the_loop_on_the_cpu(tmp_path, monkeypatch):
    """polyp-lora-per-class (tiny stack), again with a sample deleted (the
    resume branch), polyp-train-classifier and polyp-eval-augmentation,
    each through main(argv) with --device cpu: samples to the quotas, the
    register row, and the augmented metrics logged into the generator's
    run."""
    layout = fabricate_corpus(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    common = ["--data-root", str(layout.root), "--cache-dir",
              str(tmp_path / "cache"), "--tracker-root",
              str(tmp_path / "mlruns"), "--device", "cpu"]
    argv = common + ["--folder", str(tmp_path / "run"), "--classes_to_train",
                     "AD", "REST", "--num_imgs_to_generate", "2", "3",
                     "--num_epochs", "1", "--image_size", "32", "--tiny"]
    first = lora_per_class.main(argv)
    assert {c: r["trained"] for c, r in first["classes"].items()} == {
        "AD": True, "REST": True}
    (tmp_path / "run" / "samples" / "REST" / "1.png").unlink()
    second = lora_per_class.main(argv + ["--run_id", first["run_id"]])
    assert second["run_id"] == first["run_id"]
    assert second["classes"]["REST"]["trained"] is False
    assert second["classes"]["REST"]["images"] == 3
    assert count_samples(tmp_path / "run" / "samples" / "REST") == 3
    metrics = train_classifier.main(common + [
        "--variant", "tiny", "--image_size", "32", "--num_epochs", "1",
        "--batch_size", "8", "--weighted_sampling", "--one_vs_all",
        "--output-dir", str(tmp_path / "models")])
    assert set(metrics["labels"]) <= {"AD", "HP"}  # HP names class 1
    rows = (tmp_path / "results" / "parameters_register.csv").read_text()
    assert "weighted sampling" in rows and "ad vs rest" in rows
    augmented = eval_augmentation.main(common + [
        "--path_model", str(tmp_path / "run"), "--run_id", first["run_id"],
        "--ad_vs_rest", "--image_size", "32", "--num_epochs", "1",
        "--batch_size", "8"])
    assert augmented["train_size"] == 18 + 5
    for k in ("accuracy", "precision", "recall", "f1_score"):
        assert 0.0 <= augmented[k] <= 1.0
    run_dir = next((tmp_path / "mlruns").glob(f"*/{first['run_id']}"))
    keys = {json.loads(line)["key"] for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()}
    assert {"train_loss_AD", "train_loss_REST", "f1_score",
            "test_accuracy"} <= keys
    params = json.loads((tmp_path / "run" / "params.json").read_text())
    assert params["ad_vs_rest"] is True
