"""The port's data layer, eval helpers, tracker and plotting against
polyp_tpu's on the CPU, on a fabricated `.tif` corpus: tables (the label
maps, REST merging and first-appearance label order), image IO and the
npz cache, weighted sampling and the Loader's batches, the classifier's
augmentation, quotas, metrics, the experiment register, the tracker's run
linking, the plots' JSON branch and the native bindings.

Everything here is exact (integers, strings, uint8 pixels) but the
augmentation, which computes the same fp32 formula (1e-6 relative) and
rounds the same values to bf16 (equal).
"""

from __future__ import annotations

import builtins
import json
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from polyp_tpu.data import cache as jcache
from polyp_tpu.data import io as jio
from polyp_tpu.data import native as jnative
from polyp_tpu.data import pipeline as jpipe
from polyp_tpu.data import tables as jtables
from polyp_tpu.data import transforms as jtransforms
from polyp_tpu.eval import metrics as jmetrics
from polyp_tpu.eval import quota as jquota
from polyp_tpu.eval import register as jregister
from polyp_tpu.track import tracker as jtracker
from polyp_tpu_torch.data import cache as tcache
from polyp_tpu_torch.data import io as tio
from polyp_tpu_torch.data import native as tnative
from polyp_tpu_torch.data import pipeline as tpipe
from polyp_tpu_torch.data import tables as ttables
from polyp_tpu_torch.data import transforms as ttransforms
from polyp_tpu_torch.eval import metrics as tmetrics
from polyp_tpu_torch.eval import quota as tquota
from polyp_tpu_torch.eval import register as tregister
from polyp_tpu_torch.track import tracker as ttracker
from polyp_tpu_torch.utils import plotting as tplotting
from _torch_threads import _one_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
CLASSES = ["AD", "HP", "AD", "ASS", "AD", "HP", "ASS", "AD", "HP", "AD"]


def _write_split(d: Path, classes, seed: int, ids=None) -> tuple[Path, Path]:
    """`d/images/*.tif` (with masks in `d/masks`) and `d/labels.csv`."""
    rng = np.random.default_rng(seed)
    images, masks = d / "images", d / "masks"
    images.mkdir(parents=True)
    masks.mkdir()
    ids = ids or [f"{d.name}_{i:03d}" for i in range(len(classes))]
    for image_id in ids:
        arr = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
        Image.fromarray(arr).save(images / f"{image_id}.tif")
        mask = np.zeros((40, 52), np.uint8)
        mask[8:30, 10:40] = 255
        Image.fromarray(mask).save(masks / f"{image_id}.tif")
    csv = d / "labels.csv"
    csv.write_text("image_id,cls\n" + "".join(
        f"{i},{c}\n" for i, c in zip(ids, classes)))
    return images, csv


@pytest.fixture
def corpus(tmp_path):
    """Two labelled splits and generated sample directories."""
    train = _write_split(tmp_path / "train", CLASSES, 0)
    val = _write_split(tmp_path / "val", ["HP", "ASS", "AD", "HP"], 1)
    samples = tmp_path / "samples"
    rng = np.random.default_rng(2)
    for cls, n in (("AD", 2), ("HP", 3), ("ASS", 1)):
        (samples / cls).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (36, 36, 3), np.uint8)
                            ).save(samples / cls / f"{i + 1}.png")
    return {"train": train, "val": val, "samples": samples,
            "masks": tmp_path / "train" / "masks"}


def _same_table(got, want):
    assert got.image_paths == want.image_paths
    assert got.labels == want.labels
    assert list(got.label2idx.items()) == list(want.label2idx.items())
    assert got.mask_paths == want.mask_paths
    assert got.idx2label == want.idx2label
    assert got.num_classes == want.num_classes


@pytest.mark.parametrize("one_vs_rest", [False, True])
@pytest.mark.parametrize("masks", [False, True])
def test_classification_table_matches_jax(corpus, one_vs_rest, masks):
    images, csv = corpus["train"]
    mask_dir = corpus["masks"] if masks else None
    _same_table(ttables.ClassificationTable.from_csv(images, csv, mask_dir,
                                                     one_vs_rest),
                jtables.ClassificationTable.from_csv(images, csv, mask_dir,
                                                     one_vs_rest))


@pytest.mark.parametrize("keep", [None, "HP", ["AD"], ["HP", "ASS"],
                                  ["ASS", "AD", "HP"]])
def test_diffusion_table_matches_jax(corpus, keep):
    """Label ids in first-appearance order of the kept classes, directory
    by directory, with REST merging when more than one class is kept."""
    dirs = [corpus["train"][0], corpus["val"][0]]
    csvs = [corpus["train"][1], corpus["val"][1]]
    masks = [corpus["masks"], corpus["masks"]]
    _same_table(ttables.DiffusionTable.from_dirs(dirs, csvs, masks, keep),
                jtables.DiffusionTable.from_dirs(dirs, csvs, masks, keep))


@pytest.mark.parametrize("ad_vs_rest", [False, True])
def test_augmented_table_matches_jax(corpus, ad_vs_rest):
    dirs = [corpus["train"]] + [(str(corpus["samples"] / c), None)
                                for c in ("AD", "HP", "ASS")]
    _same_table(ttables.AugmentedTable.from_dirs(dirs, ad_vs_rest),
                jtables.AugmentedTable.from_dirs(dirs, ad_vs_rest))
    for label2idx in ({"AD": 0, "REST": 1}, {"AD": 0, "ASS": 1, "HP": 2}):
        for d in ("samples/AD", "samples/HP/", "x/ASS"):
            assert ttables.extract_label_from_dir(d, label2idx) == \
                jtables.extract_label_from_dir(d, label2idx)


def test_integer_image_ids_are_read_as_pandas_reads_them(tmp_path):
    """A column of integer ids ("007") names the files pandas names
    ("7.tif")."""
    images, csv = _write_split(tmp_path / "n", ["AD", "HP", "ASS"], 3,
                               ids=["007", "12", "3"])
    got = ttables.ClassificationTable.from_csv(images, csv)
    want = jtables.ClassificationTable.from_csv(images, csv)
    assert got.image_paths == want.image_paths
    assert got.image_paths[0].endswith("/7.tif")


@pytest.mark.parametrize("size", [32, 40])
def test_load_preprocessed_and_cache_match_jax(corpus, tmp_path, size):
    """decode → mask → resize, and the npz cache: the same pixels; the
    cache file is written once and read back."""
    images, csv = corpus["train"]
    jt = jtables.ClassificationTable.from_csv(images, csv, corpus["masks"])
    tt = ttables.ClassificationTable.from_csv(images, csv, corpus["masks"])
    np.testing.assert_array_equal(
        tio.load_preprocessed(tt.image_paths[0], size, tt.mask_paths[0]),
        jio.load_preprocessed(jt.image_paths[0], size, jt.mask_paths[0]))
    want = jcache.ArrayDataset.from_table(jt, size)
    got = tcache.ArrayDataset.from_table(tt, size, tmp_path / "cache")
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.int32
    assert got.idx2label == want.idx2label
    files = list((tmp_path / "cache").glob("polyp_cache_*.npz"))
    assert len(files) == 1
    again = tcache.ArrayDataset.from_table(tt, size, tmp_path / "cache")
    np.testing.assert_array_equal(again.images, want.images)


@pytest.mark.parametrize("weighted,drop_last", [(False, False), (True, True)])
def test_loader_batches_match_jax(weighted, drop_last):
    """Weighted sampling (the balanced class weights) and the reference's
    index stream: the same batches, the padded tail and its `valid` mask;
    skip_epochs lands on the same epoch."""
    rng = np.random.default_rng(4)
    labels = np.asarray([0] * 9 + [1] * 3 + [2] * 2, np.int32)
    images = rng.integers(0, 256, (14, 4, 4, 3), dtype=np.uint8)
    w = tpipe.weighted_sample_weights(labels) if weighted else None
    if weighted:
        np.testing.assert_array_equal(w, jpipe.weighted_sample_weights(labels))
    jl = jpipe.Loader(images, labels, 4, seed=3, drop_last=drop_last,
                      weights=w)
    tl = tpipe.Loader(images, labels, 4, seed=3, drop_last=drop_last,
                      weights=w, device="cpu")
    assert len(tl) == len(jl)
    jl.skip_epochs(1)
    tl.skip_epochs(1)
    got, want = list(tl), list(jl)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        for a, b in zip(g, w_):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("train", [False, True])
def test_augment_classifier_batch_matches_jax(dtype, train):
    """uint8 NHWC → flip (train) → /255 → ImageNet normalise, as NCHW:
    fp32 within 1e-6 relative, bf16 equal."""
    images = np.random.default_rng(5).integers(0, 256, (6, 8, 10, 3),
                                               dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jtransforms.augment_classifier_batch(
        jnp.asarray(images), key, train=train, dtype=jdt).astype(jnp.float32))
    flip = (torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.5, (6,))))
            if train else None)
    got = ttransforms.augment_classifier_batch(torch.from_numpy(images), flip,
                                               tdt)
    assert got.dtype == tdt and got.shape == (6, 3, 8, 10)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quota_matches_jax(corpus):
    _, csv = corpus["train"]
    assert tquota.counts_per_class(csv) == jquota.counts_per_class(csv)
    assert list(tquota.counts_per_class(csv)) == ["AD", "HP", "ASS"]
    real = {"AD": 535, "HP": 131, "ASS": 122}
    for one_vs_rest in (False, True):
        dist = tquota.default_distribution(one_vs_rest)
        assert dist == jquota.default_distribution(one_vs_rest)
        for minimum in (1000, 10):
            assert tquota.get_num_images_to_generate(
                real, dist, minimum, one_vs_rest) == \
                jquota.get_num_images_to_generate(real, dist, minimum,
                                                  one_vs_rest)
    assert tquota.get_num_images_to_generate(real, (0.4, 0.3, 0.3)) == {
        "AD": 465, "HP": 619, "ASS": 628}


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    names = np.asarray(["AD", "ASS", "HP"])
    y_true = names[rng.integers(0, 3, 50)].tolist()
    y_pred = names[rng.integers(0, 3, 50)].tolist()
    order = sorted(set(y_true))
    assert tmetrics.accuracy_score(y_true, y_pred) == \
        jmetrics.accuracy_score(y_true, y_pred)
    for average in ("weighted", "macro"):
        assert tmetrics.precision_recall_f1(y_true, y_pred, average, order) \
            == jmetrics.precision_recall_f1(y_true, y_pred, average, order)
    np.testing.assert_array_equal(
        tmetrics.confusion_matrix(y_true, y_pred, order),
        jmetrics.confusion_matrix(y_true, y_pred, order))
    assert tmetrics.classification_report(y_true, y_pred, order) == \
        jmetrics.classification_report(y_true, y_pred, order)
    labels = rng.integers(0, 3, 30)
    assert tmetrics.balanced_class_weights(labels) == \
        jmetrics.balanced_class_weights(labels)


def test_register_matches_jax(tmp_path):
    params = {"image_size": 224, "batch_size": 16, "dropout": 0.5,
              "other_techniques": ["weighted sampling"]}
    for mod, name in ((tregister, "t.csv"), (jregister, "j.csv")):
        mod.append_run(tmp_path / name, "m1", params, 0.61234)
        mod.append_run(tmp_path / name, "m2", params, 0.7)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert tregister.best_run(tmp_path / "t.csv")["model_name"] == "m2"


def test_tracker_links_runs_as_jax_does(tmp_path):
    """A run reopened by id from a tracker set to another experiment logs
    into the same directory; both packages write the same files."""
    for mod, root in ((ttracker, tmp_path / "t"), (jtracker, tmp_path / "j")):
        tr = mod.get_tracker(root)
        tr.set_experiment("gen")
        with tr.start_run(run_name="g") as run:
            tr.log_params({"a": 1, "b": [1, 2]})
            tr.log_metric("loss", 0.5, 0)
        other = mod.JsonlTracker(root)
        other.set_experiment("eval")
        with other.start_run(run_id=run.run_id):
            other.log_metric("f1_score", 0.75)
            (tmp_path / "art.txt").write_text("x")
            other.log_artifact(str(tmp_path / "art.txt"), "results")
        metrics = other.read_metrics(run.run_id)
        assert [m["key"] for m in metrics] == ["loss", "f1_score"]
        assert other.read_params(run.run_id) == {"a": 1, "b": [1, 2]}
        assert (root / "gen" / run.run_id / "artifacts" / "results" /
                "art.txt").exists()


def test_mlflow_tracker_imports_mlflow_only_when_built(monkeypatch):
    """POLYP_MLFLOW_URI without mlflow installed falls back to the JSONL
    tracker; importing the module imports no mlflow."""
    monkeypatch.setenv("POLYP_MLFLOW_URI", "file:///nowhere")
    real_import = builtins.__import__

    def no_mlflow(name, *args, **kwargs):
        if name == "mlflow":
            raise ImportError("no mlflow")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mlflow)
    assert isinstance(ttracker.get_tracker("x"), ttracker.JsonlTracker)


def _hide_matplotlib(monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)


def test_plots_write_their_data_as_json_without_matplotlib(
        tmp_path, monkeypatch, capsys):
    _hide_matplotlib(monkeypatch)
    path = tplotting.plot_loss([1.0, 0.5], [1.2, 0.7],
                               str(tmp_path / "r" / "loss.png"))
    assert path == str(tmp_path / "r" / "loss.json")
    assert json.loads(Path(path).read_text())["val_loss"] == [1.2, 0.7]
    cm = np.asarray([[2, 1], [0, 3]])
    path = tplotting.plot_confusion_matrix(cm, ["AD", "HP"],
                                           str(tmp_path / "cm.png"))
    data = json.loads(Path(path).read_text())
    assert data["confusion_matrix"] == cm.tolist()
    assert data["labels"] == ["AD", "HP"]
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 2 and all("matplotlib" in line for line in err)
    assert not (tmp_path / "cm.png").exists()


def test_plots_draw_pngs_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    path = tplotting.plot_loss([1.0, 0.5], None, str(tmp_path / "loss.png"))
    assert path.endswith(".png") and Path(path).stat().st_size > 0
    path = tplotting.plot_confusion_matrix(np.eye(2, dtype=int), ["a", "b"],
                                           str(tmp_path / "cm.png"))
    assert Image.open(path).size[0] > 0


@pytest.fixture
def native_libs(tmp_path, monkeypatch):
    """native/preprocess.cpp and tiff_decode.cpp built into tmp_path (the
    repository's Makefile recipe) as the port's native directory, or a
    skip where g++ is missing."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native libraries")
    for name in ("preprocess", "tiff_decode"):
        lib = tmp_path / ("libpolyp_preprocess.so" if name == "preprocess"
                          else "libpolyp_tiff.so")
        proc = subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-o", str(lib), str(ROOT / "native" / f"{name}.cpp")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            pytest.skip(f"{name} did not build: {proc.stderr[-300:]}")
    monkeypatch.setattr(tnative, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "libpolyp_png.so")
    return tmp_path


def test_native_bindings_match_the_references(corpus, native_libs,
                                              monkeypatch):
    """The port's resize on the library the reference's bindings load
    (equal), the TIFF decoder against PIL (equal), and io's
    POLYP_NATIVE_PREPROCESS=1 dispatch through them."""
    monkeypatch.setenv("POLYP_NATIVE_LIB",
                       str(native_libs / "libpolyp_preprocess.so"))
    monkeypatch.setattr(jnative, "_SEARCHED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    image = np.random.default_rng(7).integers(0, 256, (37, 53, 3), np.uint8)
    assert tnative.preprocess_available()
    np.testing.assert_array_equal(tnative.resize_bilinear(image, 24),
                                  jnative.resize_bilinear(image, 24))
    path = Path(corpus["train"][0]) / "train_000.tif"
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGB"))
    assert tnative.decoder_available("tiff")
    assert not tnative.decoder_available("png")
    np.testing.assert_array_equal(tnative.decode_tiff(path), pil)
    monkeypatch.setenv("POLYP_NATIVE_PREPROCESS", "1")
    np.testing.assert_array_equal(tio.load_preprocessed(path, 24),
                                  tnative.resize_bilinear(pil, 24))
