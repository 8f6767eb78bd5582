"""Fréchet distance (FID-style) of generated samples: the twin of
polyp_tpu/eval/fid.py.

* `frechet_distance(mu1, s1, mu2, s2)`: the Fréchet (Wasserstein-2)
  distance between two Gaussians,
  d² = |μ₁ − μ₂|² + tr(Σ₁ + Σ₂ − 2 (Σ₁^½ Σ₂ Σ₁^½)^½), with the square
  roots of symmetric PSD matrices by numpy's `eigh` (`_sqrtm_psd`), as the
  reference;
* `feature_statistics(features)`: (μ, Σ) of an [N, D] feature matrix;
* `FeatureExtractor`: uint8 NHWC images → features, in batches;
* `efficientnet_extractor`: the port's B0 backbone's pooled 1280-d
  features, ImageNet-calibrated when a torchvision state-dict file is
  given, else a seeded random backbone: repeatable, comparable between
  runs, not with published FID (the result says which);
* `class_frechet_distances`: per class, real training images against
  `samples/{cls}`; `fid_between_dirs`: two image directories.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from polyp_tpu_torch.data.io import load_preprocessed


def feature_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(μ, Σ) of an [N, D] feature matrix (rowvar=False covariance)."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """The square root of a symmetric PSD matrix by eigh, with the small
    negative eigenvalues of rounding clipped to 0."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """d²((μ₁, Σ₁), (μ₂, Σ₂)), the FID formula, at least 0."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    d2 = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
               - 2.0 * np.trace(covmean))
    return max(d2, 0.0)


@dataclass
class FeatureExtractor:
    """Batched uint8 NHWC images → [N, D] numpy features."""

    fn: Callable[[np.ndarray], np.ndarray]
    name: str = "custom"
    calibrated: bool = True  # False: distances compare only to themselves

    def __call__(self, images_u8: np.ndarray,
                 batch_size: int = 32) -> np.ndarray:
        return np.concatenate([
            np.asarray(self.fn(images_u8[i:i + batch_size]))
            for i in range(0, len(images_u8), batch_size)], axis=0)


@functools.lru_cache(maxsize=4)
def efficientnet_extractor(image_size: int = 224,
                           torch_weights: str | None = None, seed: int = 0,
                           device: str = "cuda") -> FeatureExtractor:
    """B0's pooled features in fp32 (evaluation mode, ImageNet-normalised
    input) on `device`. `torch_weights`: a torchvision efficientnet_b0
    state-dict file, imported by models/importers.py; without it the
    backbone is initialised from `seed`. `image_size` is the size the
    images come at (the features are pooled, so any size runs)."""
    from polyp_tpu_torch.data.transforms import augment_classifier_batch
    from polyp_tpu_torch.models.efficientnet import (
        EfficientNet, init_classifier_)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the feature extractor runs on the CUDA card by "
                           "default and no card is present; pass "
                           "device='cpu'")
    model = EfficientNet("b0", device=dev)
    init_classifier_(model, torch.Generator(dev).manual_seed(seed))
    calibrated = False
    if torch_weights is not None and Path(torch_weights).exists():
        from polyp_tpu_torch.models.importers import (
            efficientnet_from_torchvision)
        sd = torch.load(torch_weights, map_location="cpu", weights_only=True)
        model.load_state_dict(efficientnet_from_torchvision(sd))
        calibrated = True
    model.eval()

    @torch.no_grad()
    def features(images_u8: np.ndarray) -> np.ndarray:
        x = augment_classifier_batch(torch.from_numpy(images_u8).to(dev),
                                     None, torch.float32)
        return model(x).cpu().numpy()

    return FeatureExtractor(features, name="efficientnet_b0" + (
        "" if calibrated else "_randominit"), calibrated=calibrated)


def load_image_dir(d: str | Path, image_size: int,
                   exts: Sequence[str] = (".png", ".tif", ".jpg")
                   ) -> np.ndarray:
    """Every image of `d` (sorted by name) as uint8 [N, size, size, 3]."""
    paths = sorted(p for p in Path(d).iterdir() if p.suffix in exts)
    if not paths:
        raise ValueError(f"no images in {d}")
    return np.stack([load_preprocessed(p, image_size) for p in paths])


def fid_between_dirs(real_dir: str | Path, fake_dir: str | Path,
                     extractor: FeatureExtractor | None = None,
                     image_size: int = 224, device: str = "cuda") -> dict:
    """The Fréchet distance between two image directories, with the
    extractor's name, whether it is calibrated, and the image counts.
    Without `extractor`, B0's features on `device`."""
    extractor = extractor or efficientnet_extractor(image_size,
                                                    device=str(device))
    real = extractor(load_image_dir(real_dir, image_size))
    fake = extractor(load_image_dir(fake_dir, image_size))
    mu_r, s_r = feature_statistics(real)
    mu_f, s_f = feature_statistics(fake)
    return {"frechet_distance": frechet_distance(mu_r, s_r, mu_f, s_f),
            "extractor": extractor.name, "calibrated": extractor.calibrated,
            "n_real": len(real), "n_fake": len(fake)}


def frechet_from_arrays(real_u8: np.ndarray, fake_u8: np.ndarray,
                        extractor: FeatureExtractor) -> float:
    """Fréchet distance between two uint8 NHWC image stacks."""
    mu_r, s_r = feature_statistics(extractor(real_u8))
    mu_f, s_f = feature_statistics(extractor(fake_u8))
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def class_frechet_distances(train_images_dir: str | Path,
                            train_csv: str | Path,
                            samples_root: str | Path,
                            ad_vs_rest: bool = False,
                            image_size: int = 224,
                            extractor: FeatureExtractor | None = None,
                            cache_dir: str | None = None,
                            device: str = "cuda") -> dict:
    """Per class, the Fréchet distance between the real training images of
    the class and `samples_root/{cls}`; a class with fewer than 2 images on
    either side (or an empty directory) is skipped."""
    from polyp_tpu_torch.data.cache import ArrayDataset
    from polyp_tpu_torch.data.tables import AugmentedTable

    extractor = extractor or efficientnet_extractor(image_size,
                                                    device=str(device))
    real = ArrayDataset.from_table(
        AugmentedTable.from_dirs([(train_images_dir, train_csv)], ad_vs_rest),
        image_size, cache_dir)
    by_class = {name: real.images[real.labels == idx]
                for idx, name in real.idx2label.items()}
    per_class: dict[str, float] = {}
    for cls, real_imgs in sorted(by_class.items()):
        d = Path(samples_root) / cls
        if not d.exists() or len(real_imgs) < 2:
            continue
        try:
            fake = load_image_dir(d, image_size)
        except ValueError:
            continue  # an interrupted run can leave samples/{cls} empty
        if len(fake) < 2:
            continue  # a covariance needs 2 samples
        per_class[cls] = frechet_from_arrays(real_imgs, fake, extractor)
    return {"per_class": per_class, "extractor": extractor.name,
            "calibrated": extractor.calibrated}
