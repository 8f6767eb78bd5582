"""Batching and a prefetching device loader: the twin of
polyp_tpu/data/pipeline.py (:31-170) on one device.

Index batches come from a seeded `np.random.default_rng(seed)` in the
reference's order, so the port's batches are the reference's. Batches keep
a static shape: with `drop_last=False` the tail batch is padded by
wrapping around and a boolean `valid` mask marks the real rows.
`skip_epochs` fast-forwards the index stream for a resumed run.
`weighted_sample_weights` gives the class-balanced draw weights of
weighted sampling (torch's WeightedRandomSampler with replacement, as the
reference's classifier draws). A batch is copied to the device from
pinned memory one batch ahead, so the copy overlaps the previous step.
Sharding over processes and devices is the multi-GPU slice's
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from polyp_tpu_torch.eval.metrics import balanced_class_weights


def weighted_sample_weights(labels) -> np.ndarray:
    """Per-sample draw weights: the balanced class weight of each label."""
    weights = balanced_class_weights(labels)
    return np.asarray([weights[int(l)] for l in np.asarray(labels)],
                      dtype=np.float64)


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True, drop_last: bool = False,
                  weights: np.ndarray | None = None) -> list[np.ndarray]:
    """Index batches for one epoch: n draws with replacement ∝ `weights`,
    else a permutation (`shuffle`) or arange."""
    if weights is not None:
        p = weights / weights.sum()
        order = rng.choice(n, size=n, replace=True, p=p)
    elif shuffle:
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    return [order[i:i + batch_size] for i in range(0, end, batch_size)
            if drop_last is False or i + batch_size <= n]


class Loader:
    """Iterates (images, labels, valid) batches on `device`: uint8 NHWC
    images, the labels, and the bool mask of real rows."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = False, weights: np.ndarray | None = None,
                 device: torch.device | str = "cuda"):
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.weights = weights
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.labels)
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _epoch(self) -> list[np.ndarray]:
        return epoch_batches(len(self.labels), self.batch_size, self._rng,
                             self.shuffle, self.drop_last, self.weights)

    def host_batches(self):
        """One epoch's (images, labels, valid) numpy batches."""
        n = len(self.labels)
        for idx in self._epoch():
            valid = np.ones(self.batch_size, dtype=bool)
            if len(idx) < self.batch_size:
                pad = self.batch_size - len(idx)
                valid[len(idx):] = False
                idx = np.concatenate([idx, np.arange(pad) % n])
            yield self.images[idx], self.labels[idx], valid

    def skip_epochs(self, k: int) -> None:
        """Advance the index stream past `k` epochs without making a batch,
        so a resumed run yields the batches an uninterrupted one would."""
        for _ in range(max(k, 0)):
            self._epoch()

    def _put(self, arrays) -> tuple[torch.Tensor, ...]:
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t.to(self.device))
        return tuple(out)

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        pending = None
        for batch in self.host_batches():
            nxt = self._put(batch)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending
