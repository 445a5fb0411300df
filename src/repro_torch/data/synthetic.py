"""Synthetic classification data (offline stand-ins for MNIST/FMNIST/CIFAR).

A copy of the reference's ``repro.data.synthetic`` image path: an
anisotropic Gaussian mixture, one mean per class on a random simplex, plus
a class-dependent rotation. Pure numpy from ``RandomState(seed)``, so the
port draws exactly the reference's arrays (pinned by the CPU tests).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticClassification:
    x: np.ndarray       # (N, ...) float32
    y: np.ndarray       # (N,) int64
    num_classes: int

    def __len__(self):
        return self.x.shape[0]

    def subset(self, idx) -> "SyntheticClassification":
        return SyntheticClassification(self.x[idx], self.y[idx], self.num_classes)


def make_classification(num_samples: int = 10_000, num_classes: int = 10,
                        dim: int = 32, *, image_hw=None, seed: int = 0,
                        class_sep: float = 1.8,
                        noise: float = 1.0) -> SyntheticClassification:
    """Gaussian mixture. ``image_hw=(H, W, C)`` reshapes features to images
    (for the CNN family); dim is then H*W*C."""
    rng = np.random.RandomState(seed)
    if image_hw is not None:
        dim = int(np.prod(image_hw))
    means = rng.randn(num_classes, dim).astype(np.float32)
    means *= class_sep / np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.randint(0, num_classes, size=num_samples)
    x = means[y] + noise * rng.randn(num_samples, dim).astype(np.float32) / np.sqrt(dim) * np.sqrt(dim) * 0.3
    # mild class-dependent rotation so the task is not purely linear
    w = rng.randn(num_classes, dim, 8).astype(np.float32) / np.sqrt(dim)
    feats = np.einsum("nd,ndk->nk", x, w[y])
    x[:, :8] += 0.5 * np.tanh(feats)
    x = x.astype(np.float32)
    if image_hw is not None:
        x = x.reshape((num_samples,) + tuple(image_hw))
    return SyntheticClassification(x, y.astype(np.int64), num_classes)


def train_test_split(ds: SyntheticClassification, test_frac: float = 0.1,
                     seed: int = 7):
    """Paper protocol: 10% test split, remainder training."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds))
    n_test = int(len(ds) * test_frac)
    return ds.subset(idx[n_test:]), ds.subset(idx[:n_test])
