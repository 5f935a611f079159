"""Synthetic class-structured image datasets (offline stand-ins for
MNIST/CIFAR — see DESIGN.md §2).

Each class is a random smooth prototype image; samples are prototype +
per-sample Gaussian noise + random shift. Linearly separable enough for the
paper's small CNN/ResNet to reach high accuracy in a few hundred steps, with
genuine cross-class confusability (shared low-frequency structure) so
non-iid bias effects reproduce qualitatively.

The FFT split mirrors the paper: a *public* server set with broad class
coverage but few samples per class, and client *private* sets partitioned by
``repro.fl.partition``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray          # (N, H, W, C) float32
    y: np.ndarray          # (N,) int32
    n_classes: int


def _prototypes(rng, n_classes, image_size, channels):
    base = rng.normal(0.0, 1.0, (image_size // 4, image_size // 4, channels))
    protos = []
    for c in range(n_classes):
        p = 0.35 * base + rng.normal(0.0, 1.0, base.shape)
        p = np.kron(p, np.ones((4, 4, 1)))            # smooth upsample
        protos.append(p)
    return np.stack(protos).astype(np.float32)


def make_dataset(n_samples: int, n_classes: int = 10, image_size: int = 32,
                 channels: int = 3, noise: float = 0.9,
                 seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, n_classes, image_size, channels)
    y = rng.integers(0, n_classes, n_samples).astype(np.int32)
    x = protos[y] + noise * rng.normal(0.0, 1.0, (n_samples, image_size,
                                                  image_size, channels))
    shift = rng.integers(-2, 3, (n_samples, 2))
    for i in range(n_samples):                        # small translations
        x[i] = np.roll(x[i], tuple(shift[i]), axis=(0, 1))
    return Dataset(x=x.astype(np.float32), y=y, n_classes=n_classes)


def train_test_split(dataset: Dataset, n_test: int,
                     seed: int = 0) -> Tuple[Dataset, Dataset]:
    """Split one generated dataset (same class prototypes!) into train/test."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(dataset.y))
    te, tr = perm[:n_test], perm[n_test:]
    return (Dataset(dataset.x[tr], dataset.y[tr], dataset.n_classes),
            Dataset(dataset.x[te], dataset.y[te], dataset.n_classes))


def fft_split(dataset: Dataset, *, public_per_class: int,
              seed: int = 0) -> Tuple[Dataset, Dataset]:
    """Split into (public server set with ≤ public_per_class samples/class,
    private pool for the clients) — the paper's data regime (§II-A)."""
    rng = np.random.default_rng(seed)
    pub_idx = []
    for c in range(dataset.n_classes):
        pool = np.where(dataset.y == c)[0]
        pub_idx.extend(rng.permutation(pool)[:public_per_class].tolist())
    pub_idx = np.array(sorted(pub_idx))
    priv_mask = np.ones(len(dataset.y), dtype=bool)
    priv_mask[pub_idx] = False
    priv_idx = np.where(priv_mask)[0]
    pub = Dataset(dataset.x[pub_idx], dataset.y[pub_idx], dataset.n_classes)
    priv = Dataset(dataset.x[priv_idx], dataset.y[priv_idx], dataset.n_classes)
    return pub, priv
