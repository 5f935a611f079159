"""Federated data partitioners matching the paper's protocol (§V-A3).

* iid: shuffle and split uniformly.
* group_classes: the paper's non-iid scheme — clients are grouped in fours;
  each group owns a disjoint set of ``classes_per_group`` classes
  (MNIST/CIFAR-10: 2 of 10; CIFAR-100: 20 of 100).
* dirichlet: standard Dir(α) label-skew partitioner (extra coverage).

All return ``client_indices: List[np.ndarray]`` into the dataset plus the
per-client class histograms (N, C) the server uses for Eq. (8) (Remark 2:
clients share only their label histograms).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def class_histogram(labels: np.ndarray, n_classes: int) -> np.ndarray:
    return np.bincount(labels, minlength=n_classes).astype(np.int64)


def iid_partition(labels: np.ndarray, n_clients: int,
                  seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def group_classes_partition(labels: np.ndarray, n_clients: int,
                            n_classes: int, classes_per_group: int,
                            group_size: int = 4,
                            seed: int = 0) -> List[np.ndarray]:
    """Paper scheme: clients 1–4 → classes {0,1}, clients 5–8 → {2,3}, …"""
    rng = np.random.default_rng(seed)
    n_groups = (n_clients + group_size - 1) // group_size
    out: List[np.ndarray] = []
    for g in range(n_groups):
        cls = [(g * classes_per_group + j) % n_classes
               for j in range(classes_per_group)]
        pool = np.where(np.isin(labels, cls))[0]
        pool = rng.permutation(pool)
        members = list(range(g * group_size, min((g + 1) * group_size, n_clients)))
        for part in np.array_split(pool, len(members)):
            out.append(np.sort(part))
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int, n_classes: int,
                        alpha: float, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    buckets: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        pool = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet([alpha] * n_clients)
        splits = (np.cumsum(props) * len(pool)).astype(int)[:-1]
        for i, part in enumerate(np.split(pool, splits)):
            buckets[i].extend(part.tolist())
    return [np.sort(np.array(b, dtype=int)) for b in buckets]


def partition(mode: str, labels: np.ndarray, n_clients: int, n_classes: int,
              *, classes_per_group: int = 2, dirichlet_alpha: float = 0.3,
              group_size: int = 4,
              seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    if mode == "iid":
        parts = iid_partition(labels, n_clients, seed)
    elif mode == "group_classes":
        parts = group_classes_partition(labels, n_clients, n_classes,
                                        classes_per_group,
                                        group_size=group_size, seed=seed)
    elif mode == "dirichlet":
        parts = dirichlet_partition(labels, n_clients, n_classes,
                                    dirichlet_alpha, seed)
    else:
        raise ValueError(mode)
    hists = np.stack([class_histogram(labels[p], n_classes) for p in parts])
    return parts, hists
