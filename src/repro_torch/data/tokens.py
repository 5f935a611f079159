"""Copied from ``repro/data/tokens.py`` (numpy only).

Synthetic token streams for LM-architecture FFT experiments and for the
training/serving drivers: a class-conditioned bigram process so that (a) a
model can actually reduce loss, and (b) each FL client's "domain" (= label
class in the paper's histogram machinery) induces a distinct token
distribution — letting the FedAuto class-histogram weights act on LM clients
via hashed token-class buckets (DESIGN.md §4).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_bigram_stream(n_tokens: int, vocab: int, domain: int,
                       n_domains: int, seed: int = 0) -> np.ndarray:
    """Markov token stream whose transition structure depends on `domain`."""
    rng = np.random.default_rng(seed * 1000 + domain)
    out = np.empty(n_tokens, dtype=np.int32)
    t = rng.integers(0, vocab)
    stride = (domain * 2 + 3) % max(vocab - 1, 1) + 1
    for i in range(n_tokens):
        out[i] = t
        if rng.uniform() < 0.8:
            t = (t * 7 + stride) % vocab       # domain-specific deterministic hop
        else:
            t = rng.integers(0, vocab)
    return out


def batches_from_stream(stream: np.ndarray, batch: int, seq: int,
                        seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(stream) - seq - 1
    while True:
        starts = rng.integers(0, n, batch)
        toks = np.stack([stream[s:s + seq] for s in starts])
        labels = np.stack([stream[s + 1:s + seq + 1] for s in starts])
        yield toks.astype(np.int32), labels.astype(np.int32)


def token_class_histogram(tokens: np.ndarray, n_buckets: int) -> np.ndarray:
    """Hashed token histogram — the LM generalization of label histograms."""
    t = tokens.reshape(-1).astype(np.int64)
    return np.bincount((t * 2654435761 % (2 ** 31)) % n_buckets,
                       minlength=n_buckets).astype(np.int64)
