"""Small self-contained FFT problems for examples and tests, ported from
``repro/fl/toy.py``.

One factory instead of each caller hand-rolling the
dataset → split → partition → model → runner pipeline.  ``init_fn`` and
``batch_indices`` pass through to ``FFTRunner`` (a caller can start from
given params and minibatch indices); by default the cnn is drawn from the
config's seed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.data.synthetic import fft_split, make_dataset, train_test_split
from repro_torch.fl.partition import partition
from repro_torch.fl.runtime import FFTConfig, FFTRunner
from repro_torch.models.vision import make_model


def make_toy_runner(cfg: FFTConfig, *, n_samples: int = 1500,
                    n_classes: int = 4, image_size: int = 8,
                    public_per_class: int = 15,
                    pretrain_steps: int = 30, seed: int = 0,
                    device="cuda", init_fn: Optional[Callable] = None,
                    batch_indices: Optional[Callable] = None) -> FFTRunner:
    """CNN on a synthetic class-structured dataset, non-iid group split."""
    ds = make_dataset(n_samples, n_classes=n_classes, image_size=image_size,
                      channels=1, seed=seed)
    train, test = train_test_split(ds, n_samples // 5, seed=seed + 1)
    public, private = fft_split(train, public_per_class=public_per_class,
                                seed=seed)
    parts, _ = partition("group_classes", private.y, cfg.n_clients,
                         n_classes, classes_per_group=1, group_size=2,
                         seed=seed)
    model_init, apply_fn = make_model("cnn", n_classes, image_size, 1,
                                      device=device)
    return FFTRunner(cfg, init_fn or model_init, apply_fn, public, parts,
                     private, test, pretrain_steps=pretrain_steps,
                     device=device, batch_indices=batch_indices)


def make_server_mode_runners(cfg: FFTConfig, modes=("sync", "async"),
                             **toy_kwargs) -> Dict[str, FFTRunner]:
    """Identically-seeded runners differing only in ``server_mode`` — the
    fair way to compare the synchronous and asynchronous servers: same
    data split, same initial params, same failure realization seed."""
    return {mode: make_toy_runner(dataclasses.replace(cfg, server_mode=mode),
                                  **toy_kwargs)
            for mode in modes}
