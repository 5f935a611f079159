"""Carry parameters across from the JAX package.

``params_from_jax`` takes the JAX package's parameters as a nested dict of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
nested dict of tensors with the same keys and the same shapes and layout:
HWIO convolution weights, (d_in, d_out) dense weights, and the transformer's
stacked (L, ...) layer leaves.  The port's model code permutes to PyTorch's
layouts where it needs to, so payload leaves, aggregates and tests compare
leaf by leaf.

A bf16 JAX leaf arrives as an ``ml_dtypes.bfloat16`` numpy array, which
``torch.from_numpy`` refuses; its bits are carried across through a
``uint16`` view and reinterpreted as ``torch.bfloat16``, unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda"):
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a).to(dev), tree)
