"""Carry parameters across from the JAX package.

``params_from_jax`` takes the JAX package's parameters as a nested dict of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
nested dict of tensors with the same keys and the same shapes and layout:
HWIO convolution weights and (d_in, d_out) dense weights.  The port's model
code permutes to PyTorch's layouts at the call into ``F.conv2d``, so
payload leaves, aggregates and tests compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def params_from_jax(tree, device="cuda"):
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)

