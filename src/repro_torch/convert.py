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

A decode state carries the JAX package's caches, NamedTuples (``KVCache``,
``MambaCache``) whose ``length`` is a device scalar (stacked per layer in
the homogeneous stack).  Each becomes the port's cache of the same fields,
its ``length`` a host ``int``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import MambaCache

_CACHES = {cls._fields: cls for cls in (KVCache, MambaCache)}


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _length(a) -> int:
    a = np.asarray(a).reshape(-1)
    if a.size == 0 or (a != a[0]).any():
        raise ValueError(f"cache lengths {a.tolist()} are not one length")
    return int(a[0])


def params_from_jax(tree, device="cuda"):
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields is None:
            return tensor_from_numpy(node).to(dev)
        if tuple(fields) not in _CACHES:
            raise TypeError(f"no port counterpart for {type(node).__name__}"
                            f"{tuple(fields)}")
        return _CACHES[tuple(fields)](**{
            f: _length(v) if f == "length" else convert(v)
            for f, v in node._asdict().items()})

    return convert(tree)
