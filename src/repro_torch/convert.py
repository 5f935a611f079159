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
``params_to_numpy`` goes the other way (the checkpoint writer uses it).

A decode state carries the JAX package's caches, NamedTuples (``KVCache``,
``MambaCache``, ``MLSTMCache``, ``SLSTMCache``) whose ``length`` is a device scalar (stacked per layer in
the homogeneous stack).  Each becomes the port's cache of the same fields,
its ``length`` a host ``int``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import MambaCache
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache

# keyed by the fields the JAX caches have (the port's KVCache adds ``shard``,
# with a default)
_CACHES = {tuple(f for f in cls._fields if f not in cls._field_defaults): cls
           for cls in (KVCache, MambaCache, MLSTMCache, SLSTMCache)}


class BFloat16Bits(np.ndarray):
    """A bf16 array's raw 16-bit payload as a ``uint16`` view: numpy has no
    bf16 dtype without ``ml_dtypes``, which the machine with the card may
    lack.  ``params_to_numpy`` and ``checkpoint.load`` give bf16 leaves in
    this form; ``tensor_from_numpy`` turns them back into bf16."""


def tensor_from_numpy(a) -> torch.Tensor:
    bits = isinstance(a, BFloat16Bits)
    a = np.array(a)
    if bits or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_to_numpy(tree):
    """The port's tree as numpy, as ``jax.tree.map(np.asarray, tree)`` gives
    the JAX package's: dicts with sorted keys, lists and tuples kept, None
    kept, every other leaf ``np.asarray``; a tensor is copied to the host,
    and a bf16 tensor becomes ``BFloat16Bits``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view(BFloat16Bits)
        return t.numpy()
    return np.asarray(tree)


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
