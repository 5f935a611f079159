"""The device sync that keeps the phase timers honest on the card.

A CUDA launch returns before its kernel has run, so a ``Telemetry.timer``
that closes right after one would hold dispatch time only, and the device
time would land in whichever phase waits next.  Under a live hub the JAX
package calls ``jax.block_until_ready`` before such a timer closes; the
port calls ``block_until_ready(tel, tree)`` at the same places.  It waits
only when the hub is live and the tree holds a CUDA tensor: with telemetry
off, or on the CPU, it does nothing, so a telemetry-off run adds no sync.
"""
from __future__ import annotations

from typing import Optional

import torch


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return None
    for node in tree:
        t = _first_tensor(node)
        if t is not None:
            return t
    return None


def block_until_ready(tel, tree) -> None:
    """``torch.cuda.synchronize`` the device of ``tree``'s first tensor
    (dicts, lists and tuples are walked) when ``tel`` is live and that
    tensor lies on a CUDA device; otherwise a no-op."""
    if not tel:
        return
    t = _first_tensor(tree)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
