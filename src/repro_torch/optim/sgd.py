"""Plain / momentum SGD over the port's dict trees (the paper fine-tunes with
SGD, Eq. 2-3), as ``repro/optim/sgd.py``: without momentum the step is
taken in fp32 and cast back to the param's dtype; the momentum buffer has
the param's dtype, and the decayed gradient the gradient's.  Where the JAX
package multiplies a bf16 array by a Python float, JAX rounds the float to
bf16 first (a weakly typed scalar takes the array's dtype) and rounds each
op's result; ``_scalar`` does the same here, where PyTorch would keep the
float in fp32."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def sgd_init(params, momentum: float = 0.0):
    if momentum == 0.0:
        return {}
    return {"mu": tree_map(torch.zeros_like, params)}


def sgd_update(params, grads, state, lr, momentum: float = 0.0,
               weight_decay: float = 0.0):
    if weight_decay:
        grads = tree_map(
            lambda g, p: g + _scalar(weight_decay, g) * p.to(g.dtype),
            grads, params)
    if momentum == 0.0:
        new = tree_map(lambda p, g: (p - lr * g.to(torch.float32)).to(p.dtype),
                       params, grads)
        return new, state
    mu = tree_map(lambda m, g: _scalar(momentum, m) * m + g.to(m.dtype),
                  state["mu"], grads)
    new = tree_map(lambda p, m: (p - _scalar(lr, m) * m).to(p.dtype),
                   params, mu)
    return new, {"mu": mu}
