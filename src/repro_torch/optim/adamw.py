"""AdamW over the port's dict trees (server pre-training and the LLM
training entry point), as ``repro/optim/adamw.py``: ``m`` and ``v`` are fp32,
``t`` an int32 scalar tensor, and the update is taken in fp32 and cast back
to each param's dtype."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params):
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01):
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                 state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) *
                 torch.square(g.to(torch.float32)), state["v"], grads)
    tf = t.to(torch.float32)
    bc1 = 1 - torch.pow(b1, tf)
    bc2 = 1 - torch.pow(b2, tf)

    def upd(p, m_, v_):
        upd_ = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        decay = weight_decay * p.to(torch.float32)
        return (p - lr * (upd_ + decay)).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
