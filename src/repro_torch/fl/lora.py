"""LoRA substrate (paper §V-C: partial-parameter fine-tuning, rank 8 on the
attention projections), ported from ``repro/fl/lora.py``.

Generic over any nested-dict parameter tree: 2-D weight leaves (and 3-D
stacked ``(L, d_in, d_out)`` layer leaves) selected by a path predicate get
(A, B) factors.  ``apply_lora`` produces effective params
``W + (α/r)·A@B`` for the forward pass, and only the adapters travel between
server and clients, which is what makes FedEx-LoRA's residual (Eq. 52-53)
meaningful.  ``lora_matmul`` is the unmerged single-layer forward
``x@W + s·(x@A)@B`` through ``kernels.ops.lora_matmul`` (the CUDA kernel on
the card, its plain version on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    match: Callable[[str], bool] = lambda path: path.endswith("qkv/w")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _iter_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def lora_paths(params, cfg: LoRAConfig):
    """2-D weights and 3-D scanned layer stacks (leading layer dim), in the
    tree's iteration order."""
    return [p for p, leaf in _iter_paths(params)
            if hasattr(leaf, "ndim") and leaf.ndim in (2, 3) and cfg.match(p)]


def lora_init(generator: torch.Generator, params,
              cfg: LoRAConfig) -> Dict[str, Any]:
    """Returns {path: {"a": (…, d_in, r), "b": (…, r, d_out)}} on each
    weight's device: ``a`` ~ N(0, 1)/√d_in in fp32 drawn from ``generator``
    path by path, ``b`` zero.  Stacked (L, d_in, d_out) weights get
    per-layer (L, …) factors."""
    adapters = {}
    for path in lora_paths(params, cfg):
        leaf = _get(params, path)
        d_in, d_out = leaf.shape[-2], leaf.shape[-1]
        lead = tuple(leaf.shape[:-2])
        a = torch.randn(lead + (d_in, cfg.rank), generator=generator,
                        device=generator.device) / math.sqrt(d_in)
        adapters[path] = {
            "a": a.to(device=leaf.device, dtype=torch.float32),
            "b": torch.zeros(lead + (cfg.rank, d_out), dtype=torch.float32,
                             device=leaf.device)}
    return adapters


def _get(tree, path):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _set(tree, path, value):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value


def _copy_dicts(tree):
    return {k: _copy_dicts(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def apply_lora(params, adapters: Dict[str, Any], cfg: LoRAConfig):
    """Effective params: W_eff = W + scaling · A @ B, computed in fp32 and
    cast to W's dtype (batched for 3-D leaves).  Copy-on-write: ``params``
    and its dicts are not modified, and leaves without an adapter are
    shared."""
    out = _copy_dicts(params)
    for path, ab in adapters.items():
        w = _get(params, path)
        delta = torch.matmul(ab["a"], ab["b"]) * cfg.scaling
        _set(out, path, (w.to(torch.float32) + delta).to(w.dtype))
    return out


def lora_matmul(x, w, ab, cfg: LoRAConfig):
    """Unmerged forward of one LoRA layer: x @ w + s·(x @ a) @ b."""
    return kops.lora_matmul(x, w, ab["a"], ab["b"], cfg.scaling)


def merge_lora(params, adapters, cfg: LoRAConfig):
    return apply_lora(params, adapters, cfg)
