"""Nested-dict parameter trees with ``jax.tree.flatten``'s leaf order.

JAX flattens dicts in *sorted-key* order, and payloads, templates and
residual stores all index leaves by that order.  ``torch.utils._pytree``
keeps insertion order instead, so the port uses this one flatten/unflatten
pair everywhere.  A tree is a (nested) dict; anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

# A spec is None for a leaf, or (sorted keys, child specs) for a dict.
TreeSpec = Any


def _walk(node, leaves: List[Any]) -> TreeSpec:
    if isinstance(node, dict):
        keys = sorted(node)
        return (tuple(keys), tuple(_walk(node[k], leaves) for k in keys))
    leaves.append(node)
    return None


def tree_flatten(tree) -> Tuple[List[Any], TreeSpec]:
    """(leaves in sorted-key order, spec).  The walk is a module-level
    function: a recursive closure would make a reference cycle that keeps
    ``leaves`` (and every tensor in it) alive until the garbage collector
    runs."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(s: TreeSpec, it):
    if s is None:
        return next(it)
    keys, children = s
    return {k: _build(c, it) for k, c in zip(keys, children)}


def tree_unflatten(spec: TreeSpec, leaves) -> Any:
    it = iter(leaves)
    out = _build(spec, it)
    rest = next(it, _END)
    if rest is not _END:
        raise ValueError("more leaves than the tree spec holds")
    return out


_END = object()


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for _, s in others:
        if s != spec:
            raise ValueError("tree_map over trees of different structure")
    out = [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))]
    return tree_unflatten(spec, out)
