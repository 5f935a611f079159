"""Distributed execution context for model code, as ``repro/models/dist.py``.

A rank is a process.  The launcher installs a ``MeshContext`` here: a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, and which of
them are the batch axes and which the model (tensor/expert-parallel) axis.
Model code (the MoE block, the GQA decode) queries it to choose between the
single-device path and the sharded bodies, exactly as the JAX package
chooses: a path depends only on the installed context, never on
``torch.distributed.is_initialized()`` or the environment.  With nothing
installed the models run as plain single-device PyTorch.

Where the JAX package runs a body under ``shard_map``, the port runs a plain
function on each rank's local shards; ``psum``, ``pmax`` and ``pmean`` are
``torch.distributed.all_reduce`` on the mesh dims' process groups.  Each
wrapper records its kind, count and bytes in ``collectives``
(``reset_collectives`` zeroes it), which ``launch/roofline.collective_bytes``
reads as the JAX package reads the compiled HLO's collectives.

Every wrapper reduces in x's dtype, as JAX's bodies do.

The JAX module's ``shard_map`` and ``set_mesh`` shims exist only for JAX
versions and have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

Axes = Union[str, Sequence[str]]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a live ``DeviceMesh`` or of a mesh shape
    (``launch/mesh.MeshShape``), in the mesh's axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object                     # DeviceMesh with named dims
    batch_axes: Tuple[str, ...]      # e.g. ('pod', 'data') or ('data',)
    model_axis: str                  # tensor/expert-parallel axis, e.g. 'model'

    @property
    def model_size(self) -> int:
        return axis_sizes(self.mesh)[self.model_axis]

    @property
    def batch_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)


_CTX: Optional[MeshContext] = None


def set_mesh_context(ctx: Optional[MeshContext]) -> None:
    global _CTX
    _CTX = ctx


def get_mesh_context() -> Optional[MeshContext]:
    return _CTX


@contextlib.contextmanager
def mesh_context(ctx: Optional[MeshContext]):
    prev = _CTX
    set_mesh_context(ctx)
    try:
        yield
    finally:
        set_mesh_context(prev)


def axis_index(ctx: MeshContext, axis: str) -> int:
    """This rank's coordinate on mesh dim ``axis`` (``lax.axis_index``)."""
    return ctx.mesh.get_local_rank(mesh_dim=axis)


def local_batch(ctx: Optional[MeshContext], batch: int) -> int:
    """The rows of a global batch that one rank holds: the batch is sharded
    over the batch axes where it divides, else replicated (a batch of 1 in
    the long-context decode), as the JAX package's specs lay it out."""
    if ctx is None or batch % ctx.batch_size:
        return batch
    return batch // ctx.batch_size


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
#: per wrapper: calls and bytes reduced (``reset_collectives`` zeroes them)
collectives: Dict[str, Dict[str, int]] = {
    k: {"count": 0, "bytes": 0} for k in ("psum", "pmax", "pmean")}


def reset_collectives() -> None:
    for rec in collectives.values():
        rec["count"] = rec["bytes"] = 0


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _all_reduce(kind: str, x: torch.Tensor, axis: Axes,
                op) -> torch.Tensor:
    ctx = get_mesh_context()
    if ctx is None:
        raise RuntimeError(f"{kind} needs an installed MeshContext")
    axes = _axes(axis)
    y = x.clone()
    for a in axes:            # a reduction over a tuple of axes, axis by axis
        tdist.all_reduce(y, op=op, group=ctx.mesh.get_group(mesh_dim=a))
    collectives[kind]["count"] += 1
    collectives[kind]["bytes"] += y.numel() * y.element_size()
    return y


def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Sum over the ranks of mesh dim(s) ``axis`` (``lax.psum``)."""
    return _all_reduce("psum", x, axis, tdist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Max over the ranks of mesh dim(s) ``axis`` (``lax.pmax``)."""
    return _all_reduce("pmax", x, axis, tdist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """Mean over the ranks of mesh dim(s) ``axis`` (``lax.pmean``)."""
    ctx = get_mesh_context()
    n = math.prod(axis_sizes(ctx.mesh)[a] for a in _axes(axis)) if ctx else 1
    return _all_reduce("pmean", x, axis, tdist.ReduceOp.SUM) / n


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec, mesh):
    """A partition spec (a tuple over the tensor's dims of an axis name, a
    tuple of axis names or None) as DTensor placements, one per mesh dim:
    ``Shard(i)`` on each mesh dim that dim i is split over, ``Replicate()``
    on the others.  A dim split over several axes is split over them in
    the spec's order, as JAX splits it (row-major)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for i, ax in enumerate(spec):
        dims = [names.index(a) for a in (() if ax is None else _axes(ax))]
        if seen & set(dims) or dims != sorted(dims):
            raise ValueError(f"{spec}: each mesh axis splits one dim, in the "
                             f"mesh's axis order {tuple(names)}")
        seen |= set(dims)
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)
