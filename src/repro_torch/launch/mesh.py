"""Meshes and ranks, as ``repro/launch/mesh.py``.

PyTorch has no abstract mesh, so the production meshes are mesh *shapes*
(``MeshShape``: axis names and sizes), which the dry-run plan and the
partition rules need and which need no process group; ``make_device_mesh``
builds a live ``DeviceMesh`` over the ranks that exist.

``run_ranks`` is the counterpart of JAX's forced host devices: it spawns one
process per rank, joined by a ``FileStore`` in a temporary directory (no TCP
port), runs a function on each and gathers what each returns.  The backend
follows one stated rule (``choose_backend``): NCCL when every rank has a
card of its own, gloo where several ranks share one card (NCCL refuses two
ranks on one device) or on the CPU.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with the attribute names of
    ``DeviceMesh`` (``mesh_dim_names``, ``shape``)."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh_dim_names

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 devices per pod; multi_pod adds a leading 2-pod axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_device_mesh(shape: Sequence[int], names: Sequence[str],
                     device="cuda"):
    """A live ``DeviceMesh`` of ``shape`` over ranks 0..prod(shape)-1 of the
    default process group (``run_ranks`` makes one), row-major, its dims
    named ``names``; ``device`` gives its device type."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if tdist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the process "
                         f"group has {tdist.get_world_size()}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_host_mesh(device):
    """A 1×1 ("data", "model") mesh over a one-rank process group on
    ``device``'s type."""
    return make_device_mesh((1, 1), ("data", "model"), device)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------
def choose_backend(world_size: int, device) -> Tuple[str, str]:
    """(backend, why): NCCL when every rank has a CUDA device of its own,
    gloo where ranks share a card (NCCL refuses two ranks on one device) or
    on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", f"ranks on {dev.type}"
    cards = torch.cuda.device_count()
    if cards >= world_size:
        return "nccl", f"{world_size} ranks, each on a card of its own"
    return "gloo", f"{world_size} ranks share {cards} card(s)"


def _rank_main(rank: int, world_size: int, backend: str, device: str,
               workdir: str, timeout_s: float, fn: Callable, args: tuple):
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = tdist.FileStore(os.path.join(workdir, "store"), world_size)
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world_size,
                             timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        tdist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *, device="cuda",
              timeout_s: float = 300.0, args: tuple = (),
              workdir: Optional[str] = None, verbose: bool = True) -> List[Any]:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned processes in
    one process group, each on one thread; returns what each rank returned
    (saved with ``torch.save``: keep it on the CPU).  ``fn`` must be
    importable by name (a module-level function).  The group's store is a
    ``FileStore`` in ``workdir`` (a fresh temporary directory by default).
    A rank that fails makes the call raise with its traceback at once; a
    rank that has not finished within ``timeout_s`` makes it stop every
    rank and raise."""
    backend, why = choose_backend(world_size, device)
    if verbose:
        print(f"[mesh] {world_size} ranks on {device}: backend {backend} "
              f"({why})", flush=True)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        spawn = torch.multiprocessing.get_context("spawn")
        procs = [spawn.Process(target=_rank_main, args=(
            r, world_size, backend, str(device), tmp, timeout_s, fn, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        pending = {p.sentinel: p for p in procs}
        failed = None
        while pending and failed is None:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            for s in multiprocessing.connection.wait(list(pending), left):
                p = pending.pop(s)
                p.join()
                if p.exitcode != 0:
                    failed = procs.index(p)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        if failed is not None:
            err = os.path.join(tmp, f"err{failed}.txt")
            msg = open(err).read() if os.path.exists(err) else \
                f"exit code {procs[failed].exitcode}"
            raise RuntimeError(f"rank {failed} of {world_size} failed:\n{msg}")
        if pending:
            raise TimeoutError(f"{len(pending)} of {world_size} ranks had not "
                               f"finished after {timeout_s} s")
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                for r in range(world_size)]
