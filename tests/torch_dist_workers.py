"""Rank functions for ``tests/test_torch_dist.py``: each spawned rank imports
this module by name (it imports torch, the port and ``chip_smoke``, never
JAX, so a rank starts in a couple of seconds)."""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402


def decode_cases(rank, world, specs):
    """``chip_smoke.dist_decode_rank`` for each spec, then ``constrain``
    on a DTensor on the same ranks."""
    return ([chip_smoke.dist_decode_rank(rank, world, s) for s in specs],
            constrain_check(world))


def constrain_check(world):
    """A replicated (4, 8) DTensor on a (1, world) mesh constrained to
    ("batch", "heads") under rules batch -> data, heads -> model; a plain
    tensor through the same call."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.layers import constrain, use_logical_rules
    mesh = make_device_mesh((1, world), ("data", "model"), "cpu")
    x = torch.arange(32.0).reshape(4, 8)
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with use_logical_rules({"batch": "data", "heads": "model"}):
        y = constrain(d, "batch", "heads")
        plain = constrain(x, "batch", "heads")
    return {"placements": [str(p) for p in y.placements],
            "local": y.to_local().clone(), "full": y.full_tensor(),
            "plain_unchanged": plain is x}


def host_mesh(rank, world):
    from repro_torch.launch.mesh import make_host_mesh
    m = make_host_mesh("cpu")
    return tuple(m.mesh_dim_names), tuple(m.shape), m.device_type


def fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def sleep(rank, world):
    import time
    time.sleep(60)
