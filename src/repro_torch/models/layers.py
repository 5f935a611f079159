"""The layers of ``repro/models/layers.py``: the logical-axis rules and
``constrain``, dense, embedding, norms, RoPE.

Functional: ``*_init`` returns a param dict drawn from an explicit
``torch.Generator`` on the generator's device, the apply functions are
pure.  Norms and RoPE compute in fp32 and cast back to the input's dtype.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that the init
    functions, which draw on their generator's device, build params on the
    meta device (shapes and dtypes, no data): ``torch.Generator`` has no
    meta device of its own."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """The init generator for ``device``, seeded with ``seed``."""
    if device.type == "meta":
        return MetaGenerator().manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Logical-axis sharding constraints.
#
# The launcher installs a mapping logical axis -> mesh axes.  ``constrain``
# lays a DTensor out as the rules say; a plain tensor (and any tensor when
# no rules are installed) passes unchanged, as JAX's constraint is a no-op
# without a mesh.  The model code calls it nowhere: the port has no GSPMD
# for such annotations to steer.
# ---------------------------------------------------------------------------
_LOGICAL_RULES: dict = {}


def set_logical_rules(rules: dict) -> None:
    """rules: logical axis name -> mesh axis (str, tuple of str, or None)."""
    global _LOGICAL_RULES
    _LOGICAL_RULES = dict(rules)


@contextlib.contextmanager
def use_logical_rules(rules: dict):
    """The rules installed for the block, the previous ones back after."""
    prev = dict(_LOGICAL_RULES)
    set_logical_rules(rules)
    try:
        yield
    finally:
        set_logical_rules(prev)


def constrain(x, *logical_axes: Optional[str]):
    """A DTensor redistributed to the placements the rules give its
    logical axes; any other tensor unchanged."""
    if not _LOGICAL_RULES:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.models.dist import to_placements
    spec = tuple(_LOGICAL_RULES.get(a) if a is not None else None
                 for a in logical_axes)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    e = torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02
    return {"embedding": e.to(dtype)}


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S).
    Split-halves rotation [x1·cos − x2·sin, x2·cos + x1·sin], as
    ``repro/models/layers.py`` (not the interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (half,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, half)
    angles = angles[..., None, :]                                 # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")
