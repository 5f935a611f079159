"""Update codecs: client update tree ⇄ wire payload with exact byte counts,
ported from ``repro/fl/comm/codecs.py``.

Each codec encodes a client's update (the float32 delta from the round's
global model, plus any error-feedback residual) into a ``Payload`` whose
``nbytes`` is the exact bytes-on-wire count, and decodes it server-side.
Every codec's byte count is a function of the tree *structure* only, never
of the values, so the failure model can price an upload before local
training runs.

Registry specs (``FFTConfig.codec``):

  fp32        identity float32 (4 B/param) — the lossless baseline
  fp16        half-precision cast (2 B/param)
  int8        per-leaf absmax linear quantization (1 B/param + 4 B scale)
  qsgd:<b>    b-bit (2..8) absmax quantization, deterministic nearest
              rounding (⌈b·n/8⌉ B + 4 B scale per leaf; held as one int8
              per value in memory, only the byte count is bit-packed)
  topk:<f>    top-⌈f·n⌉ magnitudes per leaf as (int32 index, fp32 value),
              indices sorted ascending
  sign1       1 bit/param sign (0 maps to +1) + per-leaf mean-|x| scale
  lora_only   fp32 over LoRA adapter factors only (refuses full params)

Payloads equal the JAX package's for the same input: the same ``q``,
``idx``, ``val`` and ``scale``, except that sign1's scale (a mean, summed
in another order) may differ in its last bits.  ``adaptive:<lo>-<hi>``
is no codec but a per-client rung controller (``fl.comm.adaptive``) that
the runner parses first; ``make_codec`` raises ``ValueError`` for it, as
the JAX package's does.  All codecs are deterministic (no RNG).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple, Type

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclasses.dataclass
class EncodedLeaf:
    """One tree leaf on the wire."""
    shape: Tuple[int, ...]
    data: Dict[str, Any]          # codec-specific tensors
    nbytes: int                   # exact wire bytes for this leaf


@dataclasses.dataclass
class Payload:
    """One client upload: encoded leaves in sorted-key flatten order."""
    codec: str
    leaves: List[EncodedLeaf]
    treedef: Any
    nbytes: int                   # Σ leaf nbytes (what the link carries)


class Codec:
    """Leaf-wise update codec.  ``encode_leaf``/``decode_leaf`` operate on
    float32 tensors; ``leaf_nbytes`` must be value-independent."""

    name = "base"
    lossless = False              # lossless ⇒ no error-feedback residual kept

    def encode_leaf(self, x: torch.Tensor) -> EncodedLeaf:
        raise NotImplementedError

    def decode_leaf(self, el: EncodedLeaf) -> torch.Tensor:
        raise NotImplementedError

    def leaf_nbytes(self, shape: Tuple[int, ...]) -> int:
        raise NotImplementedError

    # ---------------------------------------------------------------- trees
    def encode(self, tree) -> Payload:
        leaves, treedef = tree_flatten(tree)
        enc = [self.encode_leaf(l.to(torch.float32)) for l in leaves]
        return Payload(codec=self.name, leaves=enc, treedef=treedef,
                       nbytes=sum(e.nbytes for e in enc))

    def decode(self, payload: Payload):
        return tree_unflatten(payload.treedef,
                              [self.decode_leaf(e) for e in payload.leaves])

    def nbytes(self, template) -> int:
        """Exact wire bytes for any value with ``template``'s structure."""
        return sum(self.leaf_nbytes(tuple(l.shape))
                   for l in tree_leaves(template))

    def validate_template(self, template, lora_cfg=None) -> None:
        """Hook: codecs with structural requirements raise here."""


def _size(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape)) if shape else 1


# ---------------------------------------------------------------------------
# lossless float codecs
# ---------------------------------------------------------------------------
class Fp32Codec(Codec):
    name = "fp32"
    lossless = True

    def encode_leaf(self, x):
        return EncodedLeaf(tuple(x.shape), {"v": x},
                           self.leaf_nbytes(tuple(x.shape)))

    def decode_leaf(self, el):
        return el.data["v"]

    def leaf_nbytes(self, shape):
        return 4 * _size(shape)


class Fp16Codec(Codec):
    """Half-precision cast.  Lossy in general (hence error feedback), exact
    on fp16-representable values."""
    name = "fp16"

    def encode_leaf(self, x):
        return EncodedLeaf(tuple(x.shape), {"v": x.to(torch.float16)},
                           self.leaf_nbytes(tuple(x.shape)))

    def decode_leaf(self, el):
        return el.data["v"].to(torch.float32)

    def leaf_nbytes(self, shape):
        return 2 * _size(shape)


class LoRAOnlyCodec(Fp32Codec):
    """fp32 over adapter factors only.  The runner's trainable tree *is*
    the adapter dict in LoRA mode, so numerically this is the identity; the
    codec's job is to refuse full-parameter trees, turning "only adapters
    travel" from a convention into an enforced invariant, and to make the
    byte accounting reflect adapter-sized uploads."""
    name = "lora_only"

    def validate_template(self, template, lora_cfg=None) -> None:
        if lora_cfg is None:
            raise ValueError(
                "codec 'lora_only' needs a LoRA run (lora_cfg set): the "
                "trainable tree must be the adapter dict, not full params")
        ok = (isinstance(template, dict) and template and all(
            isinstance(v, dict) and set(v) == {"a", "b"}
            for v in template.values()))
        if not ok:
            raise ValueError(
                "codec 'lora_only': trainable tree is not an adapter dict "
                "({path: {'a','b'}}); refusing full-parameter upload")


# ---------------------------------------------------------------------------
# quantizers (deterministic nearest rounding; EF makes them convergent)
# ---------------------------------------------------------------------------
class _ScaledInt8Codec(Codec):
    """Payload {"q": int8 tensor, "scale": fp32 scalar}; decode q · scale."""

    def decode_leaf(self, el):
        return el.data["q"].to(torch.float32) * el.data["scale"]


class QSGDCodec(_ScaledInt8Codec):
    """b-bit absmax quantization (levels = 2^{b−1} − 1 signed), with
    deterministic nearest rounding (half to even, as ``jnp.round``) instead
    of QSGD's stochastic rounding; error feedback absorbs the bias.  Wire:
    ⌈b·n/8⌉ B + 4 B scale per leaf."""

    def __init__(self, bits: int):
        # 2^b − 1 symmetric values fit b bits; the 1-bit case is ``sign1``
        if not 2 <= bits <= 8:
            raise ValueError(f"qsgd bits must be in 2..8 (1-bit = sign1), "
                             f"got {bits}")
        self.bits = bits
        self.name = f"qsgd:{bits}"
        self.levels = (1 << (bits - 1)) - 1           # signed levels

    def encode_leaf(self, x):
        scale = x.abs().max().clamp(min=1e-12) / self.levels
        q = torch.round(x / scale).clamp(-self.levels, self.levels)
        return EncodedLeaf(tuple(x.shape), {"q": q.to(torch.int8),
                                            "scale": scale},
                           self.leaf_nbytes(tuple(x.shape)))

    def leaf_nbytes(self, shape):
        return math.ceil(self.bits * _size(shape) / 8) + 4


class Int8Codec(QSGDCodec):
    """Per-leaf absmax linear quantization to int8: q = round(127·x/‖x‖∞),
    i.e. ``qsgd:8`` under its own name.  Wire: 1 B/param + one fp32 scale
    per leaf.  |x − x̂| ≤ scale/2."""

    def __init__(self):
        super().__init__(8)
        self.name = "int8"


class Sign1Codec(_ScaledInt8Codec):
    """signSGD / FeedSign-style 1-bit codec: sign(x) at 1 bit/param (0 maps
    to +1, as the JAX codec's ``where(x < 0, -1, 1)``), scaled by the
    leaf's mean |x|.  Wire: ⌈n/8⌉ B + 4 B scale per leaf."""
    name = "sign1"

    def encode_leaf(self, x):
        scale = x.abs().mean()
        s = torch.where(x < 0, -1, 1).to(torch.int8)
        return EncodedLeaf(tuple(x.shape), {"q": s, "scale": scale},
                           self.leaf_nbytes(tuple(x.shape)))

    def leaf_nbytes(self, shape):
        return math.ceil(_size(shape) / 8) + 4


class TopKCodec(Codec):
    """Per-leaf magnitude sparsification: keep the ⌈f·n⌉ largest-|x| entries
    as (int32 index, fp32 value) pairs, indices sorted ascending; everything
    else is zero server-side and carried forward by the error-feedback
    residual.  A stable descending sort keeps the lower index among equal
    magnitudes, as ``jax.lax.top_k`` does, so ties (exact zeros) choose the
    JAX package's entries too."""

    def __init__(self, frac: float):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        self.frac = frac
        self.name = f"topk:{frac:g}"

    def _k(self, shape) -> int:
        return max(1, math.ceil(self.frac * _size(shape)))

    def encode_leaf(self, x):
        flat = x.reshape(-1)
        k = self._k(tuple(x.shape))
        order = torch.sort(flat.abs(), descending=True, stable=True).indices
        idx = torch.sort(order[:k]).values
        return EncodedLeaf(tuple(x.shape),
                           {"idx": idx.to(torch.int32), "val": flat[idx]},
                           self.leaf_nbytes(tuple(x.shape)))

    def decode_leaf(self, el):
        flat = torch.zeros(_size(el.shape), dtype=torch.float32,
                           device=el.data["val"].device)
        flat[el.data["idx"].long()] = el.data["val"]
        return flat.reshape(el.shape)

    def leaf_nbytes(self, shape):
        return 8 * self._k(shape)                # 4 B index + 4 B value


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
CODECS: Dict[str, Type[Codec]] = {
    "fp32": Fp32Codec,
    "fp16": Fp16Codec,
    "int8": Int8Codec,
    "sign1": Sign1Codec,
    "lora_only": LoRAOnlyCodec,
}

PARAMETRIC_CODECS = ("qsgd", "topk")


def available_codecs() -> List[str]:
    return sorted(CODECS) + [f"{p}:<arg>" for p in PARAMETRIC_CODECS]


def make_codec(spec: str) -> Codec:
    """Parse a codec spec ("fp32", "qsgd:4", "topk:0.1", ...) and build it."""
    spec = spec.strip()
    if spec in CODECS:
        return CODECS[spec]()
    family, _, arg = spec.partition(":")
    if arg and family in PARAMETRIC_CODECS:
        try:
            return QSGDCodec(int(arg)) if family == "qsgd" else TopKCodec(float(arg))
        except ValueError as e:
            raise ValueError(f"bad codec spec {spec!r}: {e}") from None
    raise ValueError(f"unknown codec {spec!r}; "
                     f"available: {available_codecs()}")
