"""Update codecs: client update tree ⇄ wire payload with exact byte counts,
ported from ``repro/fl/comm/codecs.py``.

Each codec encodes a client's update (the float32 delta from the round's
global model, plus any error-feedback residual) into a ``Payload`` whose
``nbytes`` is the exact bytes-on-wire count, and decodes it server-side.
Every codec's byte count is a function of the tree *structure* only, never
of the values, so the failure model can price an upload before local
training runs.

Ported rungs (``FFTConfig.codec``):

  fp32        identity float32 (4 B/param) — the lossless baseline
  fp16        half-precision cast (2 B/param)
  int8        per-leaf absmax linear quantization (1 B/param + 4 B scale)
  lora_only   fp32 over LoRA adapter factors only (refuses full params)

The JAX package's ``qsgd:<b>``, ``topk:<f>``, ``sign1`` and
``adaptive:<lo>-<hi>`` specs are not ported yet; ``make_codec`` raises
``NotImplementedError`` for them.  All codecs are deterministic (no RNG).
"""
from __future__ import annotations

import dataclasses
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
class Int8Codec(Codec):
    """Per-leaf absmax linear quantization to int8: q = round(127·x/‖x‖∞).
    Wire: 1 B/param + one fp32 scale per leaf.  |x − x̂| ≤ scale/2."""
    name = "int8"

    def encode_leaf(self, x):
        scale = x.abs().max().clamp(min=1e-12) / 127.0
        q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
        return EncodedLeaf(tuple(x.shape), {"q": q, "scale": scale},
                           self.leaf_nbytes(tuple(x.shape)))

    def decode_leaf(self, el):
        return el.data["q"].to(torch.float32) * el.data["scale"]

    def leaf_nbytes(self, shape):
        return _size(shape) + 4


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
CODECS: Dict[str, Type[Codec]] = {
    "fp32": Fp32Codec,
    "fp16": Fp16Codec,
    "int8": Int8Codec,
    "lora_only": LoRAOnlyCodec,
}

NOT_PORTED = ("qsgd", "topk", "sign1", "adaptive")


def available_codecs() -> List[str]:
    return sorted(CODECS)


def make_codec(spec: str) -> Codec:
    """Build the codec named by ``spec`` ("fp32", "fp16", "int8",
    "lora_only")."""
    spec = spec.strip()
    if spec in CODECS:
        return CODECS[spec]()
    if spec.split(":", 1)[0] in NOT_PORTED:
        raise NotImplementedError(f"codec {spec!r} is not ported yet; "
                                  f"available: {available_codecs()}")
    raise ValueError(f"unknown codec {spec!r}; "
                     f"available: {available_codecs()}")
