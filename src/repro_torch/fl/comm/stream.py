"""Streaming server-side aggregation: K arrivals, one fp32 accumulator,
ported from ``repro/fl/comm/stream.py``.

Uploads arrive as *packed* payloads (``CommState.encode_upload``) and a
``StreamAccumulator`` consumes ``(payload, β)`` pairs incrementally,
batching per rung family through the decode-and-accumulate kernels
(``kernels.ops.dequant_fedagg`` / ``float_fedagg`` / ``topk_fedagg_into``) into
ONE shared fp32 accumulator:

    acc[p] += Σ_{batch} β_m · decode(p_m)[p]

one kernel launch per leaf for the dense families, one launch count per
flush over every leaf for top-k (``kernels.ops.topk_fedagg_into``).

Peak *decoded* memory is O(1) in K.  Payloads bucket by rung family
(``quant`` = int8/qsgd/sign1, ``fp16``, ``fp32``, ``topk:<spec>``); a
payload of any other layout falls back to per-payload decode into the
accumulator.

``weighted_model_sum`` builds the strategy-facing aggregate

    Σ_j β_j · (origin_global_j + decode(p_j))  +  Σ_t w_t · tree_t

without materializing any per-client model: the origin-global coefficients
group per *distinct* origin tree, so the dense part is O(#origins) trees.

A dense flush stacks the batch's leaves into a fresh (M, P) tensor before
each launch, as the JAX package does.  A top-k flush stacks nothing: on the
card its kernels read every payload's rows where they lie and add the fold
into the accumulator themselves, so no partial leaf is allocated (the
``peak_decoded_bytes`` accounting still counts one, as the JAX package's
does); on the CPU the plain version stacks and adds leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fl.comm.codecs import Payload, make_codec
from repro_torch.kernels import ops as kops
from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _quant_reduce(qs, scales, betas):
    q = torch.stack([x.reshape(-1) for x in qs])
    s = torch.stack([x.to(torch.float32).reshape(()) for x in scales])
    return kops.dequant_fedagg(q, s, betas)


def _float_reduce(xs, betas):
    return kops.float_fedagg(torch.stack([x.reshape(-1) for x in xs]), betas)


@dataclasses.dataclass
class PackedUpdate:
    """One upload exactly as the server receives it on the wire: the packed
    payload plus wire metadata.  ``origin_global`` is the global tree the
    payload's delta is relative to — shared by reference across a cohort."""
    client: int
    payload: Payload
    origin_global: Any
    codec: str
    nbytes: float
    distortion: float
    origin_round: int = 0


def _size(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def payload_family(payload: Payload) -> Optional[str]:
    """The batched-kernel bucket a payload belongs to, or ``None`` when no
    batched kernel covers it (→ per-payload decode fallback).  Top-k buckets
    carry the codec spec: two top-k payloads stack only when their per-leaf
    k agree, which the shared spec guarantees."""
    fams = set()
    for el in payload.leaves:
        keys = el.data.keys()
        if keys == _TOPK_KEYS:
            fams.add(payload.codec)              # "topk:<frac>": k must agree
        elif keys == _QUANT_KEYS and el.data["q"].dtype == torch.int8:
            fams.add("quant")
        elif keys == _FLOAT_KEYS:
            fams.add("fp16" if el.data["v"].dtype == torch.float16 else "fp32")
        else:
            return None
    return fams.pop() if len(fams) == 1 else None


_TOPK_KEYS, _QUANT_KEYS, _FLOAT_KEYS = {"idx", "val"}, {"q", "scale"}, {"v"}


class StreamAccumulator:
    """Incremental β-weighted decode-and-accumulate over packed payloads.

    ``add(payload, β)`` buckets the payload by rung family; every
    ``batch_k`` payloads of a family flush through that family's batched
    kernel into the shared per-leaf fp32 accumulator.  ``total()`` flushes
    the stragglers and returns ``Σ β_m · decode(p_m)`` as an fp32 tree.
    The accumulator is owned here and updated in place.

    ``peak_decoded_bytes`` tracks the high-water mark of *decoded* fp32
    bytes live at once: the accumulator plus one batched partial leaf
    (fused flush) or one template (fallback decode).  The telemetry
    counters ``uplink.fused_payloads`` / ``uplink.fallback_payloads`` feed
    the profiler's ``uplink_decode`` attribution
    (``repro/fl/comm/stream.py:157-164, 213-244``).
    """

    def __init__(self, template, *, batch_k: int = 64,
                 telemetry=NULL_TELEMETRY):
        leaves, treedef = tree_flatten(template)
        self._treedef = treedef
        self._shapes = [tuple(l.shape) for l in leaves]
        self._device = leaves[0].device
        self._acc: Optional[List[torch.Tensor]] = None
        self._topk_plan = kops.TopkPlan()    # the card's leaf table, workspace
        self._buckets: Dict[str, List[Tuple[Payload, float]]] = {}
        self.batch_k = int(batch_k)
        self.telemetry = telemetry
        self.n_added = 0
        self.n_fused = 0
        self.n_fallback = 0
        self.n_flushes = 0
        self._acc_bytes = sum(4 * _size(s) for s in self._shapes)
        self.peak_decoded_bytes = 0

    # ------------------------------------------------------------- feeding
    def add(self, payload: Payload, beta: float) -> None:
        """Consume one ``(payload, β)`` pair; may trigger a batch flush."""
        self.n_added += 1
        fam = payload_family(payload)
        if fam is None:
            self._fallback(payload, beta)
            return
        bucket = self._buckets.setdefault(fam, [])
        bucket.append((payload, float(beta)))
        if len(bucket) >= self.batch_k:
            self._flush(fam)

    def add_tree(self, tree, weight: float) -> None:
        """Accumulate ``weight · tree`` directly (already-dense terms)."""
        self._ensure_acc()
        w = torch.tensor(weight, dtype=torch.float32, device=self._device)
        for acc, leaf in zip(self._acc, tree_leaves(tree)):
            acc.add_(w * leaf.to(torch.float32).reshape(-1))

    # ------------------------------------------------------------ flushing
    def _ensure_acc(self) -> None:
        if self._acc is None:
            self._acc = [torch.zeros((_size(s),), dtype=torch.float32,
                                     device=self._device)
                         for s in self._shapes]
            self._views = [a.view(s) for a, s in zip(self._acc, self._shapes)]
            self._note_peak(0)

    def _note_peak(self, transient_bytes: int) -> None:
        live = self._acc_bytes + transient_bytes
        if live > self.peak_decoded_bytes:
            self.peak_decoded_bytes = live

    def _fallback(self, payload: Payload, beta: float) -> None:
        # no batched kernel for this payload: decode it alone and fold it
        # in — one transient fp32 template, immediately released
        self.add_tree(make_codec(payload.codec).decode(payload), beta)
        self.n_fallback += 1
        self._note_peak(self._acc_bytes)
        if self.telemetry:
            self.telemetry.counter("uplink.fallback_payloads")
            self.telemetry.counter("uplink.decoded_bytes", self._acc_bytes)

    def _flush(self, fam: str) -> None:
        entries = self._buckets.pop(fam, [])
        if not entries:
            return
        self._ensure_acc()
        payloads = [p for p, _ in entries]
        if fam not in ("quant", "fp16", "fp32"):   # topk:<spec>: every leaf
            # β as floats: on the card they travel with the row table
            kops.topk_fedagg_into(
                self._acc, [[e.data["idx"] for e in p.leaves] for p in payloads],
                [[e.data["val"] for e in p.leaves] for p in payloads],
                [b for _, b in entries], plan=self._topk_plan)
            # one batched partial leaf, as the JAX package counts it (the
            # card allocates none)
            self._note_peak(4 * max(_size(s) for s in self._shapes))
        else:
            betas = torch.tensor([b for _, b in entries], dtype=torch.float32,
                                 device=self._device)
            for li, shape in enumerate(self._shapes):
                els = [p.leaves[li] for p in payloads]
                if fam == "quant":
                    part = _quant_reduce([e.data["q"] for e in els],
                                         [e.data["scale"] for e in els], betas)
                else:
                    part = _float_reduce([e.data["v"] for e in els], betas)
                self._acc[li].add_(part)
                self._note_peak(4 * _size(shape))  # one batched partial leaf
        self.n_fused += len(entries)
        self.n_flushes += 1
        if self.telemetry:
            self.telemetry.counter("uplink.fused_payloads", len(entries))

    def total(self):
        """Flush every bucket and return ``Σ β_m·decode(p_m)`` (+ any
        ``add_tree`` terms) as an fp32 tree of the template's structure.
        An empty accumulator (empty cohort) returns exact zeros."""
        for fam in list(self._buckets):
            self._flush(fam)
        self._ensure_acc()
        return tree_unflatten(self._treedef, self._views)

    @property
    def stats(self) -> Dict[str, float]:
        return {"added": self.n_added, "fused": self.n_fused,
                "fallback": self.n_fallback, "flushes": self.n_flushes,
                "peak_decoded_bytes": float(self.peak_decoded_bytes)}


def weighted_tree_sum(trees: Sequence[Any], weights: Sequence[float]):
    """Σ_t w_t · tree_t with fp32 leaves, through the batched float kernel.
    Small-M companion of the accumulator for the dense terms of a streaming
    aggregate (server anchor + distinct origin globals)."""
    if not trees:
        raise ValueError("weighted_tree_sum needs at least one tree")
    leaves0, treedef = tree_flatten(trees[0])
    w = torch.tensor([float(x) for x in weights], dtype=torch.float32,
                     device=leaves0[0].device)
    flats = [tree_leaves(t) for t in trees]
    out = [_float_reduce([f[li] for f in flats], w).reshape(leaves0[li].shape)
           for li in range(len(leaves0))]
    return tree_unflatten(treedef, out)


def weighted_model_sum(packed_terms: Sequence[Tuple[float, PackedUpdate]],
                       dense_terms: Sequence[Tuple[float, Any]] = (), *,
                       template, batch_k: int = 64,
                       telemetry=NULL_TELEMETRY, rnd: Optional[int] = None):
    """The streaming form of a strategy's β-weighted model aggregate:

        Σ_j β_j·(origin_global_j + decode(payload_j)) + Σ_t w_t·tree_t

    computed as one StreamAccumulator pass over the packed payloads plus an
    O(#distinct origin globals + #dense terms) dense sum.  Returns fp32
    leaves (callers cast to their model dtype).  When ``rnd`` is given,
    emits the per-round ``uplink_decode`` attribution gauges."""
    acc = StreamAccumulator(template, batch_k=batch_k, telemetry=telemetry)
    origin: Dict[int, List[Any]] = {}        # id(tree) -> [tree, coef]
    for beta, pu in packed_terms:
        acc.add(pu.payload, beta)
        ent = origin.setdefault(id(pu.origin_global), [pu.origin_global, 0.0])
        ent[1] += float(beta)
    trees = [t for _, t in dense_terms] + [t for t, _ in origin.values()]
    weights = [w for w, _ in dense_terms] + [c for _, c in origin.values()]
    delta = acc.total()
    out = (tree_map(torch.add, weighted_tree_sum(trees, weights), delta)
           if trees else delta)
    if telemetry and rnd is not None:
        telemetry.gauge(rnd, "uplink_fused_payloads", acc.n_fused)
        telemetry.gauge(rnd, "uplink_fallback_payloads", acc.n_fallback)
        telemetry.gauge(rnd, "uplink_peak_decoded_bytes",
                        acc.peak_decoded_bytes)
    return out
