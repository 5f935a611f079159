"""Fused server-side aggregation of quantized payloads, ported from
``repro/fl/comm/fused.py``.

When every upload is an int8-family payload (``int8``, ``qsgd:<bits>``,
``sign1``), the dequantize and the β-reduction fuse into one pass over the
1-byte payloads per leaf (``kernels.ops.dequant_fedagg``):

    Σ_m β_m · decode(p_m)  =  Σ_m (β_m s_m^{(leaf)}) · q_m^{(leaf)}

``aggregate_quantized`` returns that β-weighted *decoded-delta* sum; with β
on the simplex the FedAvg-style model aggregate is
``t_global + aggregate_quantized(...)``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.fl.comm.codecs import Payload
from repro_torch.fl.comm.stream import _quant_reduce, payload_family
from repro_torch.tree import tree_unflatten


def is_quantized(payload: Payload) -> bool:
    """True iff every leaf is an int8-family (q, scale) payload."""
    return payload_family(payload) == "quant"


def aggregate_quantized(payloads: Sequence[Payload], betas):
    """β-weighted sum of decoded payload trees, dequantized in-kernel.

    payloads: M same-structure int8-family payloads; betas: (M,) on the
    payloads' device.  Returns the tree Σ_m β_m · decode(payloads[m]) in
    float32, one ``dequant_fedagg`` launch per leaf on the card."""
    if not payloads:
        raise ValueError("aggregate_quantized needs at least one payload")
    if not all(is_quantized(p) for p in payloads):
        raise ValueError("aggregate_quantized only takes int8-family "
                         "payloads (int8 / qsgd:<bits> / sign1)")
    dev = payloads[0].leaves[0].data["q"].device
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    out = []
    for li in range(len(payloads[0].leaves)):
        els = [p.leaves[li] for p in payloads]
        out.append(_quant_reduce([e.data["q"] for e in els],
                                 [e.data["scale"] for e in els],
                                 betas).reshape(els[0].shape))
    return tree_unflatten(payloads[0].treedef, out)
