"""Plain PyTorch versions of the aggregation kernels.

Each is a sequential fold over the participant axis m, in the order of the
JAX package's reference flush (``repro/fl/comm/stream.py`` ``_float_reduce``
/ ``_quant_reduce`` with dispatch "off"): ``out = c_0·x_0``, then
``out = out + c_m·x_m``.  ``kernels.ops`` takes them for tensors that lie on
the CPU; ``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch


def _fold(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    if x.shape[0] == 0:
        raise ValueError("a reduction over zero participants has no value")
    out = None
    for m in range(x.shape[0]):
        term = coef[m] * x[m].to(torch.float32)
        out = term if out is None else out + term
    return out


def fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp32/bf16; betas: (M,).  Returns (P,) in stacked's
    dtype = Σ_m β_m·stacked[m], accumulated in fp32 (Eq. 7)."""
    return _fold(stacked, betas.to(torch.float32)).to(stacked.dtype)


def float_fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp16/fp32 payloads; betas: (M,).  Returns (P,) fp32
    = Σ_m β_m·stacked[m]."""
    return _fold(stacked, betas.to(torch.float32))


def dequant_fedagg(q: torch.Tensor, scales: torch.Tensor,
                   betas: torch.Tensor) -> torch.Tensor:
    """q: (M, P) int8; scales, betas: (M,).  Returns (P,) fp32
    = Σ_m (β_m·s_m)·q[m]."""
    return _fold(q, betas.to(torch.float32) * scales.to(torch.float32))
