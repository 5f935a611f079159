"""Device dispatch for the aggregation kernels.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a tensor
on a CUDA device goes to the hand-written kernel (``csrc/fedagg.cu``), or
the wrapper raises.  There is no mode switch and no fallback: a kernel that
fails to build or launch is an error.

``launches[name]`` counts the kernel launches of each wrapper (CPU calls
are not counted), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref as _ref

launches: Dict[str, int] = {"float_fedagg": 0, "dequant_fedagg": 0,
                            "fedagg": 0}

MAX_M = 12288          # the coefficients live in 48 KB of shared memory


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cpu(x: torch.Tensor, *others: torch.Tensor) -> bool:
    devs = {x.device} | {o.device for o in others}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def _check(name: str, x: torch.Tensor, dtypes: Tuple[torch.dtype, ...],
           *vectors: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a (M, P) matrix, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    M = x.shape[0]
    if not 1 <= M <= MAX_M:
        raise ValueError(f"{name}: M={M} outside [1, {MAX_M}]")
    for v in vectors:
        if v.shape != (M,):
            raise ValueError(f"{name}: expected a ({M},) coefficient vector, "
                             f"got {tuple(v.shape)}")


def _launch(entry: str, x: torch.Tensor, coef: torch.Tensor,
            out: torch.Tensor, name: str) -> torch.Tensor:
    from repro_torch.kernels.build import load
    M, P = x.shape
    if P == 0:
        return out
    coef = coef.to(torch.float32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(load(), entry)(x.data_ptr(), coef.data_ptr(),
                                     out.data_ptr(), M, P, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel {entry} launch failed with CUDA "
                           f"error {err}")
    launches[name] += 1
    return out


def float_fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp16/fp32; betas: (M,) -> (P,) fp32 = Σ_m β_m x[m]."""
    if _on_cpu(stacked, betas):
        return _ref.float_fedagg(stacked, betas)
    _check("float_fedagg", stacked, (torch.float32, torch.float16), betas)
    out = torch.empty(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    entry = ("coef_reduce_f32" if stacked.dtype == torch.float32
             else "coef_reduce_f16")
    return _launch(entry, stacked, betas, out, "float_fedagg")


def dequant_fedagg(q: torch.Tensor, scales: torch.Tensor,
                   betas: torch.Tensor) -> torch.Tensor:
    """q: (M, P) int8; scales, betas: (M,) -> (P,) fp32
    = Σ_m (β_m·s_m)·q[m], with c_m = β_m·s_m folded before the launch."""
    if _on_cpu(q, scales, betas):
        return _ref.dequant_fedagg(q, scales, betas)
    _check("dequant_fedagg", q, (torch.int8,), scales, betas)
    coef = betas.to(torch.float32) * scales.to(torch.float32)
    out = torch.empty(q.shape[1], dtype=torch.float32, device=q.device)
    return _launch("coef_reduce_i8", q, coef, out, "dequant_fedagg")


def fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp32/bf16; betas: (M,) -> (P,) in stacked's dtype
    = Σ_m β_m stacked[m], accumulated in fp32 (Eq. 7)."""
    if _on_cpu(stacked, betas):
        return _ref.fedagg(stacked, betas)
    _check("fedagg", stacked, (torch.float32, torch.bfloat16), betas)
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype,
                      device=stacked.device)
    entry = "fedagg_f32" if stacked.dtype == torch.float32 else "fedagg_bf16"
    return _launch(entry, stacked, betas, out, "fedagg")
