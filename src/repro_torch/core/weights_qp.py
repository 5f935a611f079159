"""Module 2 — aggregation-weight optimization (paper Eq. 8–9), ported from
``repro/core/weights_qp.py``.

    min_β  Σ_c ( α_{g,c} − Σ_j β_j α_{j,c} )² / α_{g,c}
    s.t.   β ≥ 0,  Σ_j β_j = 1,  β_s pinned to 1/(1+m)  (Eq. 9),
           β_j = 0 for unselected / disconnected participants (Eq. 10c).

FISTA (accelerated projected gradient) on the scaled simplex, 400
iterations in float32 on the caller's device, as the JAX solver runs it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_BIG = 1e9


def project_simplex(v: torch.Tensor, mask: torch.Tensor,
                    total: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of v onto {x >= 0, sum(x) = total, x[~mask] = 0}."""
    n = v.shape[0]
    vm = torch.where(mask, v, torch.full_like(v, -_BIG))
    vs = torch.sort(vm, descending=True).values
    css = torch.cumsum(vs, 0)
    j = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    cond = (vs - (css - total) / j > 0) & (vs > -_BIG / 2)
    idx = torch.arange(1, n + 1, device=v.device)
    rho = torch.where(cond, idx, torch.zeros_like(idx)).max().clamp(min=1)
    tau = (css[rho - 1] - total) / rho.to(v.dtype)
    return torch.where(mask, (v - tau).clamp(min=0.0), torch.zeros_like(v))


def solve_weights(alpha: torch.Tensor, alpha_g: torch.Tensor,
                  mask: torch.Tensor, fixed_idx: Optional[int] = None,
                  fixed_val: Optional[float] = None,
                  iters: int = 400) -> torch.Tensor:
    """FISTA for Eq. (8) on ``alpha``'s device.

    alpha: (J, C) per-participant class distributions (rows sum to 1).
    alpha_g: (C,) global class distribution.
    mask: (J,) bool — participant present this round (Eq. 10c).
    fixed_idx/fixed_val: pin β[fixed_idx] (the server, Eq. 9). The remaining
    mass 1 − fixed_val is distributed over the other active participants.
    Returns β (J,) float32 satisfying all constraints exactly.
    """
    J, _ = alpha.shape
    dev = alpha.device
    f32 = torch.float32
    alpha = alpha.to(f32)
    alpha_g = alpha_g.to(f32)
    mask = mask.to(torch.bool)
    dinv = 1.0 / alpha_g.clamp(min=1e-12)

    if fixed_idx is not None:
        fval = torch.tensor(fixed_val, dtype=f32, device=dev)
        fmask = torch.arange(J, device=dev) == fixed_idx
        fixed_vec = torch.where(fmask, fval, torch.zeros((), dtype=f32, device=dev))
        free_mask = mask & ~fmask
        total = 1.0 - fval
    else:
        fixed_vec = torch.zeros((J,), dtype=f32, device=dev)
        free_mask = mask
        total = torch.tensor(1.0, dtype=f32, device=dev)

    resid0 = alpha_g - fixed_vec @ alpha       # target for the free part

    def grad(z):
        eff = z @ alpha
        return 2.0 * ((eff - resid0) * dinv) @ alpha.T

    # Lipschitz bound: 2 * ||A D^-1 A^T||_F  (A = alpha)
    M = (alpha * dinv[None, :]) @ alpha.T
    L = 2.0 * torch.sqrt(torch.sum(M * M)) + 1e-6
    step = 1.0 / L

    n_active = free_mask.to(f32).sum().clamp(min=1.0)
    z = torch.where(free_mask, total / n_active, torch.zeros((), dtype=f32, device=dev))
    y = z
    t = torch.tensor(1.0, dtype=f32, device=dev)
    for _ in range(iters):
        z_new = project_simplex(y - step * grad(y), free_mask, total)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = z_new + ((t - 1.0) / t_new) * (z_new - z)
        z, t = z_new, t_new
    return z + fixed_vec


def heuristic_weights(p: np.ndarray, mask: np.ndarray, server_idx: int,
                      full_participation: bool) -> np.ndarray:
    """Footnote-2 heuristic weights used by FedAvg/FedProx under failures."""
    J = len(p)
    beta = np.zeros(J)
    if full_participation:
        denom = p[server_idx] + sum(p[j] for j in range(J)
                                    if mask[j] and j != server_idx)
        for j in range(J):
            if j == server_idx or mask[j]:
                beta[j] = p[j] / max(denom, 1e-12)
    else:
        m = sum(1 for j in range(J) if mask[j] and j != server_idx)
        beta[server_idx] = p[server_idx]
        for j in range(J):
            if j != server_idx and mask[j]:
                beta[j] = (1.0 - p[server_idx]) / max(m, 1)
    return beta
