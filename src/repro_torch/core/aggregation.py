"""FedAuto adaptive aggregation (Algorithm 2) and pytree aggregation utils,
ported from ``repro/core/aggregation.py``.

The aggregation itself (Eq. 7) is a β-weighted sum of participant parameter
trees, executed leaf-wise through ``kernels.ops.fedagg`` (the CUDA kernel on
the card, its plain version on the CPU).  Module 1 (compensatory training)
is triggered by ``missing_classes``; Module 2 (weight optimization) is
``fedauto_weights`` (``fedauto_discounted_weights`` and its lossless case
``fedauto_async_weights`` discount it by staleness and compression
fidelity), and the Table-5 ablation without it
``fedauto_simple_average_weights``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.weights_qp import solve_weights
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# weighted pytree aggregation (Eq. 5 / 7 / 10)
# ---------------------------------------------------------------------------
def aggregate_pytrees(trees: Sequence, betas) -> object:
    """Σ_m β_m · tree_m over a list of identically-structured trees."""
    dev = tree_leaves(trees[0])[0].device
    betas = torch.as_tensor(np.asarray(betas, np.float32), device=dev)

    def agg(*leaves):
        stacked = torch.stack([l.reshape(-1) for l in leaves], dim=0)
        out = kops.fedagg(stacked, betas)
        return out.reshape(leaves[0].shape).to(leaves[0].dtype)

    return tree_map(agg, *trees)


def delta_pytree(model, ref):
    """float32 update direction ``model − ref``, leaf-wise."""
    return tree_map(lambda w, g: w.to(torch.float32) - g.to(torch.float32),
                    model, ref)


# ---------------------------------------------------------------------------
# Module 1 — missing-class detection (Eq. 6 trigger)
# ---------------------------------------------------------------------------
def missing_classes(client_hists: np.ndarray, received: np.ndarray) -> np.ndarray:
    """client_hists: (N, C) per-client class sample counts; received: (N,)
    bool (selected AND connected). Returns bool (C,): classes with zero
    samples among received client updates."""
    if received.sum() == 0:
        return np.ones(client_hists.shape[1], dtype=bool)
    covered = client_hists[received].sum(axis=0) > 0
    return ~covered


# ---------------------------------------------------------------------------
# Module 2 — FedAuto weights (Eq. 8 with Eq. 9 pin)
# ---------------------------------------------------------------------------
def fedauto_weights(alpha_rows: np.ndarray, alpha_g: np.ndarray,
                    active: np.ndarray, server_row: int, *,
                    device="cuda") -> np.ndarray:
    """alpha_rows: (J, C) — row per participant (server, [compensatory],
    clients…); active: (J,) bool. Server pinned per Eq. 9:
    β_s = 1 / (1 + #connected non-server participants).  The QP is solved
    in float32 on ``device``."""
    m = int(active.sum()) - 1              # connected participants besides server
    beta_s = 1.0 / (1.0 + max(m, 0))
    f32 = torch.float32
    beta = solve_weights(torch.as_tensor(alpha_rows, dtype=f32, device=device),
                         torch.as_tensor(alpha_g, dtype=f32, device=device),
                         torch.as_tensor(active, device=device),
                         fixed_idx=server_row, fixed_val=np.float32(beta_s))
    return beta.cpu().numpy()


def fedauto_discounted_weights(alpha_rows: np.ndarray, alpha_g: np.ndarray,
                               staleness: np.ndarray,
                               distortion: np.ndarray, server_row: int,
                               discount_a: float = 0.5,
                               discount_b: float = 0.0, *,
                               device="cuda") -> np.ndarray:
    """One post-QP discount pipeline: staleness × compression fidelity.

    The QP is solved exactly as in the synchronous case — Eq. 9 pin
    ``β_s = 1/(1+m)`` included — then each non-server weight is discounted
    by ``(1 + s_j)^{-discount_a} · (1 − d_j)^{discount_b}`` and the free
    mass ``1 − β_s`` is redistributed, so the result stays on the simplex
    with the pin intact.  With every update fresh and every discount
    inactive this *is* ``fedauto_weights``.
    """
    staleness = np.asarray(staleness, dtype=float)
    distortion = np.clip(np.asarray(distortion, dtype=float), 0.0, 1.0)
    active = np.ones(len(alpha_rows), dtype=bool)
    beta = fedauto_weights(alpha_rows, alpha_g, active, server_row,
                           device=device)
    stale_on = bool(np.any(staleness > 0))
    fid_on = discount_b > 0 and bool(np.any(distortion > 0))
    if not stale_on and not fid_on:
        return beta          # fresh + lossless: exactly the sync solution
    disc = np.power(1.0 + np.maximum(staleness, 0.0), -discount_a)
    if fid_on:
        disc = disc * np.power(1.0 - distortion, discount_b)
    disc[server_row] = 1.0
    free = beta * disc
    free[server_row] = 0.0
    mass = 1.0 - beta[server_row]
    tot = free.sum()
    out = np.zeros_like(beta)
    out[server_row] = beta[server_row]
    if tot > 1e-12:
        out += free * (mass / tot)
    else:
        # every client weight vanished (all maximally stale/distorted): the
        # server keeps the whole budget, as with an empty round
        out[server_row] = 1.0
    return out


def fedauto_async_weights(alpha_rows: np.ndarray, alpha_g: np.ndarray,
                          staleness: np.ndarray, server_row: int,
                          discount_a: float = 0.5, *,
                          device="cuda") -> np.ndarray:
    """FedAuto-Async (staleness-aware Eq. 8 + Eq. 9 pin): the lossless
    special case of ``fedauto_discounted_weights``."""
    return fedauto_discounted_weights(
        alpha_rows, alpha_g, staleness,
        np.zeros(len(alpha_rows)), server_row,
        discount_a=discount_a, discount_b=0.0, device=device)


def fedauto_simple_average_weights(active: np.ndarray, server_row: int,
                                   has_comp: bool) -> np.ndarray:
    """Ablation (Appendix III-F2): Module 1 without Module 2 — Eq. (58)."""
    J = len(active)
    m = int(active.sum()) - 1 - (1 if has_comp else 0)  # connected clients
    beta = np.zeros(J)
    beta[server_row] = 1.0 / (1.0 + max(m, 0))
    rest = 1.0 - beta[server_row]
    others = [j for j in range(J) if j != server_row and active[j]]
    for j in others:
        beta[j] = rest / max(len(others), 1)
    return beta


# ---------------------------------------------------------------------------
# effective class distribution diagnostics (Theorem 1 terms)
# ---------------------------------------------------------------------------
def effective_distribution(beta: np.ndarray, alpha_rows: np.ndarray) -> np.ndarray:
    return beta @ alpha_rows


def chi2(p: np.ndarray, q: np.ndarray) -> float:
    """χ²(p‖q) = Σ (q_i − p_i)² / p_i with the paper's convention χ²_{p‖q}."""
    return float(np.sum(np.square(q - p) / np.maximum(p, 1e-12)))
