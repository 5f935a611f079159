"""Shared run-level metrics: one definition of the headline numbers
(post-outage accuracy drawdown, mean upload distortion).  A copy of
``repro/fl/metrics.py``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def accuracy_drawdown(hist: List[float], warmup: int = 0) -> float:
    """Worst accuracy drawdown (running max − current) over an eval curve,
    counted from eval index ``warmup`` onward (the running max still warms
    up over the skipped prefix)."""
    worst, run_max = 0.0, 0.0
    for i, acc in enumerate(hist):
        run_max = max(run_max, acc)
        if i >= warmup:
            worst = max(worst, run_max - acc)
    return worst


def mean_distortion(distortion_history: List[Dict[int, float]]) -> float:
    """Mean per-upload compression distortion over a run
    (``RoundLoop.distortion_history``); 0.0 if nothing was uploaded."""
    vals = [d for per_round in distortion_history
            for d in per_round.values()]
    return float(np.mean(vals)) if vals else 0.0


def distortion_replay_matches(failures, distortion_history, rounds: int
                              ) -> bool:
    """True iff the distortions a v4 trace recorded for rounds
    ``1..rounds`` equal a same-config replay's recomputed ones bit-exactly
    (``failures`` is the replay's ``ReplayFailureModel``,
    ``distortion_history`` the replaying loop's).  A NaN / absent field
    means that client uploaded nothing that round.  Only meaningful for a
    replay under the *same* strategy and config — distortion depends on the
    model trajectory, not just the network realization."""
    for r in range(1, rounds + 1):
        rec = failures.distortions(r)
        live = distortion_history[r - 1]
        if rec is None:
            if live:
                return False
            continue
        for i, v in enumerate(rec):
            if np.isnan(v):
                if i in live:
                    return False
            elif live.get(i) != v:
                return False
    return True
