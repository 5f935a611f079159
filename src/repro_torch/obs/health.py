"""Online run-health monitors over the telemetry round stream.

Long federated runs fail *quietly*: the loop keeps turning while accuracy
bleeds, β mass collapses onto one survivor, the adaptive controller thrashes
between rungs, or every cohort comes back empty.  ``HealthMonitors``
watches the constant-size round digests the hub builds at ``end_round``
(mode-agnostic — full and sketch runs produce the same digest) and emits
schema'd **health records** on rising edges, plus a run-end **verdict**
surfaced by the console sink, ``run-report``, and benchmark exit codes.

Detectors (each gated by ``HealthConfig``):

* ``acc_drawdown``     evaluated accuracy fell more than ``acc_drawdown``
                       below its running max (same definition as
                       ``repro_torch.fl.metrics.accuracy_drawdown``), after
                       ``acc_warmup_evals`` evaluations;
* ``beta_collapse``    β effective sample size (the ``beta_ess`` gauge,
                       (Σβ)²/Σβ²) stayed below ``beta_ess_frac`` of the
                       round's client rows for ``beta_streak`` consecutive
                       aggregating rounds — the aggregation view's "one
                       client is the model now" failure;
* ``rung_thrash``      the adaptive controller's ``rung_churn`` gauge
                       (fraction of clients whose assigned rung changed)
                       exceeded ``rung_churn_max`` for ``rung_streak``
                       consecutive rounds;
* ``cap_drift``        the controller's mean capacity estimate drifted more
                       than ``cap_drift_factor``× away from its running
                       median baseline — link collapse or estimator
                       divergence;
* ``distortion_spike`` the round's mean upload distortion jumped more than
                       ``distortion_spike``× (and ``distortion_min_jump``
                       absolute) above the running median of past rounds;
* ``empty_cohort``     ``empty_streak`` consecutive rounds aggregated
                       nothing;
* ``eviction_streak``  ``eviction_streak`` consecutive rounds evicted
                       buffered uploads.

Monitors are **observational** and edge-triggered: an alarm fires when a
condition becomes true and re-arms only after the condition clears, so a
ten-round blackout is one record per detector, not ten.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.obs.telemetry import AGGREGATED, EVICTED


@dataclass
class HealthConfig:
    """Thresholds for the online detectors; defaults are calibrated to stay
    silent on the committed healthy scenario baselines while firing on the
    seeded ``blackout`` fault-injection world."""

    acc_drawdown: float = 0.2          # drop below running-max accuracy
    acc_warmup_evals: int = 2          # evals before drawdown is armed
    beta_ess_frac: float = 0.12        # ESS / client rows considered collapse
    beta_min_rows: int = 4             # rounds with fewer rows can't collapse
    beta_streak: int = 2               # consecutive collapsed rounds to fire
    rung_churn_max: float = 0.5        # fraction of clients switching rungs
    rung_streak: int = 3               # consecutive thrashing rounds to fire
    cap_drift_factor: float = 8.0      # ×-fold drift from the running median
    cap_warmup_rounds: int = 3         # estimates before drift is armed
    distortion_spike: float = 3.0      # ×-fold jump over the running median
    distortion_min_jump: float = 0.1   # and at least this absolute jump
    empty_streak: int = 3              # consecutive zero-participant rounds
    eviction_streak: int = 3           # consecutive rounds with evictions


def health_record(rnd: int, monitor: str, value: float, threshold: float,
                  message: str) -> Dict[str, Any]:
    """One schema'd health event (the NDJSON ``health`` record payload)."""
    return {"round": int(rnd), "monitor": str(monitor),
            "severity": "alarm", "value": float(value),
            "threshold": float(threshold), "message": str(message)}


class _Median:
    """Running median over a small stream (one value per round — O(rounds)
    state, which the telemetry budget already carries)."""

    def __init__(self):
        self.values: List[float] = []

    def push(self, v: float) -> None:
        self.values.append(float(v))

    def get(self) -> Optional[float]:
        if not self.values:
            return None
        vs = sorted(self.values)
        n = len(vs)
        mid = n // 2
        return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


class HealthMonitors:
    """Stateful online detectors; feed one round digest at a time."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self.records: List[Dict[str, Any]] = []
        self.rounds_seen = 0
        self._active: set = set()          # monitors currently in alarm
        self._acc_max = -math.inf
        self._acc_evals = 0
        self._beta_low = 0
        self._churn_high = 0
        self._cap_median = _Median()
        self._dist_median = _Median()
        self._empty = 0
        self._evict = 0

    # ------------------------------------------------------------ plumbing
    def _edge(self, out: List[Dict], monitor: str, firing: bool,
              rnd: int, value: float, threshold: float, message: str
              ) -> None:
        """Edge-triggered emission: record on False→True, re-arm on
        True→False."""
        if firing and monitor not in self._active:
            self._active.add(monitor)
            out.append(health_record(rnd, monitor, value, threshold,
                                     message))
        elif not firing:
            self._active.discard(monitor)

    # -------------------------------------------------------------- observe
    def observe_round(self, digest: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Consume one round digest; return the health records (if any)
        that fired this round."""
        cfg = self.config
        out: List[Dict[str, Any]] = []
        rnd = digest["round"]
        gauges = digest.get("gauges", {})
        counts = digest.get("counts", {})
        self.rounds_seen += 1

        # accuracy drawdown from the running max, after warmup evals
        acc = digest.get("eval_acc")
        if acc is not None:
            self._acc_evals += 1
            self._acc_max = max(self._acc_max, float(acc))
            drawdown = self._acc_max - float(acc)
            armed = self._acc_evals > cfg.acc_warmup_evals
            self._edge(out, "acc_drawdown",
                       armed and drawdown > cfg.acc_drawdown, rnd,
                       drawdown, cfg.acc_drawdown,
                       f"accuracy {acc:.4f} is {drawdown:.4f} below its "
                       f"running max {self._acc_max:.4f}")

        # β-mass concentration collapse (ESS far below the row count)
        ess = digest.get("beta_ess")
        beta_n = digest.get("beta_n") or 0
        if ess is not None and beta_n >= cfg.beta_min_rows:
            frac = float(ess) / beta_n
            self._beta_low = (self._beta_low + 1
                              if frac < cfg.beta_ess_frac else 0)
            self._edge(out, "beta_collapse",
                       self._beta_low >= cfg.beta_streak, rnd,
                       frac, cfg.beta_ess_frac,
                       f"β effective sample size {ess:.2f} of {beta_n} "
                       f"client rows ({frac:.2f} < {cfg.beta_ess_frac}) "
                       f"for {self._beta_low} rounds")

        # adaptive-controller rung thrash
        churn = gauges.get("rung_churn")
        if churn is not None:
            self._churn_high = (self._churn_high + 1
                                if churn > cfg.rung_churn_max else 0)
            self._edge(out, "rung_thrash",
                       self._churn_high >= cfg.rung_streak, rnd,
                       churn, cfg.rung_churn_max,
                       f"{churn:.0%} of clients switched codec rungs, "
                       f"{self._churn_high} rounds running")

        # capacity-estimate drift vs the running median baseline
        cap = gauges.get("cap_hat_mean_bps")
        if cap is not None and cap > 0:
            base = self._cap_median.get()
            armed = len(self._cap_median.values) >= cfg.cap_warmup_rounds
            if armed and base is not None and base > 0:
                ratio = max(cap / base, base / cap)
                self._edge(out, "cap_drift",
                           ratio > cfg.cap_drift_factor, rnd,
                           ratio, cfg.cap_drift_factor,
                           f"mean capacity estimate {cap / 1e6:.2f} Mbps is "
                           f"{ratio:.1f}× away from its running median "
                           f"{base / 1e6:.2f} Mbps")
            self._cap_median.push(cap)

        # distortion spike over the running median of round means
        dist = digest.get("distortion_mean")
        if dist is not None:
            base = self._dist_median.get()
            if base is not None:
                jump = float(dist) - base
                firing = (dist > base * cfg.distortion_spike
                          and jump > cfg.distortion_min_jump)
                self._edge(out, "distortion_spike", firing, rnd,
                           float(dist), base * cfg.distortion_spike,
                           f"round mean distortion {dist:.3f} vs running "
                           f"median {base:.3f}")
            self._dist_median.push(float(dist))

        # empty-cohort and eviction streaks
        participants = digest.get("participants")
        if participants is None:
            participants = counts.get(AGGREGATED, 0)
        self._empty = self._empty + 1 if participants == 0 else 0
        self._edge(out, "empty_cohort", self._empty >= cfg.empty_streak,
                   rnd, self._empty, cfg.empty_streak,
                   f"{self._empty} consecutive rounds aggregated nothing")

        evicted = counts.get(EVICTED, 0)
        self._evict = self._evict + 1 if evicted > 0 else 0
        self._edge(out, "eviction_streak",
                   self._evict >= cfg.eviction_streak, rnd,
                   self._evict, cfg.eviction_streak,
                   f"evictions in {self._evict} consecutive rounds")

        self.records.extend(out)
        return out

    # -------------------------------------------------------------- verdict
    def verdict(self) -> Dict[str, Any]:
        """Run-end health verdict (the ``run_end`` record's ``health``
        section): healthy iff no detector ever fired."""
        by_monitor: Dict[str, int] = {}
        for rec in self.records:
            by_monitor[rec["monitor"]] = by_monitor.get(rec["monitor"], 0) + 1
        return {"healthy": not self.records,
                "n_alarms": len(self.records),
                "by_monitor": by_monitor,
                "first_alarm_round": (self.records[0]["round"]
                                      if self.records else None),
                "rounds_seen": self.rounds_seen}
