"""Run-report rendering and telemetry↔accounting reconciliation.

``render_markdown`` turns one or more ``RunReport``s (in-memory or loaded
from NDJSON logs) into Markdown tables: per-run summary, drop-cause
breakdown, bytes-vs-participation, and β-mass by staleness and by rung.
A copy of ``repro/obs/report.py``.

``reconcile`` is the cross-check that makes the instrumented numbers
provably the real ones: telemetry totals must agree with the accounting
that already existed — ``CommState.total_uplink_bytes`` /
``total_downlink_bytes``, the loop's ``participants_per_round``, and the
per-round per-client outcome closure (every client, every round, exactly
one terminal outcome).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.sinks import RunReport
from repro_torch.obs.telemetry import AGGREGATED, OUTCOMES


class ReconcileError(AssertionError):
    """Telemetry disagrees with the run's own accounting."""


def _close(a: float, b: float, *, rtol: float = 1e-9, atol: float = 1e-6
           ) -> bool:
    return abs(a - b) <= atol + rtol * max(abs(a), abs(b))


def reconcile(report: RunReport, runner) -> Dict[str, float]:
    """Assert ``report``'s aggregates match ``runner``'s accounting.

    Returns the reconciled numbers; raises ``ReconcileError`` naming the
    first disagreement.  Checks:

    * outcome closure — per-cause counts sum to ``n_clients × rounds`` and
      every outcome is from the known vocabulary;
    * telemetry byte totals equal ``CommState.total_uplink_bytes`` /
      ``total_downlink_bytes`` (and the hub's own ``comm.*`` counters);
    * the per-round participants gauge equals the loop's
      ``participants_per_round``.
    """
    counts = report.drop_cause_counts()
    unknown = set(counts) - set(OUTCOMES)
    if unknown:
        raise ReconcileError(f"unknown outcomes recorded: {sorted(unknown)}")
    total = sum(counts.values())
    want = report.n_clients * report.n_rounds
    if total != want:
        raise ReconcileError(
            f"outcome counts sum to {total}, expected n_clients × rounds = "
            f"{report.n_clients} × {report.n_rounds} = {want} ({counts})")

    comm = runner.comm
    up = report.total_upload_bytes()
    if not _close(up, comm.total_uplink_bytes):
        raise ReconcileError(
            f"telemetry uplink bytes {up} != CommState.total_uplink_bytes "
            f"{comm.total_uplink_bytes}")
    down = report.total_download_bytes()
    if not _close(down, comm.total_downlink_bytes):
        raise ReconcileError(
            f"telemetry downlink bytes {down} != "
            f"CommState.total_downlink_bytes {comm.total_downlink_bytes}")
    counters = report.summary.get("counters", {})
    for name, truth in (("comm.upload_bytes", comm.total_uplink_bytes),
                        ("comm.download_bytes", comm.total_downlink_bytes)):
        if name in counters and not _close(counters[name], truth):
            raise ReconcileError(
                f"counter {name} = {counters[name]} != {truth}")

    loop = getattr(runner, "loop", None)
    if loop is not None:
        parts = report.participants_per_round()
        if parts != [int(p) for p in loop.participants_per_round]:
            raise ReconcileError(
                f"participants gauge {parts} != loop.participants_per_round "
                f"{loop.participants_per_round}")

    # per-round phase gauges must telescope back to the run-summary timers
    # (the gauges are per-round deltas of the same accumulators), and no
    # round's phases may claim more than its measured wall time — the
    # profiler's exclusive-timer guarantee.
    timers = report.summary.get("timers_s", {})
    for name, want_s in timers.items():
        if not name.startswith("phase."):
            continue
        got_s = math.fsum(r["gauges"].get(name, 0.0) for r in report.rounds)
        if not _close(got_s, want_s):
            raise ReconcileError(
                f"per-round {name} gauges sum to {got_s} but the run "
                f"summary timer says {want_s}")
    for r in report.rounds:
        wall = r["gauges"].get("round_wall_s")
        if wall is None:
            continue
        claimed = math.fsum(v for k, v in r["gauges"].items()
                            if k.startswith("phase."))
        if claimed > wall + 1e-6:
            raise ReconcileError(
                f"round {r['round']}: phases claim {claimed}s of a "
                f"{wall}s round wall")

    return {"outcomes_total": float(total), "uplink_bytes": up,
            "downlink_bytes": down,
            "aggregated": float(counts[AGGREGATED])}


# ---------------------------------------------------------------------------
# Markdown rendering
# ---------------------------------------------------------------------------
def _table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    out = ["| " + " | ".join(header) + " |",
           "|" + "---|" * len(header)]
    for row in rows:
        out.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(out)


def _fmt(x, digits=2) -> str:
    if x is None:
        return "-"
    if isinstance(x, float):
        if math.isnan(x):
            return "-"
        return f"{x:.{digits}f}"
    return str(x)


def render_markdown(reports: List[RunReport],
                    labels: Optional[List[str]] = None) -> str:
    """Markdown run report over one or more telemetry ``RunReport``s."""
    labels = labels or [r.label() for r in reports]
    sections = ["# Run telemetry report", ""]

    rows = []
    for lab, rep in zip(labels, reports):
        rows.append([
            lab, rep.n_rounds, rep.n_clients,
            _fmt(rep.final_accuracy(), 4),
            _fmt(rep.mean_participants()),
            _fmt(rep.mean_distortion(), 3),
            _fmt(rep.total_upload_bytes() / 1e6),
            _fmt(rep.total_download_bytes() / 1e6)])
    sections += ["## Runs", "", _table(
        ["run", "rounds", "clients", "final_acc", "mean_participants",
         "mean_distortion", "uplink_MB", "downlink_MB"], rows), ""]

    rows = []
    for lab, rep in zip(labels, reports):
        counts = rep.drop_cause_counts()
        rows.append([lab] + [counts[c] for c in OUTCOMES]
                    + [sum(counts.values())])
    sections += ["## Drop-cause breakdown", "", _table(
        ["run"] + list(OUTCOMES) + ["total"], rows), ""]

    rows = []
    for lab, rep in zip(labels, reports):
        counts = rep.drop_cause_counts()
        agg = counts[AGGREGATED]
        up = rep.total_upload_bytes()
        rows.append([
            lab, agg, _fmt(rep.mean_participants()), _fmt(up / 1e6),
            _fmt(up / 1e3 / agg if agg else None),
            _fmt((up + rep.total_download_bytes()) / 1e6 /
                 max(rep.n_rounds, 1))])
    sections += ["## Bytes vs participation", "", _table(
        ["run", "aggregated_updates", "mean_participants", "uplink_MB",
         "KB_per_aggregated_update", "total_MB_per_round"], rows), ""]

    def mass_section(title: str, key: str, sort_key=None) -> List[str]:
        groups: List = []
        masses = []
        for rep in reports:
            m = rep.beta_mass_by(key)
            masses.append(m)
            for g in m:
                if g not in groups:
                    groups.append(g)
        if sort_key is not None:
            groups.sort(key=sort_key)
        rows = [[lab] + [_fmt(m.get(g, 0.0), 3) for g in groups]
                for lab, m in zip(labels, masses)]
        return [f"## {title}", "", _table(
            ["run"] + [str(g) for g in groups], rows), ""]

    # β-mass sections render for any report that recorded applied weights —
    # full mode keeps the rows, sketch mode keeps the per-group mass sums
    if any(rep.beta_mass_by("role") for rep in reports):
        sections += mass_section(
            "β-mass by staleness", "staleness",
            sort_key=lambda g: (isinstance(g, str), g))
        sections += mass_section("β-mass by rung", "rung",
                                 sort_key=lambda g: str(g))

    quantile_rows = []
    for lab, rep in zip(labels, reports):
        qdocs = rep.quantiles() if hasattr(rep, "quantiles") else {}
        for metric in sorted(qdocs):
            qs = qdocs[metric]
            quantile_rows.append(
                [lab, metric,
                 _fmt(qs.get(0.5), 4), _fmt(qs.get(0.9), 4),
                 _fmt(qs.get(0.99), 4)])
    if quantile_rows:
        sections += ["## Distribution quantiles", "",
                     "Exact for full-mode reports; rank error ≤ ε·n "
                     "(sketch ε, default 0.01) for sketch-mode reports.", "",
                     _table(["run", "metric", "p50", "p90", "p99"],
                            quantile_rows), ""]

    health_rows = []
    for lab, rep in zip(labels, reports):
        verdict = (rep.health_verdict()
                   if hasattr(rep, "health_verdict") else None)
        alarms = getattr(rep, "health", None) or []
        if verdict is None and not alarms:
            continue
        if verdict is None:
            verdict = {"healthy": not alarms, "n_alarms": len(alarms),
                       "first_alarm_round": (alarms[0]["round"]
                                             if alarms else None),
                       "by_monitor": {}}
        by = ",".join(f"{k}×{v}" for k, v in
                      sorted(verdict.get("by_monitor", {}).items())) or "-"
        health_rows.append(
            [lab, "HEALTHY" if verdict.get("healthy") else "ALARMS",
             verdict.get("n_alarms", 0),
             _fmt(verdict.get("first_alarm_round")), by])
    if health_rows:
        sections += ["## Health", "", _table(
            ["run", "verdict", "alarms", "first_alarm_round", "by_monitor"],
            health_rows), ""]
        for lab, rep in zip(labels, reports):
            for a in (getattr(rep, "health", None) or []):
                sections.append(f"- **{lab}** r={a['round']} "
                                f"`{a['monitor']}`: {a['message']}")
        if any(getattr(rep, "health", None) for rep in reports):
            sections.append("")

    if any(rep.phase_table() for rep in reports):
        rows = []
        for lab, rep in zip(labels, reports):
            for p in rep.phase_table():
                rows.append([lab, p["phase"], _fmt(p["total_s"], 3),
                             _fmt(p["s_per_round"] * 1e3, 1),
                             _fmt(p["share"] * 100.0, 1)])
        sections += ["## Phase timings", "", _table(
            ["run", "phase", "total_s", "ms_per_round", "share_%"], rows),
            ""]

    return "\n".join(sections)
