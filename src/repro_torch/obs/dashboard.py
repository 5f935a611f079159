"""Live run dashboard: in-place console view of a running (or finished) run.

Two entry points over the same renderer:

* ``DashboardSink`` — attach with ``FFTConfig.telemetry_dashboard=True``;
  re-renders an in-place ANSI panel after every round record (falls back to
  plain append when stdout is not a TTY, so logs stay readable);
* ``watch(<log.ndjson>)`` — tail an NDJSON
  flight record another process is writing (the per-record flush plus the
  truncated-final-line tolerance make the file readable mid-run) and
  redraw until the ``run_end`` record lands.  ``--once`` renders a single
  frame and exits (CI smoke).

The renderer reads only the report's aggregate views, so full-mode
``RunReport`` and bounded-memory ``SketchReport`` both drive it.
"""
from __future__ import annotations

import sys
import time as _time
from typing import Dict, List

from repro_torch.obs.sinks import Sink

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 24) -> str:
    """Unicode mini-chart of the last ``width`` values."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _BLOCKS[0] * len(vals)
    return "".join(_BLOCKS[min(int((v - lo) / span * (len(_BLOCKS) - 1)),
                               len(_BLOCKS) - 1)] for v in vals)


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"


def render_dashboard(report, width: int = 72) -> str:
    """One text frame of the dashboard panel for ``report`` as it stands."""
    lines: List[str] = []
    n_rounds = report.n_rounds
    meta = report.meta
    total = meta.get("rounds", "?")
    head = f"{report.label()}  ·  round {n_rounds}/{total}"
    mode = meta.get("telemetry_mode")
    if mode:
        head += f"  ·  telemetry={mode}"
    lines.append("┌ " + head[:width - 2])

    parts = report.participants_per_round()
    if parts:
        lines.append(f"│ participants  {sparkline(parts):<24s} "
                     f"last={parts[-1]}  mean={report.mean_participants():.1f}")

    counts = report.drop_cause_counts()
    total_outcomes = sum(counts.values())
    if total_outcomes:
        mix = "  ".join(
            f"{name}={c} ({c / total_outcomes:.0%})"
            for name, c in sorted(counts.items(), key=lambda kv: -kv[1])
            if c)
        lines.append(f"│ outcomes      {mix}"[:width])

    phases = report.phase_seconds()
    wall = report.total_wall_s()
    if phases and wall > 0:
        top = sorted(phases.items(), key=lambda kv: -kv[1])[:4]
        split = "  ".join(f"{name}={s / wall:.0%}" for name, s in top)
        lines.append(f"│ phase split   {split}  (wall {wall:.1f}s)")

    curve = [a for _r, a in report.accuracy_curve()]
    acc = (f"acc={curve[-1]:.4f} {sparkline(curve, 16)}" if curve
           else "acc=–")
    lines.append(f"│ progress      {acc}  up={_fmt_bytes(report.total_upload_bytes())}"
                 f"  down={_fmt_bytes(report.total_download_bytes())}")

    health = getattr(report, "health", None) or []
    verdict = (report.health_verdict()
               if hasattr(report, "health_verdict") else None)
    if verdict is not None:
        if verdict.get("healthy"):
            lines.append("│ health        OK (run complete, 0 alarms)")
        else:
            by = ",".join(f"{k}×{v}" for k, v in
                          sorted(verdict.get("by_monitor", {}).items()))
            lines.append(f"│ health        {verdict.get('n_alarms')} ALARMS "
                         f"[{by}] first r={verdict.get('first_alarm_round')}")
    elif health:
        last = health[-1]
        lines.append(f"│ health        {len(health)} alarm(s) — last: "
                     f"{last['monitor']}@r{last['round']}")
    else:
        lines.append("│ health        OK")
    lines.append("└")
    return "\n".join(lines)


class DashboardSink(Sink):
    """In-place console dashboard; reads the run's report sink (which is
    registered before it, so each ``on_round`` sees the round included)."""

    def __init__(self, report, stream=None):
        self.report = report
        self.stream = stream or sys.stdout
        self._last_height = 0

    def _paint(self) -> None:
        frame = render_dashboard(self.report)
        isatty = getattr(self.stream, "isatty", lambda: False)()
        if isatty and self._last_height:
            # move up over the previous frame and overwrite in place
            self.stream.write(f"\x1b[{self._last_height}F\x1b[J")
        self.stream.write(frame + "\n")
        self.stream.flush()
        self._last_height = frame.count("\n") + 1

    def on_round(self, rec: Dict) -> None:
        self._paint()

    def on_health(self, rec: Dict) -> None:
        pass                                   # next round's frame shows it

    def on_run_end(self, summary: Dict) -> None:
        # the report sink already consumed the summary (it precedes this
        # sink), so the final frame can show the verdict
        self._paint()


def watch(path: str, interval: float = 2.0, once: bool = False,
          stream=None) -> None:
    """Tail an NDJSON telemetry log, redrawing the dashboard until the
    ``run_end`` record appears (or forever, for an abandoned log —
    interrupt with ^C)."""
    from repro_torch.obs.sinks import load_report
    stream = stream or sys.stdout
    last_height = 0
    while True:
        report = load_report(path)
        frame = render_dashboard(report)
        isatty = getattr(stream, "isatty", lambda: False)()
        if isatty and last_height:
            stream.write(f"\x1b[{last_height}F\x1b[J")
        stream.write(frame + "\n")
        stream.flush()
        last_height = frame.count("\n") + 1
        done = bool(report.summary.get("counters") or
                    report.summary.get("timers_s") or
                    report.summary.get("health"))
        if once or done:
            return
        _time.sleep(interval)
