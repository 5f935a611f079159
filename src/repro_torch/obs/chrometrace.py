"""Chrome trace-event export for the per-phase profiler.

The exclusive ``_Timer`` already holds begin timestamps on its stack; with
``FFTConfig.telemetry_trace`` set, every timer entry/exit (and every round)
additionally lands as a begin/end span in a ``ChromeTraceRecorder``, which
serializes the run as Chrome trace-event JSON — load ``trace.json`` in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing`` for a
flamegraph-style view of where round wall time went.

The recorder shares the *same* ``time.perf_counter()`` reading with the
timer accounting, so the trace is not merely "close to" the profiler: a
self-time replay of the B/E event stream (``self_times``) reproduces the
exclusive ``timers_s`` totals and the per-round ``phase.*`` gauges up to
float64 round-off in the µs conversion, and ``verify_trace`` proves that
telescoping for any saved trace against its run report.
"""
from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

BEGIN = "B"
END = "E"


class ChromeTraceError(AssertionError):
    """A saved trace failed to telescope to its run's phase accounting."""


class ChromeTraceRecorder:
    """Flag-gated span recorder; O(1) per timer entry/exit.

    Events are kept in memory as ``(name, phase, t_seconds, args)`` and
    serialized once at ``save()`` (called by ``Telemetry.end_run``).
    ``begin``/``end`` are driven by ``_Timer.__enter__``/``__exit__`` and
    the hub's round boundaries with the exact timestamps the timers
    account with.
    """

    def __init__(self, path: str):
        self.path = path
        self.events: List[Tuple[str, str, float, Optional[Dict]]] = []
        self._open: List[str] = []

    def begin(self, name: str, t: Optional[float] = None,
              args: Optional[Dict] = None) -> None:
        if t is None:
            t = time.perf_counter()
        self._open.append(name)
        self.events.append((name, BEGIN, t, args))

    def end(self, name: str, t: Optional[float] = None) -> None:
        if t is None:
            t = time.perf_counter()
        if self._open and self._open[-1] == name:
            self._open.pop()
        self.events.append((name, END, t, None))

    def save(self, meta: Optional[Dict] = None) -> str:
        """Write the trace-event JSON.  Spans still open (a crashed run)
        are closed at the last recorded timestamp so the file stays a
        valid, loadable trace."""
        events = list(self.events)
        if self._open and events:
            t_last = max(e[2] for e in events)
            for name in reversed(self._open):
                events.append((name, END, t_last, None))
        t0 = min((e[2] for e in events), default=0.0)
        trace_events = []
        for name, ph, t, args in events:
            ev: Dict[str, Any] = {
                "name": name, "ph": ph, "pid": 0, "tid": 0,
                "ts": (t - t0) * 1e6,
                "cat": "phase" if name.startswith("phase.") else "round"}
            if args:
                ev["args"] = dict(args)
            trace_events.append(ev)
        doc = {"traceEvents": trace_events, "displayTimeUnit": "ms",
               "otherData": dict(meta or {})}
        with open(self.path, "w") as fh:
            json.dump(doc, fh)
        return self.path


def load_trace(path: str) -> Dict[str, Any]:
    """Load + structurally validate a trace-event JSON file."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents array — not a Chrome "
                         f"trace-event JSON file")
    for ev in events:
        if not (isinstance(ev, dict) and ev.get("ph") in (BEGIN, END)
                and "name" in ev and "ts" in ev):
            raise ValueError(f"{path}: malformed trace event {ev!r}")
    return doc


def self_times(events: List[Dict[str, Any]]
               ) -> Tuple[Dict[str, float], Dict[int, Dict[str, float]]]:
    """Replay a B/E event stream with *exclusive* (self-time) attribution.

    Walks the events in order keeping the open-span stack; every interval
    between consecutive events is attributed to the span on top of the
    stack — exactly the accounting ``_Timer`` does live.  Returns
    ``(totals, per_round)``: exclusive seconds per span name over the whole
    stream, and per ``round`` span (keyed by its ``args.round``) the
    exclusive seconds of the phases nested inside it.
    """
    totals: Dict[str, float] = {}
    per_round: Dict[int, Dict[str, float]] = {}
    stack: List[Tuple[str, Optional[int]]] = []   # (name, round-id context)
    cur_round: Optional[int] = None
    last_ts: Optional[float] = None
    for ev in sorted(events, key=lambda e: e["ts"]):
        t = float(ev["ts"]) / 1e6
        if last_ts is not None and stack:
            name = stack[-1][0]
            dt = t - last_ts
            totals[name] = totals.get(name, 0.0) + dt
            if cur_round is not None and name != "round":
                bucket = per_round.setdefault(cur_round, {})
                bucket[name] = bucket.get(name, 0.0) + dt
        last_ts = t
        if ev["ph"] == BEGIN:
            if ev["name"] == "round":
                cur_round = ev.get("args", {}).get("round")
                if cur_round is not None:
                    per_round.setdefault(int(cur_round), {})
            stack.append((ev["name"], cur_round))
        else:
            if not stack or stack[-1][0] != ev["name"]:
                raise ValueError(
                    f"unbalanced trace: E({ev['name']!r}) at ts={ev['ts']} "
                    f"does not match open span "
                    f"{stack[-1][0] if stack else None!r}")
            stack.pop()
            if ev["name"] == "round":
                cur_round = None
    return totals, per_round


def verify_trace(path: str, report, *, atol: float = 2e-3) -> Dict[str, Any]:
    """Prove a saved trace telescopes to its run's phase accounting.

    Checks (raising ``ChromeTraceError`` on violation):

    * the file is valid trace-event JSON with balanced spans;
    * whole-run exclusive self-times per phase match the run summary's
      ``timers_s`` within ``atol`` seconds;
    * per round, the phase spans nested in that round's ``round`` span sum
      to the v2 ``phase.*`` gauges within ``atol``.

    ``atol`` covers float64 round-off of the µs conversion plus timer
    resolution; the timestamps themselves are shared with the timers, so
    observed error is orders of magnitude below it.
    """
    doc = load_trace(path)
    totals, per_round = self_times(doc["traceEvents"])
    summary_timers = report.summary.get("timers_s", {})
    checked = 0
    for name, want in summary_timers.items():
        got = totals.get(name, 0.0)
        if not math.isclose(got, want, rel_tol=1e-6, abs_tol=atol):
            raise ChromeTraceError(
                f"trace self-time for {name!r} is {got:.6f}s but the run "
                f"summary recorded {want:.6f}s")
        checked += 1
    rounds_checked = 0
    for rec in report.rounds:
        rnd = rec["round"]
        phases = {k: v for k, v in rec["gauges"].items()
                  if k.startswith("phase.")}
        if not phases:
            continue
        got_round = per_round.get(rnd, {})
        for name, want in phases.items():
            got = got_round.get(name, 0.0)
            if not math.isclose(got, want, rel_tol=1e-6, abs_tol=atol):
                raise ChromeTraceError(
                    f"round {rnd}: trace spans for {name!r} sum to "
                    f"{got:.6f}s but the gauge recorded {want:.6f}s")
        rounds_checked += 1
    return {"events": len(doc["traceEvents"]), "timers_checked": checked,
            "rounds_checked": rounds_checked}
