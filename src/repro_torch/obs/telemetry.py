"""Run-wide telemetry hub: counters, gauges, timers, per-round events.
A copy of ``repro/obs/telemetry.py``.

The paper's convergence claim is *per-realization* — FedAuto converges for
each individual realization of connection failures — so understanding a run
means seeing, round by round, exactly why each client did or did not
contribute and at what weight, staleness, and fidelity.  The ``Telemetry``
hub is the one place that evidence lands: the round loops, the scenario
engine, the comm subsystem, the staleness buffer, the adaptive controller,
and the strategies all emit into it, and pluggable sinks
(``repro_torch.obs.sinks``) consume immutable per-round records.

Drop-cause attribution: every client has exactly **one terminal outcome per
round** (enforced — a second ``client_outcome`` for the same ``(round,
client)`` raises):

  ``not_selected``     the server never contacted the client this round
  ``link_down``        selected, but the scenario reported the link down
                       (``detail`` carries the refined cause: ``ap_outage``,
                       ``handover``, ``churned``, …)
  ``missed_deadline``  selected and up, but the upload landed too late for a
                       synchronous server (or never lands at all)
  ``buffered``         async modes: the upload is parked in the
                       ``StalenessBuffer``; a later ``resolution`` event
                       upgrades the outcome to ``aggregated`` (with the
                       staleness it was applied at) or ``evicted``
  ``evicted``          the upload aged past the staleness horizon (or could
                       never physically land inside it — ``detail``
                       ``unreachable``) and was dropped
  ``aggregated``       the upload reached the strategy's aggregation step

so per-cause counts over a finished run sum to ``n_clients × rounds``
(still-in-flight uploads at run end legitimately remain ``buffered``).

The hub is **observational**: it never feeds back into the run (replay
consumes the scenario trace, never the telemetry log), and the disabled
path is a shared ``NULL_TELEMETRY`` no-op whose methods do nothing and
which is *falsy* — instrumentation sites guard any record-building work
with ``if tel:`` so a telemetry-off run executes no extra code beyond the
no-op call itself.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# drop-cause / outcome vocabulary
# ---------------------------------------------------------------------------
NOT_SELECTED = "not_selected"
SKIPPED_STRAGGLER = "skipped_straggler"
LINK_DOWN = "link_down"
MISSED_DEADLINE = "missed_deadline"
BUFFERED = "buffered"
EVICTED = "evicted"
AGGREGATED = "aggregated"

OUTCOMES = (NOT_SELECTED, SKIPPED_STRAGGLER, LINK_DOWN, MISSED_DEADLINE,
            BUFFERED, EVICTED, AGGREGATED)
# a buffered upload can only ever resolve to one of these
RESOLUTIONS = (AGGREGATED, EVICTED)


def beta_row(beta: float, *, role: str = "client",
             client: Optional[int] = None,
             origin_round: Optional[int] = None,
             staleness: Optional[int] = None,
             rung: Optional[str] = None,
             distortion: Optional[float] = None) -> Dict[str, Any]:
    """One participant's actually-applied aggregation weight.

    ``role`` is ``"server"``, ``"comp"`` (compensatory model), or
    ``"client"``; client rows carry the id and, when known, the origin
    round, staleness, codec rung, and distortion the weight was computed
    under — the renderer's β-mass-by-staleness/rung tables group on these.
    """
    row: Dict[str, Any] = {"role": role, "beta": float(beta)}
    if client is not None:
        row["client"] = int(client)
    if origin_round is not None:
        row["origin_round"] = int(origin_round)
    if staleness is not None:
        row["staleness"] = int(staleness)
    if rung is not None:
        row["rung"] = str(rung)
    if distortion is not None:
        row["distortion"] = float(distortion)
    return row


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class NullTelemetry:
    """Disabled telemetry: every method is a no-op and the object is falsy,
    so ``if tel:``-guarded record building never runs.  One shared instance
    (``NULL_TELEMETRY``) is the default everywhere."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def start_run(self, meta: Optional[Dict] = None) -> None:
        pass

    def begin_round(self, rnd: int) -> None:
        pass

    def client_outcome(self, rnd: int, client: int, outcome: str,
                       **fields) -> None:
        pass

    def resolve(self, origin_round: int, client: int, outcome: str,
                staleness: Optional[int] = None,
                applied_round: Optional[int] = None) -> None:
        pass

    def betas(self, rnd: int, rows) -> None:
        pass

    def gauge(self, rnd: int, name: str, value: float) -> None:
        pass

    def distribution(self, rnd: int, name: str, values) -> None:
        pass

    def counter(self, name: str, inc: float = 1) -> None:
        pass

    def timer(self, name: str):
        return _NULL_TIMER

    def end_round(self, rnd: int) -> None:
        pass

    def end_run(self) -> None:
        pass


NULL_TELEMETRY = NullTelemetry()


class _Timer:
    """Exclusive (self-time) phase timer.

    Timers nest: entering a timer while another is active *pauses* the
    outer one, so each phase accumulates only the time no inner phase
    claimed.  Disjoint-by-construction means per-round phase seconds sum
    to at most the round's wall time, never more — ``phase.local_update``
    triggered from inside a strategy's aggregation step is attributed to
    the local update, not double-counted under ``phase.aggregate``.
    """

    __slots__ = ("_tel", "_name")

    def __init__(self, tel: "Telemetry", name: str):
        self._tel = tel
        self._name = name

    def __enter__(self):
        now = time.perf_counter()
        stack = self._tel._timer_stack
        if stack:                          # pause the enclosing phase
            outer = stack[-1]
            timers = self._tel.timers_s
            timers[outer[0]] = timers.get(outer[0], 0.0) + (now - outer[1])
        stack.append([self._name, now])
        trace = self._tel.trace
        if trace is not None:
            # the *same* timestamp feeds the timer accounting and the trace
            # span, so a self-time replay of the trace reproduces the
            # exclusive timers bit-for-bit
            trace.begin(self._name, now)
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        stack = self._tel._timer_stack
        name, t0 = stack.pop()
        timers = self._tel.timers_s
        timers[name] = timers.get(name, 0.0) + (now - t0)
        if stack:                          # resume the enclosing phase
            stack[-1][1] = now
        trace = self._tel.trace
        if trace is not None:
            trace.end(name, now)
        return False


class Telemetry:
    """Enabled telemetry hub.

    Protocol (driven by ``RoundLoop.run``): ``start_run(meta)`` once, then
    per round ``begin_round(r)`` → any number of ``client_outcome`` /
    ``resolve`` / ``betas`` / ``gauge`` / ``counter`` / ``timer`` calls →
    ``end_round(r)``, then ``end_run()``.  ``client_outcome`` enforces the
    exactly-one-terminal-outcome-per-(round, client) invariant;
    ``resolve`` events are forwarded to sinks immediately (they refer to a
    *past* round's record), everything else is staged and flushed as one
    immutable round record at ``end_round``.
    """

    enabled = True

    def __init__(self, sinks=(), *, sketch=None, health=None, trace=None):
        self.sinks = list(sinks)
        self.sketch = sketch           # SketchState → bounded-memory mode
        self.health = health           # HealthMonitors → online detectors
        self.trace = trace             # ChromeTraceRecorder → span export
        self.meta: Dict[str, Any] = {}
        self.counters: Dict[str, float] = {}
        self.timers_s: Dict[str, float] = {}
        self._timer_stack: List[list] = []   # active (name, t0) phase frames
        self._round: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ lifecycle
    def start_run(self, meta: Optional[Dict] = None) -> None:
        self.meta = dict(meta or {})
        self.meta.setdefault(
            "telemetry_mode", "sketch" if self.sketch is not None else "full")
        for s in self.sinks:
            s.on_run_start(self.meta)

    def begin_round(self, rnd: int) -> None:
        if self._round is not None:
            raise ValueError(
                f"begin_round({rnd}) before end_round({self._round['round']})")
        if self.sketch is not None:
            # bounded-memory mode: per-client events fold into the sketch
            # state instead of staging O(n_clients) rows
            self._round = {"round": int(rnd), "gauges": {}}
            self.sketch.begin_round(int(rnd))
        else:
            self._round = {"round": int(rnd), "clients": {}, "gauges": {},
                           "betas": []}
        if self.trace is not None:
            self.trace.begin("round", time.perf_counter(),
                             args={"round": int(rnd)})

    def _staged(self, rnd: int) -> Dict[str, Any]:
        if self._round is None or self._round["round"] != int(rnd):
            cur = None if self._round is None else self._round["round"]
            raise ValueError(f"telemetry event for round {rnd} but staged "
                             f"round is {cur}")
        return self._round

    # --------------------------------------------------------------- events
    def client_outcome(self, rnd: int, client: int, outcome: str,
                       **fields) -> None:
        """Record client ``client``'s terminal outcome for round ``rnd``.

        ``fields``: ``detail`` (refined cause), ``rung`` (codec name),
        ``upload_bytes``, ``download_bytes``, ``distortion``, ``staleness``
        — absent fields are simply not recorded."""
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r} "
                             f"(known: {OUTCOMES})")
        staged = self._staged(rnd)
        client = int(client)
        if self.sketch is not None:
            self.sketch.client_outcome(client, outcome, fields)
            return
        if client in staged["clients"]:
            raise ValueError(
                f"round {rnd}: client {client} already has outcome "
                f"{staged['clients'][client]['outcome']!r}; every client has "
                f"exactly one terminal outcome per round")
        rec: Dict[str, Any] = {"client": client, "outcome": outcome}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        staged["clients"][client] = rec

    def resolve(self, origin_round: int, client: int, outcome: str,
                staleness: Optional[int] = None,
                applied_round: Optional[int] = None) -> None:
        """A previously-``buffered`` upload reached its terminal state."""
        if outcome not in RESOLUTIONS:
            raise ValueError(f"resolution outcome must be one of "
                             f"{RESOLUTIONS}, got {outcome!r}")
        rec = {"origin_round": int(origin_round), "client": int(client),
               "outcome": outcome}
        if staleness is not None:
            rec["staleness"] = int(staleness)
        if applied_round is not None:
            rec["applied_round"] = int(applied_round)
        if self.sketch is not None:
            self.sketch.resolve(rec)
        for s in self.sinks:
            s.on_resolution(rec)

    def betas(self, rnd: int, rows: List[Dict[str, Any]]) -> None:
        """The aggregation weights a strategy actually applied this round
        (``beta_row`` dicts).  Extends — a strategy that aggregates more
        than once per round (or a deferred flush) appends further rows."""
        staged = self._staged(rnd)
        if self.sketch is not None:
            self.sketch.betas(rows)
        else:
            staged["betas"].extend(rows)

    def gauge(self, rnd: int, name: str, value: float) -> None:
        self._staged(rnd)["gauges"][str(name)] = float(value)

    def distribution(self, rnd: int, name: str, values) -> None:
        """Fold a per-client value stream (e.g. the adaptive controller's
        capacity estimates) into a named quantile sketch.  Only sketch mode
        retains these — full mode already keeps richer per-client rows."""
        self._staged(rnd)
        if self.sketch is not None:
            self.sketch.distribution(name, values)

    def counter(self, name: str, inc: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def timer(self, name: str) -> _Timer:
        """Context manager accumulating *exclusive* wall seconds into
        ``timers_s[name]`` (nested timers pause the enclosing one).  Names
        prefixed ``phase.`` are the per-round profiler phases: the round
        loops emit each round's delta as a same-named gauge, so phase
        seconds land in the ``RunReport`` / NDJSON log per round and
        ``RunReport.phase_table()`` can break a run down by phase."""
        return _Timer(self, name)

    # ------------------------------------------------------------- flushing
    def end_round(self, rnd: int) -> None:
        staged = self._staged(rnd)
        self._round = None
        if self.sketch is not None:
            staged["sketch"] = self.sketch.end_round(staged["gauges"])
        elif staged.get("betas"):
            ess = _beta_ess_from_rows(staged["betas"])
            if ess is not None:
                staged["gauges"]["beta_ess"] = ess
        if self.trace is not None:
            self.trace.end("round", time.perf_counter())
        for s in self.sinks:
            s.on_round(staged)
        if self.health is not None:
            for rec in self.health.observe_round(
                    _round_digest(staged, self.meta)):
                for s in self.sinks:
                    s.on_health(rec)

    def end_run(self) -> None:
        if self._round is not None:
            # a crashed round still flushes what it staged
            self.end_round(self._round["round"])
        summary = {"counters": dict(self.counters),
                   "timers_s": dict(self.timers_s)}
        if self.sketch is not None:
            summary["sketch"] = self.sketch.summary()
        if self.health is not None:
            summary["health"] = self.health.verdict()
        for s in self.sinks:
            s.on_run_end(summary)
        if self.trace is not None:
            self.trace.save(meta=self.meta)


def _beta_ess_from_rows(rows: List[Dict[str, Any]]) -> Optional[float]:
    """β effective sample size over the round's *client* rows:
    (Σβ)²/Σβ² — n when the applied client mass is uniform, → 1 as a single
    client dominates.  The ``beta_ess`` gauge is the health monitors' view
    of aggregation-weight concentration."""
    n = 0
    total = sumsq = 0.0
    for row in rows:
        if row.get("role", "client") != "client":
            continue
        b = float(row["beta"])
        n += 1
        total += b
        sumsq += b * b
    if n == 0 or sumsq <= 0.0:
        return None
    return (total * total) / sumsq


def _round_digest(staged: Dict[str, Any], meta: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Constant-size view of a flushed round record for the health
    monitors — identical shape whether the round was staged in full or
    sketch mode, so the detectors are mode-agnostic."""
    gauges = staged["gauges"]
    if "sketch" in staged:
        sk = staged["sketch"]
        counts = dict(sk["counts"])
        n_dist = sk["distortion_n"]
        distortion_mean = (sk["distortion_sum"] / n_dist) if n_dist else None
        beta_n = sk["beta"]["n"]
    else:
        counts = {o: 0 for o in OUTCOMES}
        dist_sum = 0.0
        n_dist = 0
        for rec in staged["clients"].values():
            counts[rec["outcome"]] += 1
            d = rec.get("distortion")
            if d is not None:
                dist_sum += float(d)
                n_dist += 1
        distortion_mean = (dist_sum / n_dist) if n_dist else None
        beta_n = sum(1 for row in staged.get("betas", ())
                     if row.get("role", "client") == "client")
    return {"round": staged["round"],
            "n_clients": int(meta.get("n_clients", 0) or 0),
            "counts": counts,
            "participants": gauges.get("participants"),
            "eval_acc": gauges.get("eval_acc"),
            "beta_n": beta_n,
            "beta_ess": gauges.get("beta_ess"),
            "distortion_mean": distortion_mean,
            "gauges": gauges}
