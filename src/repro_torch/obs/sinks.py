"""Telemetry sinks: in-memory ``RunReport``, NDJSON event log, console line.

A sink consumes the hub's immutable records; it never feeds anything back
into the run.  The NDJSON log is schema-versioned and **distinct from the
replay trace** (``repro_torch.fl.scenarios.trace``): the trace freezes a network
realization for bit-exact replay, the telemetry log is an observational
flight recording — replay never reads it.
"""
from __future__ import annotations

import json
import math
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.telemetry import AGGREGATED, BUFFERED, OUTCOMES

TELEMETRY_SCHEMA = "fft-telemetry"
# v2: per-round profiler phase gauges (``phase.*``, ``round_wall_s``)
# emitted by the round loops.
# v3: sketch-mode round records (``sketch`` digest instead of
# per-client ``clients``/``betas`` rows), ``health`` records from the online
# run-health monitors, and a ``health``/``sketch`` section in ``run_end``.
# Structurally backward compatible — v1/v2 logs still load.
TELEMETRY_VERSION = 3
TELEMETRY_VERSIONS_READABLE = (1, 2, 3)


def _jnum(x):
    """JSON-safe number: non-finite floats become strings (JSON has no
    literals for them); ints and finite floats pass through."""
    if isinstance(x, float):
        if math.isinf(x):
            return "inf" if x > 0 else "-inf"
        if math.isnan(x):
            return "nan"
    return x


def _unjnum(x):
    if x == "inf":
        return math.inf
    if x == "-inf":
        return -math.inf
    if x == "nan":
        return math.nan
    return x


def _jsonable(obj):
    """Recursively make a record JSON-serializable (numpy scalars → Python,
    non-finite floats → strings)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return _jnum(float(obj))
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, float):
        return _jnum(obj)
    return obj


def read_telemetry_records(path: str) -> Iterator[Tuple[int, Dict]]:
    """Yield ``(line_no, record)`` from an NDJSON telemetry log.

    Validates the schema/version on the ``run_start`` line and tolerates a
    *truncated final line* — a run killed mid-write still yields a loadable
    flight record (with a warning) instead of raising.  Corruption anywhere
    other than the last line still raises: that is a damaged log, not a
    crash artifact.
    """
    with open(path) as fh:
        lines = fh.readlines()
    last = -1
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].strip():
            last = i
            break
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == last:
                warnings.warn(
                    f"{path}:{i + 1}: truncated final record (run killed "
                    f"mid-write?) — loading the {i} complete records",
                    RuntimeWarning, stacklevel=3)
                return
            raise
        if rec.get("record") == "run_start":
            if (rec.get("schema") != TELEMETRY_SCHEMA
                    or rec.get("version") not in TELEMETRY_VERSIONS_READABLE):
                raise ValueError(
                    f"{path}:{i + 1}: not a {TELEMETRY_SCHEMA} "
                    f"v{TELEMETRY_VERSIONS_READABLE} log "
                    f"(got {rec.get('schema')!r} v{rec.get('version')!r})")
        yield i + 1, rec


def peek_telemetry_mode(path: str) -> str:
    """``"full"`` or ``"sketch"``, from the run_start meta (v3) or the
    shape of the first round record (v1/v2 logs predate the meta key)."""
    for _ln, rec in read_telemetry_records(path):
        kind = rec.get("record")
        if kind == "run_start":
            mode = rec.get("meta", {}).get("telemetry_mode")
            if mode in ("full", "sketch"):
                return mode
        elif kind == "round":
            return "sketch" if "sketch" in rec else "full"
    return "full"


def load_report(path: str):
    """Load an NDJSON telemetry log into the right report type —
    ``RunReport`` for full-mode logs, ``SketchReport`` for sketch-mode."""
    if peek_telemetry_mode(path) == "sketch":
        from repro_torch.obs.sketch import SketchReport
        return SketchReport.from_ndjson(path)
    return RunReport.from_ndjson(path)


def build_phase_table(totals: Dict[str, float], wall: float,
                      n_rounds: int) -> List[Dict[str, float]]:
    """The shared phase-profile table (``RunReport.phase_table`` /
    ``SketchReport.phase_table``): one row per phase, hottest first, plus
    an ``(untimed)`` row closing the gap to the measured wall time."""
    if not totals:
        return []
    n = max(n_rounds, 1)
    rows = [{"phase": name, "total_s": s, "s_per_round": s / n,
             "share": (s / wall) if wall > 0 else math.nan}
            for name, s in sorted(totals.items(), key=lambda kv: -kv[1])]
    untimed = wall - math.fsum(totals.values())
    if wall > 0:
        rows.append({"phase": "(untimed)", "total_s": untimed,
                     "s_per_round": untimed / n, "share": untimed / wall})
    return rows


class Sink:
    """Telemetry consumer interface; every hook is optional."""

    def on_run_start(self, meta: Dict) -> None:
        pass

    def on_round(self, rec: Dict) -> None:
        pass

    def on_resolution(self, rec: Dict) -> None:
        pass

    def on_health(self, rec: Dict) -> None:
        pass

    def on_run_end(self, summary: Dict) -> None:
        pass


class RunReport(Sink):
    """In-memory flight record of one run, with the derived views the
    benchmarks and the report renderer read their headline numbers from."""

    mode = "full"

    def __init__(self):
        self.meta: Dict[str, Any] = {}
        self.rounds: List[Dict] = []
        self.resolutions: List[Dict] = []
        self.health: List[Dict] = []
        self.summary: Dict[str, Any] = {"counters": {}, "timers_s": {}}
        self._fo_cache: Optional[Dict[tuple, Dict]] = None
        self._fo_key: Optional[tuple] = None

    # ---------------------------------------------------------------- sink
    def on_run_start(self, meta: Dict) -> None:
        self.meta = dict(meta)

    def on_round(self, rec: Dict) -> None:
        self.rounds.append(rec)
        self._fo_cache = None

    def on_resolution(self, rec: Dict) -> None:
        self.resolutions.append(rec)
        self._fo_cache = None

    def on_health(self, rec: Dict) -> None:
        self.health.append(rec)

    def on_run_end(self, summary: Dict) -> None:
        self.summary = summary

    # ------------------------------------------------------------- loading
    @classmethod
    def from_ndjson(cls, path: str) -> "RunReport":
        """Rebuild a report from an ``NdjsonSink`` event log.  Tolerates a
        truncated final line (killed run) — see
        ``read_telemetry_records``."""
        rep = cls()
        for line_no, rec in read_telemetry_records(path):
            kind = rec.get("record")
            if kind == "run_start":
                rep.meta = rec.get("meta", {})
            elif kind == "round":
                if "clients" not in rec and "sketch" in rec:
                    raise ValueError(
                        f"{path}:{line_no}: sketch-mode log (no per-client "
                        f"rows); load it with repro_torch.obs.load_report")
                clients = {int(c["client"]): {
                    k: _unjnum(v) for k, v in c.items()}
                    for c in rec.get("clients", [])}
                rep.rounds.append({
                    "round": int(rec["round"]), "clients": clients,
                    "gauges": {k: _unjnum(v) for k, v in
                               rec.get("gauges", {}).items()},
                    "betas": rec.get("betas", [])})
            elif kind == "resolution":
                rep.resolutions.append(
                    {k: v for k, v in rec.items() if k != "record"})
            elif kind == "health":
                rep.health.append(
                    {k: _unjnum(v) for k, v in rec.items()
                     if k != "record"})
            elif kind == "run_end":
                rep.summary = {k: v for k, v in rec.items()
                               if k != "record"}
                rep.summary.setdefault("counters", {})
                rep.summary.setdefault("timers_s", {})
            else:
                raise ValueError(
                    f"{path}:{line_no}: unknown record {kind!r}")
        rep._fo_cache = None
        return rep

    # ------------------------------------------------------- derived views
    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def n_clients(self) -> int:
        n = self.meta.get("n_clients")
        if n is not None:
            return int(n)
        return max((len(r["clients"]) for r in self.rounds), default=0)

    def _rows_key(self) -> tuple:
        # cache key covering both appended records and in-place edits that
        # change row counts (reconcile's tamper tests mutate rounds
        # directly); cheap — O(rounds), not O(rounds × clients)
        return (len(self.rounds), len(self.resolutions),
                sum(len(r["clients"]) for r in self.rounds))

    def final_outcomes(self) -> Dict[tuple, Dict]:
        """``(round, client) → record`` with buffered records upgraded by
        their resolution events — the terminal per-client per-round truth.
        Uploads still in flight at run end legitimately stay ``buffered``.

        Cached: every derived view (``drop_cause_counts``,
        ``total_upload_bytes``, the renderer) funnels through here, and
        rebuilding O(rounds × clients) state per view made report
        rendering quadratic.  The cache invalidates on new round or
        resolution records (and on row-count changes).
        """
        key = self._rows_key()
        if self._fo_cache is not None and self._fo_key == key:
            return self._fo_cache
        out = {}
        for rnd_rec in self.rounds:
            r = rnd_rec["round"]
            for c, rec in rnd_rec["clients"].items():
                out[(r, int(c))] = dict(rec)
        for res in self.resolutions:
            rkey = (int(res["origin_round"]), int(res["client"]))
            rec = out.get(rkey)
            if rec is None:
                raise ValueError(f"resolution for unknown record {rkey}")
            if rec["outcome"] != BUFFERED:
                raise ValueError(
                    f"resolution for {rkey} but its outcome is "
                    f"{rec['outcome']!r}, not {BUFFERED!r}")
            rec["outcome"] = res["outcome"]
            for k in ("staleness", "applied_round"):
                if k in res:
                    rec[k] = res[k]
        self._fo_cache, self._fo_key = out, key
        return out

    def drop_cause_counts(self) -> Dict[str, int]:
        counts = {c: 0 for c in OUTCOMES}
        for rec in self.final_outcomes().values():
            counts[rec["outcome"]] += 1
        return counts

    def participants_per_round(self) -> List[int]:
        return [int(r["gauges"].get("participants", 0)) for r in self.rounds]

    def mean_participants(self) -> float:
        parts = self.participants_per_round()
        return float(np.mean(parts)) if parts else 0.0

    def total_upload_bytes(self) -> float:
        """Simulated uplink bytes summed over every recorded upload —
        reconciles with ``CommState.total_uplink_bytes``."""
        return float(math.fsum(
            rec["upload_bytes"]
            for r in self.rounds for rec in r["clients"].values()
            if rec.get("upload_bytes") is not None))

    def total_download_bytes(self) -> float:
        """Broadcast bytes summed over rounds — reconciles with
        ``CommState.total_downlink_bytes``."""
        return float(math.fsum(r["gauges"].get("downlink_bytes", 0.0)
                               for r in self.rounds))

    def accuracy_curve(self) -> List[tuple]:
        """``(round, accuracy)`` for every evaluated round."""
        return [(r["round"], r["gauges"]["eval_acc"]) for r in self.rounds
                if "eval_acc" in r["gauges"]]

    def final_accuracy(self) -> Optional[float]:
        curve = self.accuracy_curve()
        return curve[-1][1] if curve else None

    def mean_distortion(self) -> float:
        """Mean recorded per-upload compression distortion (same definition
        as ``repro_torch.fl.metrics.mean_distortion`` over the loop's history)."""
        vals = [rec["distortion"]
                for r in self.rounds for rec in r["clients"].values()
                if rec.get("distortion") is not None]
        return float(np.mean(vals)) if vals else 0.0

    def beta_rows(self, rnd: Optional[int] = None) -> List[Dict]:
        if rnd is None:
            return [row for r in self.rounds for row in r["betas"]]
        for r in self.rounds:
            if r["round"] == rnd:
                return list(r["betas"])
        return []

    def beta_mass_by(self, key: str) -> Dict[Any, float]:
        """Total applied β mass grouped by ``key`` (``"staleness"``,
        ``"rung"``, or ``"role"``); non-client rows group under their role.
        Normalized to fractions of the total recorded mass."""
        mass: Dict[Any, float] = {}
        for row in self.beta_rows():
            if key == "role" or row.get("role") != "client":
                g = row.get("role", "client")
            else:
                g = row.get(key)
                if g is None:
                    g = 0 if key == "staleness" else "?"
            mass[g] = mass.get(g, 0.0) + float(row["beta"])
        tot = sum(mass.values())
        if tot > 0:
            mass = {k: v / tot for k, v in mass.items()}
        return mass

    def total_wall_s(self) -> float:
        """Measured wall seconds summed over rounds (the ``round_wall_s``
        gauge the round loops emit; 0.0 for uninstrumented/v1 records)."""
        return float(math.fsum(r["gauges"].get("round_wall_s", 0.0)
                               for r in self.rounds))

    def phase_seconds(self, rnd: Optional[int] = None) -> Dict[str, float]:
        """Per-phase exclusive wall seconds (``phase.*`` gauges), summed
        over the run — or for one round — keyed by the bare phase name."""
        rounds = (self.rounds if rnd is None
                  else [r for r in self.rounds if r["round"] == rnd])
        out: Dict[str, float] = {}
        for r in rounds:
            for k, v in r["gauges"].items():
                if k.startswith("phase."):
                    name = k[len("phase."):]
                    out[name] = out.get(name, 0.0) + float(v)
        return out

    def phase_table(self) -> List[Dict[str, float]]:
        """Per-phase profile of the run, hottest phase first.

        One row per recorded ``phase.*`` gauge plus a final ``(untimed)``
        row for wall time no phase claimed: ``{"phase", "total_s",
        "s_per_round", "share"}`` where ``share`` is the fraction of the
        measured round wall time (phases are exclusive, so shares sum to
        ≤ 1 and the ``(untimed)`` row closes the gap).  Empty when the run
        recorded no phase gauges (telemetry off, or a v1 log)."""
        return build_phase_table(self.phase_seconds(), self.total_wall_s(),
                                 self.n_rounds)

    def rung_histogram(self) -> Dict[str, int]:
        """Uploads per codec rung over the whole run (every outcome that
        shipped bytes: aggregated, buffered, or later evicted)."""
        hist: Dict[str, int] = {}
        for r in self.rounds:
            for rec in r["clients"].values():
                rung = rec.get("rung")
                if rung is not None:
                    hist[rung] = hist.get(rung, 0) + 1
        return hist

    def quantiles(self, qs: Sequence[float] = (0.5, 0.9, 0.99)
                  ) -> Dict[str, Dict[float, float]]:
        """Exact per-metric quantiles over the recorded per-client rows —
        the full-mode counterpart of ``SketchReport.quantiles`` (same keys,
        so the renderer's distribution table works in either mode)."""
        finals = self.final_outcomes()
        streams: Dict[str, List[float]] = {
            "upload_bytes": [], "staleness": [], "distortion": []}
        for rec in finals.values():
            for name in ("upload_bytes", "distortion", "staleness"):
                v = rec.get(name)
                if v is not None:
                    streams[name].append(float(v))
        streams["beta"] = [float(row["beta"]) for row in self.beta_rows()
                           if row.get("role", "client") == "client"]
        out: Dict[str, Dict[float, float]] = {}
        for name, vals in streams.items():
            if vals:
                out[name] = {float(q): float(np.quantile(vals, q))
                             for q in qs}
        return out

    def health_verdict(self) -> Optional[Dict[str, Any]]:
        """The run-end health verdict (None for runs without monitors)."""
        return self.summary.get("health")

    def label(self) -> str:
        """Short human label for multi-run tables."""
        m = self.meta
        parts = [str(m.get(k)) for k in ("scenario", "server_mode", "codec",
                                         "strategy") if m.get(k)]
        return "/".join(parts) if parts else "run"


class NdjsonSink(Sink):
    """Append-only, schema-versioned NDJSON event-log writer.

    One line per event, in emission order: ``run_start``, then per round a
    ``round`` record (interleaved with any ``resolution`` / ``health``
    events), finally ``run_end``.  Opens fresh (truncates) so one file
    always holds exactly one run.  Every record is flushed as written —
    a killed long run leaves at worst one truncated final line, which
    ``read_telemetry_records`` tolerates, so the flight record survives
    the crash it is most needed for.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")

    def _write(self, rec: Dict) -> None:
        self._fh.write(json.dumps(_jsonable(rec)) + "\n")
        self._fh.flush()

    def on_run_start(self, meta: Dict) -> None:
        self._write({"record": "run_start", "schema": TELEMETRY_SCHEMA,
                     "version": TELEMETRY_VERSION, "meta": meta})

    def on_round(self, rec: Dict) -> None:
        if "sketch" in rec:                 # sketch mode: constant-size row
            self._write({"record": "round", "round": rec["round"],
                         "gauges": rec["gauges"], "sketch": rec["sketch"]})
            return
        clients = [rec["clients"][c] for c in sorted(rec["clients"])]
        self._write({"record": "round", "round": rec["round"],
                     "gauges": rec["gauges"], "betas": rec["betas"],
                     "clients": clients})

    def on_resolution(self, rec: Dict) -> None:
        self._write({"record": "resolution", **rec})

    def on_health(self, rec: Dict) -> None:
        self._write({"record": "health", **rec})

    def on_run_end(self, summary: Dict) -> None:
        self._write({"record": "run_end", **summary})
        self._fh.close()


class ConsoleSink(Sink):
    """One terminal summary line per round (plus health alarm lines)."""

    def on_round(self, rec: Dict) -> None:
        g = rec["gauges"]
        if "sketch" in rec:
            causes = {k: int(v) for k, v in rec["sketch"]["counts"].items()
                      if v}
            total = sum(causes.values())
        else:
            causes = {}
            for c in rec["clients"].values():
                causes[c["outcome"]] = causes.get(c["outcome"], 0) + 1
            total = len(rec["clients"])
        drops = ",".join(f"{k}={v}" for k, v in sorted(causes.items())
                         if k != AGGREGATED and v)
        acc = (f" acc={g['eval_acc']:.4f}" if "eval_acc" in g else "")
        print(f"[obs] r={rec['round']:>3} "
              f"agg={causes.get(AGGREGATED, 0)}/{total} "
              f"[{drops}] wait={g.get('server_wait_s', 0.0):.2f}s "
              f"up={g.get('cum_uplink_bytes', 0.0) / 1e6:.2f}MB "
              f"down={g.get('cum_downlink_bytes', 0.0) / 1e6:.2f}MB{acc}")

    def on_health(self, rec: Dict) -> None:
        print(f"[health] ALARM r={rec['round']:>3} {rec['monitor']}: "
              f"{rec['message']}")

    def on_run_end(self, summary: Dict) -> None:
        verdict = summary.get("health")
        if not verdict:
            return
        if verdict.get("healthy"):
            print(f"[health] verdict: HEALTHY "
                  f"({verdict.get('rounds_seen', 0)} rounds, 0 alarms)")
        else:
            by = ",".join(f"{k}={v}" for k, v in
                          sorted(verdict.get("by_monitor", {}).items()))
            print(f"[health] verdict: {verdict.get('n_alarms', 0)} ALARMS "
                  f"[{by}] first at r={verdict.get('first_alarm_round')}")
