"""Bounded-memory telemetry: streaming sketches and the sketch-mode report.

The full-mode flight recorder keeps one row per client per round — perfect
at tens of clients, and exactly the thing that becomes the memory and disk
bottleneck at the population scales the ROADMAP targets (100k–1M clients:
FeedSign-style O(1)-byte uplinks exist precisely because nothing per-client
survives contact with a million phones).  ``FFTConfig.telemetry="sketch"``
keeps the *accounting* exact and collapses the *distributions*:

* outcome/rung counters, β-mass-by-group sums, and additive byte/distortion
  totals stay **exact** — byte totals through a Shewchuk exact accumulator
  (``ExactSum``), so ``total_upload_bytes()`` is bit-equal to full mode's
  ``math.fsum`` over every individual upload and ``reconcile`` still proves
  closure against ``CommState``;
* per-client distributions (upload bytes, staleness, distortion, β weights,
  controller capacity estimates) collapse into Greenwald–Khanna streaming
  quantile sketches (``GKQuantiles``, rank error ≤ ε·n, default ε=0.01, no
  new deps) plus one seeded K-row reservoir sample (``Reservoir``) for
  spot-checking concrete rows;
* resident state is O(rounds + K + 1/ε·log εn): per round only a
  constant-size digest is retained, never the n_clients rows.

``SketchState`` is the hub-side fold (``repro.obs.Telemetry`` stages into
it instead of a per-client dict); ``SketchReport`` is the sink mirroring
``RunReport``'s aggregate API, so ``reconcile`` and ``render_markdown``
work identically in either mode.
"""
from __future__ import annotations

import math
import random
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.telemetry import BUFFERED, OUTCOMES, RESOLUTIONS

# documented rank-error bound of the quantile sketches: a query for
# quantile q returns a value whose rank is within EPS·n of q·n
SKETCH_EPS = 0.01


class ExactSum:
    """Incremental Shewchuk summation: ``add`` keeps exact non-overlapping
    partials, ``value()`` rounds once — bit-equal to ``math.fsum`` over the
    same multiset of addends, independent of order or batching.  This is
    what lets a sketch run's byte totals match full mode bit-for-bit."""

    __slots__ = ("partials",)

    def __init__(self, partials: Optional[Sequence[float]] = None):
        self.partials: List[float] = list(partials or [])

    def add(self, x: float) -> None:
        partials = self.partials
        x = float(x)
        i = 0
        for y in partials:
            if abs(x) < abs(y):
                x, y = y, x
            hi = x + y
            lo = y - (hi - x)
            if lo:
                partials[i] = lo
                i += 1
            x = hi
        partials[i:] = [x]

    def value(self) -> float:
        return math.fsum(self.partials)

    def to_json(self) -> List[float]:
        return list(self.partials)


class GKQuantiles:
    """Greenwald–Khanna ε-approximate streaming quantiles (GK01).

    Maintains tuples ``(v, g, Δ)`` with the invariant
    ``g_i + Δ_i ≤ ⌊2εn⌋``; a ``query(q)`` then returns a value whose rank in
    the stream is within ``ε·n`` of ``q·n``.  Size is O((1/ε)·log(εn)) —
    independent of the number of clients for fixed ε and round count.
    """

    __slots__ = ("eps", "n", "entries", "_values", "_since_compress")

    def __init__(self, eps: float = SKETCH_EPS):
        self.eps = float(eps)
        self.n = 0
        self.entries: List[List[float]] = []    # [v, g, delta], sorted by v
        self._values: List[float] = []          # parallel keys for bisect
        self._since_compress = 0

    def add(self, v: float) -> None:
        v = float(v)
        pos = bisect_right(self._values, v)
        if pos == 0 or pos == len(self.entries):
            delta = 0                           # new extremum is exact
        else:
            delta = max(int(2.0 * self.eps * self.n) - 1, 0)
        self.entries.insert(pos, [v, 1, delta])
        self._values.insert(pos, v)
        self.n += 1
        self._since_compress += 1
        if self._since_compress >= max(int(1.0 / (2.0 * self.eps)), 1):
            self._compress()

    def _compress(self) -> None:
        self._since_compress = 0
        threshold = int(2.0 * self.eps * self.n)
        entries = self.entries
        i = len(entries) - 2
        while i >= 1:                           # keep the extrema exact
            v, g, d = entries[i]
            nv, ng, nd = entries[i + 1]
            if g + ng + nd <= threshold:
                entries[i + 1][1] = g + ng
                del entries[i]
                del self._values[i]
            i -= 1

    def query(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` (rank error ≤ ``eps * n``)."""
        if self.n == 0:
            return None
        q = min(max(float(q), 0.0), 1.0)
        want = max(1, math.ceil(q * self.n))
        budget = want + self.eps * self.n
        rmin = 0
        prev = self.entries[0][0]
        for v, g, d in self.entries:
            rmin += g
            if rmin + d > budget:
                return prev
            prev = v
        return self.entries[-1][0]

    def to_json(self) -> Dict[str, Any]:
        return {"eps": self.eps, "n": self.n,
                "entries": [list(e) for e in self.entries]}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "GKQuantiles":
        gk = cls(eps=doc["eps"])
        gk.n = int(doc["n"])
        gk.entries = [[float(v), int(g), int(d)]
                      for v, g, d in doc["entries"]]
        gk._values = [e[0] for e in gk.entries]
        return gk


class Reservoir:
    """Seeded K-row uniform reservoir sample (Vitter's algorithm R) of the
    per-client outcome rows a sketch run no longer retains in full."""

    def __init__(self, k: int, seed: int = 0):
        self.k = int(k)
        self.n = 0
        self.rows: List[Dict[str, Any]] = []
        self._rng = random.Random(0x5EED ^ int(seed))

    def offer(self, row: Dict[str, Any]) -> None:
        self.n += 1
        if len(self.rows) < self.k:
            self.rows.append(row)
        else:
            j = self._rng.randrange(self.n)
            if j < self.k:
                self.rows[j] = row

    def to_json(self) -> Dict[str, Any]:
        return {"k": self.k, "n": self.n, "rows": list(self.rows)}


def _beta_stats(n: int, total: float, sumsq: float) -> Optional[float]:
    """Effective sample size of the applied client β mass: (Σβ)²/Σβ².
    n client rows all at equal weight → ESS = n; one dominating row → 1."""
    if n == 0 or sumsq <= 0.0:
        return None
    return (total * total) / sumsq


class SketchState:
    """Hub-side per-run fold for sketch-mode telemetry.

    ``Telemetry`` routes ``client_outcome``/``betas``/``resolve`` calls
    here instead of staging per-client rows; ``end_round`` returns the
    constant-size round digest that gets flushed to sinks, and
    ``summary()`` the run-long exact accumulators + sketches flushed at
    ``end_run``.
    """

    def __init__(self, n_clients: int, *, k: int = 64,
                 eps: float = SKETCH_EPS, seed: int = 0):
        self.n_clients = int(n_clients)
        self.k = int(k)
        self.eps = float(eps)
        self.exact_upload = ExactSum()
        self.exact_distortion = ExactSum()
        self.distortion_n = 0
        self.sketches: Dict[str, GKQuantiles] = {
            name: GKQuantiles(eps)
            for name in ("upload_bytes", "staleness", "distortion", "beta")}
        self.reservoir = Reservoir(k, seed=seed)
        self._round: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ staging
    def begin_round(self, rnd: int) -> None:
        self._round = {
            "rnd": int(rnd), "seen": set(),
            "counts": {o: 0 for o in OUTCOMES}, "rungs": {},
            "upload_bytes": 0.0, "distortion_sum": 0.0, "distortion_n": 0,
            "beta_n": 0, "beta_sum": 0.0, "beta_sumsq": 0.0,
            "mass_staleness": {}, "mass_rung": {}, "mass_role": {}}

    def client_outcome(self, client: int, outcome: str,
                       fields: Dict[str, Any]) -> None:
        cur = self._round
        if client in cur["seen"]:
            raise ValueError(
                f"round {cur['rnd']}: client {client} already has an "
                f"outcome; every client has exactly one terminal outcome "
                f"per round")
        cur["seen"].add(client)
        cur["counts"][outcome] += 1
        ub = fields.get("upload_bytes")
        if ub is not None:
            ub = float(ub)
            cur["upload_bytes"] += ub
            self.exact_upload.add(ub)
            self.sketches["upload_bytes"].add(ub)
        dist = fields.get("distortion")
        if dist is not None:
            dist = float(dist)
            cur["distortion_sum"] += dist
            cur["distortion_n"] += 1
            self.exact_distortion.add(dist)
            self.distortion_n += 1
            self.sketches["distortion"].add(dist)
        st = fields.get("staleness")
        if st is not None:
            self.sketches["staleness"].add(float(st))
        rung = fields.get("rung")
        if rung is not None:
            cur["rungs"][rung] = cur["rungs"].get(rung, 0) + 1
        self.reservoir.offer(
            {"round": cur["rnd"], "client": int(client), "outcome": outcome,
             **{k: v for k, v in fields.items() if v is not None}})

    def betas(self, rows: Sequence[Dict[str, Any]]) -> None:
        cur = self._round
        for row in rows:
            beta = float(row["beta"])
            role = row.get("role", "client")
            if role != "client":
                g_st = g_rung = role
            else:
                cur["beta_n"] += 1
                cur["beta_sum"] += beta
                cur["beta_sumsq"] += beta * beta
                self.sketches["beta"].add(beta)
                g_st = row.get("staleness", 0)
                g_rung = row.get("rung", "?")
            for key, g in (("mass_staleness", g_st), ("mass_rung", g_rung),
                           ("mass_role", role)):
                cur[key][g] = cur[key].get(g, 0.0) + beta

    def resolve(self, rec: Dict[str, Any]) -> None:
        # upgraded staleness only becomes known at resolution time
        if rec.get("staleness") is not None:
            self.sketches["staleness"].add(float(rec["staleness"]))

    def distribution(self, name: str, values) -> None:
        """Fold an ad-hoc per-client value stream (e.g. the adaptive
        controller's capacity estimates) into a named quantile sketch."""
        gk = self.sketches.get(name)
        if gk is None:
            gk = self.sketches[name] = GKQuantiles(self.eps)
        for v in values:
            gk.add(float(v))

    def end_round(self, gauges: Dict[str, float]) -> Dict[str, Any]:
        """Finish the staged round: emit the β effective-sample-size gauge
        and return the constant-size digest that replaces per-client rows
        in the flushed round record."""
        cur = self._round
        self._round = None
        ess = _beta_stats(cur["beta_n"], cur["beta_sum"], cur["beta_sumsq"])
        if ess is not None:
            gauges["beta_ess"] = float(ess)
        return {
            "counts": cur["counts"], "rungs": cur["rungs"],
            "upload_bytes": cur["upload_bytes"],
            "distortion_sum": cur["distortion_sum"],
            "distortion_n": cur["distortion_n"],
            "beta": {"n": cur["beta_n"], "sum": cur["beta_sum"],
                     "sumsq": cur["beta_sumsq"],
                     "mass_staleness": cur["mass_staleness"],
                     "mass_rung": cur["mass_rung"],
                     "mass_role": cur["mass_role"]}}

    def summary(self) -> Dict[str, Any]:
        """Run-long exact accumulators + serialized sketches (the
        ``run_end`` record's ``sketch`` section)."""
        return {
            "k": self.k, "eps": self.eps,
            "exact": {"upload_bytes": self.exact_upload.to_json(),
                      "distortion": self.exact_distortion.to_json()},
            "distortion_n": self.distortion_n,
            "sketches": {name: gk.to_json()
                         for name, gk in self.sketches.items()},
            "reservoir": self.reservoir.to_json()}


class SketchReport:
    """Sketch-mode flight record: ``RunReport``'s aggregate API from
    O(rounds + K) state.

    Consumes the hub's constant-size round digests (``rec["sketch"]``) and
    the run-end exact accumulators; every view the renderer, ``reconcile``,
    and the benchmarks read — drop-cause counts, byte totals, β mass by
    group, rung histogram, phase/gauge views — is exact; quantiles come
    from the GK sketches within the documented ε rank error.
    """

    mode = "sketch"

    def __init__(self):
        self.meta: Dict[str, Any] = {}
        self.rounds: List[Dict] = []
        self.resolutions: List[Dict] = []
        self.health: List[Dict] = []
        self.summary: Dict[str, Any] = {"counters": {}, "timers_s": {}}

    # ---------------------------------------------------------------- sink
    def on_run_start(self, meta: Dict) -> None:
        self.meta = dict(meta)

    def on_round(self, rec: Dict) -> None:
        if "sketch" not in rec:
            raise ValueError(
                "SketchReport received a full-mode round record (per-client "
                "rows); use RunReport for telemetry='full' runs")
        self.rounds.append(rec)

    def on_resolution(self, rec: Dict) -> None:
        self.resolutions.append(rec)

    def on_health(self, rec: Dict) -> None:
        self.health.append(rec)

    def on_run_end(self, summary: Dict) -> None:
        self.summary = summary

    # ------------------------------------------------------------- loading
    @classmethod
    def from_ndjson(cls, path: str) -> "SketchReport":
        """Rebuild a sketch report from an ``NdjsonSink`` event log."""
        from repro_torch.obs.sinks import read_telemetry_records
        rep = cls()
        for _line_no, rec in read_telemetry_records(path):
            kind = rec.get("record")
            if kind == "run_start":
                rep.meta = rec.get("meta", {})
            elif kind == "round":
                if "clients" in rec:
                    raise ValueError(
                        f"{path}: full-mode log (per-client rows); load it "
                        "with RunReport.from_ndjson or repro_torch.obs.load_report")
                rep.rounds.append({k: v for k, v in rec.items()
                                   if k != "record"})
            elif kind == "resolution":
                rep.resolutions.append(
                    {k: v for k, v in rec.items() if k != "record"})
            elif kind == "health":
                rep.health.append(
                    {k: v for k, v in rec.items() if k != "record"})
            elif kind == "run_end":
                rep.summary = {k: v for k, v in rec.items()
                               if k != "record"}
        return rep

    # ------------------------------------------------------- derived views
    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def n_clients(self) -> int:
        return int(self.meta.get("n_clients", 0))

    def drop_cause_counts(self) -> Dict[str, int]:
        """Exact per-cause counts with ``buffered`` records upgraded by
        their resolution events — identical semantics to full mode's
        ``final_outcomes``-derived counts, from O(1)-per-round state."""
        counts = {o: 0 for o in OUTCOMES}
        for r in self.rounds:
            for o, c in r["sketch"]["counts"].items():
                counts[o] = counts.get(o, 0) + int(c)
        for res in self.resolutions:
            out = res["outcome"]
            if out not in RESOLUTIONS:
                raise ValueError(f"resolution outcome {out!r} not in "
                                 f"{RESOLUTIONS}")
            if counts[BUFFERED] <= 0:
                raise ValueError(
                    "resolution event without a matching buffered outcome")
            counts[BUFFERED] -= 1
            counts[out] += 1
        return counts

    def participants_per_round(self) -> List[int]:
        return [int(r["gauges"].get("participants", 0)) for r in self.rounds]

    def mean_participants(self) -> float:
        parts = self.participants_per_round()
        return float(sum(parts) / len(parts)) if parts else 0.0

    def _exact_partials(self, name: str) -> Optional[List[float]]:
        sk = self.summary.get("sketch")
        if sk and "exact" in sk and name in sk["exact"]:
            return sk["exact"][name]
        return None

    def total_upload_bytes(self) -> float:
        """Bit-equal to full mode's ``math.fsum`` over every upload (the
        exact partials survive the NDJSON round-trip); a crashed run with
        no ``run_end`` record degrades to the per-round partial sums."""
        partials = self._exact_partials("upload_bytes")
        if partials is not None:
            return float(math.fsum(partials))
        return float(math.fsum(r["sketch"]["upload_bytes"]
                               for r in self.rounds))

    def total_download_bytes(self) -> float:
        return float(math.fsum(r["gauges"].get("downlink_bytes", 0.0)
                               for r in self.rounds))

    def accuracy_curve(self) -> List[tuple]:
        return [(r["round"], r["gauges"]["eval_acc"]) for r in self.rounds
                if "eval_acc" in r["gauges"]]

    def final_accuracy(self) -> Optional[float]:
        curve = self.accuracy_curve()
        return curve[-1][1] if curve else None

    def mean_distortion(self) -> float:
        partials = self._exact_partials("distortion")
        if partials is not None:
            n = int(self.summary["sketch"].get("distortion_n", 0))
            return float(math.fsum(partials) / n) if n else 0.0
        tot = math.fsum(r["sketch"]["distortion_sum"] for r in self.rounds)
        n = sum(r["sketch"]["distortion_n"] for r in self.rounds)
        return float(tot / n) if n else 0.0

    def beta_mass_by(self, key: str) -> Dict[Any, float]:
        """Total applied β mass grouped by ``key`` — exact (additive group
        sums), normalized to fractions like full mode."""
        field = {"staleness": "mass_staleness", "rung": "mass_rung",
                 "role": "mass_role"}.get(key)
        if field is None:
            return {}
        mass: Dict[Any, float] = {}
        for r in self.rounds:
            for g, m in r["sketch"]["beta"][field].items():
                # JSON round-trips dict keys as strings; staleness groups
                # are ints in-memory — normalize back where unambiguous
                if field == "mass_staleness" and isinstance(g, str):
                    try:
                        g = int(g)
                    except ValueError:
                        pass
                mass[g] = mass.get(g, 0.0) + float(m)
        tot = sum(mass.values())
        if tot > 0:
            mass = {k: v / tot for k, v in mass.items()}
        return mass

    def rung_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for r in self.rounds:
            for rung, c in r["sketch"]["rungs"].items():
                hist[rung] = hist.get(rung, 0) + int(c)
        return hist

    def quantiles(self, qs: Sequence[float] = (0.5, 0.9, 0.99)
                  ) -> Dict[str, Dict[float, float]]:
        """Per-metric streaming quantiles (rank error ≤ ε·n); empty until
        the run-end sketches have been flushed."""
        sk = self.summary.get("sketch")
        if not sk or "sketches" not in sk:
            return {}
        out: Dict[str, Dict[float, float]] = {}
        for name, doc in sk["sketches"].items():
            gk = GKQuantiles.from_json(doc)
            if gk.n == 0:
                continue
            out[name] = {float(q): float(gk.query(q)) for q in qs}
        return out

    def sample_rows(self) -> List[Dict[str, Any]]:
        """The seeded K-row reservoir sample of per-client outcome rows."""
        sk = self.summary.get("sketch")
        if not sk or "reservoir" not in sk:
            return []
        return list(sk["reservoir"].get("rows", []))

    # ------------------------------------------------ shared gauge views
    def total_wall_s(self) -> float:
        return float(math.fsum(r["gauges"].get("round_wall_s", 0.0)
                               for r in self.rounds))

    def phase_seconds(self, rnd: Optional[int] = None) -> Dict[str, float]:
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
        from repro_torch.obs.sinks import build_phase_table
        return build_phase_table(self.phase_seconds(), self.total_wall_s(),
                                 self.n_rounds)

    def health_verdict(self) -> Optional[Dict[str, Any]]:
        return self.summary.get("health")

    def label(self) -> str:
        m = self.meta
        parts = [str(m.get(k)) for k in ("scenario", "server_mode", "codec",
                                         "strategy") if m.get(k)]
        return "/".join(parts) if parts else "run"

    def resident_estimate(self) -> Dict[str, int]:
        """Rough structural size of the retained state — what the scale
        test asserts is O(rounds + K), not O(n_clients × rounds)."""
        import json as _json
        from repro_torch.obs.sinks import _jsonable
        return {
            "rounds": len(self.rounds),
            "round_record_bytes": max(
                (len(_json.dumps(_jsonable(r))) for r in self.rounds),
                default=0),
            "summary_bytes": len(_json.dumps(_jsonable(self.summary))),
            "reservoir_rows": len(self.sample_rows())}
