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

Ported from ``repro/obs/sketch.py`` without ``SketchReport``: it reads and
renders telemetry logs through ``obs.sinks``, which the port does not carry
yet.  The trace's v5 sketch rounds need only ``GKQuantiles``.
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
