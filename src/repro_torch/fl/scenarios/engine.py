"""Discrete-event wall-clock round simulator.

Turns per-round link states (capacity, up/down) into a timeline of
DOWNLOAD_DONE / COMPUTE_DONE / UPLOAD_DONE events per client, processed in
time order against the server's round deadline.  A client participates in
the round iff its link is up *and* its upload completes by the deadline —
this subsumes the seed's transient outage model (capacity ≈ 0 ⇒ upload never
finishes) and adds the time dimension: slow links and compute stragglers are
dropped exactly like dead ones, which is what a real synchronous FFT server
with a round timeout does.

The engine is deliberately separate from the scenario worlds
(``repro.fl.scenarios.worlds``): a ``Scenario`` describes *what the network
does*, the ``DeadlineSimulator`` describes *what time does to it*.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.fl.failures import FailureModel

# Event kinds, in per-client causal order.
DOWNLOAD_DONE = "download_done"
COMPUTE_DONE = "compute_done"
UPLOAD_DONE = "upload_done"

# Engine dispatch (mirrors kernels' ref/ops split): the heap is the
# reference event loop, the vectorized path is the closed-form batch
# computation — bit-identical by construction, cross-checked in tests.
ENGINES = ("heap", "vectorized")

# Participation causes recorded per client per round.
CAUSE_OK = "ok"                 # upload finished before the deadline
CAUSE_LINK_DOWN = "link_down"   # scenario reported the link down (scenario
#                                 worlds refine this: "ap_outage", "handover",
#                                 "churned", "weather", ...)
CAUSE_DEADLINE = "deadline"     # link up but upload finished too late


@dataclasses.dataclass
class LinkState:
    """One client's network condition for one round (scenario output)."""
    capacity_bps: float          # uplink Shannon capacity; inf for wired-like
    up: bool = True              # False = hard outage for the whole round
    cause: str = CAUSE_OK        # refined cause when ``up`` is False
    downlink_ratio: float = 8.0  # downlink capacity = ratio * uplink


@dataclasses.dataclass
class LinkArrays:
    """Struct-of-arrays form of one round's link states (scenario output).

    The population-scale twin of ``List[LinkState]``: one float64 capacity
    array, one up mask, and per-client cause *codes* into a small string
    table (code 0 is always ``CAUSE_OK``) instead of N Python objects.
    Worlds emit this directly (``Scenario.sample_round_arrays``); the
    object-list view is derived from it via ``to_links`` only when a
    consumer actually needs per-client objects, so both engine paths see
    the identical numeric realization by construction.
    """
    capacity_bps: np.ndarray          # (N,) float64
    up: np.ndarray                    # (N,) bool
    cause_codes: np.ndarray           # (N,) small int into cause_table
    cause_table: Tuple[str, ...]      # cause_table[0] == CAUSE_OK
    downlink_ratio: float = 8.0       # downlink capacity = ratio * uplink

    def __post_init__(self):
        self.capacity_bps = np.asarray(self.capacity_bps, dtype=np.float64)
        self.up = np.asarray(self.up, dtype=bool)
        self.cause_codes = np.asarray(self.cause_codes, dtype=np.int16)

    def __len__(self) -> int:
        return len(self.capacity_bps)

    @staticmethod
    def all_up(capacity_bps, downlink_ratio: float = 8.0) -> "LinkArrays":
        caps = np.asarray(capacity_bps, dtype=np.float64)
        return LinkArrays(caps, np.ones(len(caps), dtype=bool),
                          np.zeros(len(caps), dtype=np.int16), (CAUSE_OK,),
                          downlink_ratio=downlink_ratio)

    @staticmethod
    def from_links(links: Sequence[LinkState]) -> "LinkArrays":
        caps = np.array([l.capacity_bps for l in links], dtype=np.float64)
        up = np.array([l.up for l in links], dtype=bool)
        table: List[str] = [CAUSE_OK]
        index = {CAUSE_OK: 0}
        codes = np.zeros(len(links), dtype=np.int16)
        for i, l in enumerate(links):
            if l.cause not in index:
                index[l.cause] = len(table)
                table.append(l.cause)
            codes[i] = index[l.cause]
        ratios = {float(l.downlink_ratio) for l in links}
        if len(ratios) > 1:
            raise ValueError(
                f"LinkArrays carries one shared downlink_ratio; links mix "
                f"{sorted(ratios)}")
        return LinkArrays(caps, up, codes, tuple(table),
                          downlink_ratio=(ratios.pop() if ratios else 8.0))

    def cause_of(self, i: int) -> str:
        return self.cause_table[int(self.cause_codes[i])]

    def to_links(self) -> List[LinkState]:
        return [LinkState(capacity_bps=float(self.capacity_bps[i]),
                          up=bool(self.up[i]), cause=self.cause_of(i),
                          downlink_ratio=self.downlink_ratio)
                for i in range(len(self))]


# Either form of a round's link realization; the simulator accepts both.
Links = Union[Sequence[LinkState], LinkArrays]


@dataclasses.dataclass
class ClientRoundEvent:
    """Resolved participation of one client in one round."""
    client: int
    capacity_bps: float
    up: bool
    t_download_s: float
    t_compute_s: float
    t_upload_s: float
    finish_s: float              # download + compute + upload (inf if down)
    met_deadline: bool
    cause: str

    @property
    def connected(self) -> bool:
        return self.up and self.met_deadline


@dataclasses.dataclass
class RoundEvents:
    """Everything the server observed about one round."""
    rnd: int
    deadline_s: float
    events: List[ClientRoundEvent]
    duration_s: float            # wall-clock the server waited

    def up_mask(self) -> np.ndarray:
        return np.array([e.up for e in self.events], dtype=bool)

    def deadline_mask(self) -> np.ndarray:
        return np.array([e.met_deadline for e in self.events], dtype=bool)

    def connected_mask(self) -> np.ndarray:
        return self.up_mask() & self.deadline_mask()

    def late_mask(self) -> np.ndarray:
        """Clients whose upload physically lands, just after the deadline —
        the asynchronous server's staleness-buffer candidates."""
        return np.array([e.up and math.isfinite(e.finish_s)
                         and not e.met_deadline for e in self.events],
                        dtype=bool)

    def server_wait(self, selected: Optional[np.ndarray] = None) -> float:
        """Wall-clock the server waited on the given cohort: the last
        upload's landing time if every selected client delivered, else the
        full deadline (a missing straggler is indistinguishable from a dead
        link until the timeout).  An *empty* cohort also waits the full
        deadline — a real server that selected nobody (or whose selection
        came up empty) still sits out its round timeout; returning zero here
        would advance the simulated clock by nothing and flatter the
        wall-clock comparisons in ``bench_async``."""
        events = self.events if selected is None else [
            e for e, s in zip(self.events, selected) if s]
        if not events:
            return self.deadline_s
        if all(e.connected for e in events):
            return float(max(e.finish_s for e in events))
        return self.deadline_s

    # Array accessors shared with ArrayRoundEvents, so timing consumers
    # (the adaptive controller, the round loops' outcome emission) can stay
    # vectorized regardless of which engine produced the round.
    def finish_array(self) -> np.ndarray:
        return np.array([e.finish_s for e in self.events], dtype=np.float64)

    def capacity_array(self) -> np.ndarray:
        return np.array([e.capacity_bps for e in self.events],
                        dtype=np.float64)

    def upload_time_array(self) -> np.ndarray:
        return np.array([e.t_upload_s for e in self.events],
                        dtype=np.float64)

    def cause_list(self) -> List[str]:
        return [e.cause for e in self.events]


class ArrayRoundEvents:
    """Array-backed ``RoundEvents`` twin produced by the vectorized engine.

    Duck-types the object-list API (``rnd``/``deadline_s``/``duration_s``,
    the masks, ``server_wait``) with O(1)-per-field array storage; the
    ``events`` list of ``ClientRoundEvent`` objects is materialized lazily
    and cached, so small-n consumers (trace rows, tests) keep working while
    population-scale paths never pay for N Python objects.
    """

    def __init__(self, rnd: int, deadline_s: float, *,
                 capacity_bps: np.ndarray, up: np.ndarray,
                 t_download_s: np.ndarray, t_compute_s: np.ndarray,
                 t_upload_s: np.ndarray, finish_s: np.ndarray,
                 met_deadline: np.ndarray, cause_codes: np.ndarray,
                 cause_table: Tuple[str, ...]):
        self.rnd = rnd
        self.deadline_s = deadline_s
        self.capacity_bps = capacity_bps
        self.up = up
        self.t_download_s = t_download_s
        self.t_compute_s = t_compute_s
        self.t_upload_s = t_upload_s
        self.finish_s = finish_s
        self.met_deadline = met_deadline
        self.cause_codes = cause_codes
        self.cause_table = cause_table
        self._events: Optional[List[ClientRoundEvent]] = None
        self.duration_s = self.server_wait()

    def __len__(self) -> int:
        return len(self.finish_s)

    def up_mask(self) -> np.ndarray:
        return self.up

    def deadline_mask(self) -> np.ndarray:
        return self.met_deadline

    def connected_mask(self) -> np.ndarray:
        return self.up & self.met_deadline

    def late_mask(self) -> np.ndarray:
        return self.up & np.isfinite(self.finish_s) & ~self.met_deadline

    def server_wait(self, selected: Optional[np.ndarray] = None) -> float:
        if selected is None:
            finish, connected = self.finish_s, self.connected_mask()
        else:
            sel = np.asarray(selected, dtype=bool)
            if not sel.any():
                return float(self.deadline_s)
            finish, connected = self.finish_s[sel], self.connected_mask()[sel]
        if len(finish) == 0 or not connected.all():
            return float(self.deadline_s)
        return float(finish.max())

    def finish_array(self) -> np.ndarray:
        return self.finish_s

    def capacity_array(self) -> np.ndarray:
        return self.capacity_bps

    def upload_time_array(self) -> np.ndarray:
        return self.t_upload_s

    def cause_list(self) -> List[str]:
        table = self.cause_table
        return [table[c] for c in self.cause_codes]

    @property
    def events(self) -> List[ClientRoundEvent]:
        if self._events is None:
            table = self.cause_table
            self._events = [ClientRoundEvent(
                client=i, capacity_bps=float(self.capacity_bps[i]),
                up=bool(self.up[i]),
                t_download_s=float(self.t_download_s[i]),
                t_compute_s=float(self.t_compute_s[i]),
                t_upload_s=float(self.t_upload_s[i]),
                finish_s=float(self.finish_s[i]),
                met_deadline=bool(self.met_deadline[i]),
                cause=table[self.cause_codes[i]])
                for i in range(len(self))]
        return self._events


class DeadlineSimulator:
    """Event-driven timing model for one FFT round.

    Per client: download the global model, run E local steps, upload the
    update.  Compute speed is heterogeneous (persistent per-client lognormal
    straggler factor) with per-round jitter.  All phase completions are
    pushed onto one event heap; clients whose UPLOAD_DONE lands after the
    deadline are dropped (the boundary is inclusive: ``t <= deadline_s``
    delivers).
    """

    def __init__(self, n_clients: int, *, model_bytes: float,
                 deadline_s: float, compute_s: float = 2.0,
                 hetero_sigma: float = 0.4, jitter_sigma: float = 0.1,
                 seed: int = 0, engine: str = "vectorized",
                 cohort_size: int = 0):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (known: {ENGINES})")
        self.n_clients = n_clients
        self.model_bytes = model_bytes
        self.deadline_s = deadline_s
        self.compute_s = compute_s
        self.hetero_sigma = hetero_sigma
        self.jitter_sigma = jitter_sigma
        self.seed = seed
        self.engine = engine
        # vectorized path: >0 bounds per-chunk temporaries to O(cohort_size)
        # (the outputs are necessarily O(N): finish, met, causes)
        self.cohort_size = int(cohort_size)
        # telemetry hub (repro.obs): counts simulated rounds/heap events;
        # the runner swaps in a live hub per instrumented run
        from repro_torch.obs.telemetry import NULL_TELEMETRY
        self.telemetry = NULL_TELEMETRY
        # Per-client, per-direction payload sizes.  ``model_bytes`` is the
        # symmetric default; a codec-aware runner overrides them via
        # ``set_payload_bytes`` (compressed uploads finish earlier, so
        # clients that would miss the deadline at fp32 size can recover).
        self.upload_bytes: Optional[np.ndarray] = None
        self.download_bytes: Optional[np.ndarray] = None
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        # Persistent hardware heterogeneity: factor ~ lognormal, median 1.
        self.speed = np.exp(self.rng.normal(0.0, self.hetero_sigma,
                                            self.n_clients))

    def set_payload_bytes(self, upload_bytes=None, download_bytes=None
                          ) -> None:
        """Override the per-client wire sizes (scalar or (N,) array); None
        keeps the symmetric ``model_bytes`` default for that direction.
        Payload sizes survive ``reset()`` — they are configuration, not
        realization state."""
        def as_arr(x):
            if x is None:
                return None
            return np.broadcast_to(np.asarray(x, float),
                                   (self.n_clients,)).copy()
        self.upload_bytes = as_arr(upload_bytes)
        self.download_bytes = as_arr(download_bytes)

    # ------------------------------------------------------------------ core
    def round_jitters(self, rnd: int) -> np.ndarray:
        """Per-client compute-jitter factors for round ``rnd``, drawn
        vectorized from an RNG keyed by ``(seed, rnd)`` alone.

        Client *i*'s jitter therefore never depends on other clients' link
        states, on payload sizes, or on how many times the round has been
        simulated — realizations are common-random-number comparable across
        worlds/codecs, and re-pricing a round at new payload bytes replays
        the identical compute times.  (The old implementation drew one
        normal per *up* link from a shared stream, so flipping an unrelated
        client's outage shifted everyone after it.)
        """
        rng = np.random.default_rng([self.seed, 0x6A17, rnd])
        return np.exp(rng.normal(0.0, self.jitter_sigma, self.n_clients))

    def _phase_durations(self, i: int, link: LinkState, jitter: float):
        ul_bytes = (self.model_bytes if self.upload_bytes is None
                    else self.upload_bytes[i])
        dl_bytes = (self.model_bytes if self.download_bytes is None
                    else self.download_bytes[i])
        if not link.up:
            return math.inf, math.inf, math.inf
        cap = max(link.capacity_bps, 1e-9)
        t_ul = 0.0 if math.isinf(cap) else ul_bytes * 8.0 / cap
        dl_cap = cap * max(link.downlink_ratio, 1e-9)
        t_dl = 0.0 if math.isinf(dl_cap) else dl_bytes * 8.0 / dl_cap
        t_cp = self.compute_s * self.speed[i] * jitter
        return t_dl, t_cp, t_ul

    def simulate_round(self, rnd: int, links: Links,
                       deadline_s: Optional[float] = None):
        """Resolve one round's participation; returns ``RoundEvents`` (heap
        engine) or the duck-typed ``ArrayRoundEvents`` (vectorized engine).

        Idempotent for a fixed ``(rnd, links, payload bytes)``: jitters come
        from ``round_jitters`` (no shared RNG stream is consumed), so callers
        may re-simulate the same link realization at different payload sizes
        — the per-round repricing the adaptive codec controller relies on.
        Accepts either link representation; each engine converts to its
        native one, so both consume the identical numeric realization.
        """
        if self.engine == "vectorized":
            arrays = (links if isinstance(links, LinkArrays)
                      else LinkArrays.from_links(links))
            return self._simulate_vectorized(rnd, arrays, deadline_s)
        if isinstance(links, LinkArrays):
            links = links.to_links()
        return self._simulate_heap(rnd, links, deadline_s)

    def _simulate_vectorized(self, rnd: int, arrays: LinkArrays,
                             deadline_s: Optional[float] = None
                             ) -> ArrayRoundEvents:
        """Closed-form batch timing: per-client arrival is
        ``(t_dl + t_cp) + t_ul`` with no cross-client coupling, so the heap
        is pure overhead — the same float64 operations applied in the same
        association order reproduce its results bit-for-bit."""
        deadline = self.deadline_s if deadline_s is None else deadline_s
        jitters = self.round_jitters(rnd)
        n = self.n_clients
        t_dl = np.empty(n)
        t_cp = np.empty(n)
        t_ul = np.empty(n)
        finish = np.empty(n)
        met = np.zeros(n, dtype=bool)
        chunk = self.cohort_size if self.cohort_size > 0 else n
        for lo in range(0, n, max(chunk, 1)):
            hi = min(lo + chunk, n)
            s = slice(lo, hi)
            cap = np.maximum(arrays.capacity_bps[s], 1e-9)
            up = arrays.up[s]
            ul_b = (self.model_bytes if self.upload_bytes is None
                    else self.upload_bytes[s])
            dl_b = (self.model_bytes if self.download_bytes is None
                    else self.download_bytes[s])
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                ul = np.where(np.isinf(cap), 0.0, ul_b * 8.0 / cap)
                dl_cap = cap * max(arrays.downlink_ratio, 1e-9)
                dl = np.where(np.isinf(dl_cap), 0.0, dl_b * 8.0 / dl_cap)
            cp = self.compute_s * self.speed[s] * jitters[s]
            # down links: the heap path prices every phase at +inf
            t_dl[s] = np.where(up, dl, np.inf)
            t_cp[s] = np.where(up, cp, np.inf)
            t_ul[s] = np.where(up, ul, np.inf)
            # same association order as the heap's running event clock:
            # (download + compute) + upload
            f = np.where(up, (dl + cp) + ul, np.inf)
            finish[s] = f
            met[s] = f <= deadline                 # inclusive boundary
        # refined causes: the scenario's own code while down, ok/deadline
        # decided by the timing above
        table = tuple(arrays.cause_table)
        # down links whose scenario left cause at OK refine to "link_down"
        if CAUSE_LINK_DOWN in table:
            down_code = table.index(CAUSE_LINK_DOWN)
        else:
            table = table + (CAUSE_LINK_DOWN,)
            down_code = len(table) - 1
        if CAUSE_DEADLINE in table:
            late_code = table.index(CAUSE_DEADLINE)
        else:
            table = table + (CAUSE_DEADLINE,)
            late_code = len(table) - 1
        codes = np.where(arrays.up,
                         np.where(met, 0, late_code),
                         np.where(arrays.cause_codes == 0, down_code,
                                  arrays.cause_codes)).astype(np.int16)
        tel = self.telemetry
        if tel:
            tel.counter("sim.rounds")
            tel.counter("sim.vectorized_clients", n)
        return ArrayRoundEvents(
            rnd, deadline, capacity_bps=arrays.capacity_bps, up=arrays.up,
            t_download_s=t_dl, t_compute_s=t_cp, t_upload_s=t_ul,
            finish_s=finish, met_deadline=met, cause_codes=codes,
            cause_table=table)

    def _simulate_heap(self, rnd: int, links: List[LinkState],
                       deadline_s: Optional[float] = None) -> RoundEvents:
        """Reference event loop (the original engine), kept for
        cross-checking the vectorized path."""
        deadline = self.deadline_s if deadline_s is None else deadline_s
        jitters = self.round_jitters(rnd)
        heap: List[tuple] = []
        seq = 0
        finish = np.full(self.n_clients, math.inf)
        durations = {}
        for i, link in enumerate(links):
            t_dl, t_cp, t_ul = self._phase_durations(i, link, jitters[i])
            durations[i] = (t_dl, t_cp, t_ul)
            if link.up and math.isfinite(t_dl):
                seq += 1
                heapq.heappush(heap, (t_dl, seq, i, DOWNLOAD_DONE))

        met = np.zeros(self.n_clients, dtype=bool)
        while heap:
            t, _, i, kind = heapq.heappop(heap)
            t_dl, t_cp, t_ul = durations[i]
            if kind == DOWNLOAD_DONE:
                if math.isfinite(t_cp):
                    seq += 1
                    heapq.heappush(heap, (t + t_cp, seq, i, COMPUTE_DONE))
            elif kind == COMPUTE_DONE:
                if math.isfinite(t_ul):
                    seq += 1
                    heapq.heappush(heap, (t + t_ul, seq, i, UPLOAD_DONE))
            elif kind == UPLOAD_DONE:
                finish[i] = t
                # Inclusive boundary: an upload landing at exactly the
                # deadline is delivered.  (A DEADLINE sentinel event used to
                # decide this by heap tie-break — its seq=0 won against any
                # equal-time UPLOAD_DONE, silently dropping t == deadline
                # uploads.)
                met[i] = t <= deadline

        events = []
        for i, link in enumerate(links):
            t_dl, t_cp, t_ul = durations[i]
            if not link.up:
                cause = link.cause if link.cause != CAUSE_OK else CAUSE_LINK_DOWN
            elif met[i]:
                cause = CAUSE_OK
            else:
                cause = CAUSE_DEADLINE
            events.append(ClientRoundEvent(
                client=i, capacity_bps=float(link.capacity_bps), up=link.up,
                t_download_s=t_dl, t_compute_s=t_cp, t_upload_s=t_ul,
                finish_s=float(finish[i]), met_deadline=bool(met[i]),
                cause=cause))
        tel = self.telemetry
        if tel:
            tel.counter("sim.rounds")
            tel.counter("sim.heap_events", seq)
        # Full-cohort wait (all clients treated as selected); callers that
        # know the actual selection use RoundEvents.server_wait(selected).
        out = RoundEvents(rnd=rnd, deadline_s=deadline, events=events,
                          duration_s=0.0)
        out.duration_s = out.server_wait()
        return out


class LinkRealizationCache:
    """Mixin: link realization cached *separately* from timing simulation.

    ``_links`` freezes the stochastic per-round draw (subclasses provide it
    via ``_sample_links``), while ``_events`` memoizes the deterministic
    timing simulation on top of it.  ``set_payload_bytes`` may therefore be
    called between rounds — it prices rounds simulated *after* the call,
    which is how the round loops apply the adaptive controller's per-round
    byte vectors (assign → set_payload_bytes → draw_events) — and
    ``reprice_round`` re-runs an *already-simulated* round's cached link
    draw at the current sizes without perturbing it (offline what-if
    analysis; the repricing invariants are property-tested through it).

    Subclasses set ``self.sim`` (a ``DeadlineSimulator``) and call
    ``_reset_realization()`` from their ``reset``.
    """

    sim: DeadlineSimulator

    def _reset_realization(self) -> None:
        self._links: dict = {}
        self._events: dict = {}

    def _sample_links(self, r: int) -> Links:
        """One round's link realization, as a ``List[LinkState]`` or a
        ``LinkArrays`` — the simulator accepts either."""
        raise NotImplementedError

    def set_payload_bytes(self, upload_bytes=None, download_bytes=None
                          ) -> None:
        """Set per-client wire sizes for rounds simulated from now on.
        Already-simulated rounds keep their cached pricing until
        ``reprice_round`` is called for them explicitly."""
        self.sim.set_payload_bytes(upload_bytes, download_bytes)

    def links_for(self, r: int) -> Links:
        # Cache keyed by round: repeated draws of a past round return the
        # recorded realization instead of re-advancing the underlying
        # stochastic state.  First-time draws must still arrive in round
        # order — the processes are stateful, so sampling round 7 before
        # round 3 would hand round 3 the round-8 state.
        if r not in self._links:
            self._links[r] = self._sample_links(r)
        return self._links[r]

    def reprice_round(self, r: int):
        """Re-simulate round ``r``'s cached link realization at the current
        payload sizes.  Only the transfer durations (and what follows from
        them: ``finish_s``, ``met_deadline``, causes *between* ``ok`` and
        ``deadline``) may change; ``up`` and the link draw never do."""
        self._events[r] = self.sim.simulate_round(r, self.links_for(r))
        return self._events[r]

    def draw_events(self, r: int):
        if r not in self._events:
            self._events[r] = self.sim.simulate_round(r, self.links_for(r))
        return self._events[r]

    def draw(self, r: int) -> np.ndarray:
        return self.draw_events(r).connected_mask()


class ScenarioFailureModel(LinkRealizationCache, FailureModel):
    """Adapter: (Scenario world × DeadlineSimulator) → ``FailureModel``.

    ``draw(r)`` keeps the seed contract (True = connected) so every existing
    strategy works unchanged; ``draw_events(r)`` exposes the full timing
    detail for the runtime's ``connected = selected & up & met_deadline``
    split and for trace recording.  Caching/repricing semantics come from
    ``LinkRealizationCache``.
    """

    def __init__(self, scenario, sim: DeadlineSimulator):
        self.scenario = scenario
        self.sim = sim
        self._reset_realization()

    def reset(self) -> None:
        self.scenario.reset()
        self.sim.reset()
        self._reset_realization()

    def _sample_links(self, r: int) -> Links:
        return self.scenario.sample_round_arrays(r)
