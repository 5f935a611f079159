"""Staleness buffer: late uploads carried across round boundaries.

A synchronous server discards every upload that lands after the round
deadline.  The asynchronous server instead parks it here: the update was
computed from the round-``origin_round`` global model and physically lands at
absolute simulated time ``arrival_s``; it may still be aggregated in any
round ``origin_round + 1 .. origin_round + tau_max``, tagged with its
staleness, after which it is evicted.

Invariants (tested in ``tests/test_async_server.py``):
  * an update is applied at most once — ``(client, origin_round)`` keys are
    tracked and a duplicate push raises;
  * every applied update has staleness ``<= tau_max``;
  * nothing outlives its horizon: after ``collect(now, r)`` the buffer holds
    only updates with staleness ``<= tau_max`` that have not yet arrived.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Set, Tuple


@dataclasses.dataclass
class PendingUpdate:
    """One in-flight client upload."""
    client: int
    origin_round: int            # global round whose params seeded the update
    arrival_s: float             # absolute simulated landing time
    model: Any                   # w_i^{origin,E}
    delta: Any = None            # w_i^{origin,E} − w̄^{origin} (for FedBuff)
    origin_version: int = 0      # global-model version at dispatch; version
    #                              lag (not round lag) is the staleness that
    #                              discounts the update — a buffered server's
    #                              deferred rounds don't age anything
    codec: Optional[str] = None  # rung the upload traveled under
    upload_nbytes: Optional[float] = None  # bytes it cost on the wire
    distortion: float = 0.0      # compression distortion measured at encode
    packed: Any = None           # streaming mode: the wire PackedUpdate held
    #                              instead of the decoded model/delta pytrees
    #                              (model/delta stay None; payloads are
    #                              wire-sized, and stale origin globals are
    #                              shared references — ≤ tau_max+1 distinct)

    def staleness(self, current_round: int) -> int:
        """Round lag — bounds buffer lifetime (eviction horizon)."""
        return int(current_round - self.origin_round)


class StalenessBuffer:
    """Holds uploads that missed their round's deadline until they land."""

    def __init__(self, tau_max: int):
        if tau_max < 0:
            raise ValueError(f"tau_max must be >= 0, got {tau_max}")
        self.tau_max = tau_max
        self._entries: List[PendingUpdate] = []
        self._seen: Set[Tuple[int, int]] = set()
        self.n_applied = 0
        self.n_evicted = 0
        # telemetry hub (repro.obs); when live, evictions are additionally
        # logged as (client, origin_round) pairs for the loop to drain into
        # resolution events — a ``buffered`` outcome's terminal fate
        from repro_torch.obs.telemetry import NULL_TELEMETRY
        self.telemetry = NULL_TELEMETRY
        self.evictions: List[Tuple[int, int]] = []

    def __len__(self) -> int:
        return len(self._entries)

    def pending(self) -> List[PendingUpdate]:
        return list(self._entries)

    def push(self, upd: PendingUpdate) -> None:
        key = (upd.client, upd.origin_round)
        if key in self._seen:
            raise ValueError(f"update {key} pushed twice")
        self._seen.add(key)
        self._entries.append(upd)
        if self.telemetry:
            self.telemetry.counter("buffer.pushed")

    def collect(self, now_s: float, current_round: int
                ) -> List[PendingUpdate]:
        """Pop every update that has landed by ``now_s`` and is still fresh
        enough (staleness ``<= tau_max``); silently evict updates whose
        staleness exceeded the horizon (landed or not — they can only get
        staler).  Returns arrivals sorted by landing time."""
        with self.telemetry.timer("phase.buffer"):
            ready, kept = [], []
            for e in self._entries:
                if e.staleness(current_round) > self.tau_max:
                    self.n_evicted += 1
                    if self.telemetry:
                        self.telemetry.counter("buffer.evicted")
                        self.evictions.append((e.client, e.origin_round))
                elif e.arrival_s <= now_s:
                    ready.append(e)
                else:
                    kept.append(e)
            self._entries = kept
            ready.sort(key=lambda e: (e.arrival_s, e.client))
            self.n_applied += len(ready)
            if self.telemetry and ready:
                self.telemetry.counter("buffer.applied", len(ready))
        return ready

    def ready_count(self, now_s: float, current_round: int) -> int:
        """How many still-fresh updates have landed by ``now_s`` (the
        buffered-K server's trigger condition), without popping them."""
        return sum(1 for e in self._entries
                   if e.arrival_s <= now_s
                   and e.staleness(current_round) <= self.tau_max)

    def evict(self, current_round: int) -> int:
        """Drop every update whose staleness exceeded the horizon; returns
        the number evicted.  ``collect`` does this implicitly — this is for
        rounds where the server defers aggregation."""
        with self.telemetry.timer("phase.buffer"):
            n0 = len(self._entries)
            if self.telemetry:
                for e in self._entries:
                    if e.staleness(current_round) > self.tau_max:
                        self.telemetry.counter("buffer.evicted")
                        self.evictions.append((e.client, e.origin_round))
            self._entries = [e for e in self._entries
                             if e.staleness(current_round) <= self.tau_max]
            self.n_evicted += n0 - len(self._entries)
            return n0 - len(self._entries)

    def drop_client(self, client: int) -> int:
        """Discard every pending upload from ``client`` (e.g. permanent
        churn observed before its stragglers landed). Returns #dropped."""
        n0 = len(self._entries)
        if self.telemetry:
            for e in self._entries:
                if e.client == client:
                    self.telemetry.counter("buffer.evicted")
                    self.evictions.append((e.client, e.origin_round))
        self._entries = [e for e in self._entries if e.client != client]
        dropped = n0 - len(self._entries)
        self.n_evicted += dropped
        return dropped

    def reset(self) -> None:
        self._entries.clear()
        self._seen.clear()
        self.n_applied = 0
        self.n_evicted = 0
        self.evictions.clear()
