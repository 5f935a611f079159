"""Arrival-timeline synthesis for legacy (boolean) failure models.

The async server needs to know *when* each upload lands, but the seed
failure processes (``transient`` / ``intermittent`` / ``mixed`` / ``none``)
only answer up-or-down.  This adapter gives them the time dimension the
scenario worlds already have: each round it takes the inner model's up/down
draw, samples a capacity realization from the client's physical channel
(Eq. 37–39), and runs the same ``DeadlineSimulator`` the scenario engine
uses — capacity → upload time via the Eq. 41 rate relation
(``net_mod.uplink_rate`` fixes the bits; the channel draw fixes the bps).

The synthesized capacity is an independent realization of the same channel,
so under ``transient`` an up-flagged client can still draw a slow channel
and become a straggler — richer than the boolean model, by design.  The
link realization is cached separately from its timing simulation
(``LinkRealizationCache``), so repeated draws replay the realization and
per-round payload repricing never perturbs the inner model's draw.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.fl.failures import FailureModel
from repro_torch.fl.network import ClientChannel, capacity_array
from repro_torch.fl.scenarios.engine import (CAUSE_OK, DeadlineSimulator,
                                             LinkArrays, LinkRealizationCache)


class TimedFailureAdapter(LinkRealizationCache, FailureModel):
    """Wraps a boolean ``FailureModel`` with synthesized arrival timelines."""

    def __init__(self, inner: FailureModel, channels: List[ClientChannel], *,
                 model_bytes: float, deadline_s: float,
                 compute_s: float = 2.0, seed: int = 0,
                 engine: str = "vectorized"):
        self.inner = inner
        self.channels = channels
        self.sim = DeadlineSimulator(len(channels), model_bytes=model_bytes,
                                     deadline_s=deadline_s,
                                     compute_s=compute_s, seed=seed + 13,
                                     engine=engine)
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.inner.reset()
        self.sim.reset()
        self._reset_realization()

    def _sample_links(self, r: int) -> LinkArrays:
        up = np.asarray(self.inner.draw(r), dtype=bool)
        # Capacity draws come from an RNG keyed by (seed, round) and are
        # made for *every* client, up or down — mirroring the
        # DeadlineSimulator jitter fix, so one client's outage (or a
        # different inner failure mode at the same seed) never shifts
        # another client's synthesized capacity: realizations stay
        # common-random-number comparable.
        rng = np.random.default_rng([self.seed + 29, 0x71D3, r])
        caps = capacity_array(self.channels, rng)
        caps = np.where(up, caps, 0.0)
        codes = np.where(up, 0, 1).astype(np.int16)
        return LinkArrays(caps, up, codes, (CAUSE_OK, "outage"))
