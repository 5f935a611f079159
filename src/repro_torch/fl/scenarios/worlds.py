"""Named network scenario worlds beyond the paper's Table-6 topology.

Each ``Scenario`` is a seeded stochastic process emitting one ``LinkState``
per client per round; the registry makes them addressable from
``FFTConfig.failure_mode = "scenario:<name>"``.  Worlds model *correlated*
and *time-structured* dynamics the seed's memoryless outage draws cannot:
shared-AP Wi-Fi outages, diurnal capacity cycles, bursty cell handover,
client churn, and cross-region capacity mixes.

All worlds are reset()-able back to their seed so a run is reproducible per
realization — the property FedAuto's guarantee is stated against.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Type

import numpy as np

from repro_torch.fl.scenarios.engine import CAUSE_OK, LinkArrays, LinkState

MBPS = 1e6


def _one_cause(caps: np.ndarray, up: np.ndarray, cause: str,
               downlink_ratio: float = 8.0) -> LinkArrays:
    """LinkArrays for a world with a single down-cause string."""
    codes = np.where(up, 0, 1).astype(np.int16)
    return LinkArrays(caps, up, codes, (CAUSE_OK, cause),
                      downlink_ratio=downlink_ratio)


class Scenario:
    """Base class: seeded per-round link-state process.

    Worlds implement ``sample_round_arrays`` (one vectorized struct-of-
    arrays draw per round — the population-scale hot path); the object-list
    ``sample_round`` view is derived from it, so both views expose the
    identical numeric realization.  Legacy out-of-tree worlds that only
    override ``sample_round`` still work: the base ``sample_round_arrays``
    wraps their list draw.

    ``channels`` optionally carries the runner's physical channel list
    (e.g. after a ResourceOpt intervention) for worlds grounded in the
    paper's path-loss model; synthetic worlds ignore it.
    """

    name = "base"

    def __init__(self, n_clients: int, seed: int = 0, channels=None):
        self.n_clients = n_clients
        self.seed = seed
        self.channels_hint = channels
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        self._setup()

    def _setup(self) -> None:
        pass

    def sample_round(self, r: int) -> List[LinkState]:
        if type(self).sample_round_arrays is not Scenario.sample_round_arrays:
            return self.sample_round_arrays(r).to_links()
        raise NotImplementedError

    def sample_round_arrays(self, r: int) -> LinkArrays:
        if type(self).sample_round is not Scenario.sample_round:
            return LinkArrays.from_links(self.sample_round(r))
        raise NotImplementedError

    # helper: lognormal capacity around a base rate (scalar, legacy worlds)
    def _cap(self, base_bps: float, sigma: float = 0.5) -> float:
        return float(base_bps * math.exp(self.rng.normal(0.0, sigma)))

    # helper: vectorized lognormal capacities, one draw per entry
    def _caps(self, base_bps, sigma: float = 0.5) -> np.ndarray:
        base = np.asarray(base_bps, dtype=np.float64)
        return base * np.exp(self.rng.normal(0.0, sigma, base.shape))


SCENARIOS: Dict[str, Type[Scenario]] = {}


def register(cls: Type[Scenario]) -> Type[Scenario]:
    SCENARIOS[cls.name] = cls
    return cls


def available_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def make_scenario(name: str, n_clients: int, seed: int = 0,
                  **kwargs) -> Scenario:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"registered: {available_scenarios()}")
    return SCENARIOS[name](n_clients, seed=seed, **kwargs)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------
@register
class Table6Scenario(Scenario):
    """The paper's Appendix-III topology, lifted into the time domain.

    Capacities come from the seed's log-distance path-loss channel
    (``repro.fl.network``); instead of thresholding capacity against a fixed
    rate (Eq. 40), the deadline decides — a deep shadow fade yields an
    upload too slow to land before the timeout, which *is* a transient
    failure, now with a duration attached.
    """

    name = "table6"

    def _setup(self) -> None:
        from repro_torch.fl.network import build_network
        if self.channels_hint is not None:
            self.channels = self.channels_hint
        else:
            self.channels = build_network(self.n_clients, seed=self.seed)

    def sample_round_arrays(self, r: int) -> LinkArrays:
        from repro_torch.fl.network import capacity_array
        return LinkArrays.all_up(capacity_array(self.channels, self.rng))


@register
class CorrelatedWifiScenario(Scenario):
    """Clients share access points; an AP outage drops its whole group.

    Each AP is a two-state Markov chain (up/down); client capacity when the
    AP is up is lognormal around a per-client base drawn once.  This breaks
    the seed's independence assumption: failures arrive in correlated
    bundles, which skews the effective class distribution far more than
    i.i.d. drops of the same marginal rate.
    """

    name = "correlated_wifi"

    def __init__(self, n_clients: int, seed: int = 0, n_aps: int = 4,
                 p_fail: float = 0.08, p_recover: float = 0.45,
                 base_mbps: float = 12.0, **kw):
        self.n_aps = n_aps
        self.p_fail = p_fail
        self.p_recover = p_recover
        self.base_mbps = base_mbps
        super().__init__(n_clients, seed, **kw)

    def _setup(self) -> None:
        self.ap_of = np.arange(self.n_clients) % self.n_aps
        self.ap_up = np.ones(self.n_aps, dtype=bool)
        self.base = self.base_mbps * MBPS * np.exp(
            self.rng.normal(0.0, 0.6, self.n_clients))

    def sample_round_arrays(self, r: int) -> LinkArrays:
        flip = self.rng.uniform(size=self.n_aps)
        self.ap_up = np.where(self.ap_up, flip > self.p_fail,
                              flip < self.p_recover)
        up = self.ap_up[self.ap_of]
        caps = np.zeros(self.n_clients)
        caps[up] = self._caps(self.base[up], 0.4)
        return _one_cause(caps, up, "ap_outage")


@register
class DiurnalScenario(Scenario):
    """Capacity follows a day/night cycle with per-timezone phase offsets.

    Congestion peaks cut capacity to ``trough`` of the off-peak rate, so the
    same deadline that admits everyone at 4 a.m. drops whole timezones at
    8 p.m. — slow, *predictable* non-stationarity that memoryless draws
    cannot express.
    """

    name = "diurnal"

    def __init__(self, n_clients: int, seed: int = 0, period: int = 48,
                 n_zones: int = 4, base_mbps: float = 10.0,
                 trough: float = 0.012, **kw):
        self.period = period
        self.n_zones = n_zones
        self.base_mbps = base_mbps
        self.trough = trough
        super().__init__(n_clients, seed, **kw)

    def _setup(self) -> None:
        zone = np.arange(self.n_clients) % self.n_zones
        self.phase = zone * (self.period / self.n_zones)
        self.base = self.base_mbps * MBPS * np.exp(
            self.rng.normal(0.0, 0.3, self.n_clients))

    def sample_round_arrays(self, r: int) -> LinkArrays:
        cyc = 0.5 * (1.0 + np.sin(
            2.0 * np.pi * (r + self.phase) / self.period))
        scale = self.trough + (1.0 - self.trough) * cyc
        return LinkArrays.all_up(self._caps(self.base * scale, 0.25))


@register
class BurstyHandoverScenario(Scenario):
    """Mobile clients with Gilbert–Elliott bursty handover outages.

    Each client is a two-state chain: GOOD (full capacity) and HANDOVER
    (link down, geometric dwell).  Entering handover is rare but dwelling is
    sticky, producing the multi-round failure bursts of §V-A2's intermittent
    model — driven here by an explicit channel state instead of a renewal
    clock, and mixed with capacity fading while GOOD.
    """

    name = "bursty_handover"

    def __init__(self, n_clients: int, seed: int = 0, p_enter: float = 0.06,
                 p_exit: float = 0.35, base_mbps: float = 8.0, **kw):
        self.p_enter = p_enter
        self.p_exit = p_exit
        self.base_mbps = base_mbps
        super().__init__(n_clients, seed, **kw)

    def _setup(self) -> None:
        self.in_handover = np.zeros(self.n_clients, dtype=bool)
        self.base = self.base_mbps * MBPS * np.exp(
            self.rng.normal(0.0, 0.5, self.n_clients))

    def sample_round_arrays(self, r: int) -> LinkArrays:
        u = self.rng.uniform(size=self.n_clients)
        self.in_handover = np.where(self.in_handover, u > self.p_exit,
                                    u < self.p_enter)
        up = ~self.in_handover
        caps = np.zeros(self.n_clients)
        caps[up] = self._caps(self.base[up], 0.6)
        return _one_cause(caps, up, "handover")


@register
class ChurnScenario(Scenario):
    """Client churn: devices alternate present/away sessions (mobility,
    app backgrounding, battery).  Session and away lengths are geometric;
    away clients are simply gone for the round."""

    name = "churn"

    def __init__(self, n_clients: int, seed: int = 0, mean_stay: float = 12.0,
                 mean_away: float = 5.0, base_mbps: float = 15.0, **kw):
        self.mean_stay = mean_stay
        self.mean_away = mean_away
        self.base_mbps = base_mbps
        super().__init__(n_clients, seed, **kw)

    def _setup(self) -> None:
        self.present = self.rng.uniform(size=self.n_clients) < (
            self.mean_stay / (self.mean_stay + self.mean_away))
        self.base = self.base_mbps * MBPS * np.exp(
            self.rng.normal(0.0, 0.4, self.n_clients))

    def sample_round_arrays(self, r: int) -> LinkArrays:
        u = self.rng.uniform(size=self.n_clients)
        leave = u < 1.0 / self.mean_stay
        arrive = u < 1.0 / self.mean_away
        self.present = np.where(self.present, ~leave, arrive)
        up = self.present.astype(bool)
        caps = np.zeros(self.n_clients)
        caps[up] = self._caps(self.base[up], 0.3)
        return _one_cause(caps, up, "churned")


@register
class CrossRegionScenario(Scenario):
    """Clients striped across regions with very different link classes:
    datacenter fiber, urban 5G, suburban cable, and satellite (high capacity
    but weather-driven outages).  Stresses aggregation under persistent
    capacity heterogeneity rather than randomness."""

    name = "cross_region"

    REGIONS = (
        dict(name="fiber", mbps=400.0, sigma=0.1, p_out=0.001, cause="fiber_cut"),
        dict(name="urban5g", mbps=40.0, sigma=0.5, p_out=0.02, cause="congestion"),
        dict(name="suburban", mbps=6.0, sigma=0.4, p_out=0.03, cause="congestion"),
        dict(name="satellite", mbps=18.0, sigma=0.8, p_out=0.10, cause="weather"),
    )

    def _setup(self) -> None:
        self.region_of = np.arange(self.n_clients) % len(self.REGIONS)
        regions = self.REGIONS
        self.base = np.array([regions[k]["mbps"] for k in self.region_of]) \
            * MBPS
        self.sigma = np.array([regions[k]["sigma"] for k in self.region_of])
        self.p_out = np.array([regions[k]["p_out"] for k in self.region_of])
        # per-region down causes, deduplicated into one cause table
        self.cause_table = (CAUSE_OK,) + tuple(dict.fromkeys(
            r["cause"] for r in regions))
        self.down_code = np.array(
            [self.cause_table.index(regions[k]["cause"])
             for k in self.region_of], dtype=np.int16)

    def sample_round_arrays(self, r: int) -> LinkArrays:
        u = self.rng.uniform(size=self.n_clients)
        up = u >= self.p_out
        caps = np.zeros(self.n_clients)
        caps[up] = self.base[up] * np.exp(
            self.rng.normal(0.0, self.sigma[up]))
        codes = np.where(up, 0, self.down_code).astype(np.int16)
        return LinkArrays(caps, up, codes, self.cause_table)


@register
class LossyUplinkScenario(Scenario):
    """Uniformly flaky uplinks: every client has an independent per-round
    outage probability plus heavy-tailed capacity fading — the closest world
    to the seed's i.i.d. transient model, kept as the control scenario."""

    name = "lossy_uplink"

    def __init__(self, n_clients: int, seed: int = 0, p_out: float = 0.15,
                 base_mbps: float = 10.0, **kw):
        self.p_out = p_out
        self.base_mbps = base_mbps
        super().__init__(n_clients, seed, **kw)

    def sample_round_arrays(self, r: int) -> LinkArrays:
        u = self.rng.uniform(size=self.n_clients)
        up = u >= self.p_out
        caps = np.zeros(self.n_clients)
        caps[up] = self._caps(np.full(int(up.sum()),
                                      self.base_mbps * MBPS), 0.7)
        return _one_cause(caps, up, "outage")


@register
class BlackoutScenario(Scenario):
    """Fault-injection world for the run-health monitors.

    Nominal lognormal links for the first ``onset`` rounds, then a core-
    network blackout: a seeded ``dark_frac`` of clients lose their links
    outright and the survivors' capacity collapses to ``residual`` of its
    base — uploads slide down the codec ladder, cohorts empty out, buffered
    uploads age past any staleness horizon, and the adaptive controller's
    capacity estimates fall off a cliff.  Every detector in
    ``repro.obs.health`` has something to say about this world; the healthy
    worlds above are the silence baselines.
    """

    name = "blackout"

    def __init__(self, n_clients: int, seed: int = 0, onset: int = 6,
                 dark_frac: float = 0.9, residual: float = 0.02,
                 base_mbps: float = 12.0, **kw):
        self.onset = onset
        self.dark_frac = dark_frac
        self.residual = residual
        self.base_mbps = base_mbps
        super().__init__(n_clients, seed, **kw)

    def _setup(self) -> None:
        self.base = self.base_mbps * MBPS * np.exp(
            self.rng.normal(0.0, 0.4, self.n_clients))
        # who goes dark is drawn once at setup, so the realization is fixed
        # by the seed regardless of how many rounds run before the onset
        self.dark = self.rng.uniform(size=self.n_clients) < self.dark_frac

    def sample_round_arrays(self, r: int) -> LinkArrays:
        up = (np.ones(self.n_clients, dtype=bool) if r <= self.onset
              else ~self.dark)
        caps = np.zeros(self.n_clients)
        caps[up] = self._caps(self.base[up], 0.3)
        if r > self.onset:
            caps[up] *= self.residual
        return _one_cause(caps, up, "blackout")
