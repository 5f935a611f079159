"""Connection-failure processes (paper §V-A2 and Appendix III-B).

* Transient  — per-round outage draws from the path-loss channel (Eq. 40).
* Intermittent — renewal process: failure triggers with probability
  1 − exp(−λ_i (r − r_0)) (Eq. 42); once triggered the disconnection lasts
  Uniform[1, duration_max] rounds (paper: [1, 100/α]).
* Mixed — union of both.
* scenario:<name> / replay:<path> — deadline-based scenario worlds and
  bit-exact trace replay from ``repro_torch.fl.scenarios``.

All models expose ``draw(round) -> np.ndarray[bool]`` (True = CONNECTED),
require no prior-knowledge hooks (FedAuto never reads their internals), and
are seeded for reproducibility.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.fl.network import ClientChannel

# Table 8 — intermittent failure rate per client (1-based groups of 4)
def intermittent_rate(i: int) -> float:
    return float(10.0 ** -(5 - min((i) // 4, 4)))   # 1e-5,1e-4,1e-3,1e-2,1e-1


class FailureModel:
    def draw(self, r: int) -> np.ndarray:           # True = connected
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def set_payload_bytes(self, upload_bytes=None, download_bytes=None
                          ) -> None:
        """Per-client, per-direction wire sizes (repro.fl.comm codecs).
        Boolean models have no time dimension, so the default is a no-op;
        timing-aware models forward to their ``DeadlineSimulator``."""


class NoFailures(FailureModel):
    def __init__(self, n: int):
        self.n = n

    def draw(self, r: int) -> np.ndarray:
        return np.ones(self.n, dtype=bool)


class TransientFailures(FailureModel):
    """Outage-driven: client i fails in round r iff C_i^r <= R_i (Eq. 40)."""

    def __init__(self, channels: List[ClientChannel], rate_bps: float,
                 seed: int = 0):
        self.channels = channels
        self.rate = rate_bps
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)

    def draw(self, r: int) -> np.ndarray:
        return np.array([c.capacity(self.rng) > self.rate for c in self.channels])


class IntermittentFailures(FailureModel):
    """Exponential trigger (Eq. 42) + uniform disconnection duration."""

    def __init__(self, n: int, duration_max: int = 10, seed: int = 0,
                 rates: Optional[np.ndarray] = None):
        self.n = n
        self.duration_max = duration_max
        self.rates = rates if rates is not None else np.array(
            [intermittent_rate(i) for i in range(n)])
        self.seed = seed
        self.reset()

    def reset(self) -> None:
        # reseed so reset() restores the full realization, matching the
        # scenario models' reproducibility contract
        self.rng = np.random.default_rng(self.seed)
        self.last_recovery = np.zeros(self.n, dtype=int)
        self.down_until = -np.ones(self.n, dtype=int)

    def draw(self, r: int) -> np.ndarray:
        up = np.ones(self.n, dtype=bool)
        for i in range(self.n):
            if r < self.down_until[i]:
                up[i] = False
                continue
            if self.down_until[i] >= 0 and r >= self.down_until[i]:
                self.last_recovery[i] = self.down_until[i]
                self.down_until[i] = -1
            p_fail = 1.0 - np.exp(-self.rates[i] * (r - self.last_recovery[i]))
            if self.rng.uniform() < p_fail:
                dur = self.rng.integers(1, self.duration_max + 1)
                self.down_until[i] = r + dur
                up[i] = False
        return up


class MixedFailures(FailureModel):
    def __init__(self, transient: TransientFailures,
                 intermittent: IntermittentFailures):
        self.t = transient
        self.i = intermittent

    def draw(self, r: int) -> np.ndarray:
        return self.t.draw(r) & self.i.draw(r)

    def reset(self) -> None:
        self.t.reset()
        self.i.reset()


def make_failure_model(mode: str, channels: List[ClientChannel],
                       rate_bps: float, *, duration_max: int = 10,
                       seed: int = 0, model_bytes: Optional[float] = None,
                       deadline_s: Optional[float] = None,
                       compute_s: float = 2.0,
                       engine: str = "vectorized") -> FailureModel:
    n = len(channels)
    if mode.startswith("scenario:"):
        # Deadline-based scenario worlds (repro_torch.fl.scenarios). Imported
        # here to keep failures.py import-light and cycle-free.
        from repro_torch.fl import scenarios as scen
        if model_bytes is None or deadline_s is None:
            raise ValueError("scenario:* failure modes need model_bytes "
                             "and deadline_s")
        return scen.make_scenario_model(
            mode.split(":", 1)[1], n, model_bytes=model_bytes,
            deadline_s=deadline_s, compute_s=compute_s, seed=seed,
            channels=channels, engine=engine)
    if mode.startswith("replay:"):
        from repro_torch.fl.scenarios import ReplayFailureModel
        return ReplayFailureModel(mode.split(":", 1)[1], n_clients=n)
    if mode == "none":
        return NoFailures(n)
    if mode == "transient":
        return TransientFailures(channels, rate_bps, seed=seed)
    if mode == "intermittent":
        return IntermittentFailures(n, duration_max=duration_max, seed=seed)
    if mode == "mixed":
        return MixedFailures(TransientFailures(channels, rate_bps, seed=seed),
                             IntermittentFailures(n, duration_max=duration_max,
                                                  seed=seed + 1))
    raise ValueError(mode)
