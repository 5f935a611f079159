"""Heterogeneous commercial-network simulation (paper Appendix III-A/B).

Implements Table 6 verbatim: 20 clients across wired / Wi-Fi 2.4 / Wi-Fi 5 /
4G / 5G, with the log-distance path-loss + shadowing channel (Eq. 38–39),
FDMA capacity (Eq. 37) and outage-driven transient failures (Eq. 40–41).
Also implements ResourceOpt-1/2 (Eq. 54–56): gradient-descent allocation of
transmit power / bandwidth to equalize failure probabilities.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

N0_DBM_HZ = -174.0          # noise PSD
PATHLOSS_EXP = 3.0          # λ in Eq. (38)

# Table 6 — standard -> (transmit power dBm, bandwidth Hz, carrier MHz, wall dB)
STANDARDS = {
    "wired":   dict(power_dbm=-20.0, bandwidth=10e6, freq_mhz=0.0, wall_db=0.0),
    "wifi24":  dict(power_dbm=20.0, bandwidth=10e6, freq_mhz=2400.0, wall_db=12.0),
    "wifi5":   dict(power_dbm=23.0, bandwidth=10e6, freq_mhz=5000.0, wall_db=18.0),
    "4g":      dict(power_dbm=23.0, bandwidth=1.8e6, freq_mhz=1800.0, wall_db=10.0),
    "5g":      dict(power_dbm=23.0, bandwidth=2.88e6, freq_mhz=3500.0, wall_db=15.0),
}

# Table 6 client index assignment (1-based in the paper)
def standard_of_client(i: int) -> str:
    idx = i + 1
    if idx <= 4:
        return "wired"
    return {1: "wifi24", 2: "wifi5", 3: "4g", 0: "5g"}[idx % 4]


@dataclasses.dataclass
class ClientChannel:
    standard: str
    power_dbm: float
    bandwidth: float
    freq_mhz: float
    wall_db: float
    distance_m: float
    indoor: bool
    shadow_sigma: float      # 4 dB LOS, 8 dB NLOS

    def capacity(self, rng: np.random.Generator) -> float:
        """One channel realization -> Shannon capacity (bps), Eq. (37)-(39)."""
        if self.standard == "wired":
            return float("inf")
        d_km = max(self.distance_m, 1.0) / 1000.0
        pl0 = 20.0 * math.log10(d_km) + 20.0 * math.log10(max(self.freq_mhz, 1.0)) + 32.44
        shadow = rng.normal(0.0, self.shadow_sigma)
        gain_db = -pl0 - 10.0 * PATHLOSS_EXP * math.log10(max(self.distance_m, 1.0)) \
            + shadow - self.wall_db
        p_rx_dbm = self.power_dbm + gain_db
        noise_dbm = N0_DBM_HZ + 10.0 * math.log10(self.bandwidth)
        snr = 10.0 ** ((p_rx_dbm - noise_dbm) / 10.0)
        return self.bandwidth * math.log2(1.0 + snr)

    def outage_probability(self, rate_bps: float, rng: np.random.Generator,
                           n_mc: int = 400) -> float:
        """Monte-Carlo ε_i (Eq. 40) over the shadowing distribution."""
        if self.standard == "wired":
            return 0.0
        fails = sum(self.capacity(rng) <= rate_bps for _ in range(n_mc))
        return fails / n_mc


def capacity_array(channels: List["ClientChannel"],
                   rng: np.random.Generator) -> np.ndarray:
    """Vectorized ``ClientChannel.capacity`` over a channel list.

    One shadowing draw per *non-wired* channel, in channel order — wired
    links are inf and consume no randomness, exactly like the scalar
    method's early return — so a single array draw replaces N scalar calls.
    """
    n = len(channels)
    caps = np.full(n, np.inf)
    idx = np.array([i for i, c in enumerate(channels)
                    if c.standard != "wired"], dtype=int)
    if len(idx) == 0:
        return caps
    dist = np.array([channels[i].distance_m for i in idx])
    freq = np.array([channels[i].freq_mhz for i in idx])
    sigma = np.array([channels[i].shadow_sigma for i in idx])
    wall = np.array([channels[i].wall_db for i in idx])
    power = np.array([channels[i].power_dbm for i in idx])
    bw = np.array([channels[i].bandwidth for i in idx])
    d_km = np.maximum(dist, 1.0) / 1000.0
    pl0 = (20.0 * np.log10(d_km) + 20.0 * np.log10(np.maximum(freq, 1.0))
           + 32.44)
    shadow = rng.normal(0.0, sigma)
    gain_db = (-pl0 - 10.0 * PATHLOSS_EXP * np.log10(np.maximum(dist, 1.0))
               + shadow - wall)
    p_rx_dbm = power + gain_db
    noise_dbm = N0_DBM_HZ + 10.0 * np.log10(bw)
    snr = 10.0 ** ((p_rx_dbm - noise_dbm) / 10.0)
    caps[idx] = bw * np.log2(1.0 + snr)
    return caps


def build_network(n_clients: int = 20, seed: int = 0) -> List[ClientChannel]:
    """Paper topology: 8 indoor (Wi-Fi, 20×20 m room), 12 outdoor (200 m cell)."""
    rng = np.random.default_rng(seed)
    chans = []
    for i in range(n_clients):
        std = standard_of_client(i)
        s = STANDARDS[std]
        indoor = std in ("wifi24", "wifi5")
        if indoor:
            x, y = rng.uniform(-10, 10, 2)
            d = math.sqrt(x * x + y * y + 3.0 ** 2)
        else:
            r = 200.0 * math.sqrt(rng.uniform(0.02, 1.0))
            d = math.sqrt(r * r + 20.0 ** 2)
        chans.append(ClientChannel(
            standard=std, power_dbm=s["power_dbm"], bandwidth=s["bandwidth"],
            freq_mhz=s["freq_mhz"], wall_db=s["wall_db"] if indoor else 0.0,
            distance_m=d, indoor=indoor, shadow_sigma=8.0 if indoor else 4.0))
    return chans


def uplink_rate(model_bytes: float, delay_s: float) -> float:
    """R_i = L_i / τ_i (Eq. 41), bits per second."""
    return model_bytes * 8.0 / delay_s


# ---------------------------------------------------------------------------
# ResourceOpt-1 / ResourceOpt-2 (Eq. 54–56)
# ---------------------------------------------------------------------------
def resource_opt(channels: List[ClientChannel], rate_bps: float, *,
                 per_standard: bool, eps_threshold: float = 0.9,
                 steps: int = 60, seed: int = 0) -> List[ClientChannel]:
    """Gradient-free coordinate search equalizing outage probabilities by
    reallocating power (within per-standard max) and bandwidth (within the
    per-standard total). per_standard=True is ResourceOpt-2."""
    rng = np.random.default_rng(seed)
    chans = [dataclasses.replace(c) for c in channels]
    groups = {}
    for idx, c in enumerate(chans):
        key = c.standard if per_standard else "all"
        if c.standard != "wired":
            groups.setdefault(key, []).append(idx)

    for key, idxs in groups.items():
        total_bw = sum(chans[i].bandwidth for i in idxs)
        pmax = max(chans[i].power_dbm for i in idxs)
        eps = np.array([chans[i].outage_probability(rate_bps, rng, 200) for i in idxs])
        eligible = eps <= eps_threshold
        for _ in range(steps):
            eps = np.array([chans[i].outage_probability(rate_bps, rng, 100)
                            for i in idxs])
            mean_eps = eps[eligible].mean() if eligible.any() else 0.0
            # move bandwidth from below-average-ε clients to above-average ones
            delta = np.where(eligible, eps - mean_eps, 0.0)
            for j, i in enumerate(idxs):
                bw = chans[i].bandwidth * (1.0 + 0.2 * delta[j])
                chans[i].bandwidth = float(np.clip(bw, 0.1e6, total_bw))
                chans[i].power_dbm = min(chans[i].power_dbm + 0.5 * delta[j], pmax)
            scale = total_bw / sum(chans[i].bandwidth for i in idxs)
            for i in idxs:
                chans[i].bandwidth *= scale
    return chans
