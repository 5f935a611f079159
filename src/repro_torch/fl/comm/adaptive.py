"""Adaptive per-client codec assignment from *observed* round outcomes.

FedAuto's promise is robustness without prior knowledge of network
conditions; a deployment that statically picks one codec for every client
either wastes capacity on fast links (everyone pays sign1's fidelity loss)
or keeps losing slow ones (everyone ships fp32 into a deadline they cannot
make).  The ``AdaptiveCommController`` closes that gap with the only
information a real server has: which selected clients' uploads landed, and
when.  It never reads ``LinkState`` — capacity is *estimated*, not leaked.

``FFTConfig.codec = "adaptive:<lo>-<hi>"`` (e.g. ``adaptive:sign1-fp16``)
selects a contiguous slice of the rung ladder

    sign1 → qsgd:2 → … → qsgd:8 → int8 → fp16 → fp32

ordered by fidelity (and, because every rung's byte count is
value-independent, by non-decreasing bytes-on-wire).  Each round, each
client is assigned the *richest* rung whose predicted landing time fits
inside a safety fraction of the deadline:

    t_pred(i, rung) = compute_prior + wire_bits(rung) / ĉ_i

where ĉ_i is the client's estimated effective capacity (bits/s) and
``wire_bits`` counts the uplink payload plus the broadcast at the assumed
downlink asymmetry.  The estimate is AIMD-flavored and needs no oracle:

* a landed upload updates ĉ_i by EWMA toward the implied throughput
  ``wire_bits / (finish_s − compute_prior)`` — *asymmetrically*: upward
  moves use the faster ``ewma_up`` (an arrival is direct evidence the link
  sustained that rate; climbing fast keeps a recovered client from lingering
  on coarse rungs, whose isolated one-shot updates are far noisier than the
  repeated ones error feedback is built for), downward moves the slower
  ``ewma_down``;
* a missed deadline (indistinguishable from a dead link, exactly as for a
  real server) multiplies ĉ_i by ``backoff`` — the client slides down the
  ladder until its uploads land again.

The controller starts optimistic (round 1 assigns ``hi`` to everyone), is
fully deterministic given the observed event stream, and therefore replays
bit-exactly from a recorded trace: the same events re-derive the same
assignments, and the v3 trace's per-round byte vectors cross-check that
nothing drifted.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

# Fidelity-ordered rung ladder; byte counts are non-decreasing left→right
# (qsgd:8 and int8 tie at 1 B/param + 4 B scale).
RUNG_LADDER: Tuple[str, ...] = (
    "sign1", "qsgd:2", "qsgd:3", "qsgd:4", "qsgd:5", "qsgd:6", "qsgd:7",
    "qsgd:8", "int8", "fp16", "fp32")


def is_adaptive_spec(spec: str) -> bool:
    return spec == "adaptive" or spec.startswith("adaptive:")


def parse_adaptive_spec(spec: str) -> Tuple[str, str]:
    """``"adaptive:<lo>-<hi>"`` → ``(lo, hi)`` rung names; bare
    ``"adaptive"`` spans the full ladder."""
    if spec == "adaptive":
        return RUNG_LADDER[0], RUNG_LADDER[-1]
    if not spec.startswith("adaptive:"):
        raise ValueError(f"not an adaptive codec spec: {spec!r}")
    body = spec.split(":", 1)[1]
    parts = body.split("-")
    if len(parts) != 2:
        raise ValueError(
            f"bad adaptive spec {spec!r}: want adaptive:<lo>-<hi> with "
            f"rungs from {RUNG_LADDER}")
    lo, hi = parts
    for name in (lo, hi):
        if name not in RUNG_LADDER:
            raise ValueError(f"bad adaptive spec {spec!r}: {name!r} is not "
                             f"a ladder rung {RUNG_LADDER}")
    if RUNG_LADDER.index(lo) > RUNG_LADDER.index(hi):
        raise ValueError(f"bad adaptive spec {spec!r}: lo rung {lo!r} is "
                         f"richer than hi rung {hi!r}")
    return lo, hi


def ladder_between(lo: str, hi: str) -> Tuple[str, ...]:
    return RUNG_LADDER[RUNG_LADDER.index(lo):RUNG_LADDER.index(hi) + 1]


@dataclasses.dataclass
class RoundAssignment:
    """One round's per-client codec decision (what the v3+ trace records).

    ``rung_idx``/``upload_bytes`` cover all N clients (the policy is a
    deterministic function of the estimates, and the simulator prices every
    link), but only the entries where ``selected`` is True describe rungs
    the server actually handed out — histograms and trace rows mask by it.
    The decision is stored array-backed (``rung_idx`` into ``rungs``);
    ``codecs`` materializes the historical per-client name list on demand.
    """
    rnd: int
    rung_idx: np.ndarray         # (N,) int index into ``rungs``
    rungs: Tuple[str, ...]       # ladder slice the indices refer to
    upload_bytes: np.ndarray     # (N,) simulated uplink wire bytes
    download_bytes: float        # broadcast bytes each client receives
    selected: Optional[np.ndarray] = None  # (N,) bool; None = all selected

    @property
    def codecs(self) -> List[str]:
        """Per-client rung names (derived view over ``rung_idx``)."""
        return [self.rungs[k] for k in self.rung_idx]


class AdaptiveCommController:
    """Online per-client bit-width policy over a rung ladder.

    ``assign(r)`` must be called once per round in order, ``observe(r, …)``
    after the round's events are known; both are deterministic functions of
    the observation history, which is what makes adaptive runs replayable.
    """

    def __init__(self, n_clients: int, comm, *, lo: str, hi: str,
                 deadline_s: float, compute_s: float = 2.0,
                 safety: float = 0.9, ewma_up: float = 0.7,
                 ewma_down: float = 0.35, backoff: float = 0.5,
                 dl_ratio: float = 8.0):
        self.n_clients = n_clients
        self.rungs = ladder_between(lo, hi)
        self.rung_bytes = np.array([comm.nbytes_for(name)
                                    for name in self.rungs], dtype=float)
        self.download_bytes = float(comm.download_bytes)
        self.deadline_s = float(deadline_s)
        self.fixed_s = float(compute_s)      # compute prior (config, no oracle)
        self.safety = float(safety)
        self.ewma_up = float(ewma_up)
        self.ewma_down = float(ewma_down)
        self.backoff = float(backoff)
        self.dl_ratio = float(dl_ratio)
        # bits each rung moves end-to-end: uplink payload + the broadcast
        # crossing the (assumed) dl_ratio-times-faster downlink
        self.wire_bits = (self.rung_bytes +
                          self.download_bytes / self.dl_ratio) * 8.0
        self.budget_s = self.safety * self.deadline_s
        # clamped into (0, 1e9]: an infinite (or sub-compute) deadline must
        # not poison cap_init with 0 or inf — 0 * inf = NaN would demote
        # everyone to the coarsest rung instead of the optimistic hi probe
        self.transfer_budget_s = max(min(self.budget_s - self.fixed_s, 1e9),
                                     1e-6)
        # optimistic start: exactly the capacity at which hi fits the budget,
        # so round 1 probes the richest rung and misses back off from there
        self.cap_init = float(self.wire_bits[-1] / self.transfer_budget_s)
        self.cap_min = float(self.wire_bits[0] / self.transfer_budget_s) * 1e-3
        self.cap_max = 1e18
        # telemetry hub (repro.obs); the runner swaps in a live one per
        # instrumented run
        from repro_torch.obs.telemetry import NULL_TELEMETRY
        self.telemetry = NULL_TELEMETRY
        self.reset()

    def reset(self) -> None:
        """Back to the optimistic prior (start of a run): estimates are
        per-run state, like error-feedback residuals."""
        self.cap_hat = np.full(self.n_clients, self.cap_init)
        self.assignments: Dict[int, RoundAssignment] = {}
        self.n_success = 0
        self.n_miss = 0
        self._last_idx: Optional[np.ndarray] = None  # previous rung indices

    # ------------------------------------------------------------- policy
    def rung_index_for(self, cap_bps: float) -> int:
        """Richest feasible rung index at estimated capacity ``cap_bps``
        (monotone non-decreasing in capacity; 0 when nothing fits)."""
        feasible = self.wire_bits <= cap_bps * self.transfer_budget_s
        if not feasible.any():
            return 0
        # wire_bits is non-decreasing, so the feasible set is a prefix
        return int(np.nonzero(feasible)[0][-1])

    def rung_for(self, cap_bps: float) -> str:
        return self.rungs[self.rung_index_for(cap_bps)]

    def rung_indices(self, cap_bps: np.ndarray) -> np.ndarray:
        """Vectorized ``rung_index_for`` over a capacity array.

        ``wire_bits`` is non-decreasing, so the feasible set at any capacity
        is a prefix of the ladder and the richest feasible rung is simply
        ``count(feasible) − 1`` (0 when nothing fits) — one broadcasted
        comparison instead of N python loops."""
        cap_bps = np.asarray(cap_bps, dtype=float)
        feasible = (self.wire_bits[None, :]
                    <= cap_bps[:, None] * self.transfer_budget_s)
        return np.maximum(feasible.sum(axis=1) - 1, 0)

    def landable_mask(self) -> np.ndarray:
        """(N,) bool: True where the current capacity estimate can land at
        least the *lowest* rung inside the transfer budget — the
        straggler-skip predicate (``FFTConfig.skip_stragglers``).  A False
        entry means even the coarsest upload is predicted to miss the
        deadline, so selecting that client buys nothing this round."""
        return self.wire_bits[0] <= self.cap_hat * self.transfer_budget_s

    def assign(self, rnd: int, selected: Optional[np.ndarray] = None,
               download_bytes: Optional[float] = None) -> RoundAssignment:
        """Assign this round's rungs.  ``selected`` masks the clients the
        server actually contacts this round: assignments are still computed
        for everyone (the policy is deterministic and the simulator prices
        every link), but stats and trace rows only count selected clients —
        a rung the server never handed out is not an assignment.
        ``download_bytes`` overrides the steady-state broadcast size for
        this round (the round-1 full-model enrollment transfer) so
        ``observe`` later divides the wire bits that actually traveled by
        the observed time."""
        tel = self.telemetry
        with tel.timer("phase.controller"):
            idx_arr = self.rung_indices(self.cap_hat)
            a = RoundAssignment(
                rnd=rnd,
                rung_idx=idx_arr,
                rungs=self.rungs,
                upload_bytes=self.rung_bytes[idx_arr].copy(),
                download_bytes=(self.download_bytes if download_bytes is None
                                else float(download_bytes)),
                selected=(None if selected is None
                          else np.asarray(selected, dtype=bool).copy()))
            self.assignments[rnd] = a
            if tel:
                if self._last_idx is not None:
                    # fraction of clients whose assigned rung changed since
                    # the previous assignment — the health monitors' rung-
                    # thrash signal (policy instability, not selection noise,
                    # so it is measured over all clients)
                    churn = float((idx_arr != self._last_idx).mean())
                    tel.gauge(rnd, "rung_churn", churn)
                # per-client capacity estimates as a distribution (folded
                # into a quantile sketch in sketch mode, dropped in full
                # mode where cap_hat_mean_bps already summarizes them)
                tel.distribution(rnd, "cap_hat_bps", self.cap_hat)
            self._last_idx = idx_arr
        return a

    # ---------------------------------------------------------- learning
    def observe(self, rnd: int, events, selected: np.ndarray) -> None:
        """Update capacity estimates from one round's resolved events.

        Only *selected* clients are observed (the server sent nothing to the
        rest), and only through what a server sees: landed uploads carry an
        arrival instant; everything else — outage or straggler alike — is
        one undifferentiated miss.
        """
        a = self.assignments.get(rnd)
        if a is None:
            return
        tel = self.telemetry
        with tel.timer("phase.controller"):
            sel = np.asarray(selected, dtype=bool)
            finish = events.finish_array()
            met = events.deadline_mask()
            landed = sel & met & np.isfinite(finish)
            missed = sel & ~(met & np.isfinite(finish))
            wire_bits = (a.upload_bytes +
                         a.download_bytes / self.dl_ratio) * 8.0
            with np.errstate(divide="ignore", invalid="ignore"):
                obs = wire_bits / np.maximum(finish - self.fixed_s, 1e-3)
            w = np.where(obs > self.cap_hat, self.ewma_up, self.ewma_down)
            ewma = (1.0 - w) * self.cap_hat + w * obs
            cap = np.where(landed, ewma,
                           np.where(missed, self.cap_hat * self.backoff,
                                    self.cap_hat))
            # clip only the clients observed this round (the rest keep
            # their estimate verbatim, clipped or not)
            self.cap_hat = np.where(
                sel, np.minimum(np.maximum(cap, self.cap_min), self.cap_max),
                cap)
            n_landed = int(landed.sum())
            n_sel = int(sel.sum())
            self.n_success += n_landed
            self.n_miss += n_sel - n_landed
            if tel:
                tel.counter("adaptive.landed", n_landed)
                tel.counter("adaptive.missed", n_sel - n_landed)
                tel.gauge(rnd, "cap_hat_mean_bps",
                          float(self.cap_hat.mean()))

    # ------------------------------------------------------- persistence
    def save_state(self, path: str) -> None:
        """Persist the learned capacity estimates as JSON.

        The estimates are the controller's only cross-round state: a later
        run that loads them skips the optimistic-probe warm-up and opens on
        each client's converged rung (``FFTConfig.controller_state_in``)."""
        state = {
            "version": 1,
            "n_clients": self.n_clients,
            "rungs": list(self.rungs),
            "cap_hat_bps": [float(c) for c in self.cap_hat],
            "n_success": int(self.n_success),
            "n_miss": int(self.n_miss),
        }
        with open(path, "w") as f:
            json.dump(state, f)

    def load_state(self, path: str) -> None:
        """Warm-start capacity estimates from ``save_state`` output.

        The ladder slice may differ between runs (estimates are in bps,
        rung-independent), but the population size must match — estimates
        are indexed by client id."""
        with open(path) as f:
            state = json.load(f)
        n = int(state["n_clients"])
        if n != self.n_clients:
            raise ValueError(
                f"controller state {path} was saved for {n} clients but "
                f"this run has {self.n_clients}; capacity estimates are "
                "indexed by client id and cannot be remapped")
        cap = np.asarray(state["cap_hat_bps"], dtype=float)
        self.cap_hat = np.minimum(np.maximum(cap, self.cap_min), self.cap_max)
        self.n_success = int(state.get("n_success", 0))
        self.n_miss = int(state.get("n_miss", 0))

    # ------------------------------------------------------------- stats
    def rung_histogram(self) -> Dict[str, int]:
        """Total per-rung assignment counts across all rounds so far —
        *selected* clients only: a rung computed for a client the server
        never contacted that round is policy state, not an assignment."""
        totals = np.zeros(len(self.rungs), dtype=np.int64)
        for a in self.assignments.values():
            idx = (a.rung_idx if a.selected is None
                   else a.rung_idx[a.selected])
            totals += np.bincount(idx, minlength=len(self.rungs))
        return {name: int(totals[k]) for k, name in enumerate(self.rungs)}
