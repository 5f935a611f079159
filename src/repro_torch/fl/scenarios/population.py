"""Population-scale scenario rounds: timing-only simulation to 1M clients.

The training runner (``FFTRunner``) carries real models, datasets, and
jitted updates — appropriate at Table-6 scale (tens of clients), hopeless
at a million.  This driver runs the *network* side of a round at
population scale with none of the training state: the vectorized scenario
engine draws every client's link and arrival time as dense arrays, an
optional :class:`~repro.fl.comm.AdaptiveCommController` prices per-client
rungs against a synthetic wire model (``_SyntheticComm`` — exact codec
byte counts from a single-leaf template, no parameters materialized), and
each round folds into O(1) :class:`PopulationRoundStats`.

Peak memory is O(population) only in the handful of per-client scalars
that *are* the simulation state (capacities, arrival times, estimates —
a few hundred MB at 1M clients); every temporary above that is bounded by
``cohort_size``, the same streaming unit the round loops use.  Traces
recorded here default to the v5 sketch schema
(``repro.fl.scenarios.trace``), so a 1M-client recording stays kilobytes
per round and cross-checks against regeneration by up-mask digest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fl.scenarios import make_scenario_model
from repro_torch.fl.scenarios.trace import TraceRecorder


@dataclasses.dataclass
class PopulationRoundStats:
    """One simulated round, folded to O(1) state."""
    rnd: int
    n_selected: int
    n_up: int                 # links up (whole population)
    n_connected: int          # selected & up & met_deadline
    n_missed: int             # selected & up & ~met_deadline
    n_skipped: int            # excluded from the draw (straggler skip)
    server_wait_s: float
    causes: Dict[str, int]    # whole-population drop-cause histogram


class _SyntheticComm:
    """Just enough of ``CommState`` for the adaptive controller's pricing.

    The controller only reads ``nbytes_for(rung)`` and ``download_bytes``;
    both derive from a single-leaf float32 template of
    ``model_bytes / 4`` parameters, so rung byte counts are the *exact*
    codec formulas at the simulated model size with no training state."""

    def __init__(self, model_bytes: float,
                 downlink_codec: Optional[str] = None):
        import torch
        n_params = max(int(round(float(model_bytes) / 4.0)), 1)
        # shape only: a meta tensor allocates nothing, and ``Codec.nbytes``
        # reads shapes alone
        self._template = {"w": torch.empty((n_params,), dtype=torch.float32,
                                           device="meta")}
        self._cache: Dict[str, float] = {}
        self.ref_bytes = 4.0 * n_params
        self.download_bytes = (self.ref_bytes if downlink_codec is None
                               else self.nbytes_for(downlink_codec))

    def nbytes_for(self, name: str) -> float:
        from repro_torch.fl.comm import make_codec
        if name not in self._cache:
            self._cache[name] = float(
                make_codec(name).nbytes(self._template))
        return self._cache[name]


def _cause_histogram(events) -> Dict[str, int]:
    codes = getattr(events, "cause_codes", None)
    if codes is not None:
        counts = np.bincount(np.asarray(codes),
                             minlength=len(events.cause_table))
        return {name: int(c) for name, c
                in zip(events.cause_table, counts) if c}
    from collections import Counter
    return dict(Counter(events.cause_list()))


def simulate_population(world: str, n_clients: int, rounds: int, *,
                        model_bytes: float = 4e6, deadline_s: float = 30.0,
                        compute_s: float = 2.0, seed: int = 0,
                        engine: str = "vectorized", cohort_size: int = 0,
                        k_selected: Optional[int] = None,
                        adaptive: Optional[str] = None,
                        skip_stragglers: bool = False,
                        trace_path: Optional[str] = None,
                        trace_mode: str = "auto"
                        ) -> List[PopulationRoundStats]:
    """Run ``rounds`` timing-only rounds of ``world`` at ``n_clients``.

    ``adaptive`` takes an ``"adaptive:<lo>-<hi>"`` codec spec to drive a
    real :class:`AdaptiveCommController` over the synthetic wire model —
    per-client rung assignment, repricing, and capacity learning all run
    exactly as in a training run, just without the training.
    ``skip_stragglers`` additionally excludes clients whose estimate
    cannot land the lowest rung from the selection draw (counted in
    ``n_skipped``).  ``trace_path`` records the realization (v5 sketch
    rounds at this scale, unless ``trace_mode`` forces rows)."""
    model = make_scenario_model(
        world, n_clients, model_bytes=model_bytes, deadline_s=deadline_s,
        compute_s=compute_s, seed=seed, engine=engine)
    if cohort_size:
        model.sim.cohort_size = int(cohort_size)

    controller = None
    if adaptive is not None:
        from repro_torch.fl.comm import (AdaptiveCommController,
                                         parse_adaptive_spec)
        lo, hi = parse_adaptive_spec(adaptive)
        controller = AdaptiveCommController(
            n_clients, _SyntheticComm(model_bytes), lo=lo, hi=hi,
            deadline_s=deadline_s, compute_s=compute_s)

    tracer = None
    if trace_path is not None:
        tracer = TraceRecorder(trace_path, {
            "scenario": f"scenario:{world}", "n_clients": n_clients,
            "deadline_s": deadline_s, "compute_s": compute_s,
            "model_bytes": model_bytes,
            "codec": adaptive or "fp32",
            "upload_bytes": None if adaptive else model_bytes,
            "download_bytes": model_bytes,
            "seed": seed}, mode=trace_mode)

    sel_rng = np.random.default_rng(seed + 17)
    stats: List[PopulationRoundStats] = []
    try:
        for r in range(1, rounds + 1):
            n_skipped = 0
            if k_selected is None and not (skip_stragglers and controller):
                selected = np.ones(n_clients, dtype=bool)
            else:
                eligible = np.arange(n_clients)
                if skip_stragglers and controller is not None:
                    landable = controller.landable_mask()
                    n_skipped = int((~landable).sum())
                    eligible = np.where(landable)[0]
                selected = np.zeros(n_clients, dtype=bool)
                k = len(eligible) if k_selected is None else k_selected
                if k >= len(eligible):
                    selected[eligible] = True
                elif len(eligible):
                    selected[sel_rng.choice(eligible, k,
                                            replace=False)] = True
            assignment = None
            if controller is not None:
                assignment = controller.assign(r, selected)
                model.set_payload_bytes(
                    upload_bytes=assignment.upload_bytes,
                    download_bytes=np.full(n_clients,
                                           assignment.download_bytes))
            events = model.draw_events(r)
            if controller is not None:
                controller.observe(r, events, selected)
            up = events.up_mask()
            met = events.deadline_mask()
            connected = selected & up & met
            if tracer is not None:
                tracer.write_round(
                    r, selected, connected, events,
                    payload_bytes=(assignment.upload_bytes
                                   if assignment is not None
                                   else model_bytes),
                    download_bytes=(assignment.download_bytes
                                    if assignment is not None
                                    else model_bytes))
            stats.append(PopulationRoundStats(
                rnd=r,
                n_selected=int(selected.sum()),
                n_up=int(up.sum()),
                n_connected=int(connected.sum()),
                n_missed=int((selected & up & ~met).sum()),
                n_skipped=n_skipped,
                server_wait_s=float(events.server_wait(selected)),
                causes=_cause_histogram(events)))
    finally:
        if tracer is not None:
            tracer.close()
    return stats
