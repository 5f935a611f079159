"""Server round loops, ported from ``repro/fl/server/loops.py``
(``FFTConfig.server_mode``):

* ``SyncRoundLoop``  ("sync") — Algorithm 1:
  ``connected = selected & up & met_deadline``, stragglers discarded.
* ``AsyncRoundLoop`` ("async") — stragglers are computed anyway (their
  local update started from the round's global model) and parked in a
  ``StalenessBuffer`` keyed by the instant the scenario engine says their
  upload lands; they are aggregated, staleness-tagged, in the round their
  arrival falls into (up to ``tau_max`` aggregation steps late).
* ``AsyncRoundLoop(buffered=True)`` ("buffered") — semi-async FedBuff-style
  server: an aggregation step is taken only once ``buffer_k`` arrivals have
  landed.

With an adaptive codec (``runner.controller``) each round's per-client
rungs are assigned before the network is drawn, and the controller learns
from the drawn events.  Every loop advances a simulated wall clock
(``RoundEvents.server_wait`` per round) and records
``TimePoint(rnd, t_s, acc)`` into ``runner.timeline`` at each evaluation.

Under a live telemetry hub (``runner.telemetry``) each loop emits, as the
JAX loops do, one terminal outcome per (round, client), the per-round
gauges (participants, bytes, ``round_wall_s``, the ``phase.*`` deltas) and
the ``phase.network_draw``, ``phase.trace`` and ``phase.aggregate`` timers,
and synchronizes the device before ``phase.aggregate`` closes.  With
telemetry off the loop never synchronizes the device: callers that time a
round call ``torch.cuda.synchronize()`` themselves.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List

import numpy as np

from repro_torch.core.aggregation import delta_pytree
from repro_torch.core.strategies import (Arrival, AsyncRoundContext,
                                         AsyncStrategy, RoundContext, Strategy)
from repro_torch.fl.comm.stream import PackedUpdate
from repro_torch.fl.server.buffer import PendingUpdate, StalenessBuffer
from repro_torch.obs.sync import block_until_ready
from repro_torch.obs.telemetry import (AGGREGATED, BUFFERED, EVICTED,
                                       LINK_DOWN, MISSED_DEADLINE,
                                       NOT_SELECTED, NULL_TELEMETRY,
                                       SKIPPED_STRAGGLER)


@dataclasses.dataclass
class TimePoint:
    """One evaluation, indexed by both round and simulated wall clock."""
    rnd: int
    t_s: float                   # simulated seconds since training start
    acc: float


class RoundLoop:
    """Skeleton shared by all server modes."""

    def __init__(self, runner, strategy: Strategy, tracer=None, log=None):
        self.runner = runner
        self.strategy = strategy
        self.tracer = tracer
        self.log = log
        self.clock_s = 0.0
        # telemetry hub: the runner builds its per-run hub (or the shared
        # no-op) in run() before constructing the loop
        self.obs = getattr(runner, "telemetry", NULL_TELEMETRY)
        self.participants_per_round: List[int] = []
        # per-round {client: normalized compression distortion} of the
        # uploads encoded that round (what the trace records and
        # fidelity-aware aggregation discounts by)
        self.distortion_history: List[Dict[int, float]] = []
        # clients excluded from this round's selection draw because their
        # capacity estimate cannot land even the lowest rung
        # (cfg.skip_stragglers); written by _select each round
        self.skipped = np.zeros(runner.n_clients, dtype=bool)
        self.n_skipped = 0
        # Streaming aggregation: a streaming-capable strategy receives the
        # round's uploads as wire PackedUpdates (fl/comm/stream.py) instead
        # of a dict of decoded model trees; ``streaming_agg="off"`` forces
        # the materializing path.
        self.streaming = (bool(getattr(strategy, "streaming", False)) and
                          getattr(runner.cfg, "streaming_agg", "auto") != "off")

    def _uplink(self, client: int, model, t_global, codec_name=None):
        """Encode client-side, decode server-side.  Returns
        ``(reconstructed_model, codec_name, wire_bytes, distortion)``;
        ``codec_name`` overrides the run's static codec (adaptive per-client
        rungs)."""
        comm = self.runner.comm
        codec = comm.codec_named(codec_name) if codec_name else comm.codec
        recon, _payload, distortion = comm.roundtrip(client, model, t_global,
                                                     codec=codec)
        return recon, codec.name, comm.nbytes_for(codec), float(distortion)

    def _uplink_packed(self, client: int, model, t_global, r: int,
                       codec_name=None):
        """Streaming sibling of ``_uplink``: encode client-side only and
        hand back the wire ``PackedUpdate``.  Error feedback, distortion
        and byte accounting happen here, at dispatch."""
        comm = self.runner.comm
        codec = comm.codec_named(codec_name) if codec_name else comm.codec
        payload, distortion = comm.encode_upload(client, model, t_global,
                                                 codec=codec)
        return PackedUpdate(client=client, payload=payload,
                            origin_global=t_global, codec=codec.name,
                            nbytes=comm.nbytes_for(codec),
                            distortion=float(distortion), origin_round=r)

    def _materialize_gauges(self, r: int, n_decoded: int) -> None:
        """The materializing path's side of the ``uplink_decode``
        attribution: ``n_decoded`` fp32 model trees were held at once for
        this round's aggregate (``repro/fl/server/loops.py:114-128``)."""
        tel = self.obs
        if not tel:
            return
        fp32 = self.runner.comm.fp32_nbytes
        if n_decoded:
            tel.counter("uplink.fallback_payloads", n_decoded)
            tel.counter("uplink.decoded_bytes", n_decoded * fp32)
        tel.gauge(r, "uplink_fused_payloads", 0)
        tel.gauge(r, "uplink_fallback_payloads", n_decoded)
        tel.gauge(r, "uplink_peak_decoded_bytes", n_decoded * fp32)

    def _begin_round(self, r: int, selected: np.ndarray):
        """Round preamble: the adaptive controller (when present) assigns
        this round's per-client rungs and re-prices the timing model before
        the network is drawn, then the server broadcasts the global model
        through the downlink codec.

        Returns ``(t_global, assignment, dl_bytes)``: the params clients
        start from (the decoded replica under a downlink codec), the round's
        ``RoundAssignment`` (None for static runs), and the broadcast bytes
        this round moved (``ref_bytes`` enrollment on a downlink codec's
        first round, the compressed rate after)."""
        runner = self.runner
        assignment = None
        dl_bytes = runner.comm.next_broadcast_nbytes()
        if runner.controller is not None:
            # v3 adaptive traces were recorded with the controller observing
            # the steady-state compressed broadcast in round 1: feed the
            # replaying controller the same number, or its re-derived rungs
            # would diverge from the recording
            hdr = getattr(runner.failures, "header", None)
            legacy_enroll = hdr is not None and hdr.get("version", 0) < 4
            assignment = runner.controller.assign(
                r, selected,
                download_bytes=(None if legacy_enroll else dl_bytes))
            if legacy_enroll:
                dl_bytes = assignment.download_bytes
            runner.failures.set_payload_bytes(
                upload_bytes=assignment.upload_bytes,
                download_bytes=np.full(runner.n_clients, dl_bytes))
            # Replaying a recorded adaptive run: the controller re-derives
            # its assignments from the replayed events, so any divergence
            # from the recorded byte vectors or rungs means the trace and
            # this configuration disagree
            if hasattr(runner.failures, "payload_bytes"):
                rec = runner.failures.payload_bytes(r)
                if rec is not None:
                    known = ~np.isnan(rec)
                    if not np.allclose(rec[known],
                                       assignment.upload_bytes[known],
                                       rtol=1e-6):
                        raise ValueError(
                            f"round {r}: replayed trace recorded per-client "
                            f"upload bytes {rec} but the adaptive controller "
                            f"assigns {assignment.upload_bytes}; the trace "
                            "was recorded under a different adaptive "
                            "configuration")
            if hasattr(runner.failures, "codecs"):
                rec_codecs = runner.failures.codecs(r)
                if rec_codecs is not None:
                    drift = {i: (rc, ac) for i, (rc, ac) in
                             enumerate(zip(rec_codecs, assignment.codecs))
                             if rc is not None and rc != ac}
                    if drift:
                        raise ValueError(
                            f"round {r}: replayed trace recorded per-client "
                            f"codec rungs {rec_codecs} but the adaptive "
                            f"controller assigns {assignment.codecs} "
                            f"(drift at {drift}); the trace was recorded "
                            "under a different adaptive configuration")
        elif runner.comm.downlink_codec is not None:
            # static run with a downlink codec: the enrollment broadcast
            # (round 1) travels at full size in the timing model too; the
            # upload size must be restated (None resets it)
            runner.failures.set_payload_bytes(
                upload_bytes=np.full(runner.n_clients,
                                     runner.comm.upload_bytes),
                download_bytes=np.full(runner.n_clients, dl_bytes))
        t_global, dl_charged = runner.comm.broadcast(runner.global_params)
        if self.obs:
            # the bytes CommState charged (what total_downlink_bytes sums)
            self.obs.gauge(r, "downlink_bytes", float(dl_charged))
        return t_global, assignment, dl_bytes

    def _trace_round(self, r, selected, connected, events, up, met_deadline,
                     assignment, dl_bytes, distortions=None) -> None:
        if self.tracer is None:
            return
        with self.obs.timer("phase.trace"):
            codecs = None
            if assignment is not None:
                # only rungs the server handed out this round are assignments
                codecs = [c if selected[i] else None
                          for i, c in enumerate(assignment.codecs)]
            self.tracer.write_round(
                r, selected, connected, events, up=up,
                met_deadline=met_deadline,
                payload_bytes=(assignment.upload_bytes
                               if assignment is not None
                               else self.runner.comm.upload_bytes),
                download_bytes=dl_bytes, codecs=codecs,
                distortions=distortions)

    def _observe(self, r, events, selected) -> None:
        runner = self.runner
        if runner.controller is not None and events is not None:
            runner.controller.observe(r, events, selected)

    # ------------------------------------------------------------- shared
    def _select(self) -> np.ndarray:
        """Uniform K-of-N selection from ``runner.rng``; with
        ``cfg.skip_stragglers`` and an adaptive controller, clients whose
        capacity estimate cannot land even the lowest rung are excluded
        from the draw (recorded in ``self.skipped``)."""
        runner = self.runner
        self.skipped = np.zeros(runner.n_clients, dtype=bool)
        if runner.cfg.skip_stragglers and runner.controller is not None:
            landable = runner.controller.landable_mask()
            self.skipped = ~landable
            self.n_skipped += int(self.skipped.sum())
            eligible = np.where(landable)[0]
            selected = np.zeros(runner.n_clients, dtype=bool)
            if runner.k_selected >= len(eligible):
                selected[eligible] = True
            elif len(eligible):
                sel = runner.rng.choice(eligible, runner.k_selected,
                                        replace=False)
                selected[sel] = True
            return selected
        if runner.k_selected >= runner.n_clients:
            return np.ones(runner.n_clients, dtype=bool)
        sel = runner.rng.choice(runner.n_clients, runner.k_selected,
                                replace=False)
        selected = np.zeros(runner.n_clients, dtype=bool)
        selected[sel] = True
        return selected

    def _cohorts(self, idx: np.ndarray):
        """Yield ``idx`` in fixed-size cohorts (``cfg.cohort_size``; 0 =
        everyone at once)."""
        cs = int(getattr(self.runner.cfg, "cohort_size", 0) or 0)
        if cs <= 0 or len(idx) <= cs:
            yield idx
            return
        for k in range(0, len(idx), cs):
            yield idx[k:k + cs]

    def _round_duration(self, selected, connected, events) -> float:
        """Simulated seconds the server spent on this round."""
        if events is not None:
            return float(events.server_wait(selected))
        # Legacy models have no time dimension: the server waits out its
        # timeout whenever a selected client is missing, else a nominal
        # compute+transmit round.
        cfg = self.runner.cfg
        if bool((selected & ~connected).any()):
            return float(cfg.deadline_s)
        return float(cfg.compute_s + cfg.tx_delay_s)

    def _maybe_eval(self, r: int, rounds: int, history: List[float]) -> None:
        runner = self.runner
        if r % runner.cfg.eval_every == 0 or r == rounds:
            acc = runner.evaluate()
            history.append(acc)
            runner.timeline.append(TimePoint(rnd=r, t_s=self.clock_s, acc=acc))
            if self.obs:
                self.obs.gauge(r, "eval_acc", float(acc))
            if self.log:
                self.log(r, acc)

    def run(self, rounds: int) -> List[float]:
        history: List[float] = []
        tel = self.obs
        for r in range(1, rounds + 1):
            tel.begin_round(r)
            if tel:
                # snapshot the run-wide phase accumulators so this round's
                # share can be emitted as per-round gauges below
                phase_snap = dict(tel.timers_s)
                wall_t0 = time.perf_counter()
            duration = self.run_round(r)
            self.clock_s += duration
            if tel:
                comm = self.runner.comm
                tel.gauge(r, "server_wait_s", float(duration))
                tel.gauge(r, "clock_s", float(self.clock_s))
                tel.gauge(r, "participants",
                          float(self.participants_per_round[-1]))
                tel.gauge(r, "cum_uplink_bytes",
                          float(comm.total_uplink_bytes))
                tel.gauge(r, "cum_downlink_bytes",
                          float(comm.total_downlink_bytes))
            self._maybe_eval(r, rounds, history)
            if tel:
                # real (host) wall seconds of this round, eval included,
                # plus each phase timer's delta since the round began;
                # phases are exclusive, so the deltas sum to at most the wall
                tel.gauge(r, "round_wall_s", time.perf_counter() - wall_t0)
                for name, total in tel.timers_s.items():
                    if not name.startswith("phase."):
                        continue
                    delta = total - phase_snap.get(name, 0.0)
                    if delta > 0.0:
                        tel.gauge(r, name, delta)
            tel.end_round(r)
        return history

    def run_round(self, r: int) -> float:
        raise NotImplementedError


class SyncRoundLoop(RoundLoop):
    """Algorithm 1 verbatim: deadline stragglers are discarded."""

    def run_round(self, r: int) -> float:
        runner, strategy = self.runner, self.strategy
        selected = self._select()
        t_global, assignment, dl_bytes = self._begin_round(r, selected)
        with self.obs.timer("phase.network_draw"):
            up, met_deadline, events = runner._draw_network(r)
        connected = selected & up & met_deadline
        self.participants_per_round.append(int(connected.sum()))
        self._observe(r, events, selected)

        client_models: Dict[int, Any] = {}
        packed: Dict[int, Any] = {}             # streaming: wire PackedUpdates
        codecs_used: Dict[int, str] = {}
        nbytes_used: Dict[int, float] = {}
        distortions: Dict[int, float] = {}
        mu = strategy.prox_mu()
        rung_names = assignment.codecs if assignment else None
        for cohort in self._cohorts(np.where(connected)[0]):
            for i in cohort:
                corr = strategy.correction(i, runner)
                m = runner.run_local(t_global, runner.client_x[i],
                                     runner.client_y[i], r, mu=mu, corr=corr)
                m = strategy.post_local(i, r, m, t_global, runner)
                cname_over = rung_names[int(i)] if rung_names else None
                if self.streaming:
                    pu = self._uplink_packed(int(i), m, t_global, r,
                                             codec_name=cname_over)
                    packed[int(i)] = pu
                    cname, nbytes, dist = pu.codec, pu.nbytes, pu.distortion
                else:
                    recon, cname, nbytes, dist = self._uplink(
                        int(i), m, t_global, codec_name=cname_over)
                    client_models[int(i)] = recon
                codecs_used[int(i)] = cname
                nbytes_used[int(i)] = nbytes
                distortions[int(i)] = dist
        if not self.streaming:
            self._materialize_gauges(r, len(client_models))
        self.distortion_history.append(dict(distortions))
        tel = self.obs
        if tel:
            tel.gauge(r, "selected", float(selected.sum()))
            if self.skipped.any():
                tel.gauge(r, "skipped_stragglers",
                          float(self.skipped.sum()))
            causes = events.cause_list() if events is not None else None
            finish = events.finish_array() if events is not None else None
            for i in range(runner.n_clients):
                if not selected[i]:
                    tel.client_outcome(
                        r, i, SKIPPED_STRAGGLER if self.skipped[i]
                        else NOT_SELECTED)
                elif not up[i]:
                    tel.client_outcome(
                        r, i, LINK_DOWN,
                        detail=(causes[i] if causes is not None else None))
                elif not met_deadline[i]:
                    never = (finish is not None and
                             not math.isfinite(finish[i]))
                    tel.client_outcome(r, i, MISSED_DEADLINE,
                                       detail="never_lands" if never else None)
                else:
                    tel.client_outcome(r, i, AGGREGATED,
                                       rung=codecs_used.get(int(i)),
                                       upload_bytes=nbytes_used.get(int(i)),
                                       distortion=distortions.get(int(i)))
        # trace written after the uploads, so each client row carries the
        # upload's measured distortion alongside its rung and byte count
        self._trace_round(r, selected, connected, events, up, met_deadline,
                          assignment, dl_bytes, distortions=distortions)
        server_model = runner.run_local(t_global, runner.public_x,
                                        runner.public_y, r)

        ctx = RoundContext(
            rnd=r, global_params=t_global, server_model=server_model,
            client_models=client_models, selected=selected,
            connected=connected, p=runner.p,
            client_hists=runner.client_hists, server_hist=runner.server_hist,
            global_hist=runner.global_hist,
            full_participation=runner.k_selected >= runner.n_clients,
            eps_estimates=runner.eps_estimates, runner=runner,
            # a decodable codec name and a scalar size only exist for static
            # runs; adaptive rounds carry the per-client truth instead
            codec=(None if assignment else runner.comm.codec.name),
            upload_nbytes=(None if assignment else runner.comm.upload_bytes),
            codecs=codecs_used, upload_bytes=nbytes_used,
            distortions=distortions,
            packed=(packed if self.streaming else None), telemetry=tel)
        with tel.timer("phase.aggregate"):
            new_global = strategy.aggregate(ctx)
            block_until_ready(tel, new_global)
        runner.global_params = new_global
        return self._round_duration(selected, connected, events)


class AsyncRoundLoop(RoundLoop):
    """Staleness-buffered server over the scenario engine's arrival times.

    Per round: every selected client with an up link and a physically
    landing upload runs its local update from the current global model.
    On-deadline uploads land this round; late ones are pushed into the
    ``StalenessBuffer`` with their absolute landing instant (round start +
    ``finish_s``) — unless even ``tau_max`` extra rounds of server waiting
    (``(tau_max+1) * deadline_s``) could not cover their upload, in which
    case they are dropped up front (``n_unreachable``).  At the round's end
    the buffer releases everything that landed within the round's window,
    staleness-tagged, and the strategy aggregates.

    A held upload keeps its round's global by reference (``origin_global``
    or its decoded model): nothing may update such a tree in place.
    """

    def __init__(self, runner, strategy, tracer=None, log=None,
                 buffered: bool = False):
        super().__init__(runner, strategy, tracer=tracer, log=log)
        self.buffer = StalenessBuffer(runner.cfg.tau_max)
        self.buffer.telemetry = self.obs
        self.buffered = buffered
        self.n_unreachable = 0
        self.staleness_applied: List[int] = []
        # Global-model version: bumped per aggregation step, not per round.
        # Staleness is version lag, so a buffered server's deferred rounds
        # (global unchanged) don't penalize updates still computed from the
        # current model.  Eviction stays round-based.
        self.version = 0

    def run_round(self, r: int) -> float:
        runner, strategy, cfg = self.runner, self.strategy, self.runner.cfg
        selected = self._select()
        t_global, assignment, dl_bytes = self._begin_round(r, selected)
        with self.obs.timer("phase.network_draw"):
            up, met_deadline, events = runner._draw_network(r)
        if events is None:
            raise RuntimeError(
                "async server modes need per-client arrival timelines; the "
                "runner should have wrapped this failure model in "
                "TimedFailureAdapter")
        fresh_connected = selected & up & met_deadline
        self._observe(r, events, selected)

        mu = strategy.prox_mu()
        t_start = self.clock_s
        horizon_s = cfg.deadline_s * (cfg.tau_max + 1)
        distortions: Dict[int, float] = {}
        tel = self.obs
        pushed: Dict[int, PendingUpdate] = {}   # this round's buffer pushes
        finish_s = events.finish_array()
        rung_names = assignment.codecs if assignment else None
        for cohort in self._cohorts(np.where(selected & up)[0]):
            for i in cohort:
                fin = float(finish_s[int(i)])
                if not math.isfinite(fin):
                    continue                   # never lands at all
                late = not met_deadline[int(i)]
                if late and (cfg.tau_max == 0 or fin > horizon_s):
                    # even tau_max full-deadline rounds cannot stretch to
                    # this landing time: don't waste the local compute
                    self.n_unreachable += 1
                    continue
                corr = strategy.correction(int(i), runner)
                m = runner.run_local(t_global, runner.client_x[i],
                                     runner.client_y[i], r, mu=mu, corr=corr)
                m = strategy.post_local(int(i), r, m, t_global, runner)
                # The buffer holds the upload exactly as the server will see
                # it, tagged with the rung, bytes and distortion measured now,
                # at encode time, not at landing.
                cname_over = rung_names[int(i)] if rung_names else None
                if self.streaming:
                    pu = self._uplink_packed(int(i), m, t_global, r,
                                             codec_name=cname_over)
                    distortions[int(i)] = pu.distortion
                    # decode(payload) IS the origin-relative delta, so
                    # delta-based strategies (FedBuff) need no snapshot
                    upd = PendingUpdate(
                        client=int(i), origin_round=r,
                        arrival_s=t_start + fin, model=None, delta=None,
                        origin_version=self.version, codec=pu.codec,
                        upload_nbytes=pu.nbytes, distortion=pu.distortion,
                        packed=pu)
                else:
                    m, cname, nbytes, dist = self._uplink(
                        int(i), m, t_global, codec_name=cname_over)
                    distortions[int(i)] = dist
                    # only delta-based strategies (FedBuff) need the
                    # dispatch-time snapshot
                    delta = (delta_pytree(m, t_global)
                             if getattr(strategy, "wants_delta", False)
                             else None)
                    upd = PendingUpdate(
                        client=int(i), origin_round=r,
                        arrival_s=t_start + fin, model=m, delta=delta,
                        origin_version=self.version, codec=cname,
                        upload_nbytes=nbytes, distortion=dist)
                self.buffer.push(upd)
                if tel:
                    pushed[int(i)] = upd
        self.distortion_history.append(dict(distortions))
        self._trace_round(r, selected, fresh_connected, events, up,
                          met_deadline, assignment, dl_bytes,
                          distortions=distortions)

        duration = self._round_duration(selected, fresh_connected, events)
        if not math.isfinite(duration):
            raise RuntimeError(
                f"round {r}: infinite server wait — the failure model has no "
                "timing data (e.g. a trace recorded from a legacy boolean "
                "mode); async server modes need real arrival timelines")
        now = t_start + duration
        if self.buffered and self.buffer.ready_count(now, r) < cfg.buffer_k:
            # semi-async server: not enough landed updates to justify a step;
            # advance the clock, age the buffer, keep the global model
            self.buffer.evict(r)
            self.participants_per_round.append(0)
            if tel:
                self._emit_async_outcomes(r, selected, up, events, pushed, {})
            return duration

        arrivals = [Arrival(client=p.client, origin_round=p.origin_round,
                            staleness=self.version - p.origin_version,
                            arrival_s=p.arrival_s,
                            model=p.model, delta=p.delta, codec=p.codec,
                            upload_nbytes=p.upload_nbytes,
                            distortion=p.distortion, packed=p.packed)
                    for p in self.buffer.collect(now, r)]
        self.staleness_applied.extend(a.staleness for a in arrivals)
        self.participants_per_round.append(len(arrivals))
        if not self.streaming:
            self._materialize_gauges(r, len(arrivals))
        if tel:
            self._emit_async_outcomes(
                r, selected, up, events, pushed,
                {(a.client, a.origin_round): a for a in arrivals})
        server_model = runner.run_local(t_global, runner.public_x,
                                        runner.public_y, r)
        with tel.timer("phase.aggregate"):
            new_global = self._aggregate(r, now, t_global, server_model,
                                         selected, arrivals)
            block_until_ready(tel, new_global)
        runner.global_params = new_global
        self.version += 1
        return duration

    def _emit_async_outcomes(self, r, selected, up, events, pushed,
                             collected) -> None:
        """One terminal outcome per (round, client), async semantics
        (``repro/fl/server/loops.py:609-658``): this round's buffer pushes
        are ``aggregated`` when collected within the same round, else
        provisionally ``buffered`` (upgraded later by a resolution event);
        selected-and-up clients that never pushed either never land at all
        (``missed_deadline``/never_lands) or could not land inside the
        staleness horizon (``evicted``/unreachable).  Past rounds' collected
        arrivals and the buffer's horizon evictions are forwarded as
        resolution events against their origin round."""
        tel = self.obs
        tel.gauge(r, "selected", float(selected.sum()))
        if self.skipped.any():
            tel.gauge(r, "skipped_stragglers", float(self.skipped.sum()))
        for a in collected.values():
            if a.origin_round != r:
                tel.resolve(a.origin_round, a.client, AGGREGATED,
                            staleness=int(a.staleness), applied_round=r)
        for client, origin in self.buffer.evictions:
            tel.resolve(origin, client, EVICTED, applied_round=r)
        self.buffer.evictions.clear()
        causes = events.cause_list()
        finish = events.finish_array()
        for i in range(self.runner.n_clients):
            if not selected[i]:
                tel.client_outcome(
                    r, i, SKIPPED_STRAGGLER if self.skipped[i]
                    else NOT_SELECTED)
            elif not up[i]:
                tel.client_outcome(r, i, LINK_DOWN, detail=causes[i])
            elif i in pushed:
                upd = pushed[i]
                a = collected.get((i, r))
                if a is not None:
                    tel.client_outcome(r, i, AGGREGATED,
                                       staleness=int(a.staleness),
                                       rung=upd.codec,
                                       upload_bytes=upd.upload_nbytes,
                                       distortion=upd.distortion)
                else:
                    tel.client_outcome(r, i, BUFFERED, rung=upd.codec,
                                       upload_bytes=upd.upload_nbytes,
                                       distortion=upd.distortion)
            else:
                if not math.isfinite(finish[i]):
                    tel.client_outcome(r, i, MISSED_DEADLINE,
                                       detail="never_lands")
                else:
                    tel.client_outcome(r, i, EVICTED, detail="unreachable")

    @staticmethod
    def _freshest(arrivals) -> Dict[int, Arrival]:
        """Freshest landed update per client (highest origin round)."""
        freshest: Dict[int, Arrival] = {}
        for a in arrivals:
            cur = freshest.get(a.client)
            if cur is None or a.origin_round > cur.origin_round:
                freshest[a.client] = a
        return freshest

    @staticmethod
    def _wire_metadata(freshest: Dict[int, Arrival]):
        """The per-client wire-metadata dicts a round context carries,
        keyed off the freshest arrival per client."""
        codecs = {c: a.codec for c, a in freshest.items()
                  if a.codec is not None}
        upload_bytes = {c: a.upload_nbytes for c, a in freshest.items()
                        if a.upload_nbytes is not None}
        distortions = {c: float(a.distortion) for c, a in freshest.items()}
        return codecs, upload_bytes, distortions

    def _aggregate(self, r, now, t_global, server_model, selected, arrivals):
        runner, strategy = self.runner, self.strategy
        # a decodable scalar codec/size only exists for static runs
        adaptive = runner.controller is not None
        static_codec = None if adaptive else runner.comm.codec.name
        static_nbytes = None if adaptive else runner.comm.upload_bytes
        freshest = self._freshest(arrivals)
        codecs, upload_bytes, distortions = self._wire_metadata(freshest)
        if isinstance(strategy, AsyncStrategy):
            ctx = AsyncRoundContext(
                rnd=r, now_s=now, global_params=t_global,
                server_model=server_model, arrivals=arrivals, p=runner.p,
                client_hists=runner.client_hists,
                server_hist=runner.server_hist,
                global_hist=runner.global_hist, runner=runner,
                codec=static_codec, upload_nbytes=static_nbytes,
                codecs=codecs, upload_bytes=upload_bytes,
                distortions=distortions, telemetry=self.obs)
            return strategy.aggregate_async(ctx)
        # Synchronous strategy under the async server: present the freshest
        # landed update per client as this round's cohort (staleness is
        # invisible to it — the documented degradation).
        connected = np.zeros(runner.n_clients, dtype=bool)
        for c in freshest:
            connected[c] = True
        streaming = self.streaming and all(a.packed is not None
                                           for a in freshest.values())
        ctx = RoundContext(
            rnd=r, global_params=t_global, server_model=server_model,
            client_models=({} if streaming else
                           {c: a.model for c, a in freshest.items()}),
            selected=selected, connected=connected, p=runner.p,
            client_hists=runner.client_hists, server_hist=runner.server_hist,
            global_hist=runner.global_hist,
            full_participation=runner.k_selected >= runner.n_clients,
            eps_estimates=runner.eps_estimates, runner=runner,
            codec=static_codec, upload_nbytes=static_nbytes,
            codecs=codecs, upload_bytes=upload_bytes,
            distortions=distortions,
            packed=({c: a.packed for c, a in freshest.items()}
                    if streaming else None),
            telemetry=self.obs)
        return strategy.aggregate(ctx)


SERVER_MODES = ("sync", "async", "buffered")


def make_round_loop(mode: str, runner, strategy: Strategy, tracer=None,
                    log=None) -> RoundLoop:
    if mode == "sync":
        return SyncRoundLoop(runner, strategy, tracer=tracer, log=log)
    if mode == "async":
        return AsyncRoundLoop(runner, strategy, tracer=tracer, log=log)
    if mode == "buffered":
        return AsyncRoundLoop(runner, strategy, tracer=tracer, log=log,
                              buffered=True)
    raise ValueError(f"unknown server_mode {mode!r} "
                     f"(known: {', '.join(SERVER_MODES)})")
