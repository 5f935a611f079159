"""Server round loops, ported from ``repro/fl/server/loops.py``.

``SyncRoundLoop`` ("sync") is Algorithm 1:
``connected = selected & up & met_deadline``, stragglers discarded.  The
JAX package's ``AsyncRoundLoop`` ("async", "buffered") is not ported yet.

Every loop advances a simulated wall clock per round and records
``TimePoint(rnd, t_s, acc)`` into ``runner.timeline`` at each evaluation.
The loop never synchronizes the device: callers that time a round call
``torch.cuda.synchronize()`` themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from repro_torch.core.strategies import RoundContext, Strategy
from repro_torch.fl.comm.stream import PackedUpdate


@dataclasses.dataclass
class TimePoint:
    """One evaluation, indexed by both round and simulated wall clock."""
    rnd: int
    t_s: float                   # simulated seconds since training start
    acc: float


class RoundLoop:
    """Skeleton shared by all server modes."""

    def __init__(self, runner, strategy: Strategy, log=None):
        self.runner = runner
        self.strategy = strategy
        self.log = log
        self.clock_s = 0.0
        self.participants_per_round: List[int] = []
        # per-round {client: normalized compression distortion}
        self.distortion_history: List[Dict[int, float]] = []
        # Streaming aggregation: a streaming-capable strategy receives the
        # round's uploads as wire PackedUpdates (fl/comm/stream.py) instead
        # of a dict of decoded model trees; ``streaming_agg="off"`` forces
        # the materializing path.
        self.streaming = (bool(getattr(strategy, "streaming", False)) and
                          getattr(runner.cfg, "streaming_agg", "auto") != "off")

    def _uplink(self, client: int, model, t_global):
        """Encode client-side, decode server-side.  Returns
        ``(reconstructed_model, codec_name, wire_bytes, distortion)``."""
        comm = self.runner.comm
        recon, _payload, distortion = comm.roundtrip(client, model, t_global)
        return recon, comm.codec.name, comm.nbytes_for(comm.codec), float(distortion)

    def _uplink_packed(self, client: int, model, t_global, r: int):
        """Streaming sibling of ``_uplink``: encode client-side only and
        hand back the wire ``PackedUpdate``."""
        comm = self.runner.comm
        payload, distortion = comm.encode_upload(client, model, t_global)
        return PackedUpdate(client=client, payload=payload,
                            origin_global=t_global, codec=comm.codec.name,
                            nbytes=comm.nbytes_for(comm.codec),
                            distortion=float(distortion), origin_round=r)

    def _begin_round(self):
        """Round preamble: price this round's broadcast
        (``next_broadcast_nbytes``: the ``ref_bytes`` enrollment on a
        downlink codec's first round, the compressed rate after), restate
        both directions to the failure model when a downlink codec is set,
        and broadcast.  Returns the params clients start from (the decoded
        replica under a downlink codec)."""
        runner = self.runner
        dl_bytes = runner.comm.next_broadcast_nbytes()
        if runner.comm.downlink_codec is not None:
            runner.failures.set_payload_bytes(
                upload_bytes=np.full(runner.n_clients, runner.comm.upload_bytes),
                download_bytes=np.full(runner.n_clients, dl_bytes))
        return runner.comm.broadcast(runner.global_params)[0]

    def _select(self) -> np.ndarray:
        """Uniform K-of-N selection from ``runner.rng``."""
        runner = self.runner
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

    def _round_duration(self, selected, connected) -> float:
        """Simulated seconds the server spent on this round: the legacy
        failure models have no time dimension, so the server waits out its
        timeout whenever a selected client is missing, else a nominal
        compute+transmit round."""
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
            if self.log:
                self.log(r, acc)

    def run(self, rounds: int) -> List[float]:
        history: List[float] = []
        for r in range(1, rounds + 1):
            self.clock_s += self.run_round(r)
            self._maybe_eval(r, rounds, history)
        return history

    def run_round(self, r: int) -> float:
        raise NotImplementedError


class SyncRoundLoop(RoundLoop):
    """Algorithm 1 verbatim: deadline stragglers are discarded."""

    def run_round(self, r: int) -> float:
        runner, strategy = self.runner, self.strategy
        selected = self._select()
        t_global = self._begin_round()
        up, met_deadline, _events = runner._draw_network(r)
        connected = selected & up & met_deadline
        self.participants_per_round.append(int(connected.sum()))

        client_models: Dict[int, Any] = {}
        packed: Dict[int, Any] = {}             # streaming: wire PackedUpdates
        codecs_used: Dict[int, str] = {}
        nbytes_used: Dict[int, float] = {}
        distortions: Dict[int, float] = {}
        mu = strategy.prox_mu()
        for cohort in self._cohorts(np.where(connected)[0]):
            for i in cohort:
                corr = strategy.correction(i, runner)
                m = runner.run_local(t_global, runner.client_x[i],
                                     runner.client_y[i], r, mu=mu, corr=corr)
                m = strategy.post_local(i, r, m, t_global, runner)
                if self.streaming:
                    pu = self._uplink_packed(int(i), m, t_global, r)
                    packed[int(i)] = pu
                    cname, nbytes, dist = pu.codec, pu.nbytes, pu.distortion
                else:
                    recon, cname, nbytes, dist = self._uplink(int(i), m, t_global)
                    client_models[int(i)] = recon
                codecs_used[int(i)] = cname
                nbytes_used[int(i)] = nbytes
                distortions[int(i)] = dist
        self.distortion_history.append(dict(distortions))
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
            codec=runner.comm.codec.name,
            upload_nbytes=runner.comm.upload_bytes,
            codecs=codecs_used, upload_bytes=nbytes_used,
            distortions=distortions,
            packed=(packed if self.streaming else None))
        runner.global_params = strategy.aggregate(ctx)
        return self._round_duration(selected, connected)


SERVER_MODES = ("sync",)


def make_round_loop(mode: str, runner, strategy: Strategy, log=None) -> RoundLoop:
    if mode == "sync":
        return SyncRoundLoop(runner, strategy, log=log)
    if mode in ("async", "buffered"):
        raise NotImplementedError(f"server_mode {mode!r} is not ported yet")
    raise ValueError(f"unknown server_mode {mode!r} "
                     f"(known: {', '.join(SERVER_MODES)})")
