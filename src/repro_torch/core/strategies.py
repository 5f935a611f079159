"""Aggregation strategies, ported from ``repro/core/strategies.py``:
FedAvg (footnote-2 heuristic weights), FedAuto (Alg. 2: Eq. 6–9) and
FedEx-LoRA (Eq. 52–53, LoRA runs only).  The JAX package's other
strategies are not ported yet.

Participant indexing convention: row 0 = server, rows 1..N = clients.
``RoundContext.connected[i]`` is True iff client i was selected AND its
upload survived the failure draw (1_i^r = 1) — the per-round view of Prop. 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.aggregation import (aggregate_pytrees,
                                          fedauto_discounted_weights,
                                          missing_classes)
from repro_torch.core.weights_qp import heuristic_weights
from repro_torch.fl.comm.stream import weighted_model_sum
from repro_torch.obs.telemetry import NULL_TELEMETRY, beta_row
from repro_torch.tree import tree_map


@dataclasses.dataclass
class RoundContext:
    rnd: int
    global_params: Any
    server_model: Any                     # w_s^{r,E}
    client_models: Dict[int, Any]         # client id -> w_i^{r,E} (connected only)
    selected: np.ndarray                  # (N,) bool
    connected: np.ndarray                 # (N,) bool (selected & survived)
    p: np.ndarray                         # (N+1,) dataset-size weights, [0]=server
    client_hists: np.ndarray              # (N, C) label histograms
    server_hist: np.ndarray               # (C,)
    global_hist: np.ndarray               # (C,)
    full_participation: bool
    eps_estimates: Optional[np.ndarray] = None
    runner: Any = None                    # back-reference (compensatory training)
    codec: Optional[str] = None           # wire codec shared by all uploads
    upload_nbytes: Optional[float] = None  # bytes-on-wire per client upload
    # per-client wire metadata of this round's uploads, keyed by client id
    codecs: Optional[Dict[int, str]] = None
    upload_bytes: Optional[Dict[int, float]] = None
    distortions: Optional[Dict[int, float]] = None
    telemetry: Any = None                 # None/falsy = not recording
    # streaming server path: client id -> stream.PackedUpdate; set (and
    # client_models left empty) when the loop runs a streaming strategy
    packed: Optional[Dict[int, Any]] = None


def _record_betas(ctx, rows) -> None:
    """Forward the weights a strategy actually applied to the telemetry
    hub; a no-op when telemetry is off."""
    tel = getattr(ctx, "telemetry", None)
    if tel:
        tel.betas(ctx.rnd, rows)


def _phase(ctx, name: str):
    tel = getattr(ctx, "telemetry", None)
    return (tel or NULL_TELEMETRY).timer(name)


def _accumulate(ctx, models, betas):
    """``aggregate_pytrees`` under the ``phase.accumulate`` timer."""
    with _phase(ctx, "phase.accumulate"):
        return aggregate_pytrees(models, betas)


def _stream_accumulate(ctx, dense, packed):
    """Streaming counterpart of ``_accumulate``: the β-weighted model sum
    ``Σ w_t·tree_t + Σ β_j·(origin_global_j + decode(payload_j))`` through
    ``fl.comm.stream.weighted_model_sum``; leaves come back cast to the
    global dtype, exactly like ``aggregate_pytrees``."""
    with _phase(ctx, "phase.accumulate"):
        out = weighted_model_sum(packed, dense, template=ctx.global_params)
        return tree_map(lambda g, v: v.to(g.dtype), ctx.global_params, out)


class Strategy:
    name = "base"
    # Streaming-capable strategies consume ctx.packed (wire payloads through
    # a StreamAccumulator) instead of ctx.client_models.
    streaming = False

    def init_state(self, runner) -> None:
        pass

    # hooks used by the runner's local update ------------------------------
    def prox_mu(self) -> float:
        return 0.0

    def correction(self, client_id: int, runner):
        return None

    def post_local(self, client_id: int, rnd: int, local_model, ctx_global,
                   runner):
        return local_model

    # aggregation -----------------------------------------------------------
    def aggregate(self, ctx: RoundContext):
        raise NotImplementedError

    def _mask(self, ctx: RoundContext) -> np.ndarray:
        """(N+1,) active mask with the server at row 0."""
        return np.concatenate([[True], ctx.connected])


class FedAvg(Strategy):
    """Footnote-2 heuristic weights under failures; Remark-1 weights when
    the network is ideal."""
    name = "fedavg"
    streaming = True

    def aggregate(self, ctx: RoundContext):
        with _phase(ctx, "phase.weight_solve"):
            beta = heuristic_weights(
                ctx.p, self._mask(ctx), server_idx=0,
                full_participation=ctx.full_participation)
        ids = [i for i in range(len(ctx.connected)) if ctx.connected[i]]
        if getattr(ctx, "telemetry", None):
            codecs = ctx.codecs or {}
            dists = ctx.distortions or {}
            _record_betas(ctx, [beta_row(beta[0], role="server")] + [
                beta_row(beta[i + 1], client=i, rung=codecs.get(i),
                         distortion=dists.get(i)) for i in ids])
        if getattr(ctx, "packed", None) is not None:
            return _stream_accumulate(
                ctx, dense=[(beta[0], ctx.server_model)],
                packed=[(beta[i + 1], ctx.packed[i]) for i in ids])
        models = [ctx.server_model] + [ctx.client_models[i] for i in ids]
        weights = [beta[0]] + [beta[i + 1] for i in ids]
        return _accumulate(ctx, models, np.array(weights))


class FedExLoRA(Strategy):
    """Exact-aggregation residual for LoRA FFT (Eq. 52–53).  Requires the
    runner to be in LoRA mode; aggregates adapters by plain averaging and
    folds the rank-mixing residual into the frozen base weights."""
    name = "fedex_lora"

    def aggregate(self, ctx: RoundContext):
        runner = ctx.runner
        ids = [i for i in range(len(ctx.connected)) if ctx.connected[i]]
        if not ids:
            return ctx.global_params
        adapters = [ctx.client_models[i] for i in ids]
        n = len(ids)
        if getattr(ctx, "telemetry", None):
            codecs = ctx.codecs or {}
            dists = ctx.distortions or {}
            _record_betas(ctx, [
                beta_row(1.0 / n, client=i, rung=codecs.get(i),
                         distortion=dists.get(i)) for i in ids])
        avg = _accumulate(ctx, adapters, np.full(n, 1.0 / n))
        # residual per adapted layer: mean(A_i B_i) − Ā B̄
        scaling = runner.lora_cfg.scaling
        for path in avg:
            mean_prod = sum(a[path]["a"] @ a[path]["b"] for a in adapters) / n
            resid = (mean_prod - avg[path]["a"] @ avg[path]["b"]) * scaling
            runner.fold_into_base(path, resid)
        return avg


def _resolve_fidelity_discount(explicit: Optional[float], ctx) -> float:
    """Strategy knob wins; else ``FFTConfig.fidelity_discount_b``; else 0."""
    if explicit is not None:
        return float(explicit)
    cfg = getattr(getattr(ctx, "runner", None), "cfg", None)
    if cfg is None:
        return 0.0
    return float(getattr(cfg, "fidelity_discount_b", 0.0))


class FedAuto(Strategy):
    """The paper's method (Algorithm 2): Module 1 compensatory training
    (Eq. 6–7) + Module 2 weight optimization (Eq. 8) with the server pin
    (Eq. 9).  ``fidelity_discount`` (exponent b; None defers to
    ``FFTConfig.fidelity_discount_b``) discounts each upload's post-QP β by
    ``(1 − d)^b``, d its measured compression distortion.  (The JAX
    package's Table-5 ablation switches are not ported yet.)"""
    name = "fedauto"
    streaming = True

    def __init__(self, fidelity_discount: Optional[float] = None):
        self.fidelity_discount = fidelity_discount

    def aggregate(self, ctx: RoundContext):
        runner = ctx.runner
        N, _ = ctx.client_hists.shape
        miss = missing_classes(ctx.client_hists, ctx.connected)
        comp_model, comp_hist = None, None
        if miss.any():
            comp_model, comp_hist = runner.train_compensatory(miss, ctx.rnd)

        def dist(h):
            tot = h.sum()
            return h / tot if tot > 0 else np.full_like(h, 1.0 / len(h), dtype=float)

        rows = [dist(ctx.server_hist.astype(float))]
        models = [ctx.server_model]
        distortion = [0.0]                    # server row: no wire, no loss
        if comp_model is not None:
            rows.append(dist(comp_hist.astype(float)))
            models.append(comp_model)
            distortion.append(0.0)
        ids = [i for i in range(N) if ctx.connected[i]]
        dmap = ctx.distortions or {}
        packed_map = getattr(ctx, "packed", None)
        for i in ids:
            rows.append(dist(ctx.client_hists[i].astype(float)))
            if packed_map is None:
                models.append(ctx.client_models[i])
            distortion.append(float(dmap.get(i, 0.0)))
        alpha_rows = np.stack(rows)
        alpha_g = dist(ctx.global_hist.astype(float))
        with _phase(ctx, "phase.weight_solve"):
            beta = fedauto_discounted_weights(
                alpha_rows, alpha_g, np.zeros(len(rows)),
                np.asarray(distortion), server_row=0,
                discount_b=_resolve_fidelity_discount(
                    self.fidelity_discount, ctx),
                device=runner.device)
        if getattr(ctx, "telemetry", None):
            out = [beta_row(beta[0], role="server")]
            k = 1
            if comp_model is not None:
                out.append(beta_row(beta[1], role="comp"))
                k = 2
            codecs = ctx.codecs or {}
            for j, i in enumerate(ids):
                out.append(beta_row(beta[k + j], client=i, staleness=0,
                                    rung=codecs.get(i),
                                    distortion=float(dmap.get(i, 0.0))))
            _record_betas(ctx, out)
        if packed_map is not None:
            n_dense = len(models)            # server (+ compensatory)
            return _stream_accumulate(
                ctx, dense=list(zip(beta[:n_dense], models)),
                packed=[(beta[n_dense + j], packed_map[i])
                        for j, i in enumerate(ids)])
        return _accumulate(ctx, models, beta)


STRATEGIES = {
    "fedavg": FedAvg,
    "fedex_lora": FedExLoRA,
    "fedauto": FedAuto,
}
