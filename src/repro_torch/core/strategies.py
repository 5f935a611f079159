"""Aggregation strategies, ported from ``repro/core/strategies.py``: the
synchronous ones of the paper (§V-A5, Appendix III-E), FedAvg (footnote-2
heuristic weights), FedProx (43), SCAFFOLD (44–45), FedLAW (46–47),
TF-Aggregation (48–50), FedAWE (51), FedEx-LoRA (52–53, LoRA runs only),
FedAuto (Alg. 2: Eq. 6–9) with its two Table-5 ablations (App. III-F),
centralized training on the public data, and the asynchronous family the
async server loop drives (FedAsync, FedBuff, FedAuto-Async; each also runs
under the synchronous loop through ``AsyncStrategy.aggregate``).

FedAvg, FedProx, FedAWE, FedAuto, FedAsync, FedBuff and FedAuto-Async
stream the uploads through ``fl.comm.stream`` (``float_fedagg``/
``dequant_fedagg`` on the card); the others, and every strategy under
``streaming_agg="off"``, reduce materialized trees through
``aggregate_pytrees`` (``fedagg``), except FedAsync's materializing mix,
which is the JAX package's leaf-wise blend, and CentralizedPublic, which
reduces nothing.

Participant indexing convention: row 0 = server, rows 1..N = clients.
``RoundContext.connected[i]`` is True iff client i was selected AND its
upload survived the failure draw (1_i^r = 1) — the per-round view of Prop. 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import (aggregate_pytrees, delta_pytree,
                                          fedauto_discounted_weights,
                                          fedauto_simple_average_weights,
                                          missing_classes)
from repro_torch.core.weights_qp import heuristic_weights
from repro_torch.fl.comm.stream import (StreamAccumulator,
                                        weighted_model_sum)
from repro_torch.obs.sync import block_until_ready
from repro_torch.obs.telemetry import NULL_TELEMETRY, beta_row
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


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
    eps_estimates: Optional[np.ndarray] = None   # TF-Aggregation inputs
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
    """A ``phase.*`` profiler timer on the round's telemetry hub: the shared
    no-op context manager when the run is uninstrumented.  Strategies split
    their aggregation between the weight solve (``phase.weight_solve``) and
    the tree accumulate (``phase.accumulate``); both nest inside the loop's
    ``phase.aggregate``."""
    tel = getattr(ctx, "telemetry", None)
    return (tel or NULL_TELEMETRY).timer(name)


def _accumulate(ctx, models, betas):
    """``aggregate_pytrees`` under the ``phase.accumulate`` timer, synced
    when telemetry is live so the timer sees device time, not dispatch
    (``repro/core/strategies.py:84-91``)."""
    with _phase(ctx, "phase.accumulate"):
        out = aggregate_pytrees(models, betas)
        block_until_ready(getattr(ctx, "telemetry", None), out)
    return out


def _stream_accumulate(ctx, dense, packed):
    """Streaming counterpart of ``_accumulate``: the β-weighted model sum
    ``Σ w_t·tree_t + Σ β_j·(origin_global_j + decode(payload_j))`` through
    ``fl.comm.stream.weighted_model_sum``; leaves come back cast to the
    global dtype, exactly like ``aggregate_pytrees``
    (``repro/core/strategies.py:94-112``)."""
    tel = getattr(ctx, "telemetry", None)
    with _phase(ctx, "phase.accumulate"):
        out = weighted_model_sum(packed, dense, template=ctx.global_params,
                                 telemetry=tel or NULL_TELEMETRY, rnd=ctx.rnd)
        out = tree_map(lambda g, v: v.to(g.dtype), ctx.global_params, out)
        block_until_ready(tel, out)
    return out


def _stream_delta_sum(ctx, dense, packed):
    """Like ``_stream_accumulate`` but over *deltas*: ``Σ w_t·tree_t +
    Σ β_j·decode(payload_j)`` with fp32 leaves and no origin-global terms —
    a payload's decode IS its origin-relative delta (what FedBuff holds;
    ``repro/core/strategies.py:115-135``)."""
    tel = getattr(ctx, "telemetry", None)
    with _phase(ctx, "phase.accumulate"):
        acc = StreamAccumulator(ctx.global_params,
                                telemetry=tel or NULL_TELEMETRY)
        for w, pu in packed:
            acc.add(pu.payload, w)
        for w, tree in dense:
            acc.add_tree(tree, w)
        out = acc.total()
        if tel:
            tel.gauge(ctx.rnd, "uplink_fused_payloads", acc.n_fused)
            tel.gauge(ctx.rnd, "uplink_fallback_payloads", acc.n_fallback)
            tel.gauge(ctx.rnd, "uplink_peak_decoded_bytes",
                      acc.peak_decoded_bytes)
            block_until_ready(tel, out)
    return out


class Strategy:
    name = "base"
    # Streaming-capable strategies consume ctx.packed (wire payloads through
    # a StreamAccumulator) instead of ctx.client_models.  Strategies that
    # need per-client models — SCAFFOLD's control variates, FedLAW's proxy
    # optimization over the stacked cohort, TF-Aggregation's per-model
    # weights, FedEx-LoRA's adapter products — keep streaming=False, and
    # the loop materializes for them.
    streaming = False

    def init_state(self, runner) -> None:
        pass

    # hooks used by the runner's local update ------------------------------
    def prox_mu(self) -> float:
        return 0.0

    def correction(self, client_id: int, runner):
        return None                       # SCAFFOLD overrides

    def post_local(self, client_id: int, rnd: int, local_model, ctx_global,
                   runner):
        return local_model                # SCAFFOLD, FedAWE override

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


class FedProx(FedAvg):
    """FedAvg + proximal term μ/2·‖w − w̄‖² in the local objective (Eq. 43)."""
    name = "fedprox"

    def __init__(self, mu: float = 0.01):
        self.mu = mu

    def prox_mu(self) -> float:
        return self.mu


def _f32(t):
    return t.to(torch.float32)


class Scaffold(Strategy):
    """Control variates (Eq. 44–45); client-only aggregation with γ_g = 1.
    Every update builds new tensors: all clients start from one shared
    zeros tree, as in JAX."""
    name = "scaffold"

    def __init__(self, global_lr: float = 1.0):
        self.global_lr = global_lr

    def init_state(self, runner) -> None:
        zeros = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                         runner.trainable(runner.global_params))
        self.c = zeros
        self.c_i = {i: zeros for i in range(runner.n_clients)}
        self._pending: Dict[int, Any] = {}

    def correction(self, client_id: int, runner):
        # gradient correction: −c_i + c
        return tree_map(lambda c, ci: c - ci, self.c, self.c_i[client_id])

    def post_local(self, client_id: int, rnd: int, local_model, ctx_global,
                   runner):
        # c_i^+ = c_i − c + (w̄ − w_i)/(K γ_l E)   (Eq. 44b)
        coef = 1.0 / (runner.k_selected * runner.lr(rnd) * runner.local_steps)
        self._pending[client_id] = tree_map(
            lambda ci, c, g, w: ci - c + coef * (_f32(g) - _f32(w)),
            self.c_i[client_id], self.c, ctx_global, local_model)
        return local_model

    def aggregate(self, ctx: RoundContext):
        ids = [i for i in range(len(ctx.connected)) if ctx.connected[i]]
        n_conn = max(len(ids), 1)
        if getattr(ctx, "telemetry", None):
            codecs = ctx.codecs or {}
            dists = ctx.distortions or {}
            # each connected delta enters the global step at global_lr/n
            _record_betas(ctx, [
                beta_row(self.global_lr / n_conn, client=i,
                         rung=codecs.get(i), distortion=dists.get(i))
                for i in ids])
        if ids:
            deltas = [tree_map(lambda w, g: _f32(w) - _f32(g),
                               ctx.client_models[i], ctx.global_params)
                      for i in ids]
            mean_delta = _accumulate(ctx, deltas,
                                     np.full(len(ids), 1.0 / n_conn))
            new_global = tree_map(
                lambda g, d: (_f32(g) + self.global_lr * d).to(g.dtype),
                ctx.global_params, mean_delta)
        else:
            new_global = ctx.global_params
        # c update (Eq. 45b) over clients that actually delivered
        N = len(ctx.connected)
        for i in ids:
            if i in self._pending:
                diff = tree_map(lambda new, old: new - old,
                                self._pending[i], self.c_i[i])
                self.c = tree_map(lambda c, d: c + d / N, self.c, diff)
                self.c_i[i] = self._pending[i]
        self._pending.clear()
        return new_global


class FedLAW(Strategy):
    """Server-side proxy-data optimization of shrinking factor ρ and
    client aggregation weights (Eq. 46–47).  The inner loop's merge is a
    plain product on the runner's device (it carries gradients to ρ and
    the logits); the final merge goes through ``aggregate_pytrees``."""
    name = "fedlaw"

    def __init__(self, opt_steps: int = 30, opt_lr: float = 0.05,
                 proxy_batch: int = 64):
        self.opt_steps = opt_steps
        self.opt_lr = opt_lr
        self.proxy_batch = proxy_batch

    def aggregate(self, ctx: RoundContext):
        ids = [i for i in range(len(ctx.connected)) if ctx.connected[i]]
        if not ids:
            return ctx.global_params
        models = [ctx.client_models[i] for i in ids]
        spec = tree_flatten(models[0])[1]
        # the cohort as (M, ...) constants: only ρ and the logits take grads
        stacked = [torch.stack(ls) for ls in
                   zip(*(tree_flatten(m)[0] for m in models))]
        runner = ctx.runner
        px, py = runner.public_proxy_batch(self.proxy_batch, ctx.rnd)
        dev = stacked[0].device

        def proxy_loss(rho_raw, logits):
            rho = F.softplus(rho_raw)
            beta = torch.softmax(logits, 0)
            merged = [torch.einsum("m...,m->...", _f32(s), beta).to(s.dtype)
                      for s in stacked]
            merged = [(rho * _f32(w)).to(w.dtype) for w in merged]
            return runner.loss_on(tree_unflatten(spec, merged), px, py)

        rho_raw = torch.tensor(0.5413, dtype=torch.float32, device=dev)  # softplus⁻¹(1)
        logits = torch.zeros(len(ids), dtype=torch.float32, device=dev)
        for _ in range(self.opt_steps):
            rho_raw.requires_grad_(True)
            logits.requires_grad_(True)
            g_rho, g_logits = torch.autograd.grad(proxy_loss(rho_raw, logits),
                                                  (rho_raw, logits))
            with torch.no_grad():
                rho_raw = rho_raw - self.opt_lr * g_rho
                logits = logits - self.opt_lr * g_logits
        rho = float(F.softplus(rho_raw))
        beta = torch.softmax(logits, 0).cpu().numpy()
        if getattr(ctx, "telemetry", None):
            codecs = ctx.codecs or {}
            dists = ctx.distortions or {}
            # the model each client contributes is scaled by rho·β_k
            _record_betas(ctx, [
                beta_row(rho * float(beta[k]), client=i, rung=codecs.get(i),
                         distortion=dists.get(i))
                for k, i in enumerate(ids)])
        merged = _accumulate(ctx, models, beta)
        return tree_map(lambda w: (rho * _f32(w)).to(w.dtype), merged)


class TFAggregation(Strategy):
    """Transient-failure-aware aggregation (Eq. 48–50), implemented literally
    — including its non-normalized weights, which is what destabilizes it in
    the paper's Tables 1–3."""
    name = "tf_aggregation"

    def __init__(self, eps_threshold: float = 0.9):
        self.eps_threshold = eps_threshold
        self.s: Optional[np.ndarray] = None

    def init_state(self, runner) -> None:
        # ``s`` is cached lazily from the first round's eps_estimates; a
        # reused strategy instance must not carry the previous run's (or the
        # previous world's) selection probabilities into the next run.
        self.s = None

    def selection_probs(self, ctx: RoundContext) -> np.ndarray:
        eps = np.clip(ctx.eps_estimates, 0.0, 0.999)
        p = ctx.p[1:]
        ok = eps <= self.eps_threshold
        s = np.where(ok, np.sqrt(p / np.maximum(1.0 - eps, 1e-6)), 0.0)
        tot = s.sum()
        return s / tot if tot > 0 else np.full_like(s, 1.0 / len(s))

    def aggregate(self, ctx: RoundContext):
        if self.s is None:
            self.s = self.selection_probs(ctx)
        eps = np.clip(ctx.eps_estimates, 0.0, 0.999)
        K = ctx.selected.sum()
        models, weights, ids = [], [], []
        for i in range(len(ctx.connected)):
            if ctx.connected[i] and self.s[i] > 0:
                w = ctx.p[i + 1] / (self.s[i] * (1.0 - eps[i])) / max(K, 1)
                models.append(ctx.client_models[i])
                weights.append(w)
                ids.append(i)
        if getattr(ctx, "telemetry", None):
            codecs = ctx.codecs or {}
            dists = ctx.distortions or {}
            _record_betas(ctx, [
                beta_row(w, client=i, rung=codecs.get(i),
                         distortion=dists.get(i))
                for w, i in zip(weights, ids)])
        if not models:
            return ctx.global_params
        return _accumulate(ctx, models, np.array(weights))


class FedAWE(Strategy):
    """Adaptive weighting via missed-round-scaled local extrapolation (Eq. 51)."""
    name = "fedawe"
    streaming = True              # aggregates via FedAvg; extrapolation is
    #                               client-side (post_local), before encode

    def __init__(self, gamma_g: float = 0.001):
        self.gamma_g = gamma_g

    def init_state(self, runner) -> None:
        self.tau = np.zeros(runner.n_clients, dtype=int)

    def post_local(self, client_id: int, rnd: int, local_model, ctx_global,
                   runner):
        gap = float(rnd - self.tau[client_id])
        return tree_map(
            lambda w, g: (_f32(w) - self.gamma_g * gap *
                          (_f32(g) - _f32(w))).to(w.dtype),
            local_model, ctx_global)

    def aggregate(self, ctx: RoundContext):
        for i in range(len(ctx.connected)):
            if ctx.connected[i]:
                self.tau[i] = ctx.rnd
        return FedAvg.aggregate(self, ctx)


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
    ``(1 − d)^b``, d its measured compression distortion.
    ``use_module1``/``use_module2`` are the Table-5 ablations: without
    Module 1 no compensatory model trains (and ``runner.rng`` skips its
    draw); without Module 2 the weights are Eq. 58's simple average."""
    name = "fedauto"
    streaming = True

    def __init__(self, use_module1: bool = True, use_module2: bool = True,
                 fidelity_discount: Optional[float] = None):
        self.use_module1 = use_module1
        self.use_module2 = use_module2
        self.fidelity_discount = fidelity_discount

    def aggregate(self, ctx: RoundContext):
        runner = ctx.runner
        N, _ = ctx.client_hists.shape
        miss = missing_classes(ctx.client_hists, ctx.connected)
        comp_model, comp_hist = None, None
        if self.use_module1 and miss.any():
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
        if self.use_module2:
            with _phase(ctx, "phase.weight_solve"):
                beta = fedauto_discounted_weights(
                    alpha_rows, alpha_g, np.zeros(len(rows)),
                    np.asarray(distortion), server_row=0,
                    discount_b=_resolve_fidelity_discount(
                        self.fidelity_discount, ctx),
                    device=runner.device)
        else:
            beta = fedauto_simple_average_weights(
                np.ones(len(rows), dtype=bool), 0, comp_model is not None)
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


# ---------------------------------------------------------------------------
# asynchronous strategy family (driven by fl.server.loops.AsyncRoundLoop)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Arrival:
    """One client upload as it lands at the asynchronous server."""
    client: int
    origin_round: int                     # round whose global seeded the update
    staleness: int                        # version lag (0 = fresh)
    arrival_s: float                      # absolute simulated landing time
    model: Any                            # w_i^{origin,E}
    delta: Any = None                     # w_i^{origin,E} − w̄^{origin}
    codec: Optional[str] = None           # rung this upload traveled under
    upload_nbytes: Optional[float] = None  # bytes this upload cost on-wire
    distortion: float = 0.0               # ‖carry−decoded‖/‖carry‖ at encode
    packed: Any = None                    # streaming mode: the wire
    #                                       PackedUpdate (model/delta None —
    #                                       decode(payload) IS the
    #                                       origin-relative delta)


@dataclasses.dataclass
class AsyncRoundContext:
    """What the async server knows when it aggregates at round ``rnd``."""
    rnd: int
    now_s: float                          # simulated clock at the round's end
    global_params: Any
    server_model: Any                     # w_s^{r,E} (always staleness 0)
    arrivals: list                        # List[Arrival], landing-time order
    p: np.ndarray
    client_hists: np.ndarray
    server_hist: np.ndarray
    global_hist: np.ndarray
    runner: Any = None
    codec: Optional[str] = None           # shared wire codec (None: adaptive)
    upload_nbytes: Optional[float] = None  # bytes per upload (None: adaptive)
    # per-client wire metadata of the aggregated arrivals, keyed by client id
    # (latest arrival per client; per-arrival values live on each Arrival)
    codecs: Optional[Dict[int, str]] = None
    upload_bytes: Optional[Dict[int, float]] = None
    distortions: Optional[Dict[int, float]] = None
    telemetry: Any = None                 # None/falsy = not recording


class AsyncStrategy(Strategy):
    """Aggregates a stream of (possibly stale) arrivals instead of a
    synchronized cohort.  Under ``server_mode="sync"`` the round's connected
    cohort is presented as staleness-0 arrivals, so async strategies remain
    runnable everywhere.  ``wants_delta`` tells the async loop to snapshot
    ``w_i − w̄^{origin}`` at dispatch time — a stale arrival's delta cannot
    be reconstructed later, once the global has moved on."""
    is_async = True
    wants_delta = False

    def aggregate_async(self, ctx: AsyncRoundContext):
        raise NotImplementedError

    def aggregate(self, ctx: RoundContext):
        codecs = ctx.codecs or {}
        nbytes = ctx.upload_bytes or {}
        dists = ctx.distortions or {}
        packed_map = getattr(ctx, "packed", None)
        if packed_map is not None:
            # streaming bridge: arrivals carry the wire payloads; no model
            # or dispatch-time delta is ever materialized
            arrivals = [Arrival(client=i, origin_round=ctx.rnd, staleness=0,
                                arrival_s=float(ctx.rnd), model=None,
                                packed=pu, codec=codecs.get(i),
                                upload_nbytes=nbytes.get(i),
                                distortion=float(dists.get(i, 0.0)))
                        for i, pu in sorted(packed_map.items())]
        else:
            arrivals = [Arrival(client=i, origin_round=ctx.rnd, staleness=0,
                                arrival_s=float(ctx.rnd), model=m,
                                delta=delta_pytree(m, ctx.global_params),
                                codec=codecs.get(i),
                                upload_nbytes=nbytes.get(i),
                                distortion=float(dists.get(i, 0.0)))
                        for i, m in sorted(ctx.client_models.items())]
        actx = AsyncRoundContext(
            rnd=ctx.rnd, now_s=float(ctx.rnd),
            global_params=ctx.global_params, server_model=ctx.server_model,
            arrivals=arrivals, p=ctx.p, client_hists=ctx.client_hists,
            server_hist=ctx.server_hist, global_hist=ctx.global_hist,
            runner=ctx.runner, codec=ctx.codec,
            upload_nbytes=ctx.upload_nbytes, codecs=ctx.codecs,
            upload_bytes=ctx.upload_bytes, distortions=ctx.distortions,
            telemetry=ctx.telemetry)
        return self.aggregate_async(actx)


def _staleness_discount(staleness: int, a: float) -> float:
    """Polynomial discount of FedAsync: (1+s)^{-a}; 1 when fresh."""
    return float((1.0 + max(int(staleness), 0)) ** -a)


class FedAsync(AsyncStrategy):
    """FedAsync-style sequential mixing: each arrival is folded into the
    global model in landing order with rate γ0·(1+s)^{-a}; the server's own
    update is a staleness-0 arrival applied last each round."""
    name = "fedasync"
    streaming = True

    def __init__(self, gamma0: float = 0.6, discount_a: float = 0.5,
                 gamma_server: float = 0.3):
        self.gamma0 = gamma0
        self.discount_a = discount_a
        self.gamma_server = gamma_server

    @staticmethod
    def _mix(global_params, model, gamma: float):
        return tree_map(
            lambda g, w: ((1.0 - gamma) * _f32(g) + gamma * _f32(w)).to(g.dtype),
            global_params, model)

    def aggregate_async(self, ctx: AsyncRoundContext):
        gammas = [self.gamma0 * _staleness_discount(a.staleness,
                                                    self.discount_a)
                  for a in ctx.arrivals]
        if getattr(ctx, "telemetry", None):
            rows = [beta_row(g, client=a.client, origin_round=a.origin_round,
                             staleness=a.staleness, rung=a.codec,
                             distortion=a.distortion)
                    for g, a in zip(gammas, ctx.arrivals)]
            rows.append(beta_row(self.gamma_server, role="server"))
            _record_betas(ctx, rows)
        if ctx.arrivals and all(a.packed is not None for a in ctx.arrivals):
            # Streaming: the sequential mixing is linear in the models, so
            # unroll it —  w_out = c0·w̄ + Σ_j c_j·model_j + γ_s·w_s with
            # c_j = (1−γ_s)·γ_j·∏_{k>j}(1−γ_k) — and evaluate the Σ over
            # model_j = origin_global_j + decode(payload_j) in one
            # accumulator pass instead of |arrivals| tree mixes.
            coefs = [0.0] * len(gammas)
            suffix = 1.0 - self.gamma_server
            for j in range(len(gammas) - 1, -1, -1):
                coefs[j] = gammas[j] * suffix
                suffix *= 1.0 - gammas[j]
            return _stream_accumulate(
                ctx, dense=[(suffix, ctx.global_params),
                            (self.gamma_server, ctx.server_model)],
                packed=[(c, a.packed)
                        for c, a in zip(coefs, ctx.arrivals)])
        w = ctx.global_params
        for gamma, arr in zip(gammas, ctx.arrivals):
            w = self._mix(w, arr.model, gamma)
        return self._mix(w, ctx.server_model, self.gamma_server)


class FedBuff(AsyncStrategy):
    """FedBuff-style buffered-K aggregation: client deltas accumulate (with
    staleness discounts) and are applied as one averaged server step only
    once K of them have landed; the server's own delta is applied every
    round so training never stalls on an empty buffer.  The step builds a
    new tree: the old global may still be a held upload's origin."""
    name = "fedbuff"
    wants_delta = True
    streaming = True              # a held payload's decode IS the
    #                               origin-relative delta: streaming mode
    #                               needs no dispatch-time snapshot at all

    def __init__(self, buffer_k: int = 4, eta: float = 1.0,
                 discount_a: float = 0.5):
        self.buffer_k = buffer_k
        self.eta = eta
        self.discount_a = discount_a

    def init_state(self, runner) -> None:
        self._held: list = []     # (delta|None, disc, meta, packed|None)

    def aggregate_async(self, ctx: AsyncRoundContext):
        for arr in ctx.arrivals:
            # dispatch-time snapshot (w_i − w̄^{origin}); in streaming mode
            # the packed payload replaces it — decode(payload) is exactly
            # that delta, so nothing is materialized at dispatch either
            delta = (None if arr.packed is not None
                     else arr.delta if arr.delta is not None
                     else delta_pytree(arr.model, ctx.global_params))
            self._held.append((
                delta, _staleness_discount(arr.staleness, self.discount_a),
                dict(client=arr.client, origin_round=arr.origin_round,
                     staleness=arr.staleness, rung=arr.codec,
                     distortion=arr.distortion), arr.packed))
        server_delta = delta_pytree(ctx.server_model, ctx.global_params)
        flush = len(self._held) >= self.buffer_k
        denom = 1 + (len(self._held) if flush else 0)
        dense = [(1.0 / denom, server_delta)]
        packed = []
        if flush:
            for d, disc, _meta, pu in self._held:
                if pu is not None:
                    packed.append((disc / denom, pu))
                else:
                    dense.append((disc / denom, d))
        if getattr(ctx, "telemetry", None):
            # each delta's applied step weight: η · disc / denom
            rows = [beta_row(self.eta / denom, role="server")]
            if flush:
                rows.extend(beta_row(self.eta * disc / denom, **meta)
                            for _d, disc, meta, _pu in self._held)
            _record_betas(ctx, rows)
        if flush:
            self._held = []
        if packed:
            step = _stream_delta_sum(ctx, dense, packed)
        else:
            step = _accumulate(ctx, [tree for _w, tree in dense],
                               np.asarray([w for w, _t in dense]))
        return tree_map(lambda g, d: (_f32(g) + self.eta * _f32(d)).to(g.dtype),
                        ctx.global_params, step)


class FedAutoAsync(AsyncStrategy):
    """FedAuto under staleness: Module 1 compensatory training over the
    classes the *arrived* cohort misses, then Module 2's QP (Eq. 8 with the
    Eq. 9 server pin) on the arrivals' α-rows with each β discounted by
    (1+s)^{-a} · (1−d)^{b} (``fedauto_discounted_weights``): staleness ×
    the upload's measured compression distortion.  With every arrival fresh
    and ``fidelity_discount`` at 0 (or every upload lossless) this is
    exactly FedAuto."""
    name = "fedauto_async"
    streaming = True

    def __init__(self, use_module1: bool = True, discount_a: float = 0.5,
                 fidelity_discount: Optional[float] = None):
        self.use_module1 = use_module1
        self.discount_a = discount_a
        self.fidelity_discount = fidelity_discount

    def aggregate_async(self, ctx: AsyncRoundContext):
        runner = ctx.runner
        received = np.zeros(len(ctx.client_hists), dtype=bool)
        for arr in ctx.arrivals:
            received[arr.client] = True
        miss = missing_classes(ctx.client_hists, received)
        comp_model, comp_hist = None, None
        if self.use_module1 and miss.any():
            comp_model, comp_hist = runner.train_compensatory(miss, ctx.rnd)

        def dist(h):
            tot = h.sum()
            return h / tot if tot > 0 else np.full_like(h, 1.0 / len(h),
                                                        dtype=float)

        rows = [dist(ctx.server_hist.astype(float))]
        models = [ctx.server_model]
        staleness = [0]
        distortion = [0.0]
        if comp_model is not None:
            rows.append(dist(comp_hist.astype(float)))
            models.append(comp_model)
            staleness.append(0)
            distortion.append(0.0)
        # client-index order (not landing order): the QP is a batch solve, and
        # this makes the fresh-cohort case bit-identical to synchronous FedAuto
        sorted_arrs = sorted(ctx.arrivals, key=lambda a: (a.client,
                                                          a.origin_round))
        streaming = bool(sorted_arrs) and all(a.packed is not None
                                              for a in sorted_arrs)
        for arr in sorted_arrs:
            rows.append(dist(ctx.client_hists[arr.client].astype(float)))
            if not streaming:
                models.append(arr.model)
            staleness.append(arr.staleness)
            distortion.append(float(arr.distortion))
        alpha_rows = np.stack(rows)
        alpha_g = dist(ctx.global_hist.astype(float))
        with _phase(ctx, "phase.weight_solve"):
            beta = fedauto_discounted_weights(
                alpha_rows, alpha_g, np.asarray(staleness),
                np.asarray(distortion), server_row=0,
                discount_a=self.discount_a,
                discount_b=_resolve_fidelity_discount(self.fidelity_discount,
                                                      ctx),
                device=runner.device)
        if getattr(ctx, "telemetry", None):
            out = [beta_row(beta[0], role="server")]
            k = 1
            if comp_model is not None:
                out.append(beta_row(beta[1], role="comp"))
                k = 2
            for j, arr in enumerate(sorted_arrs):
                out.append(beta_row(beta[k + j], client=arr.client,
                                    origin_round=arr.origin_round,
                                    staleness=arr.staleness, rung=arr.codec,
                                    distortion=arr.distortion))
            _record_betas(ctx, out)
        if streaming:
            n_dense = len(models)            # server (+ compensatory)
            return _stream_accumulate(
                ctx, dense=list(zip(beta[:n_dense], models)),
                packed=[(beta[n_dense + j], arr.packed)
                        for j, arr in enumerate(sorted_arrs)])
        return _accumulate(ctx, models, beta)


class CentralizedPublic(Strategy):
    """Server-only training on the public dataset (no client knowledge)."""
    name = "centralized_public"

    def aggregate(self, ctx: RoundContext):
        _record_betas(ctx, [beta_row(1.0, role="server")])
        return ctx.server_model


STRATEGIES = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "scaffold": Scaffold,
    "fedlaw": FedLAW,
    "tf_aggregation": TFAggregation,
    "fedawe": FedAWE,
    "fedex_lora": FedExLoRA,
    "fedauto": FedAuto,
    "centralized_public": CentralizedPublic,
    "fedasync": FedAsync,
    "fedbuff": FedBuff,
    "fedauto_async": FedAutoAsync,
}
