"""FFT round engine (Algorithm 1 + Algorithm 2), ported from
``repro/fl/runtime.py``.

Drives: client selection → failure draw → local SGD (clients + server,
Eq. 2–3) → strategy aggregation (Eq. 5/7), through the round loop
``FFTConfig.server_mode`` picks (``fl.server.loops``: the synchronous one,
or the staleness-buffered async and buffered ones), for full-parameter
fine-tuning or, with a ``lora_cfg``, partial-parameter (LoRA) fine-tuning:
the adapters are the trained, uploaded and aggregated tree and the base
weights stay frozen, except where FedEx-LoRA folds its residual into them.  Client uploads
travel through the communication codec (``FFTConfig.codec``: fp32, fp16,
int8, qsgd:<b>, sign1, topk:<f>, lora_only, or ``adaptive:<lo>-<hi>``, a
per-client rung the controller of ``fl.comm.adaptive`` learns from arrival
times): encoded client-side after the local update, aggregated server-side
by the streaming accumulator; the broadcast travels through
``FFTConfig.downlink_codec`` when one is set (the hi rung by default for
adaptive runs).  The network is a legacy failure mode (none, transient,
intermittent, mixed), a scenario world (``scenario:<world>``, with
per-client arrival times from ``fl.scenarios``) or a recorded trace
(``replay:<path>`` / ``trace_replay``); ``trace_record`` writes one.

Client datasets are resampled to a common size, as in the JAX package.  The
numpy draws come from ``self.rng`` in the JAX runner's order (client
resampling, public resampling, then per round selection and compensatory
resampling).  Minibatch indices come from ``batch_indices(n, E, bs) ->
LongTensor(E, bs)``, called once per local update in the order the JAX
runner splits its key (pretraining chunks, clients, server, compensatory
model); the default draws from a ``torch.Generator`` seeded from
``cfg.seed``.  A test can inject the JAX runner's own indices.  LoRA
adapters are drawn from a generator seeded from ``(cfg.seed, 1)``, not the
JAX numbers; a test carries the JAX adapters across instead.

The hooks the strategies call are the JAX runner's: ``local_steps``
(SCAFFOLD's Eq. 44b), ``eps_estimates`` (TF-Aggregation's outage
probabilities, 200 Monte-Carlo draws per channel from their own generator
seeded ``cfg.seed + 7``, so ``self.rng``'s draws do not move),
``trainable``, ``loss_on`` and ``public_proxy_batch`` (FedLAW's proxy
objective; the batch indices come from ``self.rng``).

Run telemetry (``FFTConfig.telemetry*``, ``repro_torch.obs``): ``run``
builds a fresh hub per run (``_make_telemetry``) and attaches it to the
comm state, the adaptive controller and the scenario engine; after the run
``runner.report`` holds the flight record.  Under a live hub the local
update and the evaluation are timed (``phase.local_update``,
``phase.eval``) and the device is synchronized before a phase timer
closes, at the places the JAX package calls ``jax.block_until_ready``;
with telemetry off the hub is ``NULL_TELEMETRY`` and nothing syncs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.strategies import Strategy
from repro_torch.data.synthetic import Dataset
from repro_torch.fl import failures as fail_mod
from repro_torch.fl import network as net_mod
from repro_torch.fl.comm import (AdaptiveCommController, CommState,
                                 is_adaptive_spec, make_codec,
                                 parse_adaptive_spec)
from repro_torch.fl.lora import LoRAConfig, _get, _set, apply_lora, lora_init
from repro_torch.fl.partition import class_histogram
from repro_torch.fl.scenarios.trace import TraceRecorder
from repro_torch.fl.server.loops import (SERVER_MODES, TimePoint,
                                         make_round_loop)
from repro_torch.fl.server.timeline import TimedFailureAdapter
from repro_torch.obs import (NULL_TELEMETRY, ChromeTraceRecorder,
                             ConsoleSink, DashboardSink, HealthMonitors,
                             NdjsonSink, RunReport, SketchReport,
                             SketchState, Telemetry)
from repro_torch.obs.sync import block_until_ready
from repro_torch.tree import tree_flatten, tree_unflatten


@dataclasses.dataclass
class FFTConfig:
    """The JAX package's ``FFTConfig``, field for field."""
    n_clients: int = 20
    k_selected: int = 20                  # K (20 = full participation)
    local_steps: int = 5                  # E
    batch_size: int = 32
    lr: float = 0.05
    lr_boundary: Optional[int] = None     # step decay at this round
    failure_mode: str = "mixed"           # none | transient | intermittent |
    #                                       mixed | scenario:<name> | replay:<path>
    duration_max: int = 10
    model_bytes: Optional[float] = None   # fp32 upload bytes; None = derive
    tx_delay_s: float = 0.8
    resource_opt: Optional[str] = None    # None | "joint" | "per_standard"
    seed: int = 0
    eval_every: int = 10
    eval_batch: int = 256
    # --- scenario engine (fl.scenarios) ------------------------------------
    deadline_s: float = 30.0              # server round timeout
    compute_s: float = 2.0                # mean local-compute seconds a round
    engine: str = "vectorized"            # "vectorized" | "heap" (bit-identical)
    cohort_size: int = 0                  # stream clients through the round in
    #                                       fixed-size cohorts (0 = all at once)
    trace_record: Optional[str] = None    # NDJSON path: record realized rounds
    trace_replay: Optional[str] = None    # NDJSON path: replay (overrides
    #                                       failure_mode)
    trace_mode: str = "auto"              # "full" | "sketch" (v5) | "auto"
    # --- server (fl.server) ------------------------------------------------
    server_mode: str = "sync"             # sync | async | buffered
    tau_max: int = 5                      # max staleness accepted async
    buffer_k: int = 4                     # buffered mode: arrivals per step
    streaming_agg: str = "auto"           # "auto": streaming strategies
    #                                       aggregate packed uploads through the
    #                                       StreamAccumulator; "off": force the
    #                                       materializing path
    # --- communication codec -------------------------------------------------
    codec: str = "fp32"                   # fp32 | fp16 | int8 | qsgd:<b> |
    #                                       sign1 | topk:<f> | lora_only |
    #                                       adaptive:<lo>-<hi>
    skip_stragglers: bool = False         # adaptive runs: leave clients that
    #                                       cannot land the lowest rung out of
    #                                       the selection draw
    controller_state_in: Optional[str] = None   # JSON: warm-start estimates
    controller_state_out: Optional[str] = None  # JSON: save them at run end
    downlink_codec: Optional[str] = None  # None: fp32 for static runs, the hi
    #                                       rung for adaptive ones
    fidelity_discount_b: float = 0.0      # exponent b of FedAuto's (1−d)^b
    # --- run telemetry (repro_torch.obs) --------------------------------------
    telemetry: Any = False                # per-round flight recorder; off =
    #                                       shared no-op hub, bit-identical
    #                                       to an uninstrumented run.
    #                                       True/"full": per-client rows;
    #                                       "sketch": bounded-memory mode —
    #                                       exact counters/byte totals +
    #                                       streaming quantile sketches,
    #                                       state O(rounds + K) instead of
    #                                       O(n_clients × rounds)
    telemetry_log: Optional[str] = None   # NDJSON event-log path (implies
    #                                       telemetry; observational only —
    #                                       replay never reads it)
    telemetry_console: bool = False       # per-round terminal summary line
    #                                       (implies telemetry)
    telemetry_sketch_k: int = 64          # sketch mode: reservoir-sample rows
    telemetry_health: bool = True         # online run-health monitors (when
    #                                       telemetry is on): alarm records +
    #                                       run-end verdict; observational
    telemetry_trace: Optional[str] = None  # Chrome trace-event JSON path
    #                                       (implies telemetry; open the file
    #                                       in Perfetto for a flamegraph of
    #                                       the phase timers)
    telemetry_dashboard: bool = False     # in-place live console dashboard
    #                                       (implies telemetry)


class FFTRunner:
    """One experiment: (model, data split, network, strategy) → accuracy
    curve, on ``device`` (CUDA unless the caller passes ``device="cpu"``).

    ``init_fn(seed)`` returns the initial params; ``apply_fn(params, x)``
    the logits of NHWC images ``x``.  ``base_params`` holds the full model
    and ``global_params`` the trained tree: the same tree without LoRA, the
    adapters with it."""

    def __init__(self, cfg: FFTConfig, init_fn: Callable, apply_fn: Callable,
                 public: Dataset, client_indices: Sequence[np.ndarray],
                 private: Dataset, test: Dataset,
                 lora_cfg: Optional[LoRAConfig] = None,
                 pretrain_steps: int = 0, *, device="cuda",
                 batch_indices: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.apply_fn = apply_fn
        self.lora_cfg = lora_cfg
        self.n_clients = cfg.n_clients
        self.k_selected = cfg.k_selected
        self.local_steps = cfg.local_steps
        self.rng = np.random.default_rng(cfg.seed)
        dev = self.device

        def to_dev(a):
            return torch.as_tensor(a, device=dev)

        self.n_classes = public.n_classes

        # --- per-client data, resampled to a common size --------------------
        sizes = [max(len(ix), 1) for ix in client_indices]
        self.data_size = max(max(sizes), cfg.batch_size)
        self.client_x, self.client_y = [], []
        for ix in client_indices:
            ix = np.asarray(ix)
            if len(ix) == 0:
                ix = np.array([0])
            res = self.rng.choice(ix, self.data_size, replace=True)
            self.client_x.append(to_dev(private.x[res]))
            self.client_y.append(to_dev(private.y[res]).long())
        self.client_hists = np.stack([
            class_histogram(private.y[np.asarray(ix)], self.n_classes)
            if len(ix) else np.zeros(self.n_classes, dtype=np.int64)
            for ix in client_indices])
        self.server_hist = class_histogram(public.y, self.n_classes)
        self.global_hist = self.server_hist + self.client_hists.sum(axis=0)

        pub_res = self.rng.choice(len(public.y), self.data_size, replace=True)
        self.public_x = to_dev(public.x[pub_res])
        self.public_y = to_dev(public.y[pub_res]).long()
        self.public_y_np = np.asarray(public.y)
        self.public_x_raw = to_dev(public.x)
        self.public_y_raw = to_dev(public.y).long()
        self.test_x = to_dev(test.x)
        self.test_y = to_dev(test.y).long()

        # p weights (Eq. 1): dataset-size proportions, index 0 = server
        counts = np.array([len(public.y)] + [max(len(ix), 1)
                                             for ix in client_indices], float)
        self.p = counts / counts.sum()

        # --- params ---------------------------------------------------------
        self.base_params = init_fn(cfg.seed)
        if lora_cfg is not None:
            seed = int(np.random.SeedSequence([cfg.seed, 1]).generate_state(1)[0])
            self.global_params = lora_init(
                torch.Generator(device=dev).manual_seed(seed),
                self.base_params, lora_cfg)
        else:
            self.global_params = self.base_params

        # --- communication codec ---------------------------------------------
        # The trained tree (adapters in LoRA mode) fixes the wire sizes; the
        # codec's exact wire size prices the upload in the failure model.
        # An adaptive spec is parsed before make_codec: its hi rung is the
        # ceiling that fixes the static accounting the controller adapts.
        self.adaptive_spec = cfg.codec if is_adaptive_spec(cfg.codec) else None
        if self.adaptive_spec:
            self._rung_lo, self._rung_hi = parse_adaptive_spec(cfg.codec)
            static_codec = make_codec(self._rung_hi)
        else:
            static_codec = make_codec(cfg.codec)
        dl_spec = cfg.downlink_codec
        if dl_spec is None and self.adaptive_spec:
            dl_spec = self._rung_hi
        self.downlink_codec_resolved = dl_spec or "fp32"
        dl_codec = (None if self.downlink_codec_resolved == "fp32"
                    else make_codec(self.downlink_codec_resolved))
        self.comm = CommState(static_codec, self.global_params,
                              model_bytes_override=cfg.model_bytes,
                              lora_cfg=lora_cfg, downlink_codec=dl_codec,
                              n_clients=cfg.n_clients)
        self.model_bytes = self.comm.ref_bytes            # fp32 reference size
        self.upload_bytes = self.comm.upload_bytes        # codec wire size
        self.download_bytes = self.comm.download_bytes    # broadcast wire size

        # --- network + failures ----------------------------------------------
        self.channels = net_mod.build_network(cfg.n_clients, seed=cfg.seed)
        rate = net_mod.uplink_rate(self.upload_bytes, cfg.tx_delay_s)
        if cfg.resource_opt:
            self.channels = net_mod.resource_opt(
                self.channels, rate, per_standard=cfg.resource_opt == "per_standard",
                seed=cfg.seed)
        mode = (f"replay:{cfg.trace_replay}" if cfg.trace_replay
                else cfg.failure_mode)
        self.failure_mode_resolved = mode
        if cfg.engine not in ("heap", "vectorized"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        self.failures = fail_mod.make_failure_model(
            mode, self.channels, rate,
            duration_max=cfg.duration_max, seed=cfg.seed,
            model_bytes=self.model_bytes, deadline_s=cfg.deadline_s,
            compute_s=cfg.compute_s, engine=cfg.engine)
        if cfg.server_mode not in SERVER_MODES:
            raise ValueError(f"unknown server_mode {cfg.server_mode!r}")
        if cfg.streaming_agg not in ("auto", "off"):
            raise ValueError(f"unknown streaming_agg {cfg.streaming_agg!r} "
                             "(known: auto, off)")
        if ((cfg.server_mode != "sync" or self.adaptive_spec)
                and not hasattr(self.failures, "draw_events")):
            # Legacy boolean failure models have no time dimension; the
            # async server and the adaptive controller need per-client
            # arrival instants, so synthesize them from the physical
            # channels (capacity -> upload time, Eq. 41).
            self.failures = TimedFailureAdapter(
                self.failures, self.channels, model_bytes=self.model_bytes,
                deadline_s=cfg.deadline_s, compute_s=cfg.compute_s,
                seed=cfg.seed, engine=cfg.engine)
        sim = getattr(self.failures, "sim", None)
        if sim is not None and cfg.cohort_size:
            sim.cohort_size = int(cfg.cohort_size)
        # Wire sizes into the timing model (a no-op for the boolean models);
        # adaptive runs re-price every round through the controller.
        self.failures.set_payload_bytes(
            upload_bytes=np.full(cfg.n_clients, self.upload_bytes),
            download_bytes=np.full(cfg.n_clients, self.download_bytes))
        self.controller = None
        if self.adaptive_spec:
            self.controller = AdaptiveCommController(
                cfg.n_clients, self.comm, lo=self._rung_lo, hi=self._rung_hi,
                deadline_s=cfg.deadline_s, compute_s=cfg.compute_s)
        if cfg.trace_replay:
            self._check_replay_header()
        mc = np.random.default_rng(cfg.seed + 7)
        self.eps_estimates = np.array([
            c.outage_probability(rate, mc, 200) for c in self.channels])

        # --- minibatch index source -------------------------------------------
        if batch_indices is None:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)

            def batch_indices(n, E, bs):
                return torch.randint(0, n, (E, bs), generator=gen, device=dev)

        self.batch_indices = batch_indices

        # --- run telemetry (repro_torch.obs; per-run hub built by run()) -----
        self.telemetry = NULL_TELEMETRY
        self.report = None                # RunReport of the last telemetry run

        if pretrain_steps:
            self.pretrain(pretrain_steps)

    # ------------------------------------------------------------ training
    def trainable(self, params):
        return params

    def _effective(self, t):
        """The full model that trained tree ``t`` stands for: the frozen
        base with the adapters merged in LoRA mode, ``t`` itself
        otherwise.  Only ``t``'s leaves can require grad."""
        if self.lora_cfg is not None:
            return apply_lora(self.base_params, t, self.lora_cfg)
        return t

    def _loss(self, t, x, y):
        logits = self.apply_fn(self._effective(t), x)
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        return -logp.gather(1, y[:, None]).mean()

    def lr(self, rnd: int) -> float:
        if self.cfg.lr_boundary is not None and rnd > self.cfg.lr_boundary:
            return self.cfg.lr * 0.1
        return self.cfg.lr

    def run_local(self, t_global, x, y, rnd, *, mu=0.0, corr=None):
        """E minibatch-SGD steps from ``t_global`` on (x, y) with the
        proximal term μ·(w − w̄) and the correction ``corr`` added to the
        gradient; returns the new params (``t_global`` is not modified).
        Timed as ``phase.local_update``; under a live hub the device is
        synchronized before the timer closes, or it would hold the E steps'
        launches only (``repro/fl/runtime.py:395-405``)."""
        tel = self.telemetry
        with tel.timer("phase.local_update"):
            out = self._local_sgd(t_global, x, y, rnd, mu, corr)
            block_until_ready(tel, out)
        return out

    def _local_sgd(self, t_global, x, y, rnd, mu, corr):
        E, bs = self.cfg.local_steps, self.cfg.batch_size
        idx = self.batch_indices(x.shape[0], E, bs).to(x.device)
        lr = self.lr(rnd)
        g_leaves, spec = tree_flatten(t_global)
        c_leaves = tree_flatten(corr)[0] if corr is not None else None
        leaves = g_leaves
        for e in range(E):
            params = [l.detach().requires_grad_(True) for l in leaves]
            loss = self._loss(tree_unflatten(spec, params), x[idx[e]], y[idx[e]])
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                new = []
                for li, (p_, g) in enumerate(zip(params, grads)):
                    g = g.to(torch.float32)
                    if mu:
                        g = g + mu * (p_.to(torch.float32) -
                                      g_leaves[li].to(torch.float32))
                    if c_leaves is not None:
                        g = g + c_leaves[li]
                    new.append((p_.to(torch.float32) - lr * g).to(p_.dtype))
            leaves = new
        return tree_unflatten(spec, [l.detach() for l in leaves])

    def loss_on(self, t, x, y) -> torch.Tensor:
        """Mean cross-entropy of trained tree ``t`` on (x, y), through
        ``_effective`` (the merged adapters in LoRA mode); differentiable in
        whatever ``t`` depends on."""
        return self._loss(t, x, y)

    def public_proxy_batch(self, n: int, rnd: int):
        """``n`` raw public samples drawn with replacement from
        ``self.rng`` (FedLAW's proxy batch)."""
        idx = self.rng.integers(0, len(self.public_y_raw), n)
        idx = torch.as_tensor(idx, device=self.device)
        return self.public_x_raw[idx], self.public_y_raw[idx]

    def fold_into_base(self, path: str, resid: torch.Tensor) -> None:
        """Add ``resid`` (fp32) to the frozen base weight at ``path``
        (FedEx-LoRA's residual); later rounds train and evaluate on it."""
        w = _get(self.base_params, path)
        _set(self.base_params, path, (w.to(torch.float32) + resid).to(w.dtype))

    def train_compensatory(self, miss_mask: np.ndarray, rnd: int):
        """Module 1 (Eq. 6): E SGD steps on the missing-class public subset."""
        miss_classes = np.where(miss_mask)[0]
        idx = np.where(np.isin(self.public_y_np, miss_classes))[0]
        if len(idx) == 0:
            return None, None
        res = torch.as_tensor(self.rng.choice(idx, self.data_size, replace=True),
                              device=self.device)
        model = self.run_local(self.global_params, self.public_x_raw[res],
                               self.public_y_raw[res], rnd)
        hist = class_histogram(self.public_y_np[idx], self.n_classes)
        return model, hist

    def pretrain(self, steps: int) -> None:
        """Stage 1 (§II-B1): server pre-training on the public dataset."""
        t = self.global_params
        for _ in range(0, steps, self.cfg.local_steps):
            t = self.run_local(t, self.public_x, self.public_y, 0)
        self.global_params = t

    def evaluate(self) -> float:
        with self.telemetry.timer("phase.eval"):
            bs = self.cfg.eval_batch
            n = len(self.test_y)
            correct = torch.zeros((), dtype=torch.int64, device=self.device)
            with torch.no_grad():
                params = self._effective(self.global_params)
                for i in range(0, n, bs):
                    logits = self.apply_fn(params, self.test_x[i:i + bs])
                    correct += (logits.argmax(-1) ==
                                self.test_y[i:i + bs]).sum()
            # int() waits for the device sum, so the timer is honest
            return int(correct) / n

    def _check_replay_header(self) -> None:
        """A replayed trace must match this run's codec and wire sizes: the
        recorded timings were priced at the recorded byte counts."""
        cfg, hdr = self.cfg, self.failures.header
        if self.failures.codec != cfg.codec:
            raise ValueError(
                f"trace {cfg.trace_replay} was recorded under codec "
                f"{self.failures.codec!r} but this run uses {cfg.codec!r}; "
                "the recorded upload timings would be wrong — replay with "
                "the matching codec")
        rec_dl = hdr.get("downlink_codec") or "fp32"
        if rec_dl != self.downlink_codec_resolved:
            raise ValueError(
                f"trace {cfg.trace_replay} was recorded under downlink codec "
                f"{rec_dl!r} but this run uses "
                f"{self.downlink_codec_resolved!r}; the recorded download "
                "timings would be wrong — replay with the matching "
                "downlink_codec")
        # adaptive runs have no single upload size; the round loop checks
        # the per-round byte vectors
        checks = [("model_bytes", self.model_bytes),
                  ("download_bytes", self.download_bytes)]
        if not self.adaptive_spec:
            checks.append(("upload_bytes", self.upload_bytes))
        for field, ours in checks:
            rec = hdr.get(field)
            if rec is not None and not np.isclose(float(rec), ours, rtol=1e-6):
                raise ValueError(
                    f"trace {cfg.trace_replay} was recorded with "
                    f"{field}={float(rec):.0f} but this run derives "
                    f"{ours:.0f}; the recorded upload timings would be "
                    "wrong — replay with the matching model_bytes")

    def _draw_network(self, r: int):
        """(up, met_deadline, RoundEvents|None) for round ``r``.  Scenario,
        replay and adapted models expose per-client timing through
        ``draw_events``; legacy models have no time dimension, so every
        surviving draw meets the deadline."""
        if hasattr(self.failures, "draw_events"):
            events = self.failures.draw_events(r)
            return events.up_mask(), events.deadline_mask(), events
        up = self.failures.draw(r)
        return up, np.ones(self.n_clients, dtype=bool), None

    # ------------------------------------------------------------------ run
    def run(self, strategy: Strategy, rounds: int,
            log: Optional[Callable[[int, float], None]] = None) -> List[float]:
        """Drive ``rounds`` rounds under ``cfg.server_mode``'s loop; returns
        the accuracy history (one entry per evaluation).  ``self.timeline``
        holds ``TimePoint(rnd, t_s, acc)`` entries in simulated seconds and
        ``self.loop`` the driver (staleness stats for the async modes)."""
        cfg = self.cfg
        strategy.init_state(self)
        self.failures.reset()
        self.comm.reset()                 # error-feedback residuals per run
        if self.controller is not None:
            self.controller.reset()       # capacity estimates per run
            if cfg.controller_state_in:
                # warm start (after the reset, so a field missing from the
                # file keeps its cold-start value)
                self.controller.load_state(cfg.controller_state_in)
        self.report = None
        self.telemetry = self._make_telemetry(strategy, rounds)
        tracer = None
        if cfg.trace_record:
            # resolved mode: a replayed run's re-recording names the replay
            # source, not the scenario the config nominally asked for
            version_override = {}
            if cfg.trace_replay and self.adaptive_spec:
                src_v = int(self.failures.header.get("version", 0) or 0)
                if 0 < src_v < 4:
                    # a legacy replay re-derives its controller trajectory
                    # under the pre-v4 enrollment pricing: stamp the source
                    # version so future replays apply the same shim
                    version_override = {"version": src_v}
            tracer = TraceRecorder(cfg.trace_record, {
                **version_override,
                "scenario": self.failure_mode_resolved,
                "n_clients": self.n_clients,
                "deadline_s": cfg.deadline_s,
                "compute_s": cfg.compute_s,
                "model_bytes": self.model_bytes,
                "codec": cfg.codec,
                # adaptive runs have no single upload size: the per-round
                # per-client byte vectors in the round records are the truth
                "upload_bytes": (None if self.adaptive_spec
                                 else self.upload_bytes),
                "downlink_codec": self.downlink_codec_resolved,
                "download_bytes": self.download_bytes,
                "seed": cfg.seed}, mode=cfg.trace_mode)
        self.timeline: List[TimePoint] = []
        self.loop = make_round_loop(cfg.server_mode, self, strategy,
                                    tracer=tracer, log=log)
        try:
            return self.loop.run(rounds)
        finally:
            self.telemetry.end_run()
            if tracer is not None:
                tracer.close()
            if self.controller is not None and cfg.controller_state_out:
                self.controller.save_state(cfg.controller_state_out)

    def _make_telemetry(self, strategy: Strategy, rounds: int):
        """Build this run's telemetry hub (a fresh one per run, like the
        error-feedback residuals) and attach it to every collaborator that
        emits into it (``repro/fl/runtime.py:530-593``).  Disabled (the
        default) this is the shared falsy no-op hub: no per-round work and
        no device sync."""
        cfg = self.cfg
        mode = cfg.telemetry
        if mode is True:
            mode = "full"
        elif mode and mode not in ("full", "sketch"):
            raise ValueError(f"FFTConfig.telemetry must be False, True, "
                             f"'full', or 'sketch', got {cfg.telemetry!r}")
        enabled = bool(mode or cfg.telemetry_log or cfg.telemetry_console
                       or cfg.telemetry_trace or cfg.telemetry_dashboard)
        if enabled:
            mode = mode or "full"
            sketch = None
            if mode == "sketch":
                # bounded-memory mode: per-client events fold into sketches;
                # the report mirrors RunReport's aggregate API
                sketch = SketchState(self.n_clients,
                                     k=cfg.telemetry_sketch_k, seed=cfg.seed)
                self.report = SketchReport()
            else:
                self.report = RunReport()
            sinks = [self.report]
            if cfg.telemetry_log:
                sinks.append(NdjsonSink(cfg.telemetry_log))
            if cfg.telemetry_console:
                sinks.append(ConsoleSink())
            if cfg.telemetry_dashboard:
                # after the report sink, so each frame sees the new round
                sinks.append(DashboardSink(self.report))
            health = HealthMonitors() if cfg.telemetry_health else None
            trace = (ChromeTraceRecorder(cfg.telemetry_trace)
                     if cfg.telemetry_trace else None)
            tel = Telemetry(sinks=sinks, sketch=sketch, health=health,
                            trace=trace)
            tel.start_run({
                "scenario": self.failure_mode_resolved,
                "server_mode": cfg.server_mode,
                "strategy": strategy.name,
                "codec": cfg.codec,
                "downlink_codec": self.downlink_codec_resolved,
                "n_clients": self.n_clients,
                "k_selected": self.k_selected,
                "rounds": rounds,
                "deadline_s": cfg.deadline_s,
                "tau_max": cfg.tau_max,
                "seed": cfg.seed})
        else:
            tel = NULL_TELEMETRY
        # observational fan-in points; each holds NULL_TELEMETRY otherwise
        self.comm.telemetry = tel
        if self.controller is not None:
            self.controller.telemetry = tel
        sim = getattr(self.failures, "sim", None)
        if sim is not None:
            sim.telemetry = tel
        return tel
