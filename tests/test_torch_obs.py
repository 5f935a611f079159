"""Run telemetry's numpy units in the port (``repro_torch.obs``,
``repro_torch.fl.metrics``, the comm and broadcast counters) against the
JAX package's (``repro.obs``, ``repro.fl.metrics``) on the same inputs.

The obs modules are copies, so every check here is exact: the hub's
one-outcome rule and its error messages, the exclusive timers on a
scripted clock, the NDJSON log byte for byte (non-finite values, a
truncated last line, a v1 log, each package's log loaded by the other),
the health monitors, the Chrome trace replay, the dashboard frame, the
Markdown report, ``reconcile``, ``fl/metrics``.  The comm counters, the
streaming accumulator's counters and gauges and the broadcast cache's
counters are held against the JAX ones on the same payload trees; the
distortions of a lossy upload within 1e-3·|d| + 1e-6.
"""
import io
import json
import math
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.fl import metrics as jmetrics
from repro.fl.comm.codecs import make_codec as j_make_codec
from repro.fl.comm.state import CommState as JCommState
from repro.fl.comm.state import _DenseFloatMap as JDenseFloatMap
from repro.fl.comm.stream import StreamAccumulator as JAcc
from repro.fl.comm.stream import PackedUpdate as JPacked
from repro.fl.comm.stream import weighted_model_sum as j_wms
from repro_torch.fl import metrics as tmetrics
from repro_torch.fl.comm.codecs import make_codec as t_make_codec
from repro_torch.fl.comm.state import CommState as TCommState
from repro_torch.fl.comm.state import _DenseFloatMap as TDenseFloatMap
from repro_torch.fl.comm.stream import StreamAccumulator as TAcc
from repro_torch.fl.comm.stream import PackedUpdate as TPacked
from repro_torch.fl.comm.stream import weighted_model_sum as t_wms
from repro_torch.obs.sync import block_until_ready

PKGS = {"jax": J, "torch": T}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn, *args, **kw):
    """``fn(pkg, ...)`` for the JAX package and the port."""
    return fn(J, *args, **kw), fn(T, *args, **kw)


# ---------------------------------------------------------------------------
# a scripted run: the hub protocol fed from a seed, identically per package
# ---------------------------------------------------------------------------
def _feed(pkg, sinks=(), *, sketch=False, rounds=6, n=8, seed=0,
          health=True, rep=None):
    """Drive ``pkg``'s hub through ``rounds`` rounds of ``n`` clients from
    ``seed``: outcomes of every kind, buffered uploads resolved later, β
    rows, phase gauges and round walls, accuracy.  Returns (hub, report,
    ground-truth runner stub for ``reconcile``)."""
    rng = np.random.default_rng(seed)
    if rep is None:
        rep = pkg.SketchReport() if sketch else pkg.RunReport()
    tel = pkg.Telemetry(
        sinks=[rep, *sinks],
        sketch=pkg.SketchState(n, k=8, seed=seed) if sketch else None,
        health=pkg.HealthMonitors() if health else None)
    tel.start_run({"scenario": "scripted", "server_mode": "async",
                   "strategy": "fedauto_async", "codec": "qsgd:4",
                   "n_clients": n, "rounds": rounds})
    up_total, down_total, parts, pending = [], 0.0, [], []
    phase_total = {}
    for r in range(1, rounds + 1):
        tel.begin_round(r)
        aggregated = 0
        for o, c in pending:
            if rng.random() < 0.6:
                tel.resolve(o, c, pkg.AGGREGATED, staleness=r - o,
                            applied_round=r)
                aggregated += 1
            else:
                tel.resolve(o, c, pkg.EVICTED, applied_round=r)
        pending = []
        rows = [pkg.beta_row(0.2, role="server")]
        for i in range(n):
            u = rng.random()
            if u < 0.15:
                tel.client_outcome(r, i, pkg.NOT_SELECTED)
            elif u < 0.25:
                tel.client_outcome(r, i, pkg.LINK_DOWN, detail="handover")
            elif u < 0.32:
                tel.client_outcome(r, i, pkg.MISSED_DEADLINE,
                                   detail="never_lands")
            else:
                b = float(rng.integers(1_000, 9_000))
                d = float(rng.random() * 0.3)
                up_total.append(b)
                if u < 0.45:
                    tel.client_outcome(r, i, pkg.BUFFERED, rung="qsgd:4",
                                       upload_bytes=b, distortion=d)
                    pending.append((r, i))
                else:
                    tel.client_outcome(r, i, pkg.AGGREGATED, staleness=0,
                                       rung="sign1" if u > 0.8 else "fp16",
                                       upload_bytes=b, distortion=d)
                    rows.append(pkg.beta_row(float(rng.random()), client=i,
                                             staleness=0, rung="fp16",
                                             distortion=d))
                    aggregated += 1
        tel.betas(r, rows)
        tel.distribution(r, "cap_hat_bps", rng.random(n) * 1e7)
        dl = 4_000.0
        down_total += dl
        parts.append(aggregated)
        wall = 1.0 + r / 10
        for name, share in (("phase.local_update", 0.6),
                            ("phase.weight_solve", 0.2),
                            ("phase.accumulate", 0.05)):
            tel.gauge(r, name, wall * share)
            phase_total[name] = phase_total.get(name, 0.0) + wall * share
        for name, v in (("participants", aggregated), ("downlink_bytes", dl),
                        ("round_wall_s", wall), ("rung_churn", 0.1 * r),
                        ("nan_gauge", math.nan), ("inf_gauge", math.inf)):
            tel.gauge(r, name, float(v))
        if r % 2 == 0:
            tel.gauge(r, "eval_acc", [0.5, 0.6, 0.2][(r // 2) % 3])
        tel.counter("comm.uploads", aggregated)
        tel.end_round(r)
    tel.timers_s.update(phase_total)
    tel.end_run()
    runner = SimpleNamespace(
        comm=SimpleNamespace(total_uplink_bytes=math.fsum(up_total),
                             total_downlink_bytes=down_total),
        loop=SimpleNamespace(participants_per_round=parts))
    return tel, rep, runner


def _rounds(rep):
    """The round records as canonical JSON text (NaN gauges included)."""
    return json.dumps(rep.rounds, default=str)


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------
def _attempts(pkg, sketch):
    rep = pkg.SketchReport() if sketch else pkg.RunReport()
    tel = pkg.Telemetry(sinks=[rep], sketch=(pkg.SketchState(4, k=8)
                                             if sketch else None))
    tel.start_run({"n_clients": 4})
    log = []

    def attempt(fn, *a, **k):
        try:
            fn(*a, **k)
            log.append("ok")
        except ValueError as e:
            log.append(f"{type(e).__name__}: {e}")

    tel.begin_round(1)
    attempt(tel.client_outcome, 1, 0, pkg.AGGREGATED, rung="fp32",
            upload_bytes=10.0)
    attempt(tel.client_outcome, 1, 0, pkg.NOT_SELECTED)
    attempt(tel.client_outcome, 1, 1, "vanished")
    attempt(tel.begin_round, 2)
    attempt(tel.client_outcome, 7, 1, pkg.AGGREGATED)
    attempt(tel.resolve, 1, 0, pkg.NOT_SELECTED)
    attempt(tel.client_outcome, 1, 1, pkg.BUFFERED, upload_bytes=5.0)
    attempt(tel.client_outcome, 1, 2, pkg.LINK_DOWN, detail="handover")
    attempt(tel.client_outcome, 1, 3, pkg.SKIPPED_STRAGGLER)
    tel.betas(1, [pkg.beta_row(0.5, role="server"),
                  pkg.beta_row(0.5, client=0)])
    tel.end_round(1)
    tel.begin_round(2)
    for i in range(4):
        tel.client_outcome(2, i, pkg.NOT_SELECTED)
    tel.resolve(1, 1, pkg.AGGREGATED, staleness=1, applied_round=2)
    tel.end_round(2)
    tel.end_run()
    return log, rep.drop_cause_counts(), _rounds(rep)


@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
def test_hub_one_outcome_rule_matches_jax(sketch):
    j, t = _both(_attempts, sketch)
    assert t == j
    log = t[0]
    assert "exactly one terminal outcome" in log[1]
    assert "unknown outcome" in log[2] and "begin_round" in log[3]
    assert "staged" in log[4] and "resolution outcome" in log[5]
    assert log.count("ok") == 4


def test_null_hub_is_falsy_and_shared():
    assert not T.NULL_TELEMETRY and T.NullTelemetry().enabled is False
    assert bool(T.Telemetry())
    for name in ("start_run", "begin_round", "client_outcome", "resolve",
                 "betas", "gauge", "distribution", "counter", "timer",
                 "end_round", "end_run"):
        assert hasattr(T.NULL_TELEMETRY, name), name
    with T.NULL_TELEMETRY.timer("phase.x"):
        T.NULL_TELEMETRY.client_outcome(1, 0, "anything")


class _Clock:
    """A scripted ``time.perf_counter``: 0.125 s a reading."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.125
        return self.t


def _timed(pkg, path):
    tel = pkg.Telemetry(trace=pkg.ChromeTraceRecorder(path))
    tel.start_run({"n_clients": 1})
    tel.begin_round(1)
    with tel.timer("phase.outer"):
        with tel.timer("phase.inner"):
            with tel.timer("phase.innermost"):
                pass
        with tel.timer("phase.inner"):
            pass
    with tel.timer("phase.outer"):
        pass
    tel.end_round(1)
    tel.end_run()
    return dict(tel.timers_s), open(path).read()


def test_exclusive_timers_and_trace_match_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "perf_counter", _Clock())
    (jt, jtrace), (tt, ttrace) = (
        _timed(J, str(tmp_path / "j.json")), _timed(T, str(tmp_path / "t.json")))
    assert tt == jt and ttrace == jtrace
    # exclusive: each timer holds only the readings no inner timer claimed
    # (outer 3 steps of its first span and 1 of its second, inner 2 + 1)
    assert tt == {"phase.outer": 0.5, "phase.inner": 0.375,
                  "phase.innermost": 0.125}
    for pkg in (J, T):
        totals, per_round = pkg.self_times(
            pkg.load_trace(str(tmp_path / "t.json"))["traceEvents"])
        for name, want in tt.items():
            assert totals[name] == pytest.approx(want, abs=1e-9)
            assert per_round[1][name] == pytest.approx(want, abs=1e-9)


def test_unbalanced_trace_rejected_by_both():
    events = [{"name": "round", "ph": "B", "ts": 0.0, "args": {"round": 1}},
              {"name": "phase.a", "ph": "B", "ts": 1.0},
              {"name": "round", "ph": "E", "ts": 2.0}]
    msgs = []
    for pkg in (J, T):
        with pytest.raises(ValueError, match="unbalanced trace") as e:
            pkg.self_times(events)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# sinks: NDJSON log, report views, console
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
def test_ndjson_log_byte_identical_and_cross_loads(tmp_path, sketch):
    paths = {}
    reports = {}
    for name, pkg in PKGS.items():
        paths[name] = str(tmp_path / f"{name}.ndjson")
        _, reports[name], _ = _feed(pkg, [pkg.NdjsonSink(paths[name])],
                                    sketch=sketch)
    assert open(paths["torch"]).read() == open(paths["jax"]).read()
    assert T.TELEMETRY_SCHEMA == J.TELEMETRY_SCHEMA
    assert T.TELEMETRY_VERSION == J.TELEMETRY_VERSION
    assert T.TELEMETRY_VERSIONS_READABLE == J.TELEMETRY_VERSIONS_READABLE
    want = "sketch" if sketch else "full"
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        pkg = PKGS[reader]
        assert pkg.peek_telemetry_mode(paths[writer]) == want
        rep = pkg.load_report(paths[writer])
        assert type(rep).__name__ == ("SketchReport" if sketch
                                      else "RunReport")
        mine = reports[reader]
        assert rep.drop_cause_counts() == mine.drop_cause_counts()
        assert rep.total_upload_bytes() == mine.total_upload_bytes()
        assert rep.participants_per_round() == mine.participants_per_round()
        assert rep.accuracy_curve() == mine.accuracy_curve()
        assert rep.phase_table() == mine.phase_table()
        assert rep.health_verdict() == mine.health_verdict()
        assert _rounds(rep) == _rounds(PKGS[writer].load_report(
            paths[writer]))
        if not sketch:
            g = rep.rounds[0]["gauges"]
            assert math.isnan(g["nan_gauge"]) and g["inf_gauge"] == math.inf


def test_ndjson_truncated_last_line_and_damage(tmp_path):
    _, _, _ = _feed(T, [T.NdjsonSink(str(tmp_path / "t.ndjson"))])
    lines = open(tmp_path / "t.ndjson").read().splitlines()
    cut = tmp_path / "cut.ndjson"
    cut.write_text("\n".join(lines[:-1]) + "\n" +
                   lines[-1][:len(lines[-1]) // 2])
    got = []
    for pkg in (J, T):
        with pytest.warns(RuntimeWarning, match="truncated final record"):
            rep = pkg.RunReport.from_ndjson(str(cut))
        got.append((rep.n_rounds, rep.drop_cause_counts(), rep.summary))
    assert got[0] == got[1] and got[1][0] == 6
    bad = tmp_path / "damaged.ndjson"
    bad.write_text(lines[0] + "\n{half a record\n" + lines[-1] + "\n")
    for pkg in (J, T):
        with pytest.raises(json.JSONDecodeError):
            pkg.RunReport.from_ndjson(str(bad))
    foreign = tmp_path / "foreign.ndjson"
    foreign.write_text('{"record": "run_start", "schema": "other", '
                       '"version": 1, "meta": {}}\n')
    msgs = []
    for pkg in (J, T):
        with pytest.raises(ValueError, match="not a fft-telemetry") as e:
            pkg.RunReport.from_ndjson(str(foreign))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_ndjson_v1_log_loads_in_both(tmp_path):
    src = tmp_path / "v2.ndjson"
    _feed(J, [J.NdjsonSink(str(src))], health=False)
    out = []
    for line in open(src):
        doc = json.loads(line)
        if doc.get("record") == "run_start":
            doc["version"] = 1
        if doc.get("record") == "round":
            doc["gauges"] = {k: v for k, v in doc["gauges"].items()
                             if not k.startswith("phase.")
                             and k != "round_wall_s"}
        out.append(json.dumps(doc))
    v1 = tmp_path / "v1.ndjson"
    v1.write_text("\n".join(out) + "\n")
    views = []
    for pkg in (J, T):
        rep = pkg.RunReport.from_ndjson(str(v1))
        assert rep.phase_seconds() == {} and rep.phase_table() == []
        views.append((rep.n_rounds, rep.drop_cause_counts(),
                      rep.total_wall_s()))
    assert views[0] == views[1] == (6, views[0][1], 0.0)


@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
def test_report_views_match_jax(sketch):
    (_, jr, _), (_, tr, _) = _both(_feed, sketch=sketch)
    assert _rounds(tr) == _rounds(jr)
    assert tr.resolutions == jr.resolutions
    for view in ("drop_cause_counts", "participants_per_round",
                 "mean_participants", "total_upload_bytes",
                 "total_download_bytes", "accuracy_curve", "final_accuracy",
                 "mean_distortion", "rung_histogram", "total_wall_s",
                 "phase_seconds", "phase_table", "health_verdict", "label",
                 "quantiles"):
        assert getattr(tr, view)() == getattr(jr, view)(), view
    for key in ("staleness", "rung", "role"):
        assert tr.beta_mass_by(key) == jr.beta_mass_by(key), key
    if sketch:
        assert tr.sample_rows() == jr.sample_rows()
        assert tr.resident_estimate() == jr.resident_estimate()
    else:
        assert tr.final_outcomes() == jr.final_outcomes()
        assert tr.beta_rows() == jr.beta_rows()


def test_console_sink_lines_match_jax(capsys):
    out = []
    for pkg in (J, T):
        _feed(pkg, [pkg.ConsoleSink()])
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "[obs] r=" in out[1] and "verdict:" in out[1]


# ---------------------------------------------------------------------------
# reconcile and the Markdown report
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
def test_reconcile_and_markdown_match_jax(sketch):
    (_, jr, jrun), (_, tr, trun) = _both(_feed, sketch=sketch)
    assert T.reconcile(tr, trun) == J.reconcile(jr, jrun)
    assert (T.render_markdown([tr], ["scripted"])
            == J.render_markdown([jr], ["scripted"]))
    # drift in the accounting: both raise the same error
    trun.comm.total_uplink_bytes += 1e6
    jrun.comm.total_uplink_bytes += 1e6
    msgs = []
    for pkg, rep, run in ((J, jr, jrun), (T, tr, trun)):
        with pytest.raises(pkg.ReconcileError, match="uplink") as e:
            pkg.reconcile(rep, run)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# health monitors
# ---------------------------------------------------------------------------
def _digest(r, **kw):
    d = dict(round=r, n_clients=10, counts={}, participants=5,
             eval_acc=None, beta_n=0, beta_ess=None, distortion_mean=None,
             gauges={})
    d.update(kw)
    return d


HEALTH_STREAMS = {
    "acc_drawdown": [dict(eval_acc=a) for a in (0.5, 0.6, 0.62, 0.3, 0.3,
                                                 0.62, 0.3)],
    "empty_cohort": [dict(participants=0, counts={"evicted": 1})] * 4,
    "beta_collapse": [dict(beta_n=10, beta_ess=1.0)] * 3,
    "rung_thrash": [dict(gauges={"rung_churn": 0.8})] * 4,
    "cap_drift": [dict(gauges={"cap_hat_mean_bps": c})
                  for c in (1e7, 1.1e7, 0.9e7, 1e7, 1e6)],
    "distortion_spike": [dict(distortion_mean=d)
                         for d in (0.1, 0.11, 0.09, 0.6)],
}


@pytest.mark.parametrize("stream", list(HEALTH_STREAMS))
def test_health_monitors_match_jax(stream):
    out = []
    for pkg in (J, T):
        hm = pkg.HealthMonitors(pkg.HealthConfig())
        recs = []
        for r, kw in enumerate(HEALTH_STREAMS[stream], start=1):
            recs += hm.observe_round(_digest(r, **kw))
        out.append((recs, hm.verdict()))
    assert out[0] == out[1]
    assert stream in out[1][1]["by_monitor"]
    assert (T.health_record(3, "x", 1.0, 2.0, "m")
            == J.health_record(3, "x", 1.0, 2.0, "m"))


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
def test_dashboard_frames_match_jax(sketch, capsys):
    frames = []
    for pkg in (J, T):
        _, rep, _ = _feed(pkg, sketch=sketch)
        frames.append(pkg.render_dashboard(rep))
    assert frames[0] == frames[1]
    assert "participants" in frames[1] and "outcomes" in frames[1]
    vals = [0.1, 0.5, 0.0, 0.3, 0.9]
    assert T.sparkline(vals) == J.sparkline(vals)
    painted = []
    for pkg in (J, T):
        rep = pkg.SketchReport() if sketch else pkg.RunReport()
        buf = io.StringIO()
        _feed(pkg, [pkg.DashboardSink(rep, stream=buf)], sketch=sketch,
              rep=rep)
        painted.append(buf.getvalue())
    assert painted[0] == painted[1] and painted[1].count("┌") >= 6


def test_watch_renders_a_log_of_either_package(tmp_path):
    path = str(tmp_path / "j.ndjson")
    _feed(J, [J.NdjsonSink(path)], sketch=True)
    bufs = []
    for pkg in (J, T):
        buf = io.StringIO()
        pkg.watch(path, once=True, stream=buf)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1] and "participants" in bufs[1]


# ---------------------------------------------------------------------------
# fl/metrics
# ---------------------------------------------------------------------------
class _Replay:
    def __init__(self, per_round):
        self._per_round = per_round

    def distortions(self, rnd):
        return self._per_round.get(rnd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fl_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    hist = list(rng.random(12))
    for warmup in (0, 2, 5, 20):
        assert (tmetrics.accuracy_drawdown(hist, warmup=warmup)
                == jmetrics.accuracy_drawdown(hist, warmup=warmup))
    dist = [{int(c): float(rng.random()) for c in rng.choice(6, k)}
            for k in rng.integers(0, 4, 5)]
    assert tmetrics.mean_distortion(dist) == jmetrics.mean_distortion(dist)
    per_round = {r + 1: np.array([d.get(i, np.nan) for i in range(6)])
                 for r, d in enumerate(dist)}
    replay = _Replay(per_round)
    for hist_d, want in ((dist, True), (dist[:-1] + [{0: 9.0}], False)):
        got = tmetrics.distortion_replay_matches(replay, hist_d, len(dist))
        assert got == want == jmetrics.distortion_replay_matches(
            replay, hist_d, len(dist))


# ---------------------------------------------------------------------------
# comm counters, the streaming accumulator, the dense distortion map
# ---------------------------------------------------------------------------
def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"conv": {"w": (rng.standard_normal((3, 3, 2, 4)) * scale)
                     .astype(np.float32)},
            "dense": {"b": (rng.standard_normal(5) * scale).astype(np.float32),
                      "w": (rng.standard_normal((20, 5)) * scale)
                      .astype(np.float32)}}


def _to(pkg, tree):
    conv = ((lambda a: jnp.asarray(a)) if pkg is J
            else (lambda a: torch.as_tensor(a)))
    return {k: ({kk: conv(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else conv(v)) for k, v in tree.items()}


def _comm_script(pkg):
    """Uploads through every path of ``CommState`` under a live hub:
    streaming encodes, materializing roundtrips and a server-side decode,
    an adaptive rung, and three broadcasts through an int8 downlink."""
    make_codec = j_make_codec if pkg is J else t_make_codec
    CommState = JCommState if pkg is J else TCommState
    g = _to(pkg, _tree(0))
    st = CommState(make_codec("qsgd:4"), g, n_clients=4,
                   downlink_codec=make_codec("int8"))
    tel = pkg.Telemetry()
    st.telemetry = tel
    dists = []
    for rnd in range(3):
        st.broadcast(_to(pkg, _tree(10 + rnd)))
        for c in range(4):
            m = _to(pkg, _tree(100 + 10 * rnd + c, 1.1))
            if c == 0:
                payload, d = st.encode_upload(c, m, g)
                st.decode_upload(payload, g)
            elif c == 1:
                _, _, d = st.roundtrip(c, m, g, codec=st.codec_named("sign1"))
            else:
                _, _, d = st.roundtrip(c, m, g)
            dists.append(float(d))
    return (dict(tel.counters), sorted(tel.timers_s), dists,
            dict(st.last_distortions.items()), st.total_uplink_bytes,
            st.total_downlink_bytes)


def test_comm_counters_and_timers_match_jax():
    (jc, jtm, jd, jlast, jup, jdown), (tc, ttm, td, tlast, tup, tdown) = (
        _both(_comm_script))
    assert tc == jc and ttm == jtm and (tup, tdown) == (jup, jdown)
    assert ttm == ["phase.downlink", "phase.uplink", "phase.uplink_decode"]
    assert tc["comm.uploads"] == 12 and tc["comm.broadcasts"] == 3
    assert tc["uplink.fallback_payloads"] == 3
    assert tlast.keys() == jlast.keys()
    for a, b in zip(td + [tlast[k] for k in tlast],
                    jd + [jlast[k] for k in jlast]):
        assert abs(a - b) <= 1e-3 * abs(b) + 1e-6


def test_dense_distortion_map_matches_jax():
    maps = [JDenseFloatMap(5), TDenseFloatMap(5)]
    views = []
    for m in maps:
        m[3] = 0.25
        m[0] = 0.5
        m[3] = 0.125
        view = [len(m), 3 in m, 1 in m, 7 in m, m.get(1), m.get(1, -1.0),
                m[0], sorted(m.keys()), sorted(m.items())]
        with pytest.raises(KeyError):
            m[2]
        m.clear()
        views.append(view + [len(m), list(m.keys())])
    assert views[0] == views[1]
    st = TCommState(t_make_codec("fp32"), _to(T, _tree(0)), n_clients=3)
    assert isinstance(st.last_distortions, TDenseFloatMap)
    st_sparse = TCommState(t_make_codec("fp32"), _to(T, _tree(0)))
    assert st_sparse.last_distortions == {}


def _mixed_payload(make_codec, tree):
    """An fp32 payload with one fp16 leaf: no single rung family, so the
    accumulator decodes it alone (the fallback path)."""
    p = make_codec("fp32").encode(tree)
    p.leaves[0] = make_codec("fp16").encode(tree).leaves[0]
    return p


def _stream_script(pkg):
    """Payloads of four rung families and one outside them (the fallback)
    through ``StreamAccumulator`` and ``weighted_model_sum`` under a live
    hub's staged round."""
    make_codec = j_make_codec if pkg is J else t_make_codec
    Acc, Packed, wms = ((JAcc, JPacked, j_wms) if pkg is J
                        else (TAcc, TPacked, t_wms))
    g = _to(pkg, _tree(0))
    rep = pkg.RunReport()
    tel = pkg.Telemetry(sinks=[rep])
    tel.start_run({})
    tel.begin_round(1)
    acc = Acc(g, batch_k=2, telemetry=tel)
    terms = []
    for i, spec in enumerate(["qsgd:4", "fp16", "fp32", "qsgd:4", "fp32",
                              "topk:0.5", "sign1", "mixed"]):
        tree = _to(pkg, _tree(50 + i, 0.01))
        payload = (_mixed_payload(make_codec, tree) if spec == "mixed"
                   else make_codec(spec).encode(tree))
        acc.add(payload, 0.1 * (i + 1))
        terms.append((0.1, Packed(client=i, payload=payload, origin_global=g,
                                  codec=spec, nbytes=1.0, distortion=0.0,
                                  origin_round=1)))
    acc.total()
    wms(terms, [(0.3, g)], template=g, batch_k=3, telemetry=tel, rnd=1)
    tel.end_round(1)
    return acc.stats, dict(tel.counters), rep.rounds[0]["gauges"]


def test_stream_counters_stats_and_gauges_match_jax():
    (js, jc, jg), (ts, tc, tg) = _both(_stream_script)
    assert ts == js and tc == jc and tg == jg
    assert ts["added"] == 8 and ts["fallback"] == 1 and ts["fused"] == 7
    assert set(tg) == {"uplink_fused_payloads", "uplink_fallback_payloads",
                       "uplink_peak_decoded_bytes"}


def test_broadcast_cache_counters_match_jax():
    from repro.launch.serve import PagedBroadcastCache as JCache
    from repro_torch.launch.serve import PagedBroadcastCache as TCache
    out = []
    for pkg, Cache, make_codec in ((J, JCache, j_make_codec),
                                   (T, TCache, t_make_codec)):
        tel = pkg.Telemetry()
        cache = Cache(page_bytes=256, keep_rounds=2, telemetry=tel)
        tree = _to(pkg, _tree(3))
        for rnd in range(1, 5):
            for rung in ("int8", "sign1", "int8", "fp16", "sign1"):
                cache.serve(rnd, rung,
                            lambda rung=rung: make_codec(rung).encode(tree))
        out.append((dict(tel.counters), cache.stats))
    assert out[0] == out[1]
    assert out[1][0] == {"broadcast.cache_miss": 12.0,
                         "broadcast.cache_hit": 8.0}
    assert TCache().telemetry is T.NULL_TELEMETRY


# ---------------------------------------------------------------------------
# the device sync behind the phase timers
# ---------------------------------------------------------------------------
def test_sync_waits_only_for_a_live_hub_and_a_cuda_tensor(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    tree = {"a": [torch.zeros(2)], "b": (torch.ones(1),)}
    block_until_ready(T.NULL_TELEMETRY, tree)
    block_until_ready(T.Telemetry(), tree)
    block_until_ready(T.Telemetry(), {"a": [], "b": None})
    assert calls == []


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA GPU: a CPU tensor never syncs")
@pytest.mark.gpu
def test_sync_waits_for_a_cuda_tensor_under_a_live_hub(monkeypatch):
    calls = []
    real = torch.cuda.synchronize

    def spy(device=None):
        calls.append(device)
        real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", spy)
    t = torch.zeros(3, device="cuda")
    block_until_ready(T.NULL_TELEMETRY, {"x": t})
    assert calls == []
    block_until_ready(T.Telemetry(), {"x": [t]})
    assert calls == [t.device]


def test_obs_exports_match_jax():
    public = {n for n in dir(J) if not n.startswith("_")
              and not isinstance(getattr(J, n), type(json))}
    assert public <= set(dir(T))
