"""Run telemetry through the port's runner (``FFTRunner(...,
telemetry=...)``) against the JAX package's on the same runs.

The seven combinations of ``tests/test_obs.py`` (sync, async and buffered
servers; static and adaptive codecs) run 5 rounds on ``fl.toy``'s cnn in
both packages, the port from the JAX cnn's converted init and on the JAX
runner's minibatch indices, telemetry full with an NDJSON log.  Exact
between the packages: the final outcome of every (round, client) and the
resolutions, rungs, upload and download bytes, participants, the counters
(``comm.*``, ``uplink.*``, ``sim.*``, ``buffer.*``, ``adaptive.*``),
``reconcile``'s return, the gauge names of every round (phases included)
and the health alarms.  Within a stated tolerance: β rows exactly for the
heuristic weights and within 1e-5 for FedAuto's float32 FISTA,
distortions within 1e-3·|d| + 1e-6 (``tests/test_torch_adaptive.py``),
accuracy within one test sample.  Each package's log loads in the other;
the port's sketch mode matches its full mode where ``tests/test_obs_scale.py``
holds it so, and with telemetry off a run is bitwise the run with it on,
with the same kernel calls.
"""
import copy
import json
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.core.strategies import STRATEGIES as J_STRATEGIES
from repro.fl.runtime import FFTConfig as JFFTConfig
from repro.fl.toy import make_toy_runner as j_toy
from repro_torch.convert import params_from_jax
from repro_torch.core.strategies import STRATEGIES
from repro_torch.fl.runtime import FFTConfig
from repro_torch.fl.toy import make_toy_runner
from repro_torch.kernels import ref as kref
from repro_torch.tree import tree_leaves
from test_torch_runner import JaxMinibatchIndices, _np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

BASE = dict(n_clients=6, k_selected=4, local_steps=2, batch_size=8, lr=0.05,
            seed=3, eval_every=2, deadline_s=30.0, tau_max=3, buffer_k=2,
            failure_mode="scenario:bursty_handover")
TOY = dict(n_samples=300, n_classes=4, image_size=8, public_per_class=10,
           pretrain_steps=0, seed=3)
N_TEST = TOY["n_samples"] // 5
ROUNDS = 5

# (server_mode, codec, strategy): tests/test_obs.py's COMBOS
COMBOS = [
    ("sync", "fp32", "fedavg"),
    ("sync", "qsgd:4", "fedauto"),
    ("sync", "adaptive:sign1-fp16", "fedauto"),
    ("async", "fp32", "fedasync"),
    ("async", "adaptive:sign1-fp16", "fedauto_async"),
    ("buffered", "qsgd:4", "fedbuff"),
    ("buffered", "adaptive:sign1-fp16", "fedauto_async"),
]
# the configs the runner refused before telemetry was ported: now parity
# cases, one sync FedAuto round each on the fp32 pair
CONFIGS = {"telemetry=True": dict(telemetry=True),
           "telemetry_log": dict(telemetry_log="t.ndjson")}
# β of the heuristic and staleness weights are computed the same way in
# float64; FedAuto's come from float32 FISTA in each package
BETA_ATOL = {"fedavg": 0.0, "fedasync": 0.0, "fedbuff": 0.0,
             "fedauto": 1e-5, "fedauto_async": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slug(*parts):
    return "_".join(parts).replace(":", "_").replace("-", "_")


def make_pair(codec):
    """A JAX toy runner and a port toy runner of ``BASE`` under ``codec``,
    the port from the JAX cnn's init and the JAX runner's minibatch
    indices; every run then resets the params and the selection stream on
    both, so the two index streams stay in step."""
    cfg = dict(BASE, codec=codec, telemetry=True)
    jr = j_toy(JFFTConfig(**cfg), **TOY)
    init_np = _np(jr.global_params)
    tr = make_toy_runner(FFTConfig(**cfg), **TOY, device="cpu",
                         init_fn=lambda s: params_from_jax(init_np,
                                                           device="cpu"),
                         batch_indices=JaxMinibatchIndices(cfg["seed"]))
    return jr, tr


def _run(runner, strategies, name, g0, rounds=ROUNDS, **over):
    for k, v in over.items():
        setattr(runner.cfg, k, v)
    runner.global_params = g0
    runner.rng = np.random.default_rng(42)
    hist = runner.run(strategies[name](), rounds)
    full = getattr(runner.report, "mode", "full") != "sketch"
    out = dict(hist=hist,
               view=chip_smoke.telemetry_view(runner) if full else None,
               reconcile=(J if strategies is J_STRATEGIES else T).reconcile(
                   runner.report, runner),
               report=runner.report, log=runner.cfg.telemetry_log,
               params=runner.global_params,
               accounting=(runner.comm.total_uplink_bytes,
                           runner.comm.total_downlink_bytes,
                           list(runner.loop.participants_per_round)))
    for k in over:
        setattr(runner.cfg, k, getattr(FFTConfig(**BASE), k))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every combo in both packages, grouped by codec so each pair of
    runners is built (and the JAX one compiled) once; then the two formerly
    refused configs and the port's sketch-mode run of the buffered adaptive
    combo."""
    tmp = tmp_path_factory.mktemp("telemetry")
    out = {}
    for codec in ("fp32", "qsgd:4", "adaptive:sign1-fp16"):
        jr, tr = make_pair(codec)
        jg0, tg0 = jr.global_params, tr.global_params
        for mode, c, name in COMBOS:
            if c != codec:
                continue
            both = {}
            for pkg, r, strategies, g0 in (("jax", jr, J_STRATEGIES, jg0),
                                           ("torch", tr, STRATEGIES, tg0)):
                both[pkg] = _run(r, strategies, name, g0, server_mode=mode,
                                 telemetry_log=str(
                                     tmp / f"{_slug(pkg, mode, codec, name)}"
                                           ".ndjson"))
            out[(mode, codec, name)] = both
        if codec == "fp32":
            for key, over in CONFIGS.items():
                over = dict(over)
                if "telemetry_log" in over:
                    over["telemetry"] = False
                both = {}
                for pkg, r, strategies, g0 in (
                        ("jax", jr, J_STRATEGIES, jg0),
                        ("torch", tr, STRATEGIES, tg0)):
                    if "telemetry_log" in over:
                        over["telemetry_log"] = str(tmp / f"{pkg}_{key}.ndjson")
                    both[pkg] = _run(r, strategies, "fedauto", g0, rounds=2,
                                     **over)
                out[key] = both
        if codec == "adaptive:sign1-fp16":
            # the same run in sketch and in full mode, each from a fresh
            # minibatch stream
            for key, mode in (("sketch", "sketch"), ("full", "full")):
                tr.batch_indices = JaxMinibatchIndices(BASE["seed"])
                out[key] = _run(tr, STRATEGIES, "fedauto_async", tg0,
                                server_mode="buffered", telemetry=mode,
                                telemetry_log=str(tmp / f"{key}.ndjson"))
        del jr, tr
    return out


# ---------------------------------------------------------------------------
# the seven combos against JAX
# ---------------------------------------------------------------------------
def _agree(j, t, name):
    res = chip_smoke.telemetry_agreement(j["view"], t["view"],
                                         beta_atol=BETA_ATOL[name])
    assert t["reconcile"] == j["reconcile"]
    assert len(t["hist"]) == len(j["hist"])
    for a, b in zip(t["hist"], j["hist"]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-12
    for (ra, aa), (rb, ab) in zip(t["view"]["acc"], j["view"]["acc"]):
        assert ra == rb and abs(aa - ab) <= 1.0 / N_TEST + 1e-12
    return res


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "/".join(c))
def test_flight_record_matches_jax(runs, combo):
    j, t = runs[combo]["jax"], runs[combo]["torch"]
    _agree(j, t, combo[2])
    rep = t["report"]
    assert rep.n_rounds == ROUNDS
    assert sum(rep.drop_cause_counts().values()) == BASE["n_clients"] * ROUNDS
    families = {k.split(".")[0] for k in t["view"]["counters"]}
    assert {"comm", "uplink", "sim"} <= families
    if combo[0] == "buffered":
        assert "buffer" in families
    if combo[1].startswith("adaptive:"):
        assert "adaptive" in families


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "/".join(c))
def test_phase_names_and_walls(runs, combo):
    t = runs[combo]["torch"]
    rep = t["report"]
    timers = rep.summary["timers_s"]
    phases = {k for k in timers if k.startswith("phase.")}
    assert {"phase.uplink", "phase.local_update", "phase.aggregate",
            "phase.network_draw", "phase.eval"} <= phases
    if combo[1].startswith("adaptive:"):
        assert "phase.controller" in phases
    if combo[0] == "buffered":
        assert "phase.buffer" in phases
    if combo[2].startswith("fedauto"):
        assert "phase.weight_solve" in phases
    assert phases == {k for k in runs[combo]["jax"]["report"]
                      .summary["timers_s"] if k.startswith("phase.")}
    for row in chip_smoke.phase_rows(rep):
        assert row["untimed"] >= -1e-9


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "/".join(c))
def test_logs_load_in_the_other_package(runs, combo):
    j, t = runs[combo]["jax"], runs[combo]["torch"]
    for pkg, path, mine in ((J, t["log"], t["report"]),
                            (T, j["log"], j["report"])):
        rep = pkg.load_report(path)
        assert type(rep).__name__ == "RunReport"
        assert rep.drop_cause_counts() == mine.drop_cause_counts()
        assert rep.total_upload_bytes() == mine.total_upload_bytes()
        assert rep.participants_per_round() == mine.participants_per_round()
        assert [g for g in map(sorted, (r["gauges"] for r in rep.rounds))] \
            == [sorted(r["gauges"]) for r in mine.rounds]
        assert rep.health_verdict() == mine.health_verdict()
    # the JAX log reconciles against the port run's own accounting
    acc = t["accounting"]
    T.reconcile(T.load_report(j["log"]), SimpleNamespace(
        comm=SimpleNamespace(total_uplink_bytes=acc[0],
                             total_downlink_bytes=acc[1]),
        loop=SimpleNamespace(participants_per_round=acc[2])))


@pytest.mark.parametrize("key", list(CONFIGS))
def test_telemetry_configs_run_like_jax(runs, key):
    """The two configs the port refused until run telemetry was ported."""
    j, t = runs[key]["jax"], runs[key]["torch"]
    _agree(j, t, "fedauto")
    assert t["report"].n_rounds == 2
    if key == "telemetry_log":
        assert T.load_report(t["log"]).drop_cause_counts() == \
            t["report"].drop_cause_counts()


# ---------------------------------------------------------------------------
# the trace, sketch mode, tampering
# ---------------------------------------------------------------------------
def test_trace_verifies_and_catches_tampering(tmp_path):
    path = str(tmp_path / "trace.json")
    cfg = dict(BASE, codec="qsgd:4", telemetry="full", telemetry_trace=path,
               server_mode="buffered", telemetry_console=True)
    r = make_toy_runner(FFTConfig(**cfg), **TOY, device="cpu")
    r.run(STRATEGIES["fedbuff"](), 3)
    for pkg in (J, T):
        stats = pkg.verify_trace(path, r.report)
        assert stats["rounds_checked"] == 3
    doc = json.load(open(path))
    ev = next(e for e in doc["traceEvents"]
              if e["name"].startswith("phase.") and e["ph"] == "E")
    ev["ts"] += 5e6
    bad = tmp_path / "tampered.json"
    bad.write_text(json.dumps(doc))
    for pkg in (J, T):
        # a stretched span either breaks the nesting or the telescoping
        with pytest.raises((pkg.ChromeTraceError, ValueError)):
            pkg.verify_trace(str(bad), r.report)
    rep = copy.deepcopy(r.report)
    name = next(k for k in rep.rounds[0]["gauges"] if k.startswith("phase."))
    rep.rounds[0]["gauges"][name] += 10.0
    with pytest.raises(T.ReconcileError, match="gauges sum"):
        T.reconcile(rep, r)


def test_sketch_matches_full_bit_for_bit(runs):
    full, sk = runs["full"], runs["sketch"]
    frep, srep = full["report"], sk["report"]
    assert sk["hist"] == full["hist"]
    for a, b in zip(tree_leaves(sk["params"]), tree_leaves(full["params"])):
        assert torch.equal(a, b)
    assert srep.total_upload_bytes() == frep.total_upload_bytes()
    assert srep.total_download_bytes() == frep.total_download_bytes()
    assert srep.drop_cause_counts() == frep.drop_cause_counts()
    assert srep.rung_histogram() == frep.rung_histogram()
    assert srep.participants_per_round() == frep.participants_per_round()
    for key in ("staleness", "rung", "role"):
        a, b = frep.beta_mass_by(key), srep.beta_mass_by(key)
        assert set(a) == set(b)
        assert all(a[g] == pytest.approx(b[g]) for g in a)
    assert srep.mean_distortion() == pytest.approx(frep.mean_distortion())
    assert sk["reconcile"]["uplink_bytes"] == full["reconcile"]["uplink_bytes"]
    back = T.load_report(sk["log"])
    assert type(back) is T.SketchReport
    assert J.load_report(sk["log"]).drop_cause_counts() == \
        srep.drop_cause_counts()


# ---------------------------------------------------------------------------
# telemetry off: the run is bitwise the run with it on, same kernel calls
# ---------------------------------------------------------------------------
def _counted_run(monkeypatch, mode, codec, name, telemetry):
    calls = dict.fromkeys(("float_fedagg", "dequant_fedagg", "fedagg",
                           "topk_fedagg"), 0)
    for fn in calls:
        real = getattr(kref, fn)

        def counted(*a, _fn=fn, _real=real, **k):
            calls[_fn] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kref, fn, counted)
    rng = np.random.default_rng(7)
    cfg = dict(BASE, server_mode=mode, codec=codec, telemetry=telemetry)
    r = make_toy_runner(
        FFTConfig(**cfg), **TOY, device="cpu",
        batch_indices=lambda n, E, bs: torch.as_tensor(
            rng.integers(0, n, (E, bs))))
    hist = r.run(STRATEGIES[name](), ROUNDS)
    monkeypatch.undo()
    return r, hist, calls


@pytest.mark.parametrize("combo", [("sync", "qsgd:4", "fedauto"),
                                   ("buffered", "adaptive:sign1-fp16",
                                    "fedauto_async")],
                         ids=lambda c: "/".join(c))
def test_disabled_path_bitwise_and_same_kernel_calls(monkeypatch, combo):
    r_on, h_on, c_on = _counted_run(monkeypatch, *combo, telemetry=True)
    r_off, h_off, c_off = _counted_run(monkeypatch, *combo, telemetry=False)
    assert h_off == h_on
    assert c_off == c_on and sum(c_on.values()) > 0
    for a, b in zip(tree_leaves(r_off.global_params),
                    tree_leaves(r_on.global_params)):
        assert torch.equal(a, b)
    assert r_off.report is None and r_off.telemetry is T.NULL_TELEMETRY
    assert r_off.comm.telemetry is T.NULL_TELEMETRY
    assert r_on.report is not None and math.isfinite(
        r_on.report.total_wall_s())


def test_bad_telemetry_mode_raises_like_jax():
    msgs = []
    for Cfg, toy, kw in ((JFFTConfig, j_toy, {}),
                         (FFTConfig, make_toy_runner, {"device": "cpu"})):
        r = toy(Cfg(**dict(BASE, telemetry="verbose")), **TOY, **kw)
        strategies = J_STRATEGIES if Cfg is JFFTConfig else STRATEGIES
        with pytest.raises(ValueError, match="must be False, True") as e:
            r.run(strategies["fedavg"](), 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
