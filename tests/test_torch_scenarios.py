"""The port's timing side against the JAX package's: the scenario worlds and
both timing engines (``fl.scenarios``), the arrival-timeline adapter for the
legacy failure modes (``fl.server.timeline``), trace record and replay
(``fl.scenarios.trace``, full and v5 sketch rounds) and the timing-only
population driver.  All of it is numpy, so every comparison is bitwise:
masks, arrival times, cause codes, trace bytes and round stats."""
import filecmp

import numpy as np
import pytest

from repro.fl import failures as j_failures
from repro.fl import network as j_network
from repro.fl import scenarios as j_scen
from repro.fl.scenarios import trace as j_trace
from repro.fl.server.timeline import TimedFailureAdapter as JAdapter
from repro_torch.fl import failures as t_failures
from repro_torch.fl import network as t_network
from repro_torch.fl import scenarios as t_scen
from repro_torch.fl.scenarios import trace as t_trace
from repro_torch.fl.server.timeline import TimedFailureAdapter as TAdapter

N, ROUNDS = 33, 5
WORLDS = sorted(j_scen.available_scenarios())


def _payload(n, seed):
    """Per-client wire sizes that differ, so pricing is exercised."""
    rng = np.random.default_rng(seed)
    return rng.uniform(5e4, 4e5, n), rng.uniform(1e5, 8e5, n)


def _same_events(a, b):
    np.testing.assert_array_equal(a.up_mask(), b.up_mask())
    np.testing.assert_array_equal(a.deadline_mask(), b.deadline_mask())
    np.testing.assert_array_equal(a.finish_array(), b.finish_array())
    assert a.cause_list() == b.cause_list()
    assert a.server_wait(np.ones(len(a.up_mask()), bool)) == \
        b.server_wait(np.ones(len(b.up_mask()), bool))


def test_registry_matches_jax():
    assert sorted(t_scen.available_scenarios()) == WORLDS
    assert len(WORLDS) == 8
    assert t_scen.ENGINES == j_scen.ENGINES


@pytest.mark.parametrize("engine", ["vectorized", "heap"])
@pytest.mark.parametrize("world", WORLDS)
def test_world_draws_match_jax_bitwise(world, engine):
    """Every registered world under both timing engines, n=33, 5 rounds,
    with per-client upload and download sizes: up and deadline masks,
    arrival times, cause codes and the server wait bitwise equal."""
    kw = dict(model_bytes=2e5, deadline_s=6.0, compute_s=2.0, seed=3,
              engine=engine)
    jm = j_scen.make_scenario_model(world, N, **kw)
    tm = t_scen.make_scenario_model(world, N, **kw)
    up_b, dl_b = _payload(N, 5)
    for m in (jm, tm):
        m.set_payload_bytes(upload_bytes=up_b, download_bytes=dl_b)
    for r in range(1, ROUNDS + 1):
        je, te = jm.draw_events(r), tm.draw_events(r)
        _same_events(je, te)
        codes = getattr(te, "cause_codes", None)
        if codes is not None:
            np.testing.assert_array_equal(codes, je.cause_codes)
            assert tuple(te.cause_table) == tuple(je.cause_table)


@pytest.mark.parametrize("mode", ["none", "transient", "intermittent", "mixed"])
def test_timed_adapter_matches_jax_bitwise(mode):
    """The legacy modes wrapped with synthesized arrival times (their seeds:
    ``seed + 13`` for the simulator, ``[seed + 29, 0x71D3, r]`` for the
    capacities)."""
    n, seed = 20, 4
    out = []
    for net, fail, adapter in ((j_network, j_failures, JAdapter),
                               (t_network, t_failures, TAdapter)):
        ch = net.build_network(n, seed=seed)
        rate = net.uplink_rate(4.4e5, 0.8)
        inner = fail.make_failure_model(mode, ch, rate, seed=seed)
        m = adapter(inner, ch, model_bytes=4.4e5, deadline_s=3.0,
                    compute_s=2.0, seed=seed)
        m.set_payload_bytes(upload_bytes=np.full(n, 1.1e5),
                            download_bytes=np.full(n, 4.4e5))
        out.append([m.draw_events(r) for r in range(1, 7)])
    for je, te in zip(*out):
        _same_events(je, te)


HEADER = {"scenario": "scenario:diurnal", "n_clients": N, "deadline_s": 6.0,
          "compute_s": 2.0, "model_bytes": 2e5, "codec": "adaptive:sign1-fp32",
          "upload_bytes": None, "downlink_codec": "fp32",
          "download_bytes": 2e5, "seed": 3}


def _record(scen, trace, path, mode="full", n=N, header=HEADER):
    """One realization of diurnal recorded with per-client bytes, rungs and
    distortions, as an adaptive round loop writes it."""
    m = scen.make_scenario_model("diurnal", n, model_bytes=2e5,
                                 deadline_s=6.0, compute_s=2.0, seed=3)
    up_b, _ = _payload(n, 6)
    rng = np.random.default_rng(7)
    with trace.TraceRecorder(path, dict(header, n_clients=n), mode=mode) as tr:
        for r in range(1, 4):
            ev = m.draw_events(r)
            sel = rng.random(n) < 0.7
            con = sel & ev.up_mask() & ev.deadline_mask()
            codecs = [("sign1", "int8", "fp32")[i % 3] if sel[i] else None
                      for i in range(n)]
            dist = {int(i): float(rng.random()) for i in np.where(con)[0]}
            tr.write_round(r, sel, con, ev, up=ev.up_mask(),
                           met_deadline=ev.deadline_mask(),
                           payload_bytes=up_b, download_bytes=2e5,
                           codecs=codecs, distortions=dist)
    return m


def test_trace_bytes_match_jax(tmp_path):
    """The same realization recorded by both packages is the same file."""
    jp, tp = str(tmp_path / "j.ndjson"), str(tmp_path / "t.ndjson")
    _record(j_scen, j_trace, jp)
    _record(t_scen, t_trace, tp)
    assert filecmp.cmp(jp, tp, shallow=False)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trace_replays_across_packages(tmp_path, writer):
    """A trace recorded by one package replays in the other: events, byte
    vectors, rungs and distortions bitwise equal to the live draw."""
    path = str(tmp_path / f"{writer}.ndjson")
    scen, trace = (j_scen, j_trace) if writer == "jax" else (t_scen, t_trace)
    live = _record(scen, trace, path)
    jrep = j_scen.ReplayFailureModel(path, n_clients=N)
    trep = t_scen.ReplayFailureModel(path, n_clients=N)
    assert trep.header == jrep.header and trep.codec == jrep.codec
    live.reset()
    for r in range(1, 4):
        _same_events(trep.draw_events(r), live.draw_events(r))
        _same_events(trep.draw_events(r), jrep.draw_events(r))
        np.testing.assert_array_equal(trep.payload_bytes(r),
                                      jrep.payload_bytes(r))
        assert trep.codecs(r) == jrep.codecs(r)
        np.testing.assert_array_equal(trep.distortions(r),
                                      jrep.distortions(r))


def test_failure_mode_replay_reads_the_trace(tmp_path):
    path = str(tmp_path / "t.ndjson")
    _record(t_scen, t_trace, path)
    ch = t_network.build_network(N, seed=3)
    m = t_failures.make_failure_model(f"replay:{path}", ch, 1e6, seed=3)
    assert isinstance(m, t_scen.ReplayFailureModel)
    with pytest.raises(ValueError):
        t_failures.make_failure_model("scenario:no_such_world", ch, 1e6,
                                      model_bytes=2e5, deadline_s=6.0)


def test_sketch_round_verifies_under_both_packages(tmp_path):
    """n=5,000 records v5 sketch rounds (at or above
    ``TRACE_SKETCH_THRESHOLD``); both packages regenerate the realization
    from the header and verify every round, and the files are identical."""
    n = 5000
    assert t_trace.TRACE_SKETCH_THRESHOLD == j_trace.TRACE_SKETCH_THRESHOLD \
        <= n
    hdr = dict(HEADER, codec="fp32", upload_bytes=2e5)
    jp, tp = str(tmp_path / "j.ndjson"), str(tmp_path / "t.ndjson")
    _record(j_scen, j_trace, jp, mode="auto", n=n, header=hdr)
    _record(t_scen, t_trace, tp, mode="auto", n=n, header=hdr)
    assert filecmp.cmp(jp, tp, shallow=False)
    thdr, trounds = t_trace.load_trace(tp)
    assert thdr.get("mode") == "sketch" and "clients" not in trounds[1]
    tmodel = t_trace.regenerate_model(thdr)
    jmodel = j_trace.regenerate_model(thdr)
    for rec in trounds.values():
        assert t_trace.verify_sketch_round(tmodel, rec)
        assert j_trace.verify_sketch_round(jmodel, rec)
    wrong = t_trace.regenerate_model({**thdr, "seed": thdr["seed"] + 1})
    assert not all(t_trace.verify_sketch_round(wrong, rec)
                   for rec in trounds.values())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(k_selected=300),
    dict(adaptive="adaptive:sign1-fp32"),
    dict(adaptive="adaptive:sign1-fp32", skip_stragglers=True,
         k_selected=500),
])
def test_population_stats_match_jax(kw):
    """``simulate_population`` at n=2,000: equal ``PopulationRoundStats``
    every round (selection from ``seed + 17``, the controller priced by
    exact codec byte counts of a shape-only template)."""
    args = ("diurnal", 2000, 4)
    opts = dict(model_bytes=4.4e7, deadline_s=25.0, seed=2, **kw)
    js = j_scen.simulate_population(*args, **opts)
    ts = t_scen.simulate_population(*args, **opts)
    assert [vars(s) for s in ts] == [vars(s) for s in js]
    if kw.get("skip_stragglers"):
        assert sum(s.n_skipped for s in ts) > 0
