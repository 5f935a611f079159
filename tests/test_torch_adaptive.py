"""The port's adaptive codec controller (``fl.comm.adaptive``) against the
JAX package's: the rung assignments and byte vectors it derives round by
round from the same events (exact), its state files (readable across the
packages), straggler skipping in the selection draw, and FedAuto and
FedAuto-Async under ``adaptive:sign1-fp32``, 3 rounds, on the cnn of
``tests/test_torch_async.py``.

One adaptive round mixes the fp32 rung with lossy ones (sign1 up to fp16),
which quantize (w − w̄) + residual, so fp32 noise between the frameworks
can put an element on either side of a rounding boundary.  The
runs are held to ``chip_smoke.quantized_agreement`` (every element within
1e-4, or within 1e-4 plus one step of its leaf for at most 1% of it),
with participants, staleness and the rung of every upload exactly equal."""
import filecmp
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.fl import scenarios as j_scen
from repro.fl.comm import AdaptiveCommController as JController
from repro.fl.comm import CommState as JCommState
from repro.fl.comm import make_codec as j_make_codec
from repro_torch.convert import params_from_jax
from repro_torch.fl.comm import (RUNG_LADDER, AdaptiveCommController,
                                 CommState, is_adaptive_spec, ladder_between,
                                 make_codec, parse_adaptive_spec)
from repro_torch.tree import tree_leaves
from test_torch_async import BASE, SCEN, _np, _run, make_pair

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

N = 24



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These runs are many small CPU ops; run several test files at once
    (pytest-xdist) and torch's intra-op thread pool only oversubscribes the
    cores, so the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _template(seed=0):
    rng = np.random.default_rng(seed)
    return {"conv": {"w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                     "b": rng.normal(size=(8,)).astype(np.float32)},
            "fc": {"w": rng.normal(size=(128, 10)).astype(np.float32)}}


def _controllers(lo="sign1", hi="fp32", model_bytes=4.4e7, deadline_s=25.0):
    tmpl = _template()
    jc = JCommState(j_make_codec(hi), jax.tree.map(jax.numpy.asarray, tmpl),
                    model_bytes_override=model_bytes, n_clients=N)
    tc = CommState(make_codec(hi), params_from_jax(tmpl, device="cpu"),
                   model_bytes_override=model_bytes, n_clients=N)
    kw = dict(lo=lo, hi=hi, deadline_s=deadline_s, compute_s=2.0)
    return JController(N, jc, **kw), AdaptiveCommController(N, tc, **kw)


def test_spec_parsing_matches_jax():
    from repro.fl.comm import adaptive as ja
    assert RUNG_LADDER == ja.RUNG_LADDER
    for spec in ("adaptive", "adaptive:sign1-fp16", "adaptive:qsgd:4-fp32"):
        assert is_adaptive_spec(spec)
        if spec.count(":") < 2:
            assert parse_adaptive_spec(spec) == ja.parse_adaptive_spec(spec)
    assert ladder_between("qsgd:2", "int8") == ja.ladder_between("qsgd:2",
                                                                 "int8")
    for bad in ("adaptive:fp32-sign1", "adaptive:sign1", "adaptive:x-fp32"):
        with pytest.raises(ValueError):
            parse_adaptive_spec(bad)
        with pytest.raises(ValueError):
            ja.parse_adaptive_spec(bad)


@pytest.mark.parametrize("lo,hi", [("sign1", "fp32"), ("qsgd:2", "fp16")])
def test_assignments_match_jax_every_round(lo, hi):
    """Both controllers price the same rungs, assign the same rung to every
    client and learn the same capacities from the same diurnal events,
    round by round (the enrollment broadcast in round 1 included)."""
    jc, tc = _controllers(lo, hi)
    np.testing.assert_array_equal(tc.rung_bytes, jc.rung_bytes)
    model = j_scen.make_scenario_model("diurnal", N, model_bytes=4.4e7,
                                       deadline_s=25.0, seed=1)
    rng = np.random.default_rng(3)
    for r in range(1, 9):
        sel = rng.random(N) < 0.75
        dl = 4.4e7 if r == 1 else None
        ja, ta = jc.assign(r, sel, download_bytes=dl), tc.assign(
            r, sel, download_bytes=dl)
        np.testing.assert_array_equal(ta.rung_idx, ja.rung_idx)
        np.testing.assert_array_equal(ta.upload_bytes, ja.upload_bytes)
        assert ta.codecs == ja.codecs and ta.download_bytes == ja.download_bytes
        model.set_payload_bytes(upload_bytes=ja.upload_bytes,
                                download_bytes=np.full(N, ja.download_bytes))
        ev = model.draw_events(r)
        jc.observe(r, ev, sel)
        tc.observe(r, ev, sel)
        np.testing.assert_array_equal(tc.cap_hat, jc.cap_hat)
        np.testing.assert_array_equal(tc.landable_mask(), jc.landable_mask())
    assert tc.rung_histogram() == jc.rung_histogram()
    assert len(set(ta.codecs)) > 1             # the ladder is really used


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_files_load_across_packages(tmp_path, writer):
    jc, tc = _controllers()
    tc.cap_hat = jc.cap_hat = np.linspace(1e5, 9e7, N)
    tc.n_success, tc.n_miss = jc.n_success, jc.n_miss = 11, 7
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jc.save_state(jp)
    tc.save_state(tp)
    assert filecmp.cmp(jp, tp, shallow=False)
    src = jp if writer == "jax" else tp
    jn, tn = _controllers()
    jn.load_state(src)
    tn.load_state(src)
    np.testing.assert_array_equal(tn.cap_hat, jn.cap_hat)
    assert (tn.n_success, tn.n_miss) == (jn.n_success, jn.n_miss) == (11, 7)
    small = AdaptiveCommController(N - 1, CommState(
        make_codec("fp32"), params_from_jax(_template(), device="cpu")),
        lo="sign1", hi="fp32", deadline_s=25.0)
    with pytest.raises(ValueError, match="clients"):
        small.load_state(src)


def test_population_controller_prices_a_meta_template():
    """``simulate_population``'s synthetic comm prices rungs from a
    shape-only template: exact codec byte counts, nothing allocated."""
    from repro.fl.scenarios.population import _SyntheticComm as J
    from repro_torch.fl.scenarios.population import _SyntheticComm as T
    j, t = J(4.4e7), T(4.4e7)
    assert t._template["w"].device.type == "meta"
    for rung in RUNG_LADDER:
        assert t.nbytes_for(rung) == j.nbytes_for(rung)
    assert t.download_bytes == j.download_bytes


# ---------------------------------------------------------------------------
# runner parity under adaptive:sign1-fp32
# ---------------------------------------------------------------------------
ADAPTIVE = dict(codec="adaptive:sign1-fp32")


@pytest.fixture(scope="module")
def adaptive_runs():
    cfg = dict(BASE, **SCEN, **ADAPTIVE)
    jr, tr = make_pair(cfg)
    assert jr.comm.codec.name == tr.comm.codec.name == "fp32"
    assert tr.downlink_codec_resolved == jr.downlink_codec_resolved == "fp32"
    step_lists = chip_smoke.record_rung_steps(tr.comm, tr.controller.rungs)
    jg0, tg0 = jr.global_params, tr.global_params
    out = {}
    for mode, name in (("sync", "fedauto"), ("async", "fedauto_async")):
        for rows in step_lists:
            del rows[:]
        j = _run(jr, name, jg0, rounds=3, server_mode=mode)
        j["rungs"] = [jr.controller.assignments[r].codecs for r in (1, 2, 3)]
        j["dist"] = list(jr.loop.distortion_history)
        t = _run(tr, name, tg0, rounds=3, server_mode=mode)
        t["rungs"] = [tr.controller.assignments[r].codecs for r in (1, 2, 3)]
        t["dist"] = list(tr.loop.distortion_history)
        out[mode] = dict(jax=j, torch=t,
                         steps=[row for rows in step_lists for row in rows])
    return out


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_adaptive_fedauto_matches_jax(adaptive_runs, mode):
    run = adaptive_runs[mode]
    j, t = run["jax"], run["torch"]
    assert t["rungs"] == j["rungs"]
    for key in ("participants", "staleness", "unreachable", "clock"):
        assert t[key] == j[key], key
    used = {c for rnd in t["rungs"] for c in rnd}
    assert {"sign1", "fp32"} & used and len(used) > 1
    for tp, jp in zip(t["snaps"], j["snaps"]):
        res = chip_smoke.quantized_agreement(
            [x.numpy() for x in tree_leaves(tp)], jax.tree.leaves(_np(jp)),
            run["steps"] or [[0.0] * len(tree_leaves(tp))])
        assert res["ok"], res
    for td, jd in zip(t["dist"], j["dist"]):
        assert td.keys() == jd.keys()
        for c in td:
            assert abs(td[c] - jd[c]) <= 1e-3 * max(jd[c], 1e-6) + 1e-6


def test_skip_stragglers_selects_like_jax():
    """With ``skip_stragglers``, clients whose estimate cannot land the
    lowest rung leave the draw: the same clients are skipped and the same
    K are drawn from the rest (``rng.choice(eligible, k)``)."""
    cfg = dict(BASE, **dict(SCEN, deadline_s=2.5), **ADAPTIVE,
               skip_stragglers=True, k_selected=4)
    jr, tr = make_pair(cfg)
    j = _run(jr, "fedauto", jr.global_params, rounds=4)
    t = _run(tr, "fedauto", tr.global_params, rounds=4)
    for r in range(1, 5):
        np.testing.assert_array_equal(tr.controller.assignments[r].selected,
                                      jr.controller.assignments[r].selected)
    assert tr.loop.n_skipped == jr.loop.n_skipped > 0
    assert t["participants"] == j["participants"]


@pytest.mark.parametrize("rung", RUNG_LADDER)
def test_every_rung_lands_in_a_stream_bucket_like_jax(rung):
    """Each rung of the ladder buckets into a batched family (fp32, fp16 or
    the quantized one), as in JAX: an adaptive round fills at most three
    buckets, and no rung takes the per-payload fallback."""
    from repro.fl.comm.stream import payload_family as j_family
    from repro_torch.fl.comm.stream import payload_family
    tmpl = _template()
    tp = make_codec(rung).encode(params_from_jax(tmpl, device="cpu"))
    jp = j_make_codec(rung).encode(jax.tree.map(jax.numpy.asarray, tmpl))
    fam = payload_family(tp)
    assert fam == j_family(jp)
    assert fam == {"fp32": "fp32", "fp16": "fp16"}.get(rung, "quant")
