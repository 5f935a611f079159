"""The port's asynchronous server (``fl.server``: ``StalenessBuffer``,
``AsyncRoundLoop``) and the async strategy family (FedAsync, FedBuff,
FedAuto-Async) against the JAX package's.

The runner cases mirror ``tests/test_async_server.py``: the cnn of
``fl.toy.make_toy_runner`` (8×8 images, 6 clients, E=2) for 4 rounds under
``scenario:diurnal`` with a 3 s deadline, tight enough that some uploads
land one or two aggregation steps late and one never lands inside the
staleness horizon.  The port starts from the JAX cnn's converted init and
takes the JAX runner's minibatch indices.  Every round, every leaf of the
global params agrees within 1e-4 (convolution summation order differs
between the frameworks); participants, applied staleness, unreachable and
evicted counts and the simulated clock of every evaluation are exactly
equal, and the accuracies agree within one test sample.  The int8
downlink run is held to ``chip_smoke.quantized_agreement``."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.aggregation import fedauto_async_weights as j_async_weights
from repro.core.strategies import STRATEGIES as J_STRATEGIES
from repro.fl.runtime import FFTConfig as JFFTConfig
from repro.fl.server import PendingUpdate as JPending
from repro.fl.server import StalenessBuffer as JBuffer
from repro.fl.toy import make_toy_runner as j_toy
from repro.models.vision import make_model as j_make_model
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import fedauto_async_weights, fedauto_weights
from repro_torch.core.strategies import STRATEGIES
from repro_torch.fl.runtime import FFTConfig
from repro_torch.fl.server import PendingUpdate, StalenessBuffer
from repro_torch.fl.toy import make_toy_runner
from repro_torch.tree import tree_leaves
from test_torch_runner import JaxMinibatchIndices, _np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

BASE = dict(n_clients=6, k_selected=6, local_steps=2, batch_size=8, lr=0.05,
            seed=0, eval_every=1, model_bytes=0.2e6)
TOY = dict(n_samples=600, public_per_class=10, pretrain_steps=9)
N_TEST = 120                            # n_samples // 5
SCEN = dict(failure_mode="scenario:diurnal", deadline_s=3.0, tau_max=4)
ROUNDS = 4



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These runs are many small CPU ops; run several test files at once
    (pytest-xdist) and torch's intra-op thread pool only oversubscribes the
    cores, so the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# StalenessBuffer invariants (tests/test_async_server.py), on both buffers
# ---------------------------------------------------------------------------
def _no_double_apply(B, P):
    buf = B(tau_max=3)
    buf.push(P(client=0, origin_round=1, arrival_s=5.0, model="m"))
    with pytest.raises(ValueError, match="twice"):
        buf.push(P(client=0, origin_round=1, arrival_s=6.0, model="m"))
    got = buf.collect(now_s=10.0, current_round=2)
    assert [e.client for e in got] == [0]
    assert buf.collect(now_s=100.0, current_round=3) == []
    return [e.client for e in got]


def _arrival_order(B, P):
    buf = B(tau_max=5)
    for c, t in ((2, 9.0), (1, 4.0), (3, 30.0)):
        buf.push(P(client=c, origin_round=1, arrival_s=t, model=c))
    got = buf.collect(now_s=10.0, current_round=2)
    assert [e.client for e in got] == [1, 2] and len(buf) == 1
    assert buf.collect(now_s=31.0, current_round=3)[0].client == 3
    return [e.client for e in got]


def _tau_bound(B, P):
    buf = B(tau_max=2)
    buf.push(P(client=0, origin_round=1, arrival_s=1.0, model=0))
    buf.push(P(client=1, origin_round=1, arrival_s=2.0, model=1))
    assert buf.collect(now_s=100.0, current_round=5) == [] and len(buf) == 0
    assert buf.n_evicted == 2
    buf.push(P(client=2, origin_round=5, arrival_s=3.0, model=2))
    got = buf.collect(now_s=100.0, current_round=7)
    assert [e.staleness(7) for e in got] == [2]
    return buf.n_evicted, buf.n_applied


def _evict_and_ready(B, P):
    buf = B(tau_max=2)
    for c, o, t in ((0, 1, 1.0), (1, 3, 2.0), (2, 3, 99.0)):
        buf.push(P(client=c, origin_round=o, arrival_s=t, model=c))
    assert buf.ready_count(now_s=10.0, current_round=4) == 1
    assert buf.evict(current_round=4) == 1
    assert sorted(e.client for e in buf.pending()) == [1, 2]
    return buf.n_evicted


def _churn(B, P):
    buf = B(tau_max=4)
    for origin in (1, 2, 3):
        buf.push(P(client=7, origin_round=origin, arrival_s=10.0 * origin,
                   model=origin))
    buf.push(P(client=3, origin_round=2, arrival_s=5.0, model=0))
    assert buf.drop_client(7) == 3
    assert [e.client for e in buf.pending()] == [3]
    buf.reset()
    assert len(buf) == 0 and buf.n_evicted == 0
    return 3


def _negative_tau(B, P):
    with pytest.raises(ValueError, match="tau_max"):
        B(tau_max=-1)
    return None


@pytest.mark.parametrize("invariant", [_no_double_apply, _arrival_order,
                                       _tau_bound, _evict_and_ready, _churn,
                                       _negative_tau],
                         ids=lambda f: f.__name__.strip("_"))
def test_buffer_invariants_match_jax(invariant):
    assert invariant(StalenessBuffer, PendingUpdate) == \
        invariant(JBuffer, JPending)


# ---------------------------------------------------------------------------
# FedAuto-Async weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fedauto_async_weights_match_jax(seed, monkeypatch):
    """The weights within 1e-5 of JAX: both solve the QP by 400 float32
    FISTA steps, whose rounding differs between the frameworks in the
    sixth decimal.  Given the same QP solution, the staleness discount and
    the redistribution of the free mass (float64) agree within 1e-9.
    Fresh arrivals are exactly the synchronous weights."""
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as tagg
    rng = np.random.default_rng(seed)
    J, C = 4 + seed, 5 + seed
    alpha = rng.dirichlet(np.ones(C) * 0.5, size=J)
    alpha_g = rng.dirichlet(np.ones(J)) @ alpha
    stale = rng.integers(0, 4, J)
    stale[0] = 0
    stale[1] = max(stale[1], 1)
    want = j_async_weights(alpha, alpha_g, stale, 0)
    got = fedauto_async_weights(alpha, alpha_g, stale, 0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(got[0] - 1.0 / J) < 1e-6 and abs(got.sum() - 1.0) < 1e-6
    qp = jagg.fedauto_weights(alpha, alpha_g, np.ones(J, bool), 0)
    monkeypatch.setattr(tagg, "fedauto_weights", lambda *a, **k: qp)
    np.testing.assert_allclose(
        fedauto_async_weights(alpha, alpha_g, stale, 0, device="cpu"), want,
        rtol=0, atol=1e-9)
    monkeypatch.undo()
    fresh = fedauto_async_weights(alpha, alpha_g, np.zeros(J, int), 0,
                                  device="cpu")
    np.testing.assert_array_equal(
        fresh, fedauto_weights(alpha, alpha_g, np.ones(J, bool), 0,
                               device="cpu"))


# ---------------------------------------------------------------------------
# runner parity against JAX
# ---------------------------------------------------------------------------
def make_pair(cfg):
    """One JAX toy runner and one port toy runner from the JAX cnn's init
    and the JAX runner's minibatch indices."""
    init_np = _np(j_make_model("cnn", 4, 8, 1)[0](jax.random.PRNGKey(0)))
    jr = j_toy(JFFTConfig(**cfg), **TOY)
    tr = make_toy_runner(FFTConfig(**cfg), **TOY, device="cpu",
                         init_fn=lambda s: params_from_jax(init_np,
                                                           device="cpu"),
                         batch_indices=JaxMinibatchIndices(cfg["seed"]))
    return jr, tr


def _run(runner, name, g0, rounds=ROUNDS, **over):
    """``rounds`` rounds of strategy ``name`` from ``g0`` under config
    overrides, with the same selection stream each time."""
    for k, v in over.items():
        setattr(runner.cfg, k, v)
    runner.global_params = g0
    runner.rng = np.random.default_rng(42)
    snaps = []
    strategies = J_STRATEGIES if hasattr(runner, "_key") else STRATEGIES
    hist = runner.run(strategies[name](), rounds,
                      log=lambda r, a: snaps.append(runner.global_params))
    loop = runner.loop
    buf = getattr(loop, "buffer", None)
    return dict(hist=hist, snaps=snaps,
                participants=list(loop.participants_per_round),
                staleness=list(getattr(loop, "staleness_applied", [])),
                unreachable=getattr(loop, "n_unreachable", 0),
                evicted=buf.n_evicted if buf is not None else 0,
                clock=[(p.rnd, p.t_s) for p in runner.timeline],
                streaming=loop.streaming)


# (case, strategy, config overrides): every case from one shared pair
CASES = {
    "async fedauto_async": ("fedauto_async", dict(server_mode="async")),
    "async fedauto_async off": ("fedauto_async", dict(server_mode="async",
                                                      streaming_agg="off")),
    "async fedasync": ("fedasync", dict(server_mode="async")),
    "async fedasync off": ("fedasync", dict(server_mode="async",
                                            streaming_agg="off")),
    "async fedbuff": ("fedbuff", dict(server_mode="async")),
    "async fedbuff off": ("fedbuff", dict(server_mode="async",
                                          streaming_agg="off")),
    "buffered fedauto_async": ("fedauto_async", dict(server_mode="buffered")),
    # a short horizon and a large batch: deferred rounds evict uploads
    "buffered fedauto_async evicting": ("fedauto_async", dict(
        server_mode="buffered", tau_max=1, buffer_k=7)),
    "sync fedauto_async": ("fedauto_async", dict(server_mode="sync")),
}


@pytest.fixture(scope="module")
def runs():
    cfg = dict(BASE, **SCEN)
    jr, tr = make_pair(cfg)
    jg0, tg0 = jr.global_params, tr.global_params
    out = {}
    for case, (name, over) in CASES.items():
        over = dict(dict(streaming_agg="auto", tau_max=4, buffer_k=4), **over)
        out[case] = dict(jax=_run(jr, name, jg0, **over),
                         torch=_run(tr, name, tg0, **over))
    return out


def _leaves_close(tsnap, jsnap, atol=1e-4):
    tl, jl = tree_leaves(tsnap), jax.tree.leaves(_np(jsnap))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_async_runner_matches_jax_every_round(runs, case):
    j, t = runs[case]["jax"], runs[case]["torch"]
    assert len(j["snaps"]) == len(t["snaps"]) == ROUNDS
    for tp, jp in zip(t["snaps"], j["snaps"]):
        _leaves_close(tp, jp)
    for key in ("participants", "staleness", "unreachable", "evicted",
                "clock", "streaming"):
        assert t[key] == j[key], (key, t[key], j[key])
    for a, b in zip(t["hist"], j["hist"]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-12


def test_cases_cover_staleness_and_eviction(runs):
    """The deadline makes late uploads land stale (up to two steps), one
    upload is unreachable, the evicting case evicts, and the streaming
    cases really stream."""
    t = {c: runs[c]["torch"] for c in CASES}
    stale = t["async fedauto_async"]["staleness"]
    assert 0 in stale and max(stale) >= 2
    assert t["async fedauto_async"]["unreachable"] >= 1
    assert t["buffered fedauto_async evicting"]["evicted"] > 0
    assert 0 in t["buffered fedauto_async"]["participants"]   # deferred
    assert t["async fedbuff"]["streaming"]
    assert not t["async fedbuff off"]["streaming"]


def test_async_fedbuff_int8_downlink_matches_jax():
    """Stale uploads whose origin globals are decoded int8 replicas: the
    replica must never move under a held upload.  Held to
    ``chip_smoke.quantized_agreement``."""
    cfg = dict(BASE, **SCEN, server_mode="async", downlink_codec="int8")
    jr, tr = make_pair(cfg)
    steps = chip_smoke.record_steps(jr.comm.downlink_codec)
    j = _run(jr, "fedbuff", jr.global_params)
    t = _run(tr, "fedbuff", tr.global_params)
    for tp, jp in zip(t["snaps"], j["snaps"]):
        res = chip_smoke.quantized_agreement(
            [x.numpy() for x in tree_leaves(tp)],
            jax.tree.leaves(_np(jp)), steps)
        assert res["ok"], res
    for key in ("participants", "staleness", "unreachable", "clock"):
        assert t[key] == j[key], key
    assert max(t["staleness"]) > 0


def test_async_under_legacy_mixed_failures_matches_jax():
    """A legacy boolean mode under the async server: both runners wrap it in
    ``TimedFailureAdapter`` and synthesize the same arrival times."""
    cfg = dict(BASE, failure_mode="mixed", deadline_s=3.0, tau_max=4,
               server_mode="async")
    jr, tr = make_pair(cfg)
    assert type(tr.failures).__name__ == "TimedFailureAdapter"
    j = _run(jr, "fedauto_async", jr.global_params, rounds=3)
    t = _run(tr, "fedauto_async", tr.global_params, rounds=3)
    for tp, jp in zip(t["snaps"], j["snaps"]):
        _leaves_close(tp, jp)
    for key in ("participants", "staleness", "unreachable", "clock"):
        assert t[key] == j[key], key


# ---------------------------------------------------------------------------
# the port alone: sync ≡ async without deadline pressure; replay
# ---------------------------------------------------------------------------
def _tiny(cfg):
    return make_toy_runner(FFTConfig(**cfg), **TOY, device="cpu")


@pytest.mark.parametrize("sync_name,async_name", [("fedavg", "fedavg"),
                                                  ("fedauto", "fedauto_async")])
def test_sync_async_equivalent_under_infinite_deadline(sync_name, async_name):
    """With no deadline pressure nothing is late, so the async server
    degenerates to the synchronous one: equal parameters, bitwise."""
    out = {}
    for mode, name in (("sync", sync_name), ("async", async_name)):
        cfg = dict(BASE, failure_mode="scenario:correlated_wifi",
                   deadline_s=1e9, server_mode=mode, eval_every=2)
        r = _tiny(cfg)
        hist = r.run(STRATEGIES[name](), 3)
        out[mode] = (hist, [x.clone() for x in tree_leaves(r.global_params)])
    assert out["sync"][0] == out["async"][0]
    for a, b in zip(out["sync"][1], out["async"][1]):
        assert bool((a == b).all())


def test_async_record_then_replay_twice_bitwise(tmp_path):
    """An async run replayed from its recorded trace: the same masks,
    staleness and parameters, bitwise, on the CPU, twice."""
    path = str(tmp_path / "async.ndjson")
    cfg = dict(BASE, **SCEN, server_mode="async")
    outs = []
    for over in (dict(trace_record=path), dict(trace_replay=path),
                 dict(trace_replay=path)):
        r = _tiny(dict(cfg, **over))
        hist = r.run(STRATEGIES["fedauto_async"](), 3)
        outs.append((hist, list(r.loop.staleness_applied),
                     list(r.loop.participants_per_round),
                     [x.clone() for x in tree_leaves(r.global_params)]))
    for other in outs[1:]:
        assert other[:3] == outs[0][:3]
        for a, b in zip(other[3], outs[0][3]):
            assert bool((a == b).all())
    with pytest.raises(ValueError, match="codec"):
        _tiny(dict(cfg, trace_replay=path, codec="int8"))


def test_fedbuff_step_leaves_the_held_origin_untouched():
    """FedBuff's step builds a new tree: the global a held upload refers to
    is not updated in place."""
    r = _tiny(dict(BASE, **SCEN, server_mode="async"))
    g0 = [x.clone() for x in tree_leaves(r.global_params)]
    held = r.global_params
    r.run(STRATEGIES["fedbuff"](), 2)
    for a, b in zip(tree_leaves(held), g0):
        assert bool((a == b).all())
