"""The paper's baseline strategies and FedAuto's Table-5 ablations in the
port (``repro_torch.core.strategies``) against the JAX package's, on the
harness of ``tests/test_torch_runner.py``: the cnn on 16x16x1 images, 6
clients with 4 selected, mixed failures, the same split, pretrained start
and minibatch indices.  Each run is 2 rounds from the same ``rng`` state;
every leaf of the global params must agree within 1e-4 after each round
and the accuracy histories within one test sample, with identical
participants.  The strategies' own state (SCAFFOLD's control variates,
TF-Aggregation's selection probabilities, FedAWE's last-seen rounds) and
the runner's outage estimates are held too; then SCAFFOLD and FedLAW one
round each in LoRA mode on the harness of ``tests/test_torch_lora_runner.py``."""
import jax
import numpy as np
import pytest
import torch

import test_torch_lora_runner as lora_harness
from repro.core import aggregation as jagg
from repro.core import strategies as jstrat
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.core import strategies as tstrat
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves
from test_torch_runner import CFG, N_TEST, _np, make_pair

ROUNDS = 2
ASYNC = {"fedasync", "fedbuff", "fedauto_async"}

# run name -> strategy from a strategies module (JAX's or the port's)
RUNS = {
    "fedprox": lambda m: m.FedProx(),
    "scaffold": lambda m: m.Scaffold(),
    "fedlaw": lambda m: m.FedLAW(),
    "tf_aggregation": lambda m: m.TFAggregation(),
    "fedawe": lambda m: m.FedAWE(),
    "centralized_public": lambda m: m.CentralizedPublic(),
    "fedauto_m1_off_m2_off": lambda m: m.FedAuto(use_module1=False,
                                                 use_module2=False),
    "fedauto_m1_on_m2_off": lambda m: m.FedAuto(use_module1=True,
                                                use_module2=False),
    "fedauto_m1_off_m2_on": lambda m: m.FedAuto(use_module1=False,
                                                use_module2=True),
}


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [t.numpy() for t in tree_leaves(tree)]


def _state(strategy, leaves):
    """A copy of the strategy's own state after a round."""
    if strategy.name == "scaffold":
        return dict(c=leaves(strategy.c),
                    c_i={i: leaves(t) for i, t in strategy.c_i.items()})
    if strategy.name == "tf_aggregation":
        return dict(s=np.array(strategy.s))
    if strategy.name == "fedawe":
        return dict(tau=strategy.tau.copy())
    return {}


def _run(runner, strategy, rounds, g0, leaves):
    runner.global_params = g0
    runner.rng = np.random.default_rng(42)
    snaps = []

    def log(r, acc):
        snaps.append((leaves(runner.global_params), _state(strategy, leaves)))

    hist = runner.run(strategy, rounds, log=log)
    return dict(hist=hist, snaps=snaps,
                participants=list(runner.loop.participants_per_round),
                streaming=runner.loop.streaming)


@pytest.fixture(scope="module")
def runs():
    jr, tr = make_pair(CFG)
    jg0, tg0 = jr.global_params, tr.global_params
    out = {"eps": (jr.eps_estimates, tr.eps_estimates), "launches": {}}
    for name, make in RUNS.items():
        before = dict(ops.launches)
        out[name] = dict(jax=_run(jr, make(jstrat), ROUNDS, jg0, _jax_leaves),
                         torch=_run(tr, make(tstrat), ROUNDS, tg0,
                                    _torch_leaves))
        out["launches"][name] = {k: ops.launches[k] - before[k]
                                 for k in ops.launches}
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_global_params_match_jax_after_every_round(runs, name):
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert len(j["snaps"]) == len(t["snaps"]) == ROUNDS
    for (jl, _), (tl, _) in zip(j["snaps"], t["snaps"]):
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(RUNS))
def test_accuracy_history_and_participation_match_jax(runs, name):
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert t["participants"] == j["participants"]
    assert t["streaming"] == j["streaming"]
    assert len(t["hist"]) == len(j["hist"]) == ROUNDS
    for a, b in zip(t["hist"], j["hist"]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-12


def test_rounds_see_partial_cohorts(runs):
    """Selection and failures leave partial cohorts, so the strategies'
    per-client paths (missed rounds, unselected variates) are exercised."""
    seen = [n for name in RUNS for n in runs[name]["torch"]["participants"]]
    assert min(seen) < CFG["k_selected"] and max(seen) >= 2


def test_scaffold_control_variates_match_jax(runs):
    """c and every c_i within 1e-4 of JAX's after each round; clients that
    never delivered keep the shared zeros, the others moved."""
    j, t = runs["scaffold"]["jax"], runs["scaffold"]["torch"]
    for (_, js), (_, ts) in zip(j["snaps"], t["snaps"]):
        for a, b in zip(ts["c"], js["c"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        assert sorted(ts["c_i"]) == sorted(js["c_i"]) == list(range(6))
        for i in ts["c_i"]:
            for a, b in zip(ts["c_i"][i], js["c_i"][i]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    last = t["snaps"][-1][1]["c_i"]
    moved = [i for i in last if any(np.any(a != 0) for a in last[i])]
    assert 0 < len(moved) < 6, moved


def test_tf_aggregation_selection_probs_match_jax(runs):
    j, t = runs["tf_aggregation"]["jax"], runs["tf_aggregation"]["torch"]
    for (_, js), (_, ts) in zip(j["snaps"], t["snaps"]):
        np.testing.assert_allclose(ts["s"], js["s"], rtol=0, atol=1e-12)
    s = t["snaps"][-1][1]["s"]
    assert abs(s.sum() - 1.0) < 1e-12 and (s > 0).any()


def test_fedawe_last_seen_rounds_match_jax(runs):
    j, t = runs["fedawe"]["jax"], runs["fedawe"]["torch"]
    for (_, js), (_, ts) in zip(j["snaps"], t["snaps"]):
        np.testing.assert_array_equal(ts["tau"], js["tau"])
    assert t["snaps"][-1][1]["tau"].max() == ROUNDS


def test_eps_estimates_are_bit_equal(runs):
    j_eps, t_eps = runs["eps"]
    assert j_eps.dtype == t_eps.dtype and j_eps.shape == t_eps.shape == (6,)
    assert np.array_equal(j_eps, t_eps)
    assert (t_eps > 0).any() and (t_eps == 0).any()   # wireless and wired


def test_cpu_runs_launch_no_kernel(runs):
    """CPU tensors take the plain versions, which are never counted; the
    counts on the card are checked by ``chip_smoke.py``."""
    for name in RUNS:
        assert set(runs["launches"][name].values()) == {0}, name


def test_fresh_strategy_state_per_run():
    """``init_state`` resets TF-Aggregation's cached probabilities and
    FedAWE's last-seen rounds, and SCAFFOLD's variates start as zeros on
    the runner's device, one tree shared by every client."""
    _, tr = make_pair(CFG, pretrain=0)
    tf = tstrat.TFAggregation()
    tf.s = np.ones(6)
    tf.init_state(tr)
    assert tf.s is None
    awe = tstrat.FedAWE()
    awe.init_state(tr)
    assert awe.tau.tolist() == [0] * 6
    sc = tstrat.Scaffold()
    sc.init_state(tr)
    leaves = tree_leaves(sc.c)
    assert all(t.dtype == torch.float32 and t.device == tr.device
               and not t.any() for t in leaves)
    assert all(sc.c_i[i] is sc.c for i in range(6))


# ---------------------------------------------------------------------------
MASKS = [np.array([1, 1, 1, 1], bool), np.array([1, 0, 1, 0, 1], bool),
         np.array([1], bool), np.array([1, 1], bool),
         np.array([1, 1, 0, 0, 0, 1], bool)]


@pytest.mark.parametrize("has_comp", [False, True])
@pytest.mark.parametrize("k", range(len(MASKS)))
def test_simple_average_weights_match_jax(k, has_comp):
    active = MASKS[k]
    for server_row in (0, len(active) - 1):
        want = jagg.fedauto_simple_average_weights(active, server_row, has_comp)
        got = tagg.fedauto_simple_average_weights(active, server_row, has_comp)
        assert np.array_equal(got, want)


def test_effective_distribution_and_chi2_match_jax():
    rng = np.random.default_rng(3)
    alpha = rng.dirichlet(np.ones(10), size=5)
    beta = rng.dirichlet(np.ones(5))
    p = rng.dirichlet(np.ones(10))
    eff_t = tagg.effective_distribution(beta, alpha)
    eff_j = jagg.effective_distribution(beta, alpha)
    assert np.array_equal(eff_t, eff_j)
    assert tagg.chi2(p, eff_t) == jagg.chi2(p, eff_j)


def test_registry_is_the_jax_registry_minus_the_async_family():
    """Since the async server came across, the async family too: the JAX
    package's twelve names (their rounds: tests/test_torch_async.py)."""
    assert list(tstrat.STRATEGIES) == list(jstrat.STRATEGIES)
    assert len(tstrat.STRATEGIES) == 12 and ASYNC <= set(tstrat.STRATEGIES)
    for name, cls in tstrat.STRATEGIES.items():
        assert cls.name == name
        assert cls.streaming == jstrat.STRATEGIES[name].streaming


# ---------------------------------------------------------------------------
# LoRA mode: the variates and FedLAW's stack are adapter-sized
# ---------------------------------------------------------------------------
LORA_RUNS = ["scaffold", "fedlaw"]


@pytest.fixture(scope="module")
def lora_runs():
    jr, tr, base_np = lora_harness.make_pair()
    jg0, tg0 = jr.global_params, tr.global_params
    out = {"base_np": base_np}
    for name in LORA_RUNS:
        jr.set_base(jax.tree.map(jax.numpy.asarray, base_np))
        tr.base_params = params_from_jax(base_np, device="cpu")
        out[name] = dict(
            jax=_run(jr, RUNS[name](jstrat), 1, jg0, _jax_leaves),
            torch=_run(tr, RUNS[name](tstrat), 1, tg0, _torch_leaves))
        out[name]["torch"]["base"] = dict(lora_harness._flat(tr.base_params))
        out[name]["torch"]["adapter_sizes"] = [
            t.numel() for t in tree_leaves(tr.global_params)]
    return out


@pytest.mark.parametrize("name", LORA_RUNS)
def test_lora_adapters_match_jax(lora_runs, name):
    j, t = lora_runs[name]["jax"], lora_runs[name]["torch"]
    assert t["participants"] == j["participants"] and max(t["participants"]) > 1
    assert abs(t["hist"][0] - j["hist"][0]) <= 1.0 / N_TEST + 1e-12
    (jl, js), (tl, ts) = j["snaps"][0], t["snaps"][0]
    assert len(tl) == len(jl) == 2 * 2             # (a, b) x 2 blocks
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    if name == "scaffold":                         # adapter-sized variates
        assert [a.shape for a in ts["c"]] == [a.shape for a in tl]
        for a, b in zip(ts["c"], js["c"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", LORA_RUNS)
def test_lora_base_is_unchanged(lora_runs, name):
    base0 = dict(lora_harness._flat(lora_runs["base_np"]))
    base = lora_runs[name]["torch"]["base"]
    assert sorted(base) == sorted(base0)
    for path, leaf in base.items():
        assert np.array_equal(leaf.numpy(), base0[path]), path
