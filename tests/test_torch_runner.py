"""The slice as a whole: the port's synchronous FedAvg and FedAuto rounds
(``repro_torch.fl.runtime.FFTRunner``) against the JAX package's on the same
split, seed, converted init and minibatch indices.  Every leaf of the global
params must agree within 1e-4 after each round (convolution summation order
differs between the frameworks) and the accuracy histories within one test
sample; then one FedAuto round each with int8 uploads and with the
materializing path (``streaming_agg="off"``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.strategies import FedAuto as JFedAuto
from repro.core.strategies import FedAvg as JFedAvg
from repro.data.synthetic import fft_split, make_dataset, train_test_split
from repro.fl.partition import partition
from repro.fl.runtime import FFTConfig as JFFTConfig
from repro.fl.runtime import FFTRunner as JFFTRunner
from repro.models.vision import make_model as jax_make_model
from repro_torch.convert import params_from_jax
from repro_torch.core.strategies import FedAuto, FedAvg
from repro_torch.fl.runtime import FFTConfig, FFTRunner
from repro_torch.models.vision import make_model
from repro_torch.tree import tree_leaves

# 6 clients, 4 selected per round; the short tx delay prices the wireless
# clients' uploads out (transient failures), so rounds run partial cohorts
CFG = dict(n_clients=6, k_selected=4, local_steps=2, batch_size=8, lr=0.05,
           failure_mode="mixed", tx_delay_s=0.01, seed=0, eval_every=1)
N_TEST = 120


class JaxMinibatchIndices:
    """The JAX runner's minibatch indices, in its key order: the runner
    splits ``fold_in(PRNGKey(seed), 2)`` once per local update and draws
    ``randint(k_e, (bs,), 0, n)`` for each of its E step keys."""

    def __init__(self, seed):
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)

    def __call__(self, n, E, bs):
        self.key, k = jax.random.split(self.key)
        idx = [np.asarray(jax.random.randint(kk, (bs,), 0, n))
               for kk in jax.random.split(k, E)]
        return torch.as_tensor(np.stack(idx), dtype=torch.long)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(runner, strategy, rounds, g0):
    runner.global_params = g0
    runner.rng = np.random.default_rng(42)
    snaps = []
    hist = runner.run(strategy, rounds,
                      log=lambda r, a: snaps.append(runner.global_params))
    return dict(hist=hist, snaps=snaps,
                participants=list(runner.loop.participants_per_round))


def make_pair(cfg, init_np=None, pretrain=4):
    """One JAX runner and one port runner of the cnn on 16x16x1 images, on
    the same split, from the same init (the JAX cnn's at ``PRNGKey(0)``
    unless ``init_np`` is given) and minibatch indices."""
    ds = make_dataset(600, n_classes=10, image_size=16, channels=1, seed=0)
    train, test = train_test_split(ds, N_TEST, seed=1)
    public, private = fft_split(train, public_per_class=5, seed=0)
    parts, _ = partition("group_classes", private.y, n_clients=6,
                         n_classes=10, classes_per_group=2, seed=0)
    j_init, j_apply = jax_make_model("cnn", 10, 16, 1)
    if init_np is None:
        init_np = _np(j_init(jax.random.PRNGKey(0)))
    _, t_apply = make_model("cnn", 10, 16, 1, device="cpu")
    jr = JFFTRunner(JFFTConfig(**cfg), lambda k: jax.tree.map(jax.numpy.asarray, init_np),
                    j_apply, public, parts, private, test,
                    pretrain_steps=pretrain)
    tr = FFTRunner(FFTConfig(**cfg),
                   lambda s: params_from_jax(init_np, device="cpu"),
                   t_apply, public, parts, private, test,
                   pretrain_steps=pretrain, device="cpu",
                   batch_indices=JaxMinibatchIndices(cfg["seed"]))
    return jr, tr


@pytest.fixture(scope="module")
def runs():
    jr, tr = make_pair(CFG)
    out = {"pretrain": dict(jax=dict(snaps=[jr.global_params]),
                            torch=dict(snaps=[tr.global_params]))}
    jg0, tg0 = jr.global_params, tr.global_params
    for name, js, ts, rounds in (("fedavg", JFedAvg, FedAvg, 2),
                                 ("fedauto", JFedAuto, FedAuto, 2)):
        out[name] = dict(jax=_run(jr, js(), rounds, jg0),
                         torch=_run(tr, ts(), rounds, tg0))
    jr.cfg.streaming_agg = tr.cfg.streaming_agg = "off"
    out["fedauto_off"] = dict(jax=_run(jr, JFedAuto(), 1, jg0),
                              torch=_run(tr, FedAuto(), 1, tg0))
    assert not tr.loop.streaming and not jr.loop.streaming
    jr8, tr8 = make_pair(dict(CFG, codec="int8"), _np(jg0), pretrain=0)
    out["fedauto_int8"] = dict(jax=_run(jr8, JFedAuto(), 1, jr8.global_params),
                               torch=_run(tr8, FedAuto(), 1, tr8.global_params))
    assert tr8.comm.codec.name == "int8" and tr8.loop.streaming
    return out


RUNS = ["fedavg", "fedauto", "fedauto_off", "fedauto_int8"]


@pytest.mark.parametrize("name", ["pretrain"] + RUNS)
def test_global_params_match_jax_after_every_round(runs, name):
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert len(j["snaps"]) == len(t["snaps"]) >= 1
    for jp, tp in zip(j["snaps"], t["snaps"]):
        jl, tl = jax.tree.leaves(_np(jp)), tree_leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", RUNS)
def test_accuracy_history_and_participation_match_jax(runs, name):
    j, t = runs[name]["jax"], runs[name]["torch"]
    assert t["participants"] == j["participants"]
    assert len(t["hist"]) == len(j["hist"])
    for a, b in zip(t["hist"], j["hist"]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-12


def test_rounds_see_partial_cohorts(runs):
    """The configuration exercises selection and failures: not every round
    aggregates every client, and FedAuto's compensatory model trains."""
    seen = [n for name in RUNS for n in runs[name]["torch"]["participants"]]
    assert min(seen) < CFG["k_selected"] and max(seen) > 0


# ---------------------------------------------------------------------------
# recorded traces and controller state run like JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trace_and_state(tmp_path_factory):
    """A JAX-recorded trace of an adaptive FedAuto run of ``CFG`` under
    ``scenario:diurnal`` and the JAX controller's state file after it, for
    the replay and warm-start cases."""
    d = tmp_path_factory.mktemp("recorded")
    trace, state = str(d / "t.ndjson"), str(d / "c.json")
    jr, _ = make_pair(dict(CFG, **SCENARIO, trace_record=trace,
                           codec="adaptive:sign1-fp16",
                           controller_state_out=state), pretrain=0)
    jr.run(JFedAuto(), 2)
    return trace, state


SCENARIO = dict(failure_mode="scenario:diurnal", deadline_s=3.0,
                model_bytes=0.2e6)


@pytest.mark.parametrize("name,override", [
    ("async", dict(server_mode="async", **SCENARIO)),
    ("buffered", dict(server_mode="buffered", buffer_k=2, **SCENARIO)),
    ("scenario", dict(SCENARIO)),
    ("trace_replay", dict(SCENARIO, codec="adaptive:sign1-fp16",
                          trace_replay="{trace}")),
    ("adaptive", dict(codec="adaptive:sign1-fp16", **SCENARIO)),
    ("skip_stragglers", dict(codec="adaptive:sign1-fp16",
                             skip_stragglers=True, **SCENARIO)),
    ("controller_state_in", dict(codec="adaptive:sign1-fp16",
                                 controller_state_in="{state}", **SCENARIO)),
])
def test_formerly_refused_configs_run_one_round_like_jax(trace_and_state,
                                                         name, override):
    """Each config the earlier slices refused now constructs on the CPU and
    runs one FedAuto round like JAX: every leaf within 1e-4 and the same
    participants."""
    trace, state = trace_and_state
    over = {k: v.format(trace=trace, state=state) if isinstance(v, str) else v
            for k, v in override.items()}
    jr, tr = make_pair(dict(CFG, **over), pretrain=0)
    j = _run(jr, JFedAuto(), 1, jr.global_params)
    t = _run(tr, FedAuto(), 1, tr.global_params)
    assert t["participants"] == j["participants"]
    for a, b in zip(tree_leaves(t["snaps"][-1]),
                    jax.tree.leaves(_np(j["snaps"][-1]))):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    if "codec" in over:
        assert tr.controller.assignments[1].codecs == \
            jr.controller.assignments[1].codecs


def test_cuda_default_and_unknown_streaming_agg_are_refused_here():
    init_fn, apply_fn = make_model("cnn", 10, 8, 1, device="cpu")
    ds = make_dataset(60, n_classes=10, image_size=8, channels=1, seed=0)
    args = (FFTConfig(**CFG), init_fn, apply_fn, ds, [np.arange(10)] * 6, ds, ds)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FFTRunner(*args)
    with pytest.raises(ValueError):
        FFTRunner(dataclasses.replace(args[0], streaming_agg="sometimes"),
                  *args[1:], device="cpu")
