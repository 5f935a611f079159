"""The runner under the compressed rungs: FedAuto 2 rounds on the cnn of
``tests/test_torch_runner.py`` (``make_pair``: the same split, seed,
converted init and minibatch indices) with ``qsgd:4``, ``sign1`` and
``topk:0.1`` uploads and with an ``int8`` downlink, the port against the JAX
package every round.

The uploads hold every leaf within 1e-4, accuracies within one test sample,
the same participants and the same byte totals.  The int8 downlink
quantizes (global − replica), a difference of nearly equal weights, so the
two frameworks' fp32 noise puts a few elements on either side of a rounding
boundary; those differ by one quantization step.  That run is held to
``chip_smoke.quantized_agreement``: every element within 1e-4, or within
1e-4 plus one step of its leaf for at most 1% of the leaf."""
import os
import sys

import jax
import numpy as np
import pytest

from repro.core.strategies import FedAuto as JFedAuto
from repro_torch.core.strategies import FedAuto
from repro_torch.tree import tree_leaves
from test_torch_runner import CFG, N_TEST, _np, _run, make_pair

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

RUNS = {"qsgd4": dict(codec="qsgd:4"), "sign1": dict(codec="sign1"),
        "topk": dict(codec="topk:0.1"), "downlink_int8": dict(downlink_codec="int8")}


@pytest.fixture(scope="module")
def runs():
    jr, _ = make_pair(CFG)
    g0 = _np(jr.global_params)
    out = {}
    for name, over in RUNS.items():
        j, t = make_pair(dict(CFG, **over), g0, pretrain=0)
        steps = (chip_smoke.record_steps(j.comm.downlink_codec)
                 if "downlink_codec" in over else None)
        out[name] = dict(jax=_run(j, JFedAuto(), 2, j.global_params),
                         torch=_run(t, FedAuto(), 2, t.global_params),
                         jr=j, tr=t, steps=steps)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_codec_runs_match_jax_every_round(runs, name):
    run = runs[name]
    j, t = run["jax"], run["torch"]
    assert len(j["snaps"]) == len(t["snaps"]) == 2
    for jp, tp in zip(j["snaps"], t["snaps"]):
        jl, tl = jax.tree.leaves(_np(jp)), [x.numpy() for x in tree_leaves(tp)]
        assert [a.shape for a in tl] == [b.shape for b in jl]
        if run["steps"] is None:
            for a, b in zip(tl, jl):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        else:
            res = chip_smoke.quantized_agreement(tl, jl, run["steps"])
            assert res["ok"], res
    assert t["participants"] == j["participants"]
    for a, b in zip(t["hist"], j["hist"]):
        assert abs(a - b) <= 1.0 / N_TEST + 1e-12


@pytest.mark.parametrize("name", list(RUNS))
def test_codec_runs_account_bytes_as_jax(runs, name):
    jr, tr = runs[name]["jr"], runs[name]["tr"]
    over = RUNS[name]
    assert tr.comm.codec.name == jr.comm.codec.name == over.get("codec", "fp32")
    assert tr.loop.streaming
    assert tr.upload_bytes == jr.upload_bytes
    assert tr.download_bytes == jr.download_bytes
    assert tr.downlink_codec_resolved == jr.downlink_codec_resolved
    assert tr.comm.total_uplink_bytes == jr.comm.total_uplink_bytes
    assert tr.comm.total_downlink_bytes == jr.comm.total_downlink_bytes
    if "downlink_codec" in over:
        # round 1 enrolls at the fp32 size, round 2 travels compressed
        assert tr.comm.total_downlink_bytes == (tr.comm.ref_bytes
                                                + tr.comm.download_bytes)
        assert tr.download_bytes < tr.model_bytes
    else:
        assert tr.upload_bytes < tr.model_bytes


def test_quantized_agreement_counts_flips():
    """The criterion itself: a step-sized flip in under 1% of a leaf
    passes, a flip past one step or in too many elements does not."""
    want = [np.zeros(1000, np.float32), np.zeros(10, np.float32)]
    steps = [[1e-3, 1e-3], [2e-3, 5e-4]]
    got = [w.copy() for w in want]
    got[0][:10] = 2e-3
    ok = chip_smoke.quantized_agreement(got, want, steps)
    assert ok["ok"] and ok["flips"] == 10 and ok["worst_share"] == 0.01
    got[0][:11] = 2e-3
    assert not chip_smoke.quantized_agreement(got, want, steps)["ok"]
    got = [w.copy() for w in want]
    got[1][0] = 1.2e-3              # past 1e-4 + the leaf's step 1e-3
    assert not chip_smoke.quantized_agreement(got, want, steps, share=0.5)["ok"]
    assert chip_smoke.quantized_agreement(want, want, steps)["max_abs_err"] == 0.0


@pytest.mark.parametrize("spec", ["int8", "qsgd:4", "sign1", "topk:0.25"])
def test_record_steps_gives_each_codecs_step(spec):
    """One level for int8/qsgd, a sign (2 · scale) for sign1, the smallest
    kept magnitude for top-k; the wrapped codec still encodes the same."""
    import torch
    from repro_torch.fl.comm import make_codec
    tree = {"a": torch.from_numpy(np.random.default_rng(0).normal(
        size=(40,)).astype(np.float32))}
    codec = make_codec(spec)
    plain = make_codec(spec).encode(tree)
    steps = chip_smoke.record_steps(codec)
    p = codec.encode(tree)
    assert p.nbytes == plain.nbytes and len(steps) == 1
    el = p.leaves[0].data
    want = (float(el["val"].abs().min()) if spec.startswith("topk")
            else float(el["scale"]) * (2 if spec == "sign1" else 1))
    assert steps[0] == [want] and want > 0
