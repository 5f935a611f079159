"""The port's codecs, comm state and streaming aggregation
(``repro_torch.fl.comm``) against the JAX package's, on the same numpy
trees: encode/decode, error feedback, ``StreamAccumulator``,
``weighted_tree_sum`` and ``weighted_model_sum`` for fp32, fp16 and int8,
and the ``lora_only`` codec (the compressed rungs: ``test_torch_codecs.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.comm import CommState as JCommState
from repro.fl.comm import make_codec as jax_make_codec
from repro.fl.comm.stream import PackedUpdate as JPackedUpdate
from repro.fl.comm.stream import StreamAccumulator as JStreamAccumulator
from repro.fl.comm.stream import weighted_model_sum as jax_weighted_model_sum
from repro.fl.comm.stream import weighted_tree_sum as jax_weighted_tree_sum
from repro_torch.fl.comm import (CommState, PackedUpdate, StreamAccumulator,
                                 make_codec, payload_family,
                                 weighted_model_sum, weighted_tree_sum)
from repro_torch.fl.comm.codecs import Payload
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves

SPECS = ["fp32", "fp16", "int8"]
FAMILY = {"fp32": "fp32", "fp16": "fp16", "int8": "quant"}


def _np_tree(seed=0, shapes=((33, 5), (17,), (4, 9))):
    rng = np.random.default_rng(seed)
    return {f"l{i}": rng.normal(size=s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _betas(k, seed=0):
    w = np.random.default_rng(seed + 99).uniform(0.1, 1.0, k)
    return (w / w.sum()).astype(np.float32)


def _close(got_tree, want_tree, atol):
    got = [t.numpy() for t in tree_leaves(got_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("spec", SPECS)
def test_codec_roundtrip_matches_jax(spec):
    tree = _np_tree(3)
    jp = jax_make_codec(spec).encode(_jax(tree))
    tp = make_codec(spec).encode(_torch(tree))
    assert tp.nbytes == jp.nbytes and tp.codec == jp.codec
    assert make_codec(spec).nbytes(_torch(tree)) == jax_make_codec(spec).nbytes(tree)
    assert payload_family(tp) == FAMILY[spec]
    for te, je in zip(tp.leaves, jp.leaves):
        assert te.shape == je.shape and te.nbytes == je.nbytes
        for key in je.data:
            np.testing.assert_array_equal(te.data[key].numpy(),
                                          np.asarray(je.data[key]))
    _close(make_codec(spec).decode(tp), jax_make_codec(spec).decode(jp), 0.0)


class _LoRACfg:  # the minimal lora_cfg stand-in of tests/test_comm.py
    rank = 4


def _adapters(seed=0):
    rng = np.random.default_rng(seed)
    return {p: {"a": rng.normal(size=(8, 4)).astype(np.float32),
                "b": rng.normal(size=(4, 6)).astype(np.float32)}
            for p in ("blk0/qkv/w", "blk1/qkv/w")}


def test_lora_only_codec_matches_jax_and_guards():
    """As ``tests/test_comm.py``'s ``lora_only`` test: an exact fp32 round
    trip of an adapter dict, the same wire bytes as the JAX codec, and the
    same refusals (not a LoRA run; not an adapter dict)."""
    tree = _adapters()
    c, jc = make_codec("lora_only"), jax_make_codec("lora_only")
    c.validate_template(_torch(tree), lora_cfg=_LoRACfg())
    tp, jp = c.encode(_torch(tree)), jc.encode(_jax(tree))
    assert tp.codec == jp.codec == "lora_only" and tp.nbytes == jp.nbytes
    assert payload_family(tp) == "fp32"
    _close(c.decode(tp), tree, 0.0)
    with pytest.raises(ValueError, match="lora"):
        c.validate_template(_torch(tree), lora_cfg=None)
    with pytest.raises(ValueError, match="adapter"):
        c.validate_template({"w": torch.ones((8, 8))}, lora_cfg=_LoRACfg())


def test_lora_only_comm_state_matches_jax():
    """``CommState(..., lora_cfg=...)`` validates the adapter template and
    prices adapter-sized uploads as the JAX one does; without ``lora_cfg``
    both refuse the codec."""
    g = _adapters(0)
    jst = JCommState(jax_make_codec("lora_only"), _jax(g), lora_cfg=_LoRACfg(),
                     model_bytes_override=1e5, n_clients=2)
    tst = CommState(make_codec("lora_only"), _torch(g), lora_cfg=_LoRACfg(),
                    model_bytes_override=1e5, n_clients=2)
    assert tst.fp32_nbytes == jst.fp32_nbytes == 4 * 2 * (8 * 4 + 4 * 6)
    assert tst.upload_bytes == jst.upload_bytes
    assert tst.nbytes_for("fp32") == jst.nbytes_for("fp32")
    jrec, _, jd = jst.roundtrip(1, _jax(_adapters(5)), _jax(g))
    trec, _, td = tst.roundtrip(1, _torch(_adapters(5)), _torch(g))
    _close(trec, jrec, 1e-6)
    assert td == jd == 0.0 and tst.residual(1) is None
    with pytest.raises(ValueError, match="lora"):
        CommState(make_codec("lora_only"), _torch(g))


@pytest.mark.parametrize("spec", ["adaptive:sign1-fp16",
                                  "adaptive:qsgd:4-fp32",
                                  "adaptive:topk:0.1-int8",
                                  "adaptive:int8-fp32"])
def test_unported_codecs_say_so(spec):
    """An adaptive spec is no codec: the runner parses it first, and
    ``make_codec`` refuses it with ``ValueError``, as JAX's does."""
    for make in (make_codec, jax_make_codec):
        with pytest.raises(ValueError, match="unknown codec"):
            make(spec)
        with pytest.raises(ValueError):
            make("no-such-codec")


@pytest.mark.parametrize("spec", SPECS)
def test_error_feedback_matches_jax(spec):
    """Three uploads of one client: residual carry, distortion and byte
    accounting track the JAX CommState."""
    g = _np_tree(0)
    jc = JCommState(jax_make_codec(spec), _jax(g), n_clients=3)
    tc = CommState(make_codec(spec), _torch(g), n_clients=3)
    for step in range(3):
        model = _np_tree(10 + step)
        jrec, _, jd = jc.roundtrip(1, _jax(model), _jax(g))
        trec, _, td = tc.roundtrip(1, _torch(model), _torch(g))
        _close(trec, jrec, 1e-6)
        assert td == pytest.approx(jd, rel=1e-5, abs=1e-7)
        jr, tr = jc.residual(1), tc.residual(1)
        assert (jr is None) == (tr is None)
        if jr is not None:
            _close(tr, jr, 1e-6)
    assert tc.total_uplink_bytes == jc.total_uplink_bytes
    assert tc.upload_bytes == jc.upload_bytes


@pytest.mark.parametrize("spec", SPECS)
def test_encode_upload_is_the_roundtrip_encode(spec):
    g = _torch(_np_tree(0))
    a = CommState(make_codec(spec), g, n_clients=2)
    b = CommState(make_codec(spec), g, n_clients=2)
    for step in range(2):
        m = _torch(_np_tree(20 + step))
        recon, _, d1 = a.roundtrip(0, m, g)
        payload, d2 = b.encode_upload(0, m, g)
        assert d1 == d2
        _close(b.decode_upload(payload, g), jax.tree.map(np.asarray, recon), 0.0)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("k", [1, 5])
def test_stream_accumulator_matches_jax(spec, k):
    trees = [_np_tree(10 * m) for m in range(k)]
    betas = _betas(k)
    jacc = JStreamAccumulator(_jax(_np_tree()))
    tacc = StreamAccumulator(_torch(_np_tree()))
    for t, b in zip(trees, betas):
        jacc.add(jax_make_codec(spec).encode(_jax(t)), float(b))
        tacc.add(make_codec(spec).encode(_torch(t)), float(b))
    _close(tacc.total(), jacc.total(), 1e-6)
    assert tacc.n_fused == k and tacc.n_fallback == 0 and tacc.n_flushes == 1
    assert tacc.peak_decoded_bytes == jacc.peak_decoded_bytes


def test_stream_accumulator_batches_mixed_rungs_and_falls_back():
    template = _torch(_np_tree())
    acc = StreamAccumulator(template, batch_k=2)
    want = {k: np.zeros_like(v) for k, v in _np_tree().items()}
    for i, spec in enumerate(["int8", "fp16", "fp32", "int8", "int8"]):
        tree = _np_tree(5 + i)
        p = make_codec(spec).encode(_torch(tree))
        dec = make_codec(spec).decode(p)
        for key in want:
            want[key] = want[key] + np.float32(0.2) * dec[key].numpy()
        acc.add(p, 0.2)
    foreign = make_codec("fp32").encode(_torch(_np_tree(40)))
    el0 = foreign.leaves[0]
    foreign = Payload(codec="fp32", treedef=foreign.treedef, nbytes=foreign.nbytes,
                      leaves=[dataclasses.replace(el0, data={**el0.data,
                                                             "extra": 0})]
                      + foreign.leaves[1:])
    assert payload_family(foreign) is None
    acc.add(foreign, 0.5)
    for key, v in _np_tree(40).items():
        want[key] = want[key] + np.float32(0.5) * v
    _close(acc.total(), want, 1e-6)
    assert (acc.n_fused, acc.n_fallback) == (5, 1)
    assert acc.n_flushes == 4          # int8 at 2, then int8/fp16/fp32 at total
    ops.reset_launches()
    empty = StreamAccumulator(template).total()
    assert all(not bool(t.any()) for t in tree_leaves(empty))
    assert sum(ops.launches.values()) == 0          # CPU: plain versions


def test_weighted_tree_sum_matches_jax():
    trees = [_np_tree(s) for s in (1, 2, 3)]
    w = [0.5, -0.25, 0.75]
    _close(weighted_tree_sum([_torch(t) for t in trees], w),
           jax_weighted_tree_sum([_jax(t) for t in trees], w), 1e-6)
    with pytest.raises(ValueError):
        weighted_tree_sum([], [])


@pytest.mark.parametrize("spec", SPECS)
def test_weighted_model_sum_matches_jax(spec):
    """The streaming aggregate of a sync round: server anchor as a dense
    term, K client payloads relative to one origin global."""
    g = _np_tree(0)
    server = _np_tree(1)
    clients = [_np_tree(2 + i) for i in range(4)]
    betas = _betas(5, seed=3)
    jg, tg = _jax(g), _torch(g)

    def packed(make, enc_tree, glob, cls):
        out = []
        for i, c in enumerate(clients):
            delta = {k: c[k] - g[k] for k in c}
            p = make(spec).encode(enc_tree(delta))
            out.append((float(betas[1 + i]), cls(
                client=i, payload=p, origin_global=glob, codec=spec,
                nbytes=float(p.nbytes), distortion=0.0)))
        return out

    want = jax_weighted_model_sum(
        packed(jax_make_codec, _jax, jg, JPackedUpdate),
        [(float(betas[0]), _jax(server))], template=jg)
    got = weighted_model_sum(
        packed(make_codec, _torch, tg, PackedUpdate),
        [(float(betas[0]), _torch(server))], template=tg)
    _close(got, want, 2e-6)
    # with no dense term the aggregate is origin + Σ β·decode
    got2 = weighted_model_sum(packed(make_codec, _torch, tg, PackedUpdate),
                              template=tg)
    want2 = jax_weighted_model_sum(packed(jax_make_codec, _jax, jg, JPackedUpdate),
                                   template=jg)
    _close(got2, want2, 2e-6)
