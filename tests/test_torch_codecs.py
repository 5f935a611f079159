"""The port's compressed rungs (``qsgd:<b>``, ``sign1``, ``topk:<f>``), the
plain ``topk_fedagg``, the top-k family of the ``StreamAccumulator``,
``aggregate_quantized``, the compressed downlink of ``CommState`` and the
paged broadcast cache, against the JAX package's on the same numpy inputs.

sign1's scale is a mean: the port's ``x.abs().mean()`` and JAX's
``jnp.mean`` sum in different orders (XLA's CPU reduction windows), so the
two scales may differ in their last bits.  The sign bits, every other
payload field and every byte count are equal; sign1 decodes are held to
the scales' relative difference, which is at most a few fp32 ulps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.comm import CommState as JCommState
from repro.fl.comm import aggregate_quantized as jax_aggregate_quantized
from repro.fl.comm import make_codec as jax_make_codec
from repro.fl.comm.stream import PackedUpdate as JPackedUpdate
from repro.fl.comm.stream import StreamAccumulator as JStreamAccumulator
from repro.fl.comm.stream import weighted_model_sum as jax_weighted_model_sum
from repro.kernels import ref as jax_ref
from repro.launch.serve import PagedBroadcastCache as JPagedBroadcastCache
from repro.launch.serve import _pack_pages as jax_pack_pages
from repro_torch.fl.comm import (CommState, PackedUpdate, StreamAccumulator,
                                 aggregate_quantized, is_quantized, make_codec,
                                 payload_family, weighted_model_sum)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.tree import tree_leaves

NEW = ["qsgd:2", "qsgd:4", "qsgd:8", "sign1", "topk:0.1", "topk:0.5",
       "topk:1.0"]
SIGN1_RTOL = 4e-7         # a few fp32 ulps: two summation orders of a mean


def _np_tree(seed=0, shapes=((33, 5), (17,), (4, 9)), zeros=True):
    """Normal draws without ties in |x| (continuous); with ``zeros`` every
    seventh entry is an exact 0 (sign1 maps it to +1; top-k ties among
    zeros decode to the same zeros)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, s in enumerate(shapes):
        x = rng.normal(size=s).astype(np.float32)
        if zeros:
            x.reshape(-1)[::7] = 0.0
        out[f"l{i}"] = x
    return out


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _betas(k, seed=0):
    w = np.random.default_rng(seed + 99).uniform(0.1, 1.0, k)
    return (w / w.sum()).astype(np.float32)


def _rtol(spec):
    return SIGN1_RTOL if spec == "sign1" else 0.0


def _close(got_tree, want_tree, atol=0.0, rtol=0.0):
    got = [t.numpy() for t in tree_leaves(got_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _same_payload(tp, jp):
    assert tp.codec == jp.codec and tp.nbytes == jp.nbytes
    for te, je in zip(tp.leaves, jp.leaves):
        assert te.shape == je.shape and te.nbytes == je.nbytes
        assert list(te.data) == list(je.data)
        for key in je.data:
            got, want = te.data[key].numpy(), np.asarray(je.data[key])
            assert got.dtype == want.dtype and got.shape == want.shape
            if key == "scale" and tp.codec == "sign1":
                np.testing.assert_allclose(got, want, rtol=SIGN1_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", NEW)
def test_new_codecs_match_jax(spec):
    tree = _np_tree(3)
    c, jc = make_codec(spec), jax_make_codec(spec)
    assert c.name == jc.name
    tp, jp = c.encode(_torch(tree)), jc.encode(_jax(tree))
    _same_payload(tp, jp)
    assert c.nbytes(_torch(tree)) == jc.nbytes(tree)
    _close(c.decode(tp), jc.decode(jp), rtol=_rtol(spec))
    assert payload_family(tp) == ("quant" if spec.startswith(("qsgd", "sign"))
                                  else c.name)


def test_codec_edge_cases_match_jax():
    """sign1 maps 0 to +1 and takes an all-zero leaf's scale of 0 without a
    clamp; qsgd clips to ±levels; top-k keeps at least one entry, breaks
    ties among equal magnitudes (an all-zero leaf) by the lower index as
    ``lax.top_k`` does, and sends sorted int32 indices; bad specs raise as
    in JAX."""
    z = {"a": np.zeros((5, 3), np.float32), "b": np.array([2.5, -0.5, 0.0],
                                                          np.float32)}
    for spec in ("sign1", "qsgd:3", "topk:0.01", "topk:0.5"):
        _same_payload(make_codec(spec).encode(_torch(z)),
                      jax_make_codec(spec).encode(_jax(z)))
    p = make_codec("sign1").encode(_torch(z))
    assert p.leaves[0].data["q"].tolist() == [[1] * 3] * 5
    assert float(p.leaves[0].data["scale"]) == 0.0
    p = make_codec("topk:0.01").encode(_torch(z))
    assert p.leaves[1].data["idx"].tolist() == [0]
    assert p.leaves[1].data["idx"].dtype == torch.int32
    for bad in ("qsgd:1", "qsgd:9", "qsgd:x", "topk:0", "topk:1.5", "topk:x"):
        with pytest.raises(ValueError):
            make_codec(bad)
        with pytest.raises(ValueError):
            jax_make_codec(bad)


@pytest.mark.parametrize("spec", NEW)
def test_error_feedback_matches_jax_for_new_codecs(spec):
    """Three uploads of one client: residual carry, distortion and byte
    accounting track the JAX CommState."""
    g = _np_tree(0)
    jc = JCommState(jax_make_codec(spec), _jax(g), n_clients=3)
    tc = CommState(make_codec(spec), _torch(g), n_clients=3)
    for step in range(3):
        model = _np_tree(10 + step)
        jrec, jp, jd = jc.roundtrip(1, _jax(model), _jax(g))
        trec, tp, td = tc.roundtrip(1, _torch(model), _torch(g))
        _close(trec, jrec, atol=1e-6)
        assert td == pytest.approx(jd, rel=1e-5, abs=1e-7)
        jr, tr = jc.residual(1), tc.residual(1)
        assert (jr is None) == (tr is None)
        if jr is not None:
            _close(tr, jr, atol=1e-6)
    assert tc.total_uplink_bytes == jc.total_uplink_bytes
    assert tc.upload_bytes == jc.upload_bytes


def test_available_codecs_match_jax():
    from repro.fl.comm import available_codecs as jax_available
    from repro_torch.fl.comm import available_codecs
    assert available_codecs() == jax_available()
    assert "qsgd:<arg>" in available_codecs() and "sign1" in available_codecs()


# ---------------------------------------------------------------------------
# topk_fedagg, the plain version (bitwise against the JAX reference)
# ---------------------------------------------------------------------------
def _topk_inputs(M, k, n, seed, sort=True, overlap=True):
    rng = np.random.default_rng(seed)
    pool = rng.choice(n, min(n, 2 * k), replace=False) if overlap else None
    rows = []
    for _ in range(M):
        src = pool if overlap and len(pool) >= k else np.arange(n)
        r = rng.choice(src, k, replace=False)
        rows.append(np.sort(r) if sort else r)
    idx = np.stack(rows).astype(np.int32)
    vals = rng.normal(size=(M, k)).astype(np.float32)
    betas = np.logspace(-3, np.log10(5.0), M).astype(np.float32)
    return idx, vals, rng.permutation(betas)


def _fold(idx, vals, betas, n):
    """The contract in numpy: from zeros, for m in order, each touched
    position takes one fp32 product and one fp32 add."""
    out = np.zeros(n, np.float32)
    for m in range(idx.shape[0]):
        prod = (betas[m] * vals[m]).astype(np.float32)
        for i, p in zip(idx[m], prod):
            out[i] = np.float32(out[i] + p)
    return out


@pytest.mark.parametrize("M,k,n,sort", [
    (1, 1, 1, True), (1, 1, 9, True), (5, 1, 3, True), (1, 40, 100, True),
    (5, 40, 100, True), (5, 40, 100, False), (5, 100, 100, True),
    (3, 300, 5000, False), (22, 236, 2359, True)])
def test_topk_fedagg_plain_is_bitwise_jax(M, k, n, sort):
    """Bitwise the product-then-add fold, and so bitwise JAX's reference,
    except at k = 1: there XLA fuses JAX's one-element scatter into an FMA
    (β·v + acc rounded once), one ulp off the fold where a position is
    touched twice (a reference-side finding, ROADMAP queue 3)."""
    idx, vals, betas = _topk_inputs(M, k, n, seed=M * 1000 + k, sort=sort)
    want = np.asarray(jax_ref.topk_fedagg(jnp.asarray(idx), jnp.asarray(vals),
                                          jnp.asarray(betas), n))
    fold = _fold(idx, vals, betas, n)
    args = (torch.from_numpy(idx), torch.from_numpy(vals),
            torch.from_numpy(betas))
    ops.reset_launches()
    for got in (ref.topk_fedagg(*args, n), ops.topk_fedagg(*args, n)):
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      fold.view(np.uint32))
        if k > 1 or M == 1:
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32))
        else:
            np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    assert ops.launches["topk_fedagg"] == 0          # CPU: the plain version


def test_topk_fedagg_wrapper_checks_its_inputs():
    idx = torch.zeros((2, 3), dtype=torch.int32)
    vals = torch.zeros((2, 3))
    b = torch.ones(2)
    with pytest.raises(TypeError):
        ops.topk_fedagg(idx.long(), vals, b, 4)
    with pytest.raises(TypeError):
        ops.topk_fedagg(idx, vals.double(), b, 4)
    with pytest.raises(ValueError):
        ops.topk_fedagg(idx, vals[:, :2], b, 4)
    with pytest.raises(ValueError):
        ops.topk_fedagg(idx, vals, torch.ones(3), 4)
    with pytest.raises(ValueError):
        ops.topk_fedagg(idx, vals, b, 0)
    with pytest.raises(ValueError):
        ops.topk_fedagg(idx.t(), vals.t(), torch.ones(3), 4)
    with pytest.raises(ValueError, match="no kernel"):
        ops.topk_fedagg(idx.to("meta"), vals.to("meta"), b.to("meta"), 4)


# ---------------------------------------------------------------------------
# streaming accumulator, weighted_model_sum, aggregate_quantized
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["topk:0.25", "qsgd:4", "sign1"])
@pytest.mark.parametrize("k", [1, 5])
def test_stream_accumulator_new_rungs_match_jax(spec, k):
    """A top-k cohort is bitwise JAX's; quant cohorts within fp32 rounding
    of the fold (and sign1's scales)."""
    trees = [_np_tree(10 * m, zeros=False) for m in range(k)]
    betas = _betas(k)
    jacc = JStreamAccumulator(_jax(_np_tree()))
    tacc = StreamAccumulator(_torch(_np_tree()))
    for t, b in zip(trees, betas):
        jacc.add(jax_make_codec(spec).encode(_jax(t)), float(b))
        tacc.add(make_codec(spec).encode(_torch(t)), float(b))
    want, got = jacc.total(), tacc.total()
    if spec.startswith("topk"):
        for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32))
    else:
        _close(got, want, atol=1e-6, rtol=_rtol(spec))
    assert tacc.n_fused == k and tacc.n_fallback == 0 and tacc.n_flushes == 1
    assert tacc.peak_decoded_bytes == jacc.peak_decoded_bytes


def test_stream_accumulator_mixed_cohort_matches_jax():
    """int8, qsgd:4, sign1, fp16 and topk payloads in one cohort: the
    families flush into one accumulator in the JAX order."""
    specs = ["int8", "qsgd:4", "sign1", "fp16", "topk:0.1", "qsgd:4",
             "topk:0.1", "sign1"]
    betas = _betas(len(specs), seed=4)
    jacc = JStreamAccumulator(_jax(_np_tree()), batch_k=2)
    tacc = StreamAccumulator(_torch(_np_tree()), batch_k=2)
    for i, (spec, b) in enumerate(zip(specs, betas)):
        t = _np_tree(50 + i, zeros=False)
        jacc.add(jax_make_codec(spec).encode(_jax(t)), float(b))
        tacc.add(make_codec(spec).encode(_torch(t)), float(b))
    _close(tacc.total(), jacc.total(), atol=2e-6)
    assert (tacc.n_fused, tacc.n_fallback, tacc.n_flushes) == (
        jacc.n_fused, jacc.n_fallback, jacc.n_flushes) == (8, 0, 5)


@pytest.mark.parametrize("spec", ["qsgd:4", "sign1", "topk:0.1"])
def test_weighted_model_sum_new_rungs_match_jax(spec):
    g, server = _np_tree(0), _np_tree(1)
    clients = [_np_tree(2 + i) for i in range(4)]
    betas = _betas(5, seed=3)
    jg, tg = _jax(g), _torch(g)

    def packed(make, enc_tree, glob, cls):
        out = []
        for i, c in enumerate(clients):
            p = make(spec).encode(enc_tree({k: c[k] - g[k] for k in c}))
            out.append((float(betas[1 + i]), cls(
                client=i, payload=p, origin_global=glob, codec=spec,
                nbytes=float(p.nbytes), distortion=0.0)))
        return out

    want = jax_weighted_model_sum(
        packed(jax_make_codec, _jax, jg, JPackedUpdate),
        [(float(betas[0]), _jax(server))], template=jg)
    got = weighted_model_sum(packed(make_codec, _torch, tg, PackedUpdate),
                             [(float(betas[0]), _torch(server))], template=tg)
    _close(got, want, atol=2e-6, rtol=_rtol(spec))


@pytest.mark.parametrize("spec", ["int8", "qsgd:2", "qsgd:4", "sign1"])
def test_aggregate_quantized_matches_jax(spec):
    trees = [_np_tree(7 * m) for m in range(5)]
    betas = _betas(5, seed=8)
    jp = [jax_make_codec(spec).encode(_jax(t)) for t in trees]
    tp = [make_codec(spec).encode(_torch(t)) for t in trees]
    assert all(is_quantized(p) for p in tp)
    _close(aggregate_quantized(tp, betas),
           jax_aggregate_quantized(jp, jnp.asarray(betas)),
           atol=1e-6, rtol=_rtol(spec))
    # and against decode-then-sum in the port itself
    want = {k: sum(np.float32(b) * make_codec(spec).decode(p)[k].numpy()
                   for b, p in zip(betas, tp)) for k in trees[0]}
    _close(aggregate_quantized(tp, torch.from_numpy(betas)), want, atol=1e-6)
    with pytest.raises(ValueError):
        aggregate_quantized([], betas)
    top = make_codec("topk:0.5").encode(_torch(trees[0]))
    assert not is_quantized(top)
    with pytest.raises(ValueError, match="int8-family"):
        aggregate_quantized([top], betas[:1])


# ---------------------------------------------------------------------------
# the compressed downlink
# ---------------------------------------------------------------------------
def _grow(seed, steps):
    """A global model drifting by N(0, 0.1) steps from zeros, as numpy."""
    rng = np.random.default_rng(seed)
    g = {k: np.zeros_like(v) for k, v in _np_tree(0).items()}
    out = [g]
    for _ in range(steps):
        g = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
             for k, v in g.items()}
        out.append(g)
    return out


def test_downlink_enrollment_and_qsgd4_error_feedback_match_jax():
    """As ``tests/test_adaptive.py``'s downlink tests: the enrollment
    broadcast ships the model at ``ref_bytes``; 12 broadcasts under
    ``qsgd:4`` with server-side error feedback give JAX's replica, residual
    and byte count, and the replica tracks the global with bounded lag."""
    t0 = _np_tree(0)
    jst = JCommState(jax_make_codec("fp32"), _jax(t0),
                     downlink_codec=jax_make_codec("qsgd:4"))
    tst = CommState(make_codec("fp32"), _torch(t0),
                    downlink_codec=make_codec("qsgd:4"))
    assert tst.download_bytes == jst.download_bytes < tst.ref_bytes
    drift = []
    for i, g in enumerate(_grow(0, 12)):
        assert tst.next_broadcast_nbytes() == jst.next_broadcast_nbytes()
        jout, jn = jst.broadcast(_jax(g))
        tout, tn = tst.broadcast(_torch(g))
        assert tn == jn == (tst.ref_bytes if i == 0 else tst.download_bytes)
        _close(tout, jout, atol=1e-6)
        if i:
            _close(tst._dl_residual, jst._dl_residual, atol=1e-6)
        drift.append(max(float((a - torch.from_numpy(b)).abs().max())
                         for a, b in zip(tree_leaves(tout),
                                         jax.tree.leaves(g))))
    assert max(drift[4:]) <= max(drift[1:4]) * 3 + 1e-3 and drift[-1] < 0.1
    assert tst.total_downlink_bytes == jst.total_downlink_bytes == (
        tst.ref_bytes + 12 * tst.download_bytes)
    tst.reset()
    assert tst._dl_ref is None and tst._dl_residual is None
    assert tst.next_broadcast_nbytes() == tst.ref_bytes


def test_downlink_fp16_accounting_and_no_codec_identity_match_jax():
    g = _np_tree(2)
    jst = JCommState(jax_make_codec("fp32"), _jax(g),
                     downlink_codec=jax_make_codec("fp16"))
    tst = CommState(make_codec("fp32"), _torch(g),
                    downlink_codec=make_codec("fp16"))
    for _ in range(3):
        jst.broadcast(_jax(g))
        tst.broadcast(_torch(g))
    assert tst.total_downlink_bytes == jst.total_downlink_bytes == pytest.approx(
        tst.ref_bytes + 2 * tst.download_bytes)
    assert tst.download_bytes == tst.ref_bytes / 2
    plain = CommState(make_codec("fp32"), _torch(g))
    tg = _torch(g)
    out, nbytes = plain.broadcast(tg)
    assert out is tg and nbytes == plain.download_bytes == plain.ref_bytes
    assert plain.next_broadcast_nbytes() == plain.ref_bytes
    with pytest.raises(ValueError, match="lora"):
        CommState(make_codec("fp32"), tg, downlink_codec=make_codec("lora_only"))


# ---------------------------------------------------------------------------
# the paged broadcast cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["int8", "qsgd:4", "sign1", "topk:0.1",
                                  "fp16"])
def test_page_bytes_equal_jax(spec):
    tree = _np_tree(5)
    tp = make_codec(spec).encode(_torch(tree))
    jp = jax_make_codec(spec).encode(_jax(tree))
    if spec == "sign1":            # the same scales give the same bytes
        for te, je in zip(tp.leaves, jp.leaves):
            te.data["scale"] = torch.tensor(np.asarray(je.data["scale"]))
    got = serve._pack_pages(tp, 64)
    want = jax_pack_pages(jp, 64)
    assert [p.dtype for p in got] == [np.uint8] * len(got)
    assert b"".join(p.tobytes() for p in got) == b"".join(
        p.tobytes() for p in want)
    assert [p.nbytes for p in got] == [p.nbytes for p in want]


def test_paged_cache_encodes_once_per_round_and_rung():
    codec = make_codec("int8")
    tree = _torch(_np_tree())
    calls = []

    def enc():
        calls.append(1)
        return codec.encode(tree)

    cache = serve.PagedBroadcastCache(page_bytes=64, keep_rounds=2)
    for _client in range(5):
        pages = cache.serve(1, "int8", enc)
    assert len(calls) == 1
    assert cache.hits == 4 and cache.misses == 1
    payload = cache.payload_for(1, "int8")
    blob = b"".join(v.numpy().tobytes()
                    for el in payload.leaves for v in el.data.values())
    assert b"".join(p.tobytes() for p in pages) == blob
    assert all(p.nbytes <= 64 for p in pages)


def test_paged_cache_evicts_old_rounds_as_jax():
    tree = _np_tree()
    caches = (serve.PagedBroadcastCache(page_bytes=256, keep_rounds=2),
              JPagedBroadcastCache(page_bytes=256, keep_rounds=2))
    for cache, mk, tr in zip(caches, (make_codec, jax_make_codec),
                             (_torch, _jax)):
        for rnd in range(1, 5):
            cache.serve(rnd, "sign1", lambda: mk("sign1").encode(tr(tree)))
    t, j = caches
    assert t.stats == j.stats and t.evictions == 2
    assert t.payload_for(1, "sign1") is None
    assert t.payload_for(4, "sign1") is not None
    assert t.peak_pages >= t.n_pages
    for bad in (dict(page_bytes=0), dict(keep_rounds=0)):
        with pytest.raises(ValueError):
            serve.PagedBroadcastCache(**bad)


def test_serve_broadcast_mode_runs_on_the_cpu(capsys):
    cache = serve.main(["--mode", "broadcast", "--device", "cpu",
                        "--clients", "12", "--rungs", "int8,sign1,topk:0.1",
                        "--rounds", "3", "--page-bytes", "4096"])
    out = capsys.readouterr().out
    assert out.count("3 encodes") == 3 and "cache: 27/36 hits" in out
    assert cache.misses == 9 and cache.hits == 27 and cache.evictions == 3
    assert all(p.dtype == np.uint8 for p in cache.serve(3, "sign1", None))
