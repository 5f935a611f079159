"""``ops.topk_fedagg_into``, the top-k flush over every leaf of an
accumulator, against the JAX package's ``StreamAccumulator`` on the same
numpy inputs, and its input checks.

On the CPU the entry takes its plain version (per leaf: the plain fold of
the stacked rows, then ``add_``), which is what the card's kernels hold
themselves to bit for bit (``tests/test_torch_kernels_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.comm import make_codec as jax_make_codec
from repro.fl.comm.stream import StreamAccumulator as JStreamAccumulator
from repro_torch.fl.comm import StreamAccumulator, make_codec
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves

# under one 2,048-output tile, a GroupNorm-sized leaf, the stem, exactly one
# tile, one past it, a 3x3x64x64 conv
SHAPES = {"a": (64,), "b": (100,), "c": (3, 3, 3, 64), "d": (2048,),
          "e": (2049,), "f": (3, 3, 64, 64)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _betas(M, seed=0):
    w = np.random.default_rng(seed + 7).uniform(0.1, 1.0, M)
    return (w / w.sum()).astype(np.float32)


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("M", [1, 5, 20])
def test_flush_is_bitwise_the_jax_stream_accumulator(M):
    """M topk:0.1 payloads after a dense ``add_tree`` term: the port's
    accumulator (one ``topk_fedagg_into`` call for the flush) and the entry
    called directly on the same rows give JAX's bits, with JAX's
    ``n_fused`` / ``n_flushes`` / ``peak_decoded_bytes``."""
    trees = [_tree(100 + m) for m in range(M)]
    anchor, w = _tree(7), 0.375
    betas = _betas(M, seed=M)
    jacc = JStreamAccumulator({k: jnp.asarray(v) for k, v in _tree(0).items()})
    tacc = StreamAccumulator({k: torch.from_numpy(v) for k, v in _tree(0).items()})
    jacc.add_tree({k: jnp.asarray(v) for k, v in anchor.items()}, w)
    tacc.add_tree({k: torch.from_numpy(v) for k, v in anchor.items()}, w)
    codec, jcodec = make_codec("topk:0.1"), jax_make_codec("topk:0.1")
    pays = []
    for t, b in zip(trees, betas):
        jacc.add(jcodec.encode({k: jnp.asarray(v) for k, v in t.items()}), float(b))
        pays.append(codec.encode({k: torch.from_numpy(v) for k, v in t.items()}))
        tacc.add(pays[-1], float(b))
    ops.reset_launches()
    want = [np.asarray(x) for x in tree_leaves(jacc.total())]
    got = tree_leaves(tacc.total())
    for g, wl in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(wl))
    assert (tacc.n_fused, tacc.n_fallback, tacc.n_flushes) == (
        jacc.n_fused, jacc.n_fallback, jacc.n_flushes) == (M, 0, 1)
    assert tacc.peak_decoded_bytes == jacc.peak_decoded_bytes

    accs = [w * torch.from_numpy(a).reshape(-1) for a in tree_leaves(anchor)]
    accs = [torch.zeros_like(a).add_(a) for a in accs]
    ops.topk_fedagg_into(accs, [[e.data["idx"] for e in p.leaves] for p in pays],
                         [[e.data["val"] for e in p.leaves] for p in pays],
                         torch.from_numpy(betas))
    for a, wl in zip(accs, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(wl.reshape(-1)))
    assert ops.launches["topk_fedagg"] == 0          # CPU: the plain version


def _rows(M=2, ks=(3, 4), seed=0):
    rng = np.random.default_rng(seed)
    idx = [[torch.from_numpy(np.sort(rng.choice(10, k, replace=False)).astype(np.int32))
            for k in ks] for _ in range(M)]
    val = [[torch.from_numpy(rng.normal(size=k).astype(np.float32)) for k in ks]
           for _ in range(M)]
    return [torch.zeros(10), torch.zeros(10)], idx, val, torch.ones(M)


def _mixed_k(accs, idx, val, b):
    idx[1][0], val[1][0] = idx[1][0][:2], val[1][0][:2]
    return accs, idx, val, b


def _wrong_dtype(accs, idx, val, b):
    idx[0][1] = idx[0][1].long()
    return accs, idx, val, b


def _not_contiguous(accs, idx, val, b):
    val[1][1] = torch.zeros((4, 2))[:, 0]
    return accs, idx, val, b


def _devices_differ(accs, idx, val, b):
    val[0][0] = val[0][0].to("meta")
    return accs, idx, val, b


@pytest.mark.parametrize("case,error,match", [
    (_mixed_k, ValueError, "same k"),
    (_wrong_dtype, TypeError, "int32"),
    (_not_contiguous, ValueError, "contiguous"),
    (_devices_differ, ValueError, "different devices")],
    ids=["mixed k in a leaf", "int64 indices", "a non-contiguous row",
         "devices differ"])
def test_flush_entry_checks_its_inputs(case, error, match):
    """The checks run before the device is known, so they raise on the CPU
    as on the card, and nothing is added."""
    accs, idx, val, b = case(*_rows())
    with pytest.raises(error, match=match):
        ops.topk_fedagg_into(accs, idx, val, b)
    assert all(bool((a == 0).all()) for a in accs)


def test_flush_entry_takes_betas_as_floats():
    """β as floats (what the stream accumulator passes: on the card they
    travel with the row table) gives the bits of β as a tensor."""
    accs, idx, val, b = _rows(M=3, seed=4)
    betas = [0.25, 1e-3, 5.0]
    other = [a.clone() for a in accs]
    ops.topk_fedagg_into(accs, idx, val, betas)
    ops.topk_fedagg_into(other, idx, val, torch.tensor(betas))
    for a, o in zip(accs, other):
        assert torch.equal(a.view(torch.int32), o.view(torch.int32))
    with pytest.raises(ValueError, match="coefficient"):
        ops.topk_fedagg_into(accs, idx, val, betas[:2])
