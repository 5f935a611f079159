"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's format (``repro.checkpoint``): the port's msgpack encoder gives
the bytes of ``msgpack.packb(..., use_bin_type=True)`` and its decoder the
objects of ``msgpack.unpackb``; a file the JAX package saves loads in the
port bitwise, and the reverse, with bf16, tuples, None and 0-d leaves; and
a save is atomic (a temp file renamed over the target)."""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.convert import (BFloat16Bits, params_from_jax,
                                 params_to_numpy, tensor_from_numpy)
from repro_torch.tree import tree_leaves

OBJECTS = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "floats": [0.0, -0.0, 1.5, -2.25e300, float("inf"), 1e-310],
    "nil_bool": [None, True, False, [None, [True]]],
    "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535,
            "f" * 65536, "unicode ß→λ"],
    "bin": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65535, b"\x03" * 65536],
    "arrays": [list(range(15)), list(range(16)), list(range(70000)), []],
    "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {str(i): i for i in range(70000)}, {}],
    "checkpoint": {"tree": {"b": {"__leaf__": 0, "dtype": "bfloat16",
                                  "shape": [3, 4]},
                            "t": {"__tuple__": [{"__scalar__": None}]}},
                   "blobs": [b"\x00\x3f" * 12]},
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_msgpack_bytes_are_msgpacks(name):
    obj = OBJECTS[name]
    want = msgpack.packb(obj, use_bin_type=True)
    got = ckpt_io.packb(obj)
    assert got == want
    assert ckpt_io.unpackb(got) == msgpack.unpackb(want, raw=False)


def test_msgpack_refuses_what_the_format_never_holds():
    with pytest.raises(TypeError, match="cannot serialize"):
        ckpt_io.packb({"x": object()})
    with pytest.raises(ValueError, match="truncated"):
        ckpt_io.unpackb(msgpack.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ckpt_io.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        ckpt_io.unpackb(b"\xc1")            # the byte msgpack never uses


def _jax_tree(rng):
    """A JAX-side tree with every kind of node the format holds."""
    return {"params": {"w": jnp.asarray(rng.normal(size=(3, 4)),
                                        jnp.float32).astype(jnp.bfloat16),
                       "b": jnp.asarray(rng.normal(size=(5,)), jnp.float32),
                       "i": jnp.arange(6, dtype=jnp.int32).reshape(2, 3)},
            "opt": {"t": jnp.zeros((), jnp.int32),
                    "pair": (jnp.ones((2,), jnp.float32), None)},
            "step": 30, "lists": [np.float16(1.5), np.arange(3, dtype=np.int64)]}


def _same_numpy(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_port_and_jax_write_the_same_bytes_and_load_each_other(tmp_path):
    jt = _jax_tree(np.random.default_rng(0))
    jckpt.save(str(tmp_path / "jax.ckpt"), jt)
    # the same tree in the port: tensors, bf16 as bf16, the rest as is
    tt = params_from_jax(jax.tree.map(np.asarray, {"params": jt["params"],
                                                   "opt": {"t": jt["opt"]["t"]}}),
                         device="cpu")
    tt["opt"]["pair"] = (tensor_from_numpy(np.asarray(jt["opt"]["pair"][0])), None)
    tt["step"], tt["lists"] = 30, [np.float16(1.5), torch.arange(3)]
    assert tt["params"]["w"].dtype == torch.bfloat16
    ckpt.save(str(tmp_path / "port.ckpt"), tt)
    assert (tmp_path / "port.ckpt").read_bytes() == \
        (tmp_path / "jax.ckpt").read_bytes()
    # JAX's file in the port, bitwise, bf16 as BFloat16Bits
    got = ckpt.load(str(tmp_path / "jax.ckpt"))
    assert isinstance(got["params"]["w"], BFloat16Bits)
    assert isinstance(got["opt"]["pair"], tuple) and got["opt"]["pair"][1] is None
    _same_numpy(got, jax.tree.map(np.asarray, jt))
    assert tensor_from_numpy(got["params"]["w"]).dtype == torch.bfloat16
    assert torch.equal(tensor_from_numpy(got["params"]["w"]), tt["params"]["w"])
    # the port's file in JAX, bitwise, bf16 as bf16
    back = jckpt.load(str(tmp_path / "port.ckpt"))
    assert back["params"]["w"].dtype == jnp.bfloat16
    _same_numpy(back, jax.tree.map(np.asarray, jt))


def test_a_train_checkpoint_round_trips_bitwise(tmp_path):
    """``{"params", "step"}`` as ``launch.train --checkpoint`` saves it:
    loaded and carried back to tensors, every leaf is bitwise the saved
    one, in its dtype."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"embedding": torch.randn(16, 8, generator=g).to(torch.bfloat16)},
              "layers": {"w": torch.randn(2, 8, 8, generator=g)},
              "final_norm": {"scale": torch.ones(8, dtype=torch.bfloat16)}}
    ckpt.save(str(tmp_path / "c.ckpt"), {"params": params, "step": 7})
    got = ckpt.load(str(tmp_path / "c.ckpt"))
    assert int(got["step"]) == 7
    back = params_from_jax(got["params"], device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_save_is_atomic(tmp_path, monkeypatch):
    """The payload goes to a temp file in the target's directory, renamed
    over the target: a save that fails before the rename leaves the old
    checkpoint whole and no temp file behind."""
    path = tmp_path / "c.ckpt"
    ckpt.save(str(path), {"x": torch.zeros(3)})
    old = path.read_bytes()
    renames = []

    def failing_replace(src, dst):
        renames.append((os.path.dirname(src), dst))
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", failing_replace)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(str(path), {"x": torch.ones(3)})
    assert renames == [(str(tmp_path), str(path))]
    assert path.read_bytes() == old
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.ckpt"]


def test_params_to_numpy_follows_jax_tree_map():
    tree = {"b": torch.ones(2, dtype=torch.bfloat16), "a": (torch.zeros(1), None),
            "c": [3]}
    got = params_to_numpy(tree)
    assert list(got) == ["a", "b", "c"]
    assert isinstance(got["b"], BFloat16Bits) and got["b"].tolist() == [0x3F80] * 2
    assert isinstance(got["a"], tuple) and got["a"][1] is None
    assert got["c"][0].shape == () and int(got["c"][0]) == 3
    want = jax.tree.map(np.asarray, {"b": jnp.ones(2, jnp.bfloat16),
                                     "a": (jnp.zeros(1), None), "c": [3]})
    _same_numpy(got, want)
