"""The port's optimizers and schedules (``repro_torch.optim``) against the JAX
package's (``repro.optim``) on the same numpy params and gradients, over 5
steps: fp32 leaves within 1e-6, bf16 leaves within one bf16 ulp of the JAX
value (both round the fp32 step once, so only a tie can differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim
from repro_torch.convert import params_from_jax
from repro_torch.tree import tree_leaves, tree_map

STEPS = 5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _tree(rng, scale=1.0):
    """fp32 and bf16 leaves, nested as a model's params."""
    f32 = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"dense": {"w": jnp.asarray(f32(6, 5)), "b": jnp.asarray(f32(5))},
            "emb": jnp.asarray(f32(7, 4)).astype(jnp.bfloat16),
            "norm": {"scale": jnp.asarray(f32(4)).astype(jnp.bfloat16)}}


def _to_torch(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _assert_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype, w.dtype)
        gn, wn = _np(g), _np(w)
        if w.dtype == jnp.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wn), 1e-30))) - 7)
            assert np.all(np.abs(gn - wn) <= ulp), np.max(np.abs(gn - wn) / ulp)
        else:
            np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=1e-6)


def _grads(rng, params):
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                              ).astype(p.dtype), params)


@pytest.mark.parametrize("momentum,weight_decay", [(0.0, 0.0), (0.9, 0.0),
                                                   (0.0, 0.01), (0.9, 0.01)])
def test_sgd_matches_jax(momentum, weight_decay):
    rng = np.random.default_rng(0)
    jp = _tree(rng)
    tp = _to_torch(jp)
    js = joptim.sgd_init(jp, momentum)
    ts = optim.sgd_init(tp, momentum)
    for step in range(STEPS):
        jg = _grads(rng, jp)
        tg = _to_torch(jg)
        lr = 0.1 / (step + 1)
        jp, js = joptim.sgd_update(jp, jg, js, lr, momentum=momentum,
                                   weight_decay=weight_decay)
        tp, ts = optim.sgd_update(tp, tg, ts, lr, momentum=momentum,
                                  weight_decay=weight_decay)
        _assert_close(tp, jp)
        if momentum:
            _assert_close(ts["mu"], js["mu"])


def test_adamw_matches_jax_and_carries_its_state_across():
    rng = np.random.default_rng(1)
    jp = _tree(rng)
    tp = _to_torch(jp)
    js, ts = joptim.adamw_init(jp), optim.adamw_init(tp)
    assert ts["t"].dtype == torch.int32 and ts["t"].shape == ()
    assert all(m.dtype == torch.float32 for m in tree_leaves(ts["m"]))
    for step in range(STEPS):
        jg = _grads(rng, jp)
        lr = 1e-2 * (step + 1)
        jp, js = joptim.adamw_update(jp, jg, js, lr)
        tp, ts = optim.adamw_update(tp, _to_torch(jg), ts, lr)
        _assert_close(tp, jp)
        _assert_close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]})
        assert int(ts["t"]) == int(js["t"]) == step + 1
    # a JAX state carried across continues as the JAX package continues
    tp2, ts2 = _to_torch(jp), _to_torch(js)
    assert ts2["t"].dtype == torch.int32 and int(ts2["t"]) == STEPS
    jg = _grads(rng, jp)
    jp, js = joptim.adamw_update(jp, jg, js, 3e-3, weight_decay=0.1)
    tp2, ts2 = optim.adamw_update(tp2, _to_torch(jg), ts2, 3e-3,
                                  weight_decay=0.1)
    _assert_close(tp2, jp)
    _assert_close(ts2["v"], js["v"])


@pytest.mark.parametrize("make", [
    lambda m: m.constant(0.1),
    lambda m: m.step_decay(0.1, boundary=3),
    lambda m: m.warmup_cosine(3e-4, warmup=3, total=8),
    lambda m: m.warmup_cosine(1e-3, warmup=20, total=10, floor=1e-5),
])
def test_schedules_match_jax(make):
    want, got = make(joptim), make(optim)
    assert [got(s) for s in range(STEPS * 3)] == [want(s) for s in range(STEPS * 3)]


def test_sgd_steps_a_bf16_leaf_in_fp32():
    """Without momentum the step is taken in fp32 and rounded once: a bf16
    weight moves by an update below its half ulp only through that one
    rounding, as in JAX."""
    p = {"w": torch.tensor([1.0, 256.0], dtype=torch.bfloat16)}
    g = {"w": torch.tensor([1.0, 1.0], dtype=torch.bfloat16)}
    new, _ = optim.sgd_update(p, g, {}, 0.6)
    assert new["w"].dtype == torch.bfloat16
    assert new["w"].tolist() == [0.400390625, 255.0]
    jnew, _ = joptim.sgd_update({"w": jnp.asarray([1.0, 256.0], jnp.bfloat16)},
                                {"w": jnp.asarray([1.0, 1.0], jnp.bfloat16)},
                                {}, 0.6)
    np.testing.assert_array_equal(_np(new["w"]), _np(jnew["w"]))
    assert tree_map(lambda t: t.dtype, new) == {"w": torch.bfloat16}
