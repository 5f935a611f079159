"""The port's Module-2 weights and aggregation (``repro_torch.core``) against
the JAX package's: the FISTA QP, the simplex projection, the discount
pipeline, the heuristic weights and ``aggregate_pytrees``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import weights_qp as jqp
from repro_torch.core import aggregation as tagg
from repro_torch.core import weights_qp as tqp
from repro_torch.tree import tree_leaves


def _problem(seed, J=8, C=10):
    rng = np.random.default_rng(seed)
    alpha = rng.dirichlet(np.ones(C) * 0.5, size=J)
    alpha_g = rng.dirichlet(np.ones(J)) @ alpha
    mask = np.ones(J, dtype=bool)
    mask[rng.choice(np.arange(1, J), 2, replace=False)] = False
    return alpha, alpha_g, mask


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("pinned", [False, True])
def test_solve_weights_matches_jax_solver(seed, pinned):
    alpha, alpha_g, mask = _problem(seed)
    kw = dict(fixed_idx=0, fixed_val=0.25) if pinned else {}
    want = np.asarray(jqp.solve_weights(
        jnp.asarray(alpha), jnp.asarray(alpha_g), jnp.asarray(mask),
        **({"fixed_idx": 0, "fixed_val": jnp.float32(0.25)} if pinned else {})))
    got = tqp.solve_weights(_t(alpha), _t(alpha_g), torch.as_tensor(mask), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert abs(float(got.sum()) - 1.0) < 1e-5
    assert np.all(got.numpy()[~mask] == 0.0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_weights_reaches_the_float64_oracle_optimum(seed):
    alpha, alpha_g, mask = _problem(seed)
    got = tqp.solve_weights(_t(alpha), _t(alpha_g), torch.as_tensor(mask),
                            fixed_idx=0, fixed_val=0.25).numpy()
    want = jqp.solve_weights_oracle(alpha, alpha_g, mask, fixed_idx=0,
                                    fixed_val=0.25, iters=20_000)
    chi2 = lambda b: float(np.sum((alpha_g - b @ alpha) ** 2 / alpha_g))
    assert abs(got[0] - 0.25) < 1e-6
    assert chi2(got) <= chi2(want) + 1e-4       # same optimum value
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_project_simplex_matches_jax(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=9).astype(np.float32)
    mask = rng.uniform(size=9) > 0.3
    want = np.asarray(jqp.project_simplex(jnp.asarray(v), jnp.asarray(mask),
                                          jnp.float32(0.7)))
    got = tqp.project_simplex(_t(v), torch.as_tensor(mask), torch.tensor(0.7))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _rows(seed, J=6, C=10):
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, 20, size=(J, C)).astype(float)
    hists[:, 0] += 1
    rows = hists / hists.sum(1, keepdims=True)
    g = hists.sum(0) / hists.sum()
    return rows, g


@pytest.mark.parametrize("staleness,distortion,b", [
    (None, None, 0.0),                        # the synchronous FedAuto call
    ([0, 2, 0, 1, 0, 3], None, 0.0),
    (None, [0, 0.2, 0.05, 0.0, 0.5, 0.1], 0.5),
])
def test_fedauto_discounted_weights_match_jax(staleness, distortion, b):
    rows, g = _rows(7)
    J = len(rows)
    s = np.zeros(J) if staleness is None else np.asarray(staleness, float)
    d = np.zeros(J) if distortion is None else np.asarray(distortion, float)
    want = jagg.fedauto_discounted_weights(rows, g, s, d, server_row=0,
                                           discount_b=b)
    got = tagg.fedauto_discounted_weights(rows, g, s, d, server_row=0,
                                          discount_b=b, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[0] - 1.0 / J) < 1e-6           # Eq. 9 pin
    assert abs(got.sum() - 1.0) < 1e-5


def test_heuristic_weights_and_missing_classes_match_jax():
    p = np.array([0.3, 0.1, 0.2, 0.15, 0.25])
    mask = np.array([True, True, False, True, False])
    for full in (True, False):
        np.testing.assert_array_equal(
            tqp.heuristic_weights(p, mask, 0, full),
            jqp.heuristic_weights(p, mask, 0, full))
    hists = np.array([[3, 0, 0, 1], [0, 2, 0, 0], [0, 0, 0, 5]])
    for rec in ([True, False, True], [False, False, False], [True, True, True]):
        rec = np.array(rec)
        np.testing.assert_array_equal(tagg.missing_classes(hists, rec),
                                      jagg.missing_classes(hists, rec))


def _trees(k, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"conv": {"w": (3, 3, 2, 4), "b": (4,)}, "fc": {"w": (16, 5)}}
    return [{n: {k_: rng.normal(size=s).astype(np.float32)
                 for k_, s in d.items()} for n, d in shapes.items()}
            for _ in range(k)]


@pytest.mark.parametrize("k", [1, 3, 22])
def test_aggregate_pytrees_matches_jax(k):
    trees = _trees(k, seed=k)
    betas = np.random.default_rng(k).dirichlet(np.ones(k))
    want = jagg.aggregate_pytrees([jax.tree.map(jnp.asarray, t) for t in trees],
                                  betas)
    tt = [jax.tree.map(torch.from_numpy, t) for t in trees]
    got = tagg.aggregate_pytrees(tt, betas)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_delta_pytree_matches_jax():
    a, b = _trees(2, seed=9)
    want = jagg.delta_pytree(a, b)
    got = tagg.delta_pytree(jax.tree.map(torch.from_numpy, a),
                            jax.tree.map(torch.from_numpy, b))
    for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
