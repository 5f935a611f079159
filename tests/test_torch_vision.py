"""The port's vision models (``repro_torch.models.vision``) against the JAX
package's: logits from the same converted init on the same images, param
structure, SAME padding and the device rule."""
import jax
import numpy as np
import pytest
import torch

from repro.models.vision import make_model as jax_make_model
from repro_torch.convert import params_from_jax
from repro_torch.models.layers import layernorm
from repro_torch.models.vision import _same_pads, make_model
from repro_torch.tree import tree_flatten, tree_map

# (name, image size, channels, batch): resnet18 at 8×8 runs the stride-2
# 3×3 convolutions on even sizes, where SAME pads (0, 1)
MODELS = [("cnn", 16, 1, 3), ("resnet", 8, 3, 2), ("resnet18", 8, 3, 2),
          ("vit", 8, 3, 2)]


@pytest.mark.parametrize("name,hw,c,batch", MODELS)
def test_logits_match_jax(name, hw, c, batch):
    j_init, j_apply = jax_make_model(name, 10, hw, c)
    params = jax.tree.map(np.asarray, jax.jit(j_init)(jax.random.PRNGKey(3)))
    x = np.random.default_rng(1).normal(size=(batch, hw, hw, c)).astype(np.float32)
    want = np.asarray(jax.jit(j_apply)(params, x))
    _, apply_fn = make_model(name, 10, hw, c, device="cpu")
    with torch.no_grad():
        got = apply_fn(params_from_jax(params, device="cpu"), torch.from_numpy(x))
    assert got.shape == (batch, 10)
    # convolution and matmul summation order differ between the frameworks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,hw,c,batch", MODELS)
def test_init_has_the_jax_structure(name, hw, c, batch):
    j_init, _ = jax_make_model(name, 10, hw, c)
    shapes = jax.eval_shape(j_init, jax.random.PRNGKey(0))
    init_fn, _ = make_model(name, 10, hw, c, device="cpu")
    params = init_fn(0)
    j_leaves, j_def = jax.tree.flatten(shapes)
    leaves, _ = tree_flatten(params)
    assert [tuple(l.shape) for l in leaves] == [tuple(s.shape) for s in j_leaves]
    assert jax.tree.structure(tree_map(lambda t: t.numpy(), params)) == j_def
    assert all(l.dtype == torch.float32 for l in leaves)
    again = init_fn(0)
    assert all(torch.equal(a, b) for a, b in zip(leaves, tree_flatten(again)[0]))


def test_resnet18_is_the_papers_width():
    shapes = jax.eval_shape(jax_make_model("resnet18", 100, 32, 3)[0],
                            jax.random.PRNGKey(0))
    j_leaves = jax.tree.leaves(shapes)
    init_fn, _ = make_model("resnet18", 100, 32, 3, device="cpu")
    leaves = tree_flatten(init_fn(0))[0]
    assert len(leaves) == len(j_leaves) == 76
    assert sum(l.numel() for l in leaves) == 11_223_140
    assert max(l.numel() for l in leaves) == 3 * 3 * 512 * 512


@pytest.mark.parametrize("n,k,s,want", [(8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)),
                                        (8, 3, 1, (1, 1)), (16, 5, 1, (2, 2)),
                                        (8, 1, 2, (0, 0))])
def test_same_padding_matches_xla(n, k, s, want):
    assert _same_pads(n, k, s) == want
    x = np.random.default_rng(0).normal(size=(1, n, n, 2)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(k, k, 2, 3)).astype(np.float32)
    j = jax.lax.conv_general_dilated(x, w, (s, s), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    from repro_torch.models.vision import conv
    t = conv({"w": torch.from_numpy(w), "b": torch.zeros(3)},
             torch.from_numpy(x).permute(0, 3, 1, 2), s)
    np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                               rtol=1e-5, atol=1e-5)


def test_layernorm_eps_matches_jax():
    from repro.models.layers import layernorm as jax_layernorm
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32) * 1e-3
    p = {"scale": np.ones(6, np.float32), "bias": np.zeros(6, np.float32)}
    want = np.asarray(jax_layernorm(p, x))
    got = layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cuda_is_the_default_device_and_is_never_faked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model("cnn", 10, 16, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError):
        make_model("no-such-model", 10, 16, 1, device="cpu")
