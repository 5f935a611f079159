"""The port's LoRA substrate (``repro_torch.fl.lora``) and the plain version
of its kernel (``repro_torch.kernels.ref.lora_matmul``) against the JAX
package on the same numpy inputs: adapter paths and layout, the merge, the
unmerged single-layer forward, gradients, and carrying adapters across."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import lora as jlora
from repro.kernels import ref as jref
from repro.kernels.lora_matmul import lora_matmul as pallas_lora_matmul
from repro.models import vision as jvision
from repro_torch.convert import params_from_jax
from repro_torch.fl import lora
from repro_torch.kernels import ops, ref
from repro_torch.models import vision
from repro_torch.tree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def _match(path):
    return "qkv/w" in path


def _tree():
    """A 2-D and a stacked (L, d_in, d_out) adapted leaf, a 1-D leaf on a
    matching path and an unmatched 2-D leaf."""
    rng = np.random.default_rng(0)
    f = np.float32
    return {"blk": {"qkv": {"w": rng.normal(size=(64, 96)).astype(f),
                            "b": np.zeros((96,), f)},
                    "proj": {"w": rng.normal(size=(32, 64)).astype(f)}},
            "stack": {"qkv": {"w": rng.normal(size=(3, 64, 48)).astype(f)}}}


def _random_b(adapters_np, seed):
    """The adapters with B ~ N(0, 0.1²) too: B starts at zero, which would
    make A@B, and A's gradient, vanish."""
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"],
                "b": (0.1 * rng.normal(size=ab["b"].shape)).astype(np.float32)}
            for p, ab in adapters_np.items()}


def test_lora_paths_and_init_match_jax_layout():
    tree = _tree()
    cfg = lora.LoRAConfig(rank=8, match=_match)
    jcfg = jlora.LoRAConfig(rank=8, match=_match)
    assert lora.lora_paths(tree, cfg) == jlora.lora_paths(tree, jcfg) == [
        "blk/qkv/w", "stack/qkv/w"]
    want = jlora.lora_init(jax.random.PRNGKey(0), tree, jcfg)
    got = lora.lora_init(torch.Generator().manual_seed(0),
                         params_from_jax(tree, device="cpu"), cfg)
    assert sorted(got) == sorted(want)
    for path in got:
        for k in ("a", "b"):
            assert tuple(got[path][k].shape) == want[path][k].shape
            assert got[path][k].dtype == torch.float32
            assert want[path][k].dtype == jnp.float32
        assert not bool(got[path]["b"].any())
    assert tuple(got["stack/qkv/w"]["a"].shape) == (3, 64, 8)
    # a ~ N(0, 1) / sqrt(d_in): 2,048 draws per leaf at d_in = 64
    for path in got:
        std = float(got[path]["a"].std()) * np.sqrt(64)
        assert abs(std - 1.0) < 0.1, (path, std)
    assert cfg.scaling == jcfg.scaling == 2.0


def test_apply_lora_matches_jax_and_is_copy_on_write():
    tree = _tree()
    cfg = lora.LoRAConfig(rank=8, match=_match)
    jcfg = jlora.LoRAConfig(rank=8, match=_match)
    ad_np = _random_b(jax.tree.map(np.asarray, jlora.lora_init(
        jax.random.PRNGKey(3), tree, jcfg)), seed=1)
    want = jax.tree.map(np.asarray, jlora.apply_lora(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, ad_np), jcfg))
    params = params_from_jax(tree, device="cpu")
    before = {id(t) for t in tree_leaves(params)}
    got = lora.apply_lora(params, params_from_jax(ad_np, device="cpu"), cfg)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    assert {id(t) for t in tree_leaves(params)} == before
    np.testing.assert_array_equal(params["blk"]["qkv"]["w"].numpy(),
                                  tree["blk"]["qkv"]["w"])
    assert got["blk"]["proj"]["w"] is params["blk"]["proj"]["w"]
    assert not torch.equal(got["stack"]["qkv"]["w"], params["stack"]["qkv"]["w"])
    assert lora.merge_lora(params, params_from_jax(ad_np, device="cpu"), cfg) \
        .keys() == got.keys()


SHAPES = [(64, 128, 128, 8), (100, 300, 200, 16), (8, 512, 1024, 4)]


def _kernel_inputs(t, d, o, r, dtype):
    """``tests/test_kernels.py``'s inputs for its LoRA-matmul case, as
    numpy fp32 (already rounded to ``dtype``)."""
    key = jax.random.PRNGKey(2)
    keys = [key] + [jax.random.fold_in(key, i) for i in (1, 2, 3)]
    return [np.array(jax.random.normal(k, s, jnp.float32).astype(dtype),
                     np.float32)
            for k, s in zip(keys, ((t, d), (d, o), (d, r), (r, o)))]


def _close_over_mean(got, want, atol):
    """``tests/test_kernels.py``'s measure: the error over mean |want|."""
    scale = np.abs(want).mean() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


@pytest.mark.parametrize("t,d,o,r", SHAPES)
def test_plain_lora_matmul_matches_jax_ref_in_fp32(t, d, o, r):
    xs = _kernel_inputs(t, d, o, r, jnp.float32)
    want = np.asarray(jref.lora_matmul(*map(jnp.asarray, xs), 2.0))
    got = ref.lora_matmul(*map(torch.from_numpy, xs), 2.0)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, o)
    _close_over_mean(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("t,d,o,r", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_lora_matmul_matches_the_pallas_kernel(t, d, o, r, dtype):
    """As ``tests/test_kernels.py`` holds the Pallas kernel (interpret mode)
    against the fp32 oracle, on its inputs and with its tolerance (atol 2e-2
    for bf16 inputs, 1e-4 for fp32); here the oracle is the port's plain
    version in fp32."""
    xs = _kernel_inputs(t, d, o, r, jnp.dtype(dtype))
    got = pallas_lora_matmul(*(jnp.asarray(v, dtype) for v in xs), 2.0,
                             block_t=32, block_o=128, block_d=128,
                             interpret=True)
    want = ref.lora_matmul(*map(torch.from_numpy, xs), 2.0).numpy()
    _close_over_mean(np.asarray(got, np.float32), want,
                     2e-2 if dtype == "bfloat16" else 1e-4)


def test_plain_lora_matmul_in_bf16_tracks_jax_ref():
    """Both plain versions in bf16 round x@W, (x@A)@B and the sum in bf16,
    at points the two frameworks may place differently: held to the bf16
    tolerance above."""
    xs = _kernel_inputs(*SHAPES[1], jnp.bfloat16)
    want = jref.lora_matmul(*(jnp.asarray(v, jnp.bfloat16) for v in xs), 2.0)
    got = ref.lora_matmul(*(torch.from_numpy(v).to(torch.bfloat16) for v in xs),
                          2.0)
    assert got.dtype == torch.bfloat16
    _close_over_mean(got.float().numpy(), np.asarray(want, np.float32), 2e-2)


def test_lora_entry_point_is_the_merged_layer():
    """``fl.lora.lora_matmul(x, W, ab, cfg)`` computes ``x @ W_eff`` of the
    merged layer without merging (what ``chip_smoke.py`` checks on the card
    with the rounds' adapters)."""
    tree = _tree()
    cfg = lora.LoRAConfig(rank=8, match=_match)
    params = params_from_jax(tree, device="cpu")
    ad = params_from_jax(_random_b(jax.tree.map(np.asarray, lora.lora_init(
        torch.Generator().manual_seed(2), params, cfg)), seed=4), device="cpu")
    x = torch.randn((40, 64), generator=torch.Generator().manual_seed(5))
    path = "blk/qkv/w"
    got = lora.lora_matmul(x, params["blk"]["qkv"]["w"], ad[path], cfg)
    want = x @ lora.apply_lora(params, ad, cfg)["blk"]["qkv"]["w"]
    err = float((got - want).abs().max() / want.abs().mean())
    assert got.shape == (40, 96) and err < 1e-4, err


def test_gradients_reach_only_the_adapters_and_match_jax():
    """Mirror of ``tests/test_lora_checkpoint.py``'s gradient test on the
    registered ViT: a nonzero gradient for every adapter leaf, none for the
    base (which never requires grad), and the JAX gradient within 1e-5."""
    j_init, j_apply = jvision.make_model("vit", 10, 16, 1)
    base_np = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    cfg = lora.LoRAConfig(rank=4, match=_match)
    jcfg = jlora.LoRAConfig(rank=4, match=_match)
    ad_np = _random_b(jax.tree.map(np.asarray, jlora.lora_init(
        jax.random.PRNGKey(1), base_np, jcfg)), seed=2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16, 16, 1)).astype(np.float32)
    y = np.array([0, 1, 2, 3])

    def jloss(ad):
        logits = j_apply(jlora.apply_lora(jax.tree.map(jnp.asarray, base_np),
                                          ad, jcfg), jnp.asarray(x))
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1))

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, ad_np))
    _, t_apply = vision.make_model("vit", 10, 16, 1, device="cpu")
    base = params_from_jax(base_np, device="cpu")
    ad = params_from_jax(ad_np, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(ad)]
    logits = t_apply(lora.apply_lora(base, ad, cfg), torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert all(not t.requires_grad and t.grad is None for t in tree_leaves(base))
    for g, w in zip((t.grad for t in leaves), jax.tree.leaves(want)):
        assert float(g.abs().sum()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_params_from_jax_carries_an_adapter_dict_in_jax_leaf_order():
    """Adapter keys hold "/" ("blk0/qkv/w"); ``repro_torch.tree`` flattens
    them in ``jax.tree``'s sorted key order, bit for bit."""
    j_init, _ = jvision.make_model("vit", 10, 16, 1)
    base_np = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    ad_np = jax.tree.map(np.asarray, jlora.lora_init(
        jax.random.PRNGKey(1), base_np, jlora.LoRAConfig(rank=8, match=_match)))
    assert len(ad_np) == 6 and "blk0/qkv/w" in ad_np
    got = params_from_jax(ad_np, device="cpu")
    assert sorted(got) == sorted(ad_np)
    j_leaves, t_leaves = jax.tree.leaves(ad_np), tree_leaves(got)
    assert len(j_leaves) == len(t_leaves) == 12
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(a.numpy(), b)
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(ad_np)[0]]
    assert [f"{p[0].key}/{p[1].key}" for p in paths] == [
        f"{k}/{ab}" for k in sorted(ad_np) for ab in ("a", "b")]


def test_lora_matmul_wrapper_checks_shapes_on_every_device():
    x, w = torch.zeros((4, 8)), torch.zeros((8, 6))
    a, b = torch.zeros((8, 2)), torch.zeros((2, 6))
    with pytest.raises(ValueError, match="chain"):
        ops.lora_matmul(x, w, a, torch.zeros((3, 6)), 1.0)
    with pytest.raises(ValueError, match="2-d"):
        ops.lora_matmul(x[None], w, a, b, 1.0)
    with pytest.raises(ValueError, match="different devices"):
        ops.lora_matmul(x, w.to("meta"), a, b, 1.0)


def _outputs(n, seed):
    """n fp32 outputs near N(0, 1.3²), as the qwen3-shape checks on the card
    give, with a few at |y| ≈ 9, where half a bf16 ulp is 0.031."""
    rng = np.random.default_rng(seed)
    y = (1.3 * rng.standard_normal(n)).astype(np.float32)
    y[:4] = [9.03, -9.03, 9.09, -9.09]
    return torch.from_numpy(y).reshape(-1, 100)


@pytest.mark.parametrize("seed", [0, 1])
def test_card_tolerance_takes_one_bf16_rounding_and_refuses_more(seed):
    """``chip_smoke.lora_error`` holds the kernel on the card.  A bf16
    output that is the fp32 result rounded once (after fp32 summation noise)
    passes, though its error reaches 2.8% of mean |want|, past
    ``tests/test_kernels.py``'s 2e-2; two ulps off at one element, or an
    error of 2e-3 of mean |want| at a small output (which 2e-2 of the mean
    would pass), does not."""
    want = _outputs(200_000, seed)
    noise = torch.from_numpy(np.random.default_rng(seed + 9).standard_normal(
        want.shape).astype(np.float32)) * 1e-6
    got = (want + noise).to(torch.bfloat16)
    err = chip_smoke.lora_error(got, want)
    assert err["ok"] and err["err_over_mean"] > 2e-2, err
    assert err["differs_from_rounded"] < 1e-3, err
    off = got.clone()
    off[0, 0] = off[0, 0].float() + 2 * 2.0 ** -4          # two ulps at 9
    assert not chip_smoke.lora_error(off, want)["ok"]
    small = int(want.abs().argmin())
    off = got.clone().reshape(-1)
    off[small] = want.reshape(-1)[small] + 2e-3 * float(want.abs().mean())
    assert not chip_smoke.lora_error(off.reshape(want.shape), want)["ok"]
    assert chip_smoke.lora_error(want + noise, want)["ok"]             # fp32
    assert not chip_smoke.lora_error(want + 2e-4 * float(want.abs().mean()),
                                     want)["ok"]


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic (csrc/lora_matmul.cu), emulated on the CPU
# ---------------------------------------------------------------------------
def _kernel_arithmetic(x, w, a, b, s, split=True):
    """The bf16 kernel's arithmetic in plain PyTorch: bf16 operands, fp32
    sums of x·W and x·A over d in the kernel's 64-deep stages, then s·xa
    (fp32) split into bf16 hi + lo parts (``split``; else rounded to bf16
    once), acc += hi·B + lo·B per 16 of r, and one rounding to bf16."""
    x, w, a, b = (t.to(torch.bfloat16).float() for t in (x, w, a, b))
    acc = torch.zeros((x.shape[0], w.shape[1]))
    xa = torch.zeros((x.shape[0], a.shape[1]))
    for k0 in range(0, x.shape[1], 64):
        acc += x[:, k0:k0 + 64] @ w[k0:k0 + 64]
        xa += x[:, k0:k0 + 64] @ a[k0:k0 + 64]
    v = xa * s
    hi = v.to(torch.bfloat16).float()
    parts = (hi, (v - hi).to(torch.bfloat16).float()) if split else (hi,)
    for q0 in range(0, a.shape[1], 16):
        for p in parts:
            acc += p[:, q0:q0 + 16] @ b[q0:q0 + 16]
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize("t,d,o,r", SHAPES)
def test_kernel_arithmetic_matches_the_pallas_kernel(t, d, o, r):
    """The emulated bf16 kernel against the Pallas kernel in interpret
    mode, on ``tests/test_kernels.py``'s inputs and with its bf16 measure
    (2e-2 of mean |want|), as the plain version is held above."""
    xs = _kernel_inputs(t, d, o, r, jnp.bfloat16)
    want = pallas_lora_matmul(*(jnp.asarray(v, jnp.bfloat16) for v in xs),
                              2.0, block_t=32, block_o=128, block_d=128,
                              interpret=True)
    got = _kernel_arithmetic(*map(torch.from_numpy, xs), 2.0)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (t, o)
    _close_over_mean(got.float().numpy(), np.asarray(want, np.float32), 2e-2)


@pytest.mark.parametrize("r", [4, 8, 64])
def test_kernel_arithmetic_holds_the_card_tolerance_at_qwen3_width(r):
    """At qwen3-1.7b's d = o = 2048 (256 rows, ``chip_smoke.lora_inputs``'s
    scales, s = 16 / r) the hi + lo epilogue holds ``chip_smoke.LORA_TOL``
    against the exact result in fp64, while rounding s·xa to bf16 once
    before the B product misses it: the design choice the kernel makes."""
    rng = np.random.default_rng(r)
    T, d, o = 256, 2048, 2048

    def bf16(shape, std):
        v = (std * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(v).to(torch.bfloat16)

    x = bf16((T, d), 1.0)
    w = bf16((d, o), d ** -0.5)
    a = bf16((d, r), d ** -0.5)
    b = bf16((r, o), 0.1)
    s = chip_smoke.LORA_ALPHA / r
    x64, w64, a64, b64 = (t.double() for t in (x, w, a, b))
    want = (x64 @ w64 + s * (x64 @ a64) @ b64).float()
    split = chip_smoke.lora_error(_kernel_arithmetic(x, w, a, b, s), want)
    once = chip_smoke.lora_error(_kernel_arithmetic(x, w, a, b, s, split=False),
                                 want)
    assert split["ok"], split
    assert not once["ok"] and once["share_of_limit"] > 10.0, once


def test_lora_route_takes_tma_only_where_it_can_map_the_operands():
    """``ops.lora_route`` picks the bf16 kernel's TMA route for d and o
    multiples of 8 on 16-byte aligned bases, and the cp.async route for
    d = 300, o = 1001 or x two bytes off its buffer's alignment."""
    def route(T, d, o, r, x_offset=0):
        x, w, _, b = chip_smoke.lora_inputs(T, d, o, r, torch.bfloat16, 0,
                                            device="cpu", x_offset=x_offset)
        return ops.lora_route(x, w, b)

    assert route(64, 2048, 2048, 8) == "tma"
    assert route(64, 2048, 1000, 5) == "tma"
    assert route(64, 300, 200, 16) == "cp.async"
    assert route(64, 2048, 1001, 8) == "cp.async"
    assert route(64, 2048, 2048, 8, x_offset=1) == "cp.async"
