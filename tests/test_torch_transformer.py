"""The port's decoder stack (``repro_torch.models.transformer`` and what it
runs: configs, layers, attention, FFN, loss, token streams, param
conversion) against the JAX package on ``qwen3-1.7b-smoke``, with JAX
params carried across leaf for leaf and numpy tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.data import tokens as jtokens
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import loss as jloss
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.data import tokens as ttokens
from repro_torch.models import layers, loss
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten, tree_leaves

ARCH = "qwen3-1.7b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(dtype="float32", **over):
    return (dataclasses.replace(jget_smoke(ARCH), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **over))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1                                  # masked targets
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs, token streams, layers, loss
# ---------------------------------------------------------------------------
def test_configs_are_the_jax_configs():
    assert list_archs() == ["codeqwen1.5-7b", "deepseek-v2-236b", "gemma-7b",
                            "llava-next-mistral-7b", "mixtral-8x22b",
                            "paper-vit-b16", ARCH, "seamless-m4t-large-v2",
                            "starcoder2-7b", "xlstm-125m", "zamba2-1.2b"]
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    assert get_config(ARCH).param_count() == jget_config(ARCH).param_count()
    with pytest.raises(KeyError):
        get_config("mixtral-8x7b")
    with pytest.raises(KeyError):
        get_smoke_config("no-such-arch")


@pytest.mark.parametrize("over", [dict(block_pattern=("attn", "attn"))])
def test_unported_stacks_raise(over):
    _, cfg = _cfgs(**over)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.init_params(cfg, device="cpu")


def test_token_streams_are_the_jax_streams():
    a = ttokens.make_bigram_stream(5000, 512, domain=3, n_domains=8, seed=1)
    b = jtokens.make_bigram_stream(5000, 512, domain=3, n_domains=8, seed=1)
    np.testing.assert_array_equal(a, b)
    for (ta, la), (tb, lb) in zip(
            [next(ttokens.batches_from_stream(a, 4, 64, seed=2))],
            [next(jtokens.batches_from_stream(b, 4, 64, seed=2))]):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # split halves, not interleaved pairs: the rotation keeps the norm of
    # each (x1[i], x2[i]) pair, which it would not with interleaved pairs
    half = torch.from_numpy(x).chunk(2, -1)
    rot = got.chunk(2, -1)
    np.testing.assert_allclose(_np(half[0] ** 2 + half[1] ** 2),
                               _np(rot[0] ** 2 + rot[1] ** 2), rtol=1e-5,
                               atol=1e-5)


def test_chunked_cross_entropy_matches_jax_and_full():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 32, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    lab = rng.integers(-1, 50, (2, 32)).astype(np.int32)
    got, cnt = loss.chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                          torch.from_numpy(lab), chunk=8)
    want, wcnt = jloss.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                             jnp.asarray(lab), chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(cnt) == float(wcnt) == float((lab >= 0).sum())
    full = loss.full_cross_entropy(torch.from_numpy(h) @ torch.from_numpy(w),
                                   torch.from_numpy(lab))
    np.testing.assert_allclose(float(full), float(got), rtol=1e-5)


# ---------------------------------------------------------------------------
# params: conversion and the port's own init
# ---------------------------------------------------------------------------
def test_params_from_jax_bf16_is_bit_exact_and_keeps_stacked_layers():
    jcfg, cfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg)
    jleaves, _ = jax.tree.flatten(jp)
    tleaves, _ = tree_flatten(tp)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    assert tp["layers"]["attn"]["wq"]["w"].shape[0] == cfg.num_layers


def test_port_init_has_the_jax_tree_shapes():
    jcfg, cfg = _cfgs("bfloat16")
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    j_leaves = jax.tree.leaves(jshapes)
    tp = T.init_params(cfg, seed=3, device="cpu")
    t_leaves = tree_leaves(tp)
    assert [tuple(a.shape) for a in j_leaves] == [tuple(t.shape) for t in t_leaves]
    assert all(t.dtype == torch.bfloat16 for t in t_leaves)
    again = T.init_params(cfg, seed=3, device="cpu")
    for a, b in zip(t_leaves, tree_leaves(again)):
        assert torch.equal(a, b)
    other = T.init_params(cfg, seed=4, device="cpu")
    assert not torch.equal(tp["embed"]["embedding"], other["embed"]["embedding"])


# ---------------------------------------------------------------------------
# forward and decode against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hidden_states_and_forward_match_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    jb, tb = _batch(cfg.vocab_size)
    jh, _ = JT.hidden_states(jp, jcfg, jb)
    th, aux = T.hidden_states(tp, cfg, tb)
    assert th.dtype == T.torch_dtype(cfg) and float(aux) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(_np(th), _np(jh), **TOL[dtype])
    else:
        # XLA and eager PyTorch round bf16 at different points, and a residual
        # sum that cancels to near zero keeps its addends' rounding (one bf16
        # ulp of a value ~4 is 0.03).  So the bf16 hidden states are held to
        # the fp32 forward of the same params: the port's error must be no
        # larger than the JAX package's own bf16 error.
        j32cfg, _ = _cfgs("float32")
        j32, _ = JT.hidden_states(jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                                  j32cfg, jb)
        err_port = np.abs(_np(th) - _np(j32))
        err_jax = np.abs(_np(jh) - _np(j32))
        assert err_port.max() <= 1.25 * err_jax.max(), (err_port.max(), err_jax.max())
        assert err_port.mean() <= 1.25 * err_jax.mean(), (err_port.mean(), err_jax.mean())
        assert np.mean(np.abs(_np(th) - _np(jh)) > 3e-2 + 3e-2 * np.abs(_np(jh))) < 1e-3
    jl, jm = JT.forward(jp, jcfg, jb, loss_chunk=16)
    tl, tm = T.forward(tp, cfg, tb, loss_chunk=16)
    np.testing.assert_allclose(float(tl), float(jl), **TOL[dtype])
    assert float(tm["target_tokens"]) == float(jm["target_tokens"]) == 61.0


def test_forward_matches_jax_with_pallas_kernels_in_interpret_mode():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batch(cfg.vocab_size, S=64, seed=1)
    jops.set_mode("interpret")
    try:
        jl, _ = JT.forward(jp, jcfg, jb, loss_chunk=32)
    finally:
        jops.set_mode("off")
    tl, _ = T.forward(tp, cfg, tb, loss_chunk=32)
    np.testing.assert_allclose(float(tl), float(jl), **TOL["float32"])


@pytest.mark.parametrize("cache_len", [32, 16])     # 16: the ring wraps at 16
def test_decode_step_logits_match_jax_step_by_step(cache_len):
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    js = JT.init_decode_state(jp, jcfg, 2, cache_len)
    ts = T.init_decode_state(tp, cfg, 2, cache_len)
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    for t in range(24):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tlog, ts = T.decode_step(tp, cfg, ts, torch.from_numpy(toks[:, t:t + 1]).long())
        assert tlog.dtype == torch.float32 and tlog.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(_np(tlog), _np(jlog), err_msg=f"t={t}",
                                   **TOL["float32"])
    assert ts["layers"].length == 24 and int(js["layers"].length[0]) == 24
    np.testing.assert_allclose(_np(ts["layers"].k), _np(js["layers"].k),
                               **TOL["float32"])


def test_decode_past_window_matches_windowed_forward():
    """tests/test_decode_ring_buffer.py on the port: with an 8-token window
    the cache is 8 slots, and decoding 3x past it matches the windowed
    forward; the windowed forward matches the JAX package's."""
    jcfg, cfg = _cfgs(sliding_window=8)
    jp, tp = _params(jcfg)
    B, S = 2, 24
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    tb = {"tokens": torch.from_numpy(toks).long()}
    h, _ = T.hidden_states(tp, cfg, tb)
    fwd = _np(h @ T.lm_head_w(tp, cfg))
    jh, _ = JT.hidden_states(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                             q_chunk=8)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL["float32"])
    state = T.init_decode_state(tp, cfg, B, S)
    assert state["layers"].k.shape[2] == 8
    for t in range(S):
        logits, state = T.decode_step(tp, cfg, state, tb["tokens"][:, t:t + 1])
        np.testing.assert_allclose(_np(logits), fwd[:, t], rtol=2e-3, atol=2e-3,
                                   err_msg=f"t={t}")


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` the new entry points ask for the card, and
    raise on a machine without one instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.launch import serve
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--decode-steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    # the training path: the entry points ask for the card, and the parallel
    # round runs where its params lie, with no CPU fallback for a device
    # that has no kernel
    from repro_torch.fl.parallel import make_fft_round_step
    from repro_torch.launch import fft_lora_llm, train
    from repro_torch.tree import tree_map
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke-scale=true", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fft_lora_llm.run(cfg, rounds=1)
    meta = tree_map(lambda t: t.to("meta"), T.init_params(cfg, device="cpu"))
    toks = torch.zeros((2, 1, 8), dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        make_fft_round_step(cfg)(meta, toks, toks, torch.tensor([1.0, 0.0]))
