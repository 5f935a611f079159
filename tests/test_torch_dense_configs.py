"""The dense configs of the port (codeqwen1.5-7b, starcoder2-7b, gemma-7b,
paper-vit-b16) against the JAX package, one case per arch: the configs,
the params carried across leaf for leaf, the forward in fp32 and bf16,
decode steps (starcoder2's ring wrapping past its 64-token window), greedy
generation, gemma's forward beside the JAX package's Pallas kernels in
interpret mode, the plain attention at the head dims these configs bring
(24, 48, 256) against the JAX references, the head-dim rules that the
card's wrappers check before a launch, and the helpers that hold
``chip_smoke.py``'s full-width ``[dense]`` forwards on the card (the loss
predicted from the hidden states, the plain attention swapped in, with P
rounded to bf16).  The smoke configs' JAX params are converted with
``convert.params_from_jax``; tokens come from numpy."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten, tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

ARCHS = ["codeqwen1.5-7b", "starcoder2-7b", "gemma-7b", "paper-vit-b16"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: under pytest-xdist torch's intra-op pool only
    oversubscribes the cores, so the module runs on one thread and
    restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32", seed=0):
    """(JAX config, port config, JAX params, port params) of ``arch``'s
    smoke config in ``dtype``, the port's converted from the JAX init."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    jcfg = _pair(arch)[0]
    return jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))


def _batch(vocab, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_configs(arch):
    for mine, theirs in ((get_config(arch), jget_config(arch)),
                         (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_leaf_for_leaf(arch):
    """Every JAX leaf has its counterpart of the same key path, shape and
    bits (bf16), and the port's own init builds the same tree: the
    attention biases ``b``, the GELU FFN's two matrices with their biases,
    and an ``lm_head`` exactly when the head is untied."""
    jcfg, cfg, jp, tp = _pair(arch, "bfloat16")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves, _ = tree_flatten(tp)
    assert len(jleaves) == len(tleaves)
    for (path, a), t in zip(jleaves, tleaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    mine = T.init_params(cfg, seed=1, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(mine)] == \
        [tuple(t.shape) for t in tleaves]
    layer = tp["layers"]
    assert ("b" in layer["attn"]["wq"]) == cfg.attn_bias
    assert ("b" in layer["attn"]["wk"]) == ("b" in layer["attn"]["wv"]) \
        == cfg.attn_bias
    assert "b" not in layer["attn"]["wo"]
    if cfg.ffn_activation == "gelu":
        assert set(layer["ffn"]) == {"w_up", "w_down"}
        assert all("b" in layer["ffn"][m] for m in ("w_up", "w_down"))
    else:
        assert set(layer["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# forward, decode, generation against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_and_forward_match_jax(arch, dtype):
    """fp32 within 1e-4; bf16 by the standing rule: the port's error against
    the fp32 forward of the same params is at most 1.25x the JAX package's
    own bf16 error, in max and in mean (``test_torch_transformer.py``)."""
    jcfg, cfg, jp, tp = _pair(arch, dtype)
    jb, tb = _batch(cfg.vocab_size)
    jh, _ = JT.hidden_states(jp, jcfg, jb)
    th, _ = T.hidden_states(tp, cfg, tb)
    if dtype == "float32":
        np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    else:
        j32cfg = dataclasses.replace(jcfg, dtype="float32")
        j32, _ = JT.hidden_states(
            jax.tree.map(lambda a: a.astype(jnp.float32), jp), j32cfg, jb)
        err_port = np.abs(_np(th) - _np(j32))
        err_jax = np.abs(_np(jh) - _np(j32))
        assert err_port.max() <= 1.25 * err_jax.max(), (err_port.max(), err_jax.max())
        assert err_port.mean() <= 1.25 * err_jax.mean(), (err_port.mean(), err_jax.mean())
    jl, jm = JT.forward(jp, jcfg, jb, loss_chunk=16)
    tl, tm = T.forward(tp, cfg, tb, loss_chunk=16)
    np.testing.assert_allclose(float(tl), float(jl),
                               **(TOL if dtype == "float32"
                                  else dict(rtol=3e-2, atol=3e-2)))
    assert float(tm["target_tokens"]) == float(jm["target_tokens"]) == 61.0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_jax_step_by_step(arch):
    """fp32 logits of every step within 1e-4, the ring wrapping: a 16-slot
    cache over 24 steps, and starcoder2's window-sized 64-slot ring over 72
    steps (its cache is min(cache_len, window))."""
    jcfg, cfg, jp, tp = _pair(arch)
    cache_len, steps = (128, 72) if cfg.sliding_window else (16, 24)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, steps)) \
        .astype(np.int32)
    js = JT.init_decode_state(jp, jcfg, 2, cache_len)
    ts = T.init_decode_state(tp, cfg, 2, cache_len)
    assert ts["layers"].k.shape[2] == min(cache_len, cfg.sliding_window or cache_len)
    step = _jax_decode(arch)
    for t in range(steps):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tlog, ts = T.decode_step(tp, cfg, ts, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(_np(tlog), _np(jlog), err_msg=f"t={t}", **TOL)
    assert ts["layers"].length == steps
    np.testing.assert_allclose(_np(ts["layers"].k), _np(js["layers"].k), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_match_jax(arch):
    """``launch/serve.py``'s greedy loop against the JAX package's, a
    12-slot ring that wraps."""
    jcfg, cfg, jp, tp = _pair(arch)
    step = _jax_decode(arch)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 8)) \
        .astype(np.int32)
    state = JT.init_decode_state(jp, jcfg, 3, 12)
    for t in range(8):
        logits, state = step(jp, state, jnp.asarray(prompts[:, t:t + 1]))
    tok = jnp.argmax(logits, -1)[:, None]
    want = [np.asarray(tok)]
    for _ in range(10):
        logits, state = step(jp, state, tok)
        tok = jnp.argmax(logits, -1)[:, None]
        want.append(np.asarray(tok))
    res = serve.generate(tp, cfg, torch.from_numpy(prompts).long(), 10, 12)
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(want, 1))


def test_gemma_forward_matches_jax_with_pallas_kernels_in_interpret_mode():
    """gemma-7b-smoke's hd 48: the Pallas flash kernel pads it to 128 lanes
    inside, the port's plain version takes it as it is."""
    jcfg, cfg, jp, tp = _pair("gemma-7b")
    jb, tb = _batch(cfg.vocab_size, S=64, seed=1)
    jops.set_mode("interpret")
    try:
        jl, _ = JT.forward(jp, jcfg, jb, loss_chunk=32)
    finally:
        jops.set_mode("off")
    tl, _ = T.forward(tp, cfg, tb, loss_chunk=32)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


# ---------------------------------------------------------------------------
# attention at the new head dims
# ---------------------------------------------------------------------------
def _qkv(B, Sq, Sk, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    out = []
    for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)):
        x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jdt)
        out.append((x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)))
    return out


def _attn_tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bf16" else \
        dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hd,H,KV,window", [(24, 6, 2, 64), (48, 4, 4, None),
                                            (256, 4, 4, None), (256, 4, 2, 40)])
def test_plain_flash_attention_at_the_new_head_dims_matches_jax(hd, H, KV,
                                                              window, dtype):
    """The plain version against the JAX reference, and (hd 24, 48: the
    smoke configs) against the Pallas kernel in interpret mode, which pads
    hd to 128 lanes."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 96, 96, H, KV, hd, dtype, seed=hd)
    kw = dict(causal=True, window=window)
    got = ref.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(jref.flash_attention(jq, jk, jv, **kw)),
                               **_attn_tol(dtype))
    if hd < 128:
        want = pallas_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True,
                            **kw)
        np.testing.assert_allclose(_np(got), _np(want), **_attn_tol(dtype))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hd,H,KV,S,n_valid", [(24, 6, 2, 64, 40),
                                               (48, 4, 4, 100, 77),
                                               (256, 16, 16, 200, 96)])
def test_plain_decode_attention_at_the_new_head_dims_matches_jax(hd, H, KV, S,
                                                               n_valid, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, S, H, KV, hd, dtype, seed=S)
    valid = np.roll(np.arange(S) < n_valid, S // 3)    # a wrapped ring
    scale = 1.0 / np.sqrt(hd)
    got = ref.decode_attention(tq, tk, tv, torch.from_numpy(valid), scale=scale)
    want = jref.decode_attention(jq, jk, jv, jnp.asarray(valid), scale=scale)
    np.testing.assert_allclose(_np(got), _np(want), **_attn_tol(dtype))


@pytest.mark.parametrize("hd,ok", [(8, True), (24, True), (48, True),
                                   (96, True), (136, True), (256, True),
                                   (4, False), (20, False), (100, False),
                                   (260, False), (264, False)])
def test_card_head_dim_rule(hd, ok):
    """What the card's forward and decode kernels take (checked before any
    launch): a head dim that is a multiple of 8 in [8, 256]; the CPU's plain
    versions take any."""
    q, k = torch.zeros(1, 8, 4, hd), torch.zeros(1, 8, 2, hd)
    if ok:
        ops._check_launchable("flash_attention", q, k, k)
    else:
        with pytest.raises(ValueError, match="multiple of 8 in \\[8, 256\\]"):
            ops._check_launchable("flash_attention", q, k, k)
    valid = torch.ones(8, dtype=torch.bool)
    assert ops.decode_attention(q[:, :1], k, k, valid, scale=1.0).shape == \
        (1, 1, 4, hd)


@pytest.mark.parametrize("hd", [24, 32, 48, 64, 128, 256, 20, 100, 264])
def test_card_backward_takes_the_forwards_head_dims(hd):
    """The backward kernels take the forward's head dims, any multiple of
    8 in [8, 256] (the smoke configs' padded 24 and 48, gemma-7b's 256),
    and refuse others (20, 100, 264) with the forward's ``ValueError``
    before a launch.  On the CPU the plain backward takes any head dim."""
    q, k = torch.zeros(1, 8, 4, hd), torch.zeros(1, 8, 2, hd)
    if hd % 8 == 0 and 8 <= hd <= 256:
        ops._check_launchable("flash_attention_bwd", q, k, k, q, q)
    else:
        with pytest.raises(ValueError, match="flash_attention_bwd: head dim "
                                             f"{hd} is not a multiple of 8"):
            ops._check_launchable("flash_attention_bwd", q, k, k, q, q)
    qc = torch.randn(1, 8, 4, hd, requires_grad=True)
    kc = torch.randn(1, 8, 2, hd)
    ops.flash_attention(qc, kc, kc).sum().backward()
    assert bool(torch.isfinite(qc.grad).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_loss_prediction_holds_the_forward(arch):
    """``chip_smoke.init_loss_prediction``, the two-sided check of the card's
    full-width forwards, on the config's full width at 2 layers, a narrow
    FFN and 32,000 tokens in bf16: the forward's loss within
    ``DENSE_LOSS_TOL`` of the prediction from its hidden states, gemma's
    (own-token logits of about 40 here, its embeddings scaled by sqrt(d))
    too, where ln V + σ²/2 would miss by 30."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2, d_ff=1024,
                              vocab_size=32_000, dtype="bfloat16")
    params = T.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    with torch.no_grad():
        loss, _ = T.forward(params, cfg, batch, loss_chunk=128)
        h, _ = T.hidden_states(params, cfg, batch)
    want = chip_smoke.init_loss_prediction(h, T.lm_head_w(params, cfg),
                                           batch["tokens"], batch["labels"])
    assert abs(float(loss) - want) <= chip_smoke.DENSE_LOSS_TOL, (float(loss), want)
    naive = np.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model
    assert (abs(float(loss) - naive) > 10) == arch.startswith("gemma")


def test_plain_flash_attention_swaps_the_wrapper_for_the_block():
    """``chip_smoke.plain_flash_attention`` runs the models' attention
    through the plain version inside the block and restores the wrapper
    after, also when the block raises."""
    kernel = ops.flash_attention
    with chip_smoke.plain_flash_attention():
        assert ops.flash_attention is ref.flash_attention
    assert ops.flash_attention is kernel
    with pytest.raises(RuntimeError):
        with chip_smoke.plain_flash_attention():
            raise RuntimeError
    assert ops.flash_attention is kernel


@pytest.mark.parametrize("window", [None, 16])
def test_plain_attention_with_p_rounded_is_the_plain_version_up_to_that_rounding(
        window):
    """``chip_smoke.plain_attention_bf16_p``, the floor of ``[dense]``'s
    hidden-state check: in fp32 (no rounding) the plain version within
    1e-6; in bf16 within the card's ``ATTN_TOL`` of it, and not equal."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, h, 48, generator=g) for h in (6, 2, 2))
    kw = dict(causal=True, window=window)
    torch.testing.assert_close(chip_smoke.plain_attention_bf16_p(q, k, v, **kw),
                               ref.flash_attention(q, k, v, **kw),
                               rtol=1e-6, atol=1e-6)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = chip_smoke.plain_attention_bf16_p(qb, kb, vb, **kw)
    want = ref.flash_attention(qb, kb, vb, **kw)
    assert chip_smoke.attention_error(got, want)["ok"]
    assert not torch.equal(got, want)
