"""The port's MoE block (``repro_torch.models.moe``), MLA, cross-attention,
the non-causal encoder attention and the plain chunked attention
(``repro_torch.models.attention``) against the JAX package, block by
block, on the same numpy inputs with JAX params carried across
(``convert.params_from_jax``).

Routing is a discrete choice: a top-k that flips on a near-tie is a
different result, not noise.  So every routing check also holds the
inputs' top-k margin (the k-th largest probability over the (k+1)-th,
per token) above the difference between the two packages' probabilities:
the expert ids then cannot differ by rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: under pytest-xdist torch's intra-op pool only
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **over):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over))


# (arch, overrides): the smoke configs' routers (mixtral: 4 experts top-2;
# deepseek: 4 top-2 and a shared expert), a GeGLU expert, and deepseek's
# published counts (160 experts top-6, 2 shared) at a narrow width
MOE_CASES = {
    "mixtral": ("mixtral-8x22b", {}),
    "deepseek": ("deepseek-v2-236b", {}),
    "geglu": ("mixtral-8x22b", dict(ffn_activation="geglu", num_experts=8)),
    "e160k6": ("deepseek-v2-236b", dict(d_model=64, moe_d_ff=32,
                                        num_experts=160, num_experts_per_tok=6,
                                        num_shared_experts=2)),
}


def _moe_pair(case, dtype="float32", seed=0):
    arch, over = MOE_CASES[case]
    jcfg, cfg = _cfgs(arch, dtype, **over)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])


def router_margin(probs: np.ndarray, k: int) -> float:
    """min over tokens of p_(k) - p_(k+1), the probabilities sorted down."""
    s = -np.sort(-probs, axis=-1)
    if k == probs.shape[-1]:
        return np.inf
    return float((s[:, k - 1] - s[:, k]).min())


def _probs(p_router_w, x2d):
    return np.asarray(jax.nn.softmax(
        jnp.asarray(x2d, jnp.float32) @ jnp.asarray(p_router_w), axis=-1))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_route_matches_jax(case):
    """Expert ids equal, gates and the aux loss within 1e-6, and the margin
    of the top-k above the two packages' probability difference."""
    jcfg, cfg, jp, tp = _moe_pair(case)
    jx, tx = _x((48, cfg.d_model), seed=1)
    jg, je, ja = jmoe._route(jp, jcfg, jx)
    tg, te, ta = moe._route(tp, cfg, tx)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    jprobs = _probs(jp["router"]["w"], jx)
    tprobs = torch.softmax(tx @ tp["router"]["w"], -1).numpy()
    diff = float(np.abs(jprobs - tprobs).max())
    assert router_margin(tprobs, cfg.num_experts_per_tok) > diff, diff


@pytest.mark.parametrize("case", ["mixtral", "e160k6"])
def test_route_ties_keep_the_lower_expert_id(case):
    """A zero router gives every expert 1/E: both packages take experts
    0..k-1, as ``lax.top_k`` breaks ties, with gates 1/k."""
    jcfg, cfg, jp, tp = _moe_pair(case)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    jx, tx = _x((5, cfg.d_model), seed=2)
    k = cfg.num_experts_per_tok
    want = np.tile(np.arange(k), (5, 1))
    np.testing.assert_array_equal(np.asarray(jmoe._route(jp, jcfg, jx)[1]), want)
    tg, te, ta = moe._route(tp, cfg, tx)
    np.testing.assert_array_equal(te.numpy(), want)
    np.testing.assert_allclose(tg.numpy(), 1.0 / k, rtol=1e-6)
    np.testing.assert_allclose(float(ta), k, rtol=1e-6)   # E · Σ (k/E)(1/E)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S", [(2, 24), (1, 2)])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_jax(case, B, S):
    """``moe_forward`` against JAX's (``_moe_local`` plus the shared
    experts, scaled aux) within 1e-5, one host read of the group sizes a
    call.  At B=1 x S=2 most experts get no rows (e160k6: at most 12 of
    160), and their products are skipped."""
    jcfg, cfg, jp, tp = _moe_pair(case)
    jx, tx = _x((B, S, cfg.d_model), seed=3)
    jo, ja = jmoe.moe_forward(jp, jcfg, jx)
    moe.reset_readbacks()
    to, ta = moe.moe_forward(tp, cfg, tx)
    assert moe.readbacks["moe_group_sizes"] == 1
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6, atol=1e-9)
    eids = moe._route(tp, cfg, tx.reshape(B * S, -1))[1]
    used = len(torch.unique(eids))
    assert used <= B * S * cfg.num_experts_per_tok
    if case == "e160k6" and B * S == 2:
        assert used <= 12 < cfg.num_experts
    probs = torch.softmax(tx.reshape(B * S, -1) @ tp["router"]["w"], -1).numpy()
    diff = np.abs(_probs(jp["router"]["w"], jx.reshape(B * S, -1)) - probs).max()
    assert router_margin(probs, cfg.num_experts_per_tok) > diff


@pytest.mark.parametrize("case", ["mixtral", "deepseek"])
def test_moe_forward_bf16_within_jaxs_own_rounding(case):
    """bf16 by the standing rule: the port's error against the fp32 block on
    the same (bf16-rounded) params and inputs at most 1.25x JAX's own bf16
    error, in max and in mean."""
    jcfg, cfg, jp, tp = _moe_pair(case, "bfloat16")
    jx, tx = _x((2, 24, cfg.d_model), seed=4, dtype="bfloat16")
    j32cfg = dataclasses.replace(jcfg, dtype="float32")
    j32, _ = jmoe.moe_forward(jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                              j32cfg, jx.astype(jnp.float32))
    jo, _ = jmoe.moe_forward(jp, jcfg, jx)
    to, _ = moe.moe_forward(tp, cfg, tx)
    assert to.dtype == torch.bfloat16
    err_port = np.abs(_np(to) - _np(j32))
    err_jax = np.abs(_np(jo) - _np(j32))
    assert err_port.max() <= 1.25 * err_jax.max(), (err_port.max(), err_jax.max())
    assert err_port.mean() <= 1.25 * err_jax.mean(), (err_port.mean(), err_jax.mean())



@pytest.mark.parametrize("k", [2, 6])
def test_combine_sums_in_the_order_of_jaxs_scatter(k):
    """bf16 gated rows sorted by expert, as ``_moe_local`` sorts them, are
    summed per token bitwise as JAX's ``.at[tok_s].add`` sums them
    (ascending expert id, a rounding after each add).  With k > 2 a sum in
    fp32 rounded once differs, so the test holds the order."""
    T_, E, d = 64, 160, 32
    rng = np.random.default_rng(k)
    eids = np.stack([rng.choice(E, k, replace=False) for _ in range(T_)])
    tok_s = np.repeat(np.arange(T_), k)[np.argsort(eids.reshape(-1), kind="stable")]
    rows = rng.normal(size=(T_ * k, d)) * np.exp2(rng.integers(-4, 5, (T_ * k, 1)))
    jg = jnp.asarray(rows.astype(np.float32)).astype(jnp.bfloat16)
    want = jnp.zeros((T_, d), jnp.bfloat16).at[jnp.asarray(tok_s)].add(jg)
    tg = torch.from_numpy(_np(jg)).to(torch.bfloat16)
    got = moe._combine(tg, torch.from_numpy(tok_s), T_, k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    once = torch.zeros((T_, d)).index_add_(0, torch.from_numpy(tok_s), tg.float())
    assert (k > 2) == bool((once.to(torch.bfloat16) != got).any())

def test_moe_params_are_the_jax_params():
    """Router fp32 (d, E), expert stacks (E, d, f) and (E, f, d), the
    shared FFN's hidden width ``moe_d_ff × num_shared_experts``; the port's
    own init builds the same tree."""
    jcfg, cfg, jp, tp = _moe_pair("e160k6", "bfloat16")
    mine = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    for tree in (tp, mine):
        assert tree["router"]["w"].dtype == torch.float32
        assert tuple(tree["router"]["w"].shape) == (64, 160)
        assert tuple(tree["w_gate"].shape) == tuple(tree["w_up"].shape) == (160, 64, 32)
        assert tuple(tree["w_down"].shape) == (160, 32, 64)
        assert tree["w_gate"].dtype == torch.bfloat16
        assert tuple(tree["shared"]["w_gate"]["w"].shape) == (64, 64)
    assert set(mine) == set(tp) == set(jp)
    # draws scaled as JAX's: 1/sqrt(d) into the experts, 1/sqrt(d_ff) out
    assert abs(float(mine["w_gate"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(mine["w_down"].float().std()) - 32 ** -0.5) < 0.01


# ---------------------------------------------------------------------------
# the plain chunked attention
# ---------------------------------------------------------------------------
SDPA_CASES = [
    # B, Sq, Sk, H, KV, hd, vd, causal, window, q_offset, q_chunk
    (2, 32, 32, 4, 4, 48, 32, True, None, 0, 2048),     # MLA's vd < hd
    (2, 64, 64, 4, 4, 48, 32, True, None, 0, 16),       # chunked
    (1, 40, 40, 6, 2, 16, 16, True, 12, 0, 8),          # GQA, window
    (2, 24, 40, 4, 4, 16, 16, False, None, 0, 8),       # cross: Sq != Sk
    (1, 16, 48, 4, 2, 16, 24, True, None, 32, 4),       # an offset chunk
]


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_matches_jax(case):
    B, Sq, Sk, H, KV, hd, vd, causal, window, off, qc = case
    jq, tq = _x((B, Sq, H, hd), seed=5)
    jk, tk = _x((B, Sk, KV, hd), seed=6)
    jv, tv = _x((B, Sk, KV, vd), seed=7)
    kw = dict(causal=causal, window=window, q_offset=off, scale=hd ** -0.5,
              q_chunk=qc)
    want = jattn._sdpa(jq, jk, jv, **kw)
    got = attn.sdpa(tq, tk, tv, **kw)
    assert got.shape == (B, Sq, H, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdpa_chunk_must_divide_the_queries():
    """JAX's ``Sq % q_chunk == 0`` rule (an assert there, a ValueError in
    the port)."""
    jq, tq = _x((1, 24, 2, 8), seed=8)
    kw = dict(causal=True, window=None, q_offset=0, scale=1.0, q_chunk=16)
    with pytest.raises(AssertionError):
        jattn._sdpa(jq, jq, jq, **kw)
    with pytest.raises(ValueError, match="not a multiple of q_chunk 16"):
        attn.sdpa(tq, tq, tq, **kw)


# ---------------------------------------------------------------------------
# MLA, cross-attention, the encoder's attention
# ---------------------------------------------------------------------------
def _attn_pair(arch, init, dtype="float32", seed=0, **over):
    jcfg, cfg = _cfgs(arch, dtype, **over)
    jp = getattr(jattn, init)(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


@pytest.mark.parametrize("q_chunk", [2048, 8])
def test_mla_forward_matches_jax(q_chunk):
    """Latent projections, one shared rope head broadcast after its RoPE,
    scale 1/sqrt(nope + rope), value head dim 32 against a query's 48."""
    jcfg, cfg, jp, tp = _attn_pair("deepseek-v2-236b", "attn_init")
    assert set(tp) == {"q_down", "q_norm", "q_up", "kv_down", "kv_norm",
                       "kv_up", "wo"}
    jx, tx = _x((2, 32, cfg.d_model), seed=9)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want = jattn.mla_forward(jp, jcfg, jx, jnp.asarray(pos), q_chunk=q_chunk)
    got = attn.mla_forward(tp, cfg, tx, torch.from_numpy(pos.copy()),
                           q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_matches_jax_step_by_step_and_its_prefill():
    """The absorbed fp32 decode against JAX's, 20 steps into a 24-slot cache
    (c_kv and k_rope written at each position), and its last step against
    the expanded prefill's last row."""
    jcfg, cfg, jp, tp = _attn_pair("deepseek-v2-236b", "attn_init", seed=1)
    B, steps = 2, 20
    jx, tx = _x((B, steps, cfg.d_model), seed=10)
    jc = jattn.mla_init_cache(jcfg, B, 24, jnp.float32)
    tc = attn.mla_init_cache(cfg, B, 24, torch.float32, "cpu")
    assert tuple(tc.k.shape) == (B, 24, cfg.mla_kv_lora_rank)
    assert tuple(tc.v.shape) == (B, 24, cfg.mla_rope_head_dim)
    for t in range(steps):
        jo, jc = jattn.mla_decode(jp, jcfg, jx[:, t:t + 1], jc)
        to, tc = attn.mla_decode(tp, cfg, tx[:, t:t + 1], tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), err_msg=f"t={t}",
                                   **TOL)
    assert tc.length == steps == int(jc.length)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)
    pos = torch.arange(steps, dtype=torch.int32).expand(B, steps)
    full = attn.mla_forward(tp, cfg, tx, pos)
    np.testing.assert_allclose(to.numpy()[:, 0], full.numpy()[:, -1],
                               rtol=1e-4, atol=1e-5)


def test_mla_cache_is_no_ring_and_raises_past_its_end():
    """At a full cache JAX's ``dynamic_update_slice`` clamps the write into
    the last slot and decodes on; the port refuses the token instead."""
    jcfg, cfg, jp, tp = _attn_pair("deepseek-v2-236b", "attn_init")
    jx, tx = _x((1, 1, cfg.d_model), seed=11)
    tc = attn.mla_init_cache(cfg, 1, 3, torch.float32, "cpu")
    for _ in range(3):
        _, tc = attn.mla_decode(tp, cfg, tx, tc)
    with pytest.raises(ValueError, match="past the end of a 3-slot MLA cache"):
        attn.mla_decode(tp, cfg, tx, tc)
    jc = jattn.mla_init_cache(jcfg, 1, 3, jnp.float32)._replace(
        length=jnp.asarray(3, jnp.int32))
    _, jc = jattn.mla_decode(jp, jcfg, jx, jc)           # clamped, silently
    assert int(jc.length) == 4 and bool(jnp.any(jc.k[:, 2] != 0))


@pytest.mark.parametrize("Se", [16, 40])
def test_cross_attn_forward_matches_jax(Se):
    """Decoder queries against encoder frames: biases, no RoPE, no mask."""
    jcfg, cfg, jp, tp = _attn_pair("seamless-m4t-large-v2", "cross_attn_init")
    assert "b" in tp["wq"] and "b" not in tp["wo"]
    jx, tx = _x((2, 24, cfg.d_model), seed=12)
    je, te = _x((2, Se, cfg.d_model), seed=13)
    want = jattn.cross_attn_forward(jp, jcfg, jx, je, q_chunk=8)
    got = attn.cross_attn_forward(tp, cfg, tx, te, q_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_forward_non_causal_matches_jax(causal):
    """The encoder's self-attention: ``flash_attention(causal=False)``
    (the plain version here) against JAX's ``gqa_forward``."""
    jcfg, cfg, jp, tp = _attn_pair("seamless-m4t-large-v2", "attn_init")
    jx, tx = _x((2, 32, cfg.d_model), seed=14)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want = jattn.gqa_forward(jp, jcfg, jx, jnp.asarray(pos), causal=causal)
    got = attn.gqa_forward(tp, cfg, tx, torch.from_numpy(pos.copy()),
                           causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
