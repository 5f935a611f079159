"""The port's Mamba2 hybrid path (``repro_torch.models.ssm``, the hybrid
stack of ``models/transformer.py``, the plain SSD scans of
``kernels/ref.py`` and the ``ops.selective_scan`` dispatch) against the JAX
package: the same numpy inputs, JAX params carried across with
``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.zamba2_1p2b import _pattern
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as jscan_kernel
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ATTN, MAMBA2, MLSTM, SHARED_ATTN
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.tree import tree_leaves
from tf32_emulation import tf32_matmul

ARCH = "zamba2-1.2b"
TOL32 = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_kernels.py's
# tests/test_kernels.py's selective-scan cases
SCAN_CASES = [
    dict(B=2, S=64, H=4, dh=8, n=16, chunk=16),
    dict(B=1, S=100, H=2, dh=32, n=64, chunk=32),    # ragged S
    dict(B=2, S=128, H=3, dh=16, n=24, chunk=128),   # single chunk, odd dims
]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _scan_inputs(B, S, H, dh, n, seed):
    """The JAX test's recipe from numpy: xdt, B, C ~ N(0, 1) and
    a_log = -softplus(N(0, 1))."""
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    a_log = -np.logaddexp(0.0, rng.normal(size=(B, S, H))).astype(np.float32)
    Bm = rng.normal(size=(B, S, n)).astype(np.float32)
    Cm = rng.normal(size=(B, S, n)).astype(np.float32)
    return xdt, a_log, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cfgs(dtype="float32", **over):
    return (dataclasses.replace(jget_smoke(ARCH), dtype=dtype, **over),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **over))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab, B=2, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return toks


# ---------------------------------------------------------------------------
# the plain scans against the Pallas kernel and the JAX oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", SCAN_CASES)
def test_plain_scans_match_the_pallas_kernel_and_the_jax_oracle(case):
    B, S, H, dh, n = (case[k] for k in ("B", "S", "H", "dh", "n"))
    xdt, a_log, Bm, Cm = _scan_inputs(B, S, H, dh, n, seed=S + n)
    got_k = jscan_kernel(*map(jnp.asarray, (xdt, a_log, Bm, Cm)),
                         chunk=case["chunk"], interpret=True)
    want, _ = jref.selective_scan(*map(jnp.asarray, (xdt, a_log, Bm, Cm)),
                                  jnp.zeros((B, H, dh, n)))
    h0 = torch.zeros((B, H, dh, n))
    seq, _ = ref.selective_scan(*_t(xdt, a_log, Bm, Cm), h0)
    chunked, _ = ref.ssd_chunked(*_t(xdt, a_log, Bm, Cm), h0, case["chunk"])
    for got in (seq, chunked):
        assert got.shape == (B, S, H, dh) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)
        np.testing.assert_allclose(_np(got), _np(got_k), **SCAN_TOL)
    ops.reset_launches()
    got_ops = ops.selective_scan(*_t(xdt, a_log, Bm, Cm), chunk=case["chunk"])
    assert torch.equal(got_ops, chunked) and ops.launches["selective_scan"] == 0


@pytest.mark.parametrize("S,chunk", [(48, 16), (50, 16), (7, 32)])
def test_plain_scans_carry_an_initial_state(S, chunk):
    """y and h_end from a nonzero h0 against the JAX oracle, at a chunk that
    divides S, a ragged one and one longer than S."""
    B, H, dh, n = 2, 3, 8, 12
    xdt, a_log, Bm, Cm = _scan_inputs(B, S, H, dh, n, seed=7)
    h0 = np.random.default_rng(8).normal(size=(B, H, dh, n)).astype(np.float32)
    want_y, want_h = jref.selective_scan(*map(jnp.asarray, (xdt, a_log, Bm, Cm, h0)))
    for fn in (ref.selective_scan,
               lambda *a: ref.ssd_chunked(*a, chunk)):
        y, h = fn(*_t(xdt, a_log, Bm, Cm, h0))
        np.testing.assert_allclose(_np(y), _np(want_y), **SCAN_TOL)
        np.testing.assert_allclose(_np(h), _np(want_h), **SCAN_TOL)


def test_plain_scans_of_an_empty_sequence_keep_the_state():
    h0 = torch.randn(1, 2, 4, 3)
    z = torch.zeros
    for fn in (ref.selective_scan, lambda *a: ref.ssd_chunked(*a, 16)):
        y, h = fn(z(1, 0, 2, 4), z(1, 0, 2), z(1, 0, 3), z(1, 0, 3), h0)
        assert y.shape == (1, 0, 2, 4) and torch.equal(h, h0)


def test_chunked_plain_scan_holds_the_kernel_tolerance_at_a_zamba2_layer():
    """``ops.selective_scan`` on the CPU (the chunked plain version at
    ``mamba2_forward``'s chunk of 256) against the sequential oracle in fp64
    at one zamba2-1.2b layer, with the JAX test's inputs: within
    tests/test_kernels.py's 2e-4 (1 + |y|).  An fp32 in-chunk cumsum misses
    it here (1.28 of the limit)."""
    B, S, H, dh, n = 1, 4096, 32, 128, 64
    xdt, a_log, Bm, Cm = _t(*_scan_inputs(B, S, H, dh, n, seed=0))
    got = ops.selective_scan(xdt, a_log, Bm, Cm, chunk=256)
    want, _ = ref.selective_scan(*(t.double() for t in (xdt, a_log, Bm, Cm)),
                                 torch.zeros((B, H, dh, n), dtype=torch.float64))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want.numpy(), **SCAN_TOL)


def _tf32_chunked_scan(xdt, a_log, Bm, Cm, split, Q=32):
    """``csrc/selective_scan.cu``'s algorithm at its chunk Q, every
    tensor-core product emulated by ``tf32_matmul``: G = C·Bᵀ per chunk in
    fp32 from a separate pass; the in-chunk cumsum and its differences in
    fp64, exponentials in fp32; then per chunk
    Yᵀ = Xᵀ·Wᵀ + (H·Cᵀ)·diag(exp(cum)) and H <- exp(cum_Q)·H + (dend∘X)ᵀ·B,
    with W = G ∘ L (masked before the exponential) and
    dend_s = exp(cum_Q - cum_s)."""
    Bsz, S, H, dh = xdt.shape
    n = Bm.shape[-1]
    assert S % Q == 0
    G = Cm.reshape(Bsz, S // Q, Q, n) @ Bm.reshape(Bsz, S // Q, Q, n).transpose(-1, -2)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    h = torch.zeros((Bsz, H, dh, n))
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        cum = torch.cumsum(a_log[:, sl].double(), dim=1).transpose(1, 2)  # (B,H,Q)
        diff = (cum[..., :, None] - cum[..., None, :]).float()
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        W = G[:, c, None] * L                                        # (B,H,t,s)
        dend = torch.exp((cum[..., -1:] - cum).float())              # (B,H,s)
        xT = xdt[:, sl].permute(0, 2, 3, 1)                          # (B,H,dh,s)
        carried = tf32_matmul(h, Cm[:, None, sl].transpose(-1, -2), split)
        yT = (tf32_matmul(xT, W.transpose(-1, -2), split)
              + carried * torch.exp(cum.float())[..., None, :])
        h = torch.exp(cum[..., -1].float())[..., None, None] * h + \
            tf32_matmul(xT * dend[..., None, :], Bm[:, None, sl], split)
        ys.append(yT.permute(0, 3, 1, 2))
    return torch.cat(ys, 1)


@pytest.mark.parametrize("decay", ["recipe", "none"])
def test_tf32_split_products_hold_the_scan_tolerance(decay):
    """The kernel's chunked algorithm with its products in 3xTF32 against
    the fp64 sequential oracle, within tests/test_kernels.py's
    2e-4 (1 + |y|): the JAX test's inputs from seed 0, and with no decay
    (a_log = 0, so the state grows over all 4096 steps).

    Without decay no fp32 computation of the scan holds that limit against
    the exact recurrence: the state reaches ~300 and y ~2500, and the
    elements where y cancels to near 0 keep the fp32 rounding of the large
    terms.  There the split is held to the fp32 sequential recurrence (the
    plain version every other check holds the kernel to): its share of the
    limit no larger than that recurrence's own.  The single-TF32 share and
    the chunked plain version's (``ops.selective_scan`` on the CPU) are
    printed, not held."""
    B, S, H, dh, n = 1, 4096, 4, 128, 64
    xdt, a_log, Bm, Cm = _t(*_scan_inputs(B, S, H, dh, n, seed=0))
    if decay == "none":
        a_log = torch.zeros_like(a_log)
    want, _ = ref.selective_scan(*(t.double() for t in (xdt, a_log, Bm, Cm)),
                                 torch.zeros((B, H, dh, n), dtype=torch.float64))
    limit = SCAN_TOL["atol"] * (1 + want.abs())

    def share(got):
        assert got.shape == want.shape and got.dtype == torch.float32
        return float(((got.double() - want).abs() / limit).max())

    seq = share(ref.selective_scan(xdt, a_log, Bm, Cm, torch.zeros((B, H, dh, n)))[0])
    plain = share(ops.selective_scan(xdt, a_log, Bm, Cm))
    split = {k: share(_tf32_chunked_scan(xdt, a_log, Bm, Cm, k)) for k in (1, 3)}
    print(f"[tf32] decay={decay}: share of the 2e-4 (1 + |y|) limit: 1xTF32 "
          f"{split[1]:.4f}, 3xTF32 {split[3]:.4f}, fp32 sequential {seq:.4f}, "
          f"chunked plain fp32 {plain:.4f}")
    assert split[3] <= max(1.0, seq), (split, seq)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------
def _mamba_params(jcfg, seed=0):
    jp = jssm.mamba2_init(jax.random.PRNGKey(seed), jcfg, jnp.dtype(jcfg.dtype))
    jp = dict(jp, A_log=jnp.linspace(-1.0, 0.5, jp["A_log"].shape[0]),
              dt_bias=jnp.linspace(-0.5, 0.5, jp["dt_bias"].shape[0]),
              D=jnp.linspace(0.5, 1.5, jp["D"].shape[0]))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_ssd_chunked_matches_jax():
    jcfg, _ = _cfgs()
    B, S, H, dh, n = 2, 32, 4, 8, 16
    rng = np.random.default_rng(3)
    xh = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, n)).astype(np.float32) for _ in range(2))
    dt = np.logaddexp(0.0, rng.normal(size=(B, S, H))).astype(np.float32)
    A_log = rng.normal(size=(H,)).astype(np.float32) * 0.5
    h0 = rng.normal(size=(B, H, dh, n)).astype(np.float32)
    args = (xh, Bm, Cm, dt, A_log, h0)
    for chunk in (8, 32, 64):
        jy, jh = jssm._ssd_chunked(*map(jnp.asarray, args), chunk)
        ty, th = ssm._ssd_chunked(*_t(*args), chunk)
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL32)
        np.testing.assert_allclose(_np(th), _np(jh), **TOL32)


def test_mamba2_forward_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp, tp = _mamba_params(jcfg)
    B, S = 2, 24
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    for chunk in (8, 256):
        want = jssm.mamba2_forward(jp, jcfg, jnp.asarray(x), chunk=chunk)
        got = ssm.mamba2_forward(tp, cfg, torch.from_numpy(x), chunk=chunk)
        np.testing.assert_allclose(_np(got), _np(want), **TOL32)
    jc = jssm.mamba2_init_cache(jcfg, B, jnp.float32)
    tc = ssm.mamba2_init_cache(cfg, B, torch.float32, "cpu")
    for t in range(6):
        jy, jc = jssm.mamba2_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = ssm.mamba2_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]), tc)
        np.testing.assert_allclose(_np(ty), _np(jy), err_msg=f"t={t}", **TOL32)
    np.testing.assert_allclose(_np(tc.h), _np(jc.h), **TOL32)
    np.testing.assert_allclose(_np(tc.conv), _np(jc.conv), **TOL32)
    assert tc.length == int(jc.length) == 6


def test_mamba2_forward_raises_where_jax_asserts():
    jcfg, cfg = _cfgs()
    jp, tp = _mamba_params(jcfg)
    x = np.zeros((1, 24, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jssm.mamba2_forward(jp, jcfg, jnp.asarray(x), chunk=16)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssm.mamba2_forward(tp, cfg, torch.from_numpy(x), chunk=16)
    ssm.mamba2_forward(tp, cfg, torch.from_numpy(x), chunk=8)


# ---------------------------------------------------------------------------
# the zamba2 hybrid stack
# ---------------------------------------------------------------------------
def test_zamba2_configs_are_the_jax_configs_and_other_kinds_raise():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jget_smoke(ARCH))
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    _, cfg = _cfgs(block_pattern=(MAMBA2, ATTN, SHARED_ATTN))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.init_params(cfg, device="cpu")


def test_mixed_mamba2_mlstm_stack_matches_jax():
    """A pattern that mixes Mamba2, mLSTM and shared attention, as JAX's
    hybrid loop allows: hidden states and loss (fp32) within 1e-4 of JAX's,
    then 6 decode steps' logits."""
    jcfg, cfg = _cfgs(block_pattern=(MAMBA2, MLSTM, SHARED_ATTN))
    jp, tp = _params(jcfg, seed=6)
    toks = _tokens(cfg.vocab_size, S=32, seed=6)
    labels = np.roll(toks, -1, 1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jh, _ = JT.hidden_states(jp, jcfg, jb)
    th, _ = T.hidden_states(tp, cfg, tb)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL32)
    jl, _ = JT.forward(jp, jcfg, jb, loss_chunk=16)
    tl, _ = T.forward(tp, cfg, tb, loss_chunk=16)
    np.testing.assert_allclose(float(tl), float(jl), **TOL32)
    js = JT.init_decode_state(jp, jcfg, 2, 8)
    ts = T.init_decode_state(tp, cfg, 2, 8)
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    for t in range(6):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tlog, ts = T.decode_step(tp, cfg, ts, tb["tokens"][:, t:t + 1])
        np.testing.assert_allclose(_np(tlog), _np(jlog), err_msg=f"t={t}", **TOL32)


def test_hybrid_params_and_decode_state_follow_the_jax_tree():
    """12 layers, so that the block keys "10" and "11" sort before "2" as
    JAX sorts them: the port's own init has the JAX tree's leaf shapes in
    the JAX leaf order, and a JAX decode state carries across cache by
    cache."""
    jcfg, cfg = _cfgs(num_layers=12, block_pattern=_pattern(12, 6))
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = T.init_params(cfg, seed=1, device="cpu")
    assert [tuple(a.shape) for a in jax.tree.leaves(jshapes)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    assert sorted(tp["blocks"]) == sorted(str(i) for i in range(12) if i not in (5, 11))
    jp, cp = _params(jcfg)
    assert len(tree_leaves(cp)) == len(jax.tree.leaves(jp))
    js = JT.init_decode_state(jp, jcfg, 2, 16)
    ts = T.init_decode_state(tp, cfg, 2, 16)
    cs = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert sorted(ts["blocks"]) == sorted(cs["blocks"]) == sorted(js["blocks"])
    for i, kind in enumerate(cfg.layer_kinds()):
        mine, theirs = ts["blocks"][str(i)], cs["blocks"][str(i)]
        assert type(mine) is type(theirs) is (
            ssm.MambaCache if kind == MAMBA2 else KVCache)
        assert mine.length == theirs.length == 0
        for a, b in zip(mine[:2], theirs[:2]):
            assert a.shape == b.shape and a.dtype == b.dtype
    # the shared block has one parameter set and a cache per position
    assert ts["blocks"]["5"].k is not ts["blocks"]["11"].k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_hidden_states_and_forward_match_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp, tp = _params(jcfg)
    toks = _tokens(cfg.vocab_size)
    labels = np.roll(toks, -1, 1)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jh, _ = JT.hidden_states(jp, jcfg, jb)
    th, aux = T.hidden_states(tp, cfg, tb)
    assert th.dtype == T.torch_dtype(cfg) and float(aux) == 0.0
    jl, jm = JT.forward(jp, jcfg, jb, loss_chunk=16)
    tl, tm = T.forward(tp, cfg, tb, loss_chunk=16)
    assert float(tm["target_tokens"]) == float(jm["target_tokens"]) == 61.0
    if dtype == "float32":
        np.testing.assert_allclose(_np(th), _np(jh), **TOL32)
        np.testing.assert_allclose(float(tl), float(jl), **TOL32)
        return
    # bf16: XLA and eager PyTorch round at different points (the causal
    # conv's sum of bf16 products, the gate), so the port is held to the
    # fp32 forward of the same params: its error no larger than the JAX
    # package's own bf16 error (tests/test_torch_transformer.py's rule).
    j32cfg, _ = _cfgs("float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    j32, _ = JT.hidden_states(jp32, j32cfg, jb)
    err_port = np.abs(_np(th) - _np(j32))
    err_jax = np.abs(_np(jh) - _np(j32))
    assert err_port.max() <= 1.25 * err_jax.max(), (err_port.max(), err_jax.max())
    assert err_port.mean() <= 1.25 * err_jax.mean(), (err_port.mean(), err_jax.mean())
    jl32, _ = JT.forward(jp32, j32cfg, jb, loss_chunk=16)
    assert abs(float(tl) - float(jl32)) <= 1.25 * abs(float(jl) - float(jl32)) + 1e-3


def test_zamba2_decode_steps_match_jax_and_continue_from_a_jax_state():
    """Step by step through a 8-slot ring (it wraps at 8): logits within
    1e-4 of JAX's; then a JAX state after 10 steps, carried across, decodes
    the next steps as JAX does."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens(cfg.vocab_size, S=14, seed=2)
    js = JT.init_decode_state(jp, jcfg, 2, 8)
    ts = T.init_decode_state(tp, cfg, 2, 8)
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    for t in range(10):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tlog, ts = T.decode_step(tp, cfg, ts, torch.from_numpy(toks[:, t:t + 1]).long())
        assert tlog.dtype == torch.float32 and tlog.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(_np(tlog), _np(jlog), err_msg=f"t={t}", **TOL32)
    for i in ("0", "1"):
        np.testing.assert_allclose(_np(ts["blocks"][i].h), _np(js["blocks"][i].h),
                                   **TOL32)
    np.testing.assert_allclose(_np(ts["blocks"]["2"].k), _np(js["blocks"]["2"].k),
                               **TOL32)
    cs = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for t in range(10, 14):
        jlog, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        clog, cs = T.decode_step(tp, cfg, cs, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(_np(clog), _np(jlog), err_msg=f"t={t}", **TOL32)
    assert all(c.length == 14 for c in cs["blocks"].values())


def test_zamba2_decode_matches_forward():
    """tests/test_models.py's decode-vs-forward check on the port alone:
    token-by-token decode reproduces the forward's logits (5e-3)."""
    _, cfg = _cfgs()
    tp = T.init_params(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, S=24, seed=5)).long()
    h, _ = T.hidden_states(tp, cfg, {"tokens": toks})
    fwd = _np(h @ T.lm_head_w(tp, cfg))
    state = T.init_decode_state(tp, cfg, 2, 24)
    for t in range(24):
        logits, state = T.decode_step(tp, cfg, state, toks[:, t:t + 1])
        np.testing.assert_allclose(_np(logits), fwd[:, t], rtol=5e-3, atol=5e-3,
                                   err_msg=f"t={t}")


def test_zamba2_serve_generates_the_jax_greedy_tokens():
    from repro_torch.launch import serve
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    prompts = _tokens(cfg.vocab_size, S=6, seed=3)
    res = serve.generate(tp, cfg, torch.from_numpy(prompts).long(), 5, 16)
    js = JT.init_decode_state(jp, jcfg, 2, 16)
    step = jax.jit(lambda p, s, t: JT.decode_step(p, jcfg, s, t))
    for t in range(prompts.shape[1]):
        logits, js = step(jp, js, jnp.asarray(prompts[:, t:t + 1]))
    out = []
    for _ in range(6):
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(np.asarray(tok))
        logits, js = step(jp, js, tok)
    np.testing.assert_array_equal(res["tokens"].numpy(), np.concatenate(out, 1))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
def _z(*shape, device="cpu", grad=False):
    return torch.zeros(shape, device=device, requires_grad=grad)


@pytest.mark.parametrize("args,err,match", [
    ((_z(2, 8, 3), _z(2, 8, 3), _z(2, 8, 4), _z(2, 8, 4)), ValueError, "4-d"),
    ((_z(2, 8, 3, 4), _z(2, 8, 2), _z(2, 8, 4), _z(2, 8, 4)), ValueError, "match"),
    ((_z(2, 8, 3, 4), _z(2, 8, 3), _z(2, 8, 4), _z(2, 8, 5)), ValueError, "match"),
    ((_z(2, 8, 3, 4), _z(2, 8, 3), _z(1, 8, 4), _z(1, 8, 4)), ValueError, "match"),
    ((_z(2, 8, 3, 4), _z(2, 8, 3), _z(2, 8, 4), _z(2, 8, 4, device="meta")),
     ValueError, "different devices"),
    ((_z(2, 8, 3, 4, device="meta"), _z(2, 8, 3, device="meta"),
      _z(2, 8, 4, device="meta"), _z(2, 8, 4, device="meta")), ValueError,
     "no kernel for device"),
    ((_z(2, 8, 3, 4, device="meta", grad=True), _z(2, 8, 3, device="meta"),
      _z(2, 8, 4, device="meta"), _z(2, 8, 4, device="meta")), ValueError,
     "no kernel for device"),
])
def test_selective_scan_wrapper_refuses(args, err, match):
    with pytest.raises(err, match=match):
        ops.selective_scan(*args)


def test_selective_scan_wrapper_on_the_cpu_is_the_chunked_plain_version():
    """Uncounted, differentiable, and the chunk changes nothing but
    rounding."""
    xdt, a_log, Bm, Cm = _t(*_scan_inputs(1, 40, 2, 4, 8, seed=11))
    ops.reset_launches()
    y16 = ops.selective_scan(xdt, a_log, Bm, Cm, chunk=16)
    y40 = ops.selective_scan(xdt, a_log, Bm, Cm, chunk=64)
    np.testing.assert_allclose(_np(y16), _np(y40), **SCAN_TOL)
    xg = xdt.clone().requires_grad_()
    ops.selective_scan(xg, a_log, Bm, Cm).sum().backward()
    assert bool(torch.isfinite(xg.grad).all())
    assert ops.launches["selective_scan"] == 0
    with pytest.raises(ValueError, match="chunk"):
        ops.selective_scan(xdt, a_log, Bm, Cm, chunk=0)
