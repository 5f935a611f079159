"""The gradient of the port's attention against the JAX package's: the plain
FlashAttention-2 backward (``repro_torch.kernels.ref.flash_attention_bwd``)
and ``ops.flash_attention``'s autograd on the CPU against ``jax.vjp`` of
``repro.kernels.ref.flash_attention`` on the same numpy inputs and output
gradient, in fp32 within 1e-5 (1 + |want|); and the forward's row
log-sum-exp against ``jax.nn.logsumexp`` of the masked scores; and the
plain backward against ``jax.grad`` of the models' ``_sdpa`` at the head
dims the card runs on a wider instantiation (24, 48) and at 256.  The CUDA
backward kernels against this plain version on the card are in
``test_torch_kernels_gpu.py``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import _sdpa
from repro_torch.kernels import ops, ref

CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window)
    (2, 64, 64, 4, 4, 32, True, None),        # g = 1
    (1, 96, 96, 4, 2, 64, True, None),        # g = 2
    (1, 80, 80, 8, 2, 128, True, None),       # g = 4, hd 128
    (2, 64, 64, 4, 2, 64, False, None),       # not causal
    (1, 100, 100, 4, 1, 32, True, 17),        # windowed, MQA
    (1, 80, 48, 4, 2, 32, True, None),        # the edges of
    (1, 64, 16, 4, 2, 32, False, 8),          # test_flash_attention_plain_
    (1, 16, 64, 4, 2, 32, True, 4),           # edges_match_jax_ref: rows
    (1, 1, 33, 4, 2, 32, False, None),        # with no valid key among them
]
TOL = 1e-5


def _ids(c):
    return "B{}-Sq{}-Sk{}-H{}-KV{}-hd{}-{}-w{}".format(
        *c[:6], "causal" if c[6] else "full", c[7])


def _inputs(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(q, k, v, do, causal, window):
    f = lambda a, b, c: jref.flash_attention(a, b, c, causal=causal, window=window)
    out, vjp = jax.vjp(f, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _check(got, want):
    got = got.detach().float().numpy()
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= TOL, err.max()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_vjp(case):
    B, Sq, Sk, H, KV, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, hd, seed=Sq + Sk)
    _, want = _jax_vjp(q, k, v, do, causal, window)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    scale = 1.0 / math.sqrt(hd)
    out, lse = ref.flash_attention_lse(*t[:3], causal=causal, window=window,
                                       scale=scale)
    got = ref.flash_attention_bwd(*t[:3], out, lse, t[3], causal=causal,
                                  window=window, scale=scale)
    for g, w in zip(got, want):
        _check(g, w)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_wrapper_autograd_matches_jax_vjp(case):
    """``ops.flash_attention`` on CPU tensors that require grad: the
    autograd function's plain forward and backward, no kernel launch."""
    B, Sq, Sk, H, KV, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, hd, seed=Sq * Sk + 1)
    want_out, want = _jax_vjp(q, k, v, do, causal, window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(ops.launches)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    assert ops.launches == before
    _check(out, want_out)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        _check(g, w)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lse_is_the_logsumexp_of_the_masked_scores(case):
    B, Sq, Sk, H, KV, hd, causal, window = case
    q, k, v, _ = _inputs(B, Sq, Sk, H, KV, hd, seed=7)
    scale = 1.0 / math.sqrt(hd)
    qg = jnp.asarray(q).reshape(B, Sq, KV, H // KV, hd)
    s = jnp.einsum("bqkgh,bskh->bkgqs", qg, jnp.asarray(k)) * scale
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = jnp.where(mask, s, jref.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, Sq)
    _, lse = ref.flash_attention_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal=causal, window=window, scale=scale)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    empty = ~mask.any(axis=1)
    assert np.all(lse.numpy()[:, :, empty] <= ref.NEG_INF / 2)


def test_a_row_with_no_valid_key_passes_its_gradient_to_v_only():
    """Rows past Sk + window - 1 averaged every value in the forward: they
    add dO / Sk to every dV row and nothing to dq or dk."""
    q, k, v, do = _inputs(1, 32, 8, 2, 2, 32, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    kw = dict(causal=False, window=4, scale=0.25)
    out, lse = ref.flash_attention_lse(*t[:3], **kw)
    empty = np.arange(32) >= 8 + 4 - 1
    do_e = t[3].clone()
    do_e[:, ~empty] = 0
    dq, dk, dv = ref.flash_attention_bwd(*t[:3], out, lse, do_e, **kw)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    want = do_e.sum(dim=1, keepdim=True).expand(-1, 8, -1, -1) / 8
    torch.testing.assert_close(dv, want, rtol=1e-6, atol=1e-6)


# (B, Sq, Sk, H, KV, hd, causal, window): starcoder2-7b-smoke's hd 24 with
# its window, gemma-7b-smoke's hd 48, gemma-7b's hd 256 with GQA
SDPA_CASES = [
    (2, 64, 64, 6, 2, 24, True, 16),
    (1, 80, 80, 4, 4, 48, True, None),
    (1, 64, 64, 4, 2, 256, True, None),
]


@pytest.mark.parametrize("case", SDPA_CASES, ids=_ids)
def test_plain_backward_matches_jax_grad_of_sdpa(case):
    """The models' attention (``repro/models/attention.py::_sdpa``, the
    function JAX differentiates in training) under ``jax.grad`` of
    sum(out * dO), against the plain backward of the port's forward, in
    fp32 within 1e-5 (1 + |want|)."""
    B, Sq, Sk, H, KV, hd, causal, window = case
    q, k, v, do = _inputs(B, Sq, Sk, H, KV, hd, seed=hd)
    scale = 1.0 / math.sqrt(hd)

    def f(a, b, c):
        out = _sdpa(a, b, c, causal=causal, window=window, q_offset=0,
                    scale=scale)
        return jnp.sum(out * jnp.asarray(do))

    want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = ref.flash_attention_lse(*t[:3], causal=causal, window=window,
                                       scale=scale)
    got = ref.flash_attention_bwd(*t[:3], out, lse, t[3], causal=causal,
                                  window=window, scale=scale)
    for g, w in zip(got, want):
        _check(g, w)
