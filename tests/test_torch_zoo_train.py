"""Training the rest of the zoo in the port against the JAX package, fp32,
the JAX params carried across leaf for leaf:

  * ``launch.train.value_and_grad`` against ``jax.value_and_grad`` of the
    JAX forward on ``tests/test_configs_smoke.py``'s batch (B=2, S=32;
    llava's image embeddings with labels -1 over them, seamless's 16
    encoder frames) for mixtral-8x22b (MoE, remat off and on),
    deepseek-v2-236b (MLA with MoE), seamless-m4t-large-v2 (the
    encoder-decoder) and llava-next-mistral-7b (the VLM prefix): the loss
    within 1e-5, every leaf's gradient at ``LEAF_TOL``, each MoE routing
    decision held to its margin (``test_torch_zoo_configs.route_margins``);
    the VLM's loss reading the text positions only;
  * the MoE internals: ``_grouped_ffn``'s vjp against ``jax.vjp`` of the
    JAX package's three ``ragged_dot`` calls, empty groups included; the
    router's gradient from the aux loss alone; a remat'd step reading the
    group sizes back twice a MoE layer and routing alike in the recompute;
  * ``fl.parallel.make_fft_round_step`` on deepseek-v2-236b-smoke (K=2)
    against a per-client loop of JAX ``value_and_grad`` and the same Eq.-7
    fold rebuilt here (the JAX package's own round vmaps over the clients,
    which its ``ragged_dot`` does not support);
  * ``chip_smoke.py``'s ``[zoo-train]`` rehearsed at smoke size.

The JAX gradients are computed once per arch (``_jax_grads``, jitted)."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.fl.parallel import make_fft_round_step
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.tree import tree_leaves

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_zoo_configs import _batch, route_margins, route_recorder  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

LOSS_TOL = 1e-5
LEAF_TOL = dict(rtol=1e-4, atol=1e-4)
S_ENC = 16                     # tests/test_configs_smoke.py's encoder frames
CASES = [("mixtral-8x22b", True), ("mixtral-8x22b", False),
         ("deepseek-v2-236b", True), ("seamless-m4t-large-v2", True),
         ("llava-next-mistral-7b", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_vg(arch):
    """The jitted ``jax.value_and_grad`` of the JAX forward (remat off, so
    each MoE layer routes once), loss_chunk and q_chunk 16."""
    jcfg = _pair(arch)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: JT.forward(
        p, jcfg, b, q_chunk=16, loss_chunk=16, remat=False)[0]))


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    """(loss, grads, the router inputs of each MoE call) on the batch."""
    jb, _ = _batch(_pair(arch)[1], S_enc=S_ENC)
    with route_recorder() as (jxs, _):
        loss, grads = _jax_vg(arch)(_pair(arch)[2], jb)
        loss = float(loss)
    return loss, grads, jxs


def _same_leaves(got, want, tol=LEAF_TOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def _extra(tb):
    return {k: v for k, v in tb.items() if k not in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# value_and_grad against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,remat", CASES)
def test_value_and_grad_matches_jax(arch, remat):
    jcfg, cfg, jp, tp = _pair(arch)
    jloss, jgrads, jxs = _jax_grads(arch)
    _, tb = _batch(cfg, S_enc=S_ENC)
    moe.reset_readbacks()
    with route_recorder() as (_, txs):
        loss, grads = train.value_and_grad(cfg, tp, tb["tokens"], tb["labels"],
                                           loss_chunk=16, q_chunk=16,
                                           remat=remat, extra=_extra(tb))
    assert abs(float(loss) - jloss) <= LOSS_TOL
    _same_leaves(grads, jgrads)
    n_moe = (cfg.num_layers - cfg.first_k_dense) if cfg.moe else 0
    assert moe.readbacks["moe_group_sizes"] == (2 if remat else 1) * n_moe
    if cfg.moe:
        assert len(jxs) == n_moe
        for ratio, sets_equal in route_margins(cfg, tp, jxs, txs[:n_moe]):
            assert sets_equal and ratio > 1.0, ratio


def test_vlm_loss_reads_the_text_positions_only():
    """With labels -1 over the image positions, the loss's gradient with
    respect to the final hidden states is exactly zero there and nonzero
    at the text positions: the image embeddings reach the loss only
    through what the text positions attend to."""
    from repro_torch.models import transformer as T
    from repro_torch.models.loss import chunked_cross_entropy
    _, cfg, _, tp = _pair("llava-next-mistral-7b")
    _, tb = _batch(cfg, S_enc=S_ENC)
    n_img = cfg.num_image_tokens
    assert bool((tb["labels"][:, :n_img] == -1).all())
    h, _ = T.hidden_states(tp, cfg, tb, q_chunk=16)
    h = h.detach().requires_grad_()
    loss, cnt = chunked_cross_entropy(h, T.lm_head_w(tp, cfg), tb["labels"],
                                      chunk=16)
    g = torch.autograd.grad(loss, h)[0]
    assert float(g[:, :n_img].abs().max()) == 0.0
    assert float(g[:, n_img:].abs().max()) > 0 and float(cnt) == 61.0


# ---------------------------------------------------------------------------
# MoE internals
# ---------------------------------------------------------------------------
def test_grouped_ffn_vjp_matches_ragged_dot_with_empty_groups():
    """``_grouped_ffn``'s gradients of the rows and the three expert
    stacks against ``jax.vjp`` of JAX's ``ragged_dot`` grouped FFN, with
    two empty groups; one host read of the sizes."""
    cfg = get_smoke_config("mixtral-8x22b")
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    sizes = np.array([3, 0, 5, 0][:E] + [2] * (E - 4), np.int32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(int(sizes.sum()), d)).astype(np.float32)
    ws = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    dy = rng.normal(size=(x.shape[0], d)).astype(np.float32)
    gs = jnp.asarray(sizes)
    want_y, vjp = jax.vjp(lambda *a: jmoe._grouped_ffn(cfg, *a, gs),
                          *map(jnp.asarray, [x] + ws))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x] + ws]
    moe.reset_readbacks()
    y = moe._grouped_ffn(cfg, *leaves, torch.from_numpy(sizes).long())
    assert moe.readbacks["moe_group_sizes"] == 1
    np.testing.assert_allclose(_np(y), _np(want_y), **LEAF_TOL)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **LEAF_TOL)
    for e in np.flatnonzero(sizes == 0):       # an empty expert learns nothing
        assert all(float(g[e].abs().max()) == 0 for g in got[1:])


def test_router_gradient_comes_from_the_softmax_alone():
    """The aux loss's gradient with respect to the router against JAX's:
    the expert counts ``fe`` (``bincount`` here, ``one_hot`` of the top-k
    there) carry none, so it is E Σ fe ∂me/∂w."""
    cfg = get_smoke_config("mixtral-8x22b")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, cfg.d_model)).astype(np.float32)
    w = (rng.normal(size=(cfg.d_model, cfg.num_experts)) * 0.1).astype(np.float32)
    jg = jax.grad(lambda w_: jmoe._route({"router": {"w": w_}}, cfg,
                                         jnp.asarray(x))[2])(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    _, _, aux = moe._route({"router": {"w": tw}}, cfg, torch.from_numpy(x))
    g = torch.autograd.grad(aux, tw)[0]
    np.testing.assert_allclose(_np(g), _np(jg), **LEAF_TOL)
    gates = moe._route({"router": {"w": tw}}, cfg, torch.from_numpy(x))[0]
    gg = torch.autograd.grad(gates[:, 0].sum(), tw)[0]
    assert float(gg.abs().max()) > 0          # the gates carry one too


def test_remat_recompute_routes_alike_and_reads_back_twice():
    """Under ``_run_block``'s remat each MoE layer routes twice a step (the
    forward and its recompute in the backward), on bitwise equal router
    inputs to the same experts, and reads its group sizes back twice."""
    _, cfg, _, tp = _pair("mixtral-8x22b")
    _, tb = _batch(cfg, S_enc=S_ENC)
    calls, route = [], moe._route

    def record(p, cfg_, x2d):
        out = route(p, cfg_, x2d)
        calls.append((x2d.detach().clone(), out[1].clone()))
        return out

    moe._route = record
    moe.reset_readbacks()
    try:
        train.value_and_grad(cfg, tp, tb["tokens"], tb["labels"],
                             loss_chunk=16, q_chunk=16, remat=True)
    finally:
        moe._route = route
    L = cfg.num_layers
    assert len(calls) == 2 * L and moe.readbacks["moe_group_sizes"] == 2 * L
    for i in range(L):               # the recompute runs the layers backwards
        (x0, e0), (x1, e1) = calls[i], calls[2 * L - 1 - i]
        assert torch.equal(x0, x1) and torch.equal(e0, e1)


# ---------------------------------------------------------------------------
# the FFT round on an MoE config
# ---------------------------------------------------------------------------
def test_fft_round_on_deepseek_matches_a_per_client_jax_loop():
    """K=2 clients, one SGD step each (lr 1e-2) from the global params,
    then Eq. 7 in delta form (w + Σ β_k·bf16(w_k − w), summed in fp32):
    the port's round against JAX ``value_and_grad`` per client and the fold
    rebuilt in numpy; β = (0.7, 0.3)."""
    arch, lr = "deepseek-v2-236b", 1e-2
    jcfg, cfg, jp, tp = _pair(arch)
    K, b, S = 2, 2, 32
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (K, b, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (K, b, S)).astype(np.int32)
    beta = np.array([0.7, 0.3], np.float32)
    fft_round = make_fft_round_step(cfg, lr=lr, loss_chunk=16)
    new, loss = fft_round(tp, torch.from_numpy(toks), torch.from_numpy(labels),
                          torch.from_numpy(beta))
    acc = [np.zeros(np.shape(w), np.float32) for w in jax.tree.leaves(jp)]
    jloss = np.float32(0)
    for k in range(K):
        jb = {"tokens": jnp.asarray(toks[k]), "labels": jnp.asarray(labels[k])}
        lk, gk = _jax_vg(arch)(jp, jb)
        for a, w, g in zip(acc, jax.tree.leaves(jp), jax.tree.leaves(gk)):
            w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
            delta = jnp.asarray((w - np.float32(lr) * g) - w).astype(jnp.bfloat16)
            a += beta[k] * np.asarray(delta, np.float32)
        jloss = jloss + np.float32(lk) * beta[k]
    want = [np.asarray(w, np.float32) + a for w, a in zip(jax.tree.leaves(jp), acc)]
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    got = tree_leaves(new)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, **LEAF_TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py's [zoo-train], rehearsed at smoke size
# ---------------------------------------------------------------------------
def test_zoo_train_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_zoo_train`` at smoke size on the CPU: each arch
    trained, no kernel launch (the plain versions), the MoE read-backs
    two per MoE layer a step, the frozen base unchanged (the phase asserts
    them itself)."""
    out = chip_smoke.phase_zoo_train(
        device="cpu", smoke=True, zamba2=dict(steps=2, B=2, S=32),
        seamless=dict(steps=2, B=2, S=32), deepseek=dict(B=2, S=32),
        lora_rounds=1)
    assert sorted(out) == sorted(["zamba2-1.2b", "seamless-m4t-large-v2",
                                  "deepseek-v2-236b", "mixtral-8x22b",
                                  "llava-next-mistral-7b"])
    assert out["deepseek-v2-236b"]["loss"][1] < out["deepseek-v2-236b"]["loss"][0]
