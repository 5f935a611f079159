"""The gradient of the port's Mamba2 scan against the JAX package's:

  * ``kernels/ref.py::selective_scan_bwd`` (the plain backward, by chunks)
    and the CPU backward of ``ops.selective_scan`` (its autograd Function)
    against ``jax.vjp`` of ``repro/kernels/ref.py::selective_scan`` (the
    sequential oracle, h0 = 0) at ``tests/test_kernels.py``'s scan shapes,
    S off the chunk, no decay and underflowing decays, and against
    ``jax.vjp`` of ``repro/models/ssm.py::_ssd_chunked`` through the
    Mamba2 block's scan inputs (dt, A_log);
  * ``torch.autograd.gradcheck`` of ``ops.selective_scan`` in fp64;
  * zamba2-1.2b-smoke in fp32: ``launch.train.value_and_grad`` against
    ``jax.value_and_grad`` of the JAX forward, and 3 steps of
    ``launch.train.train`` against the JAX script's jitted ``train_step``;
  * ``chip_smoke.py``'s ``[scan-bwd]`` and ``[zoo-train]``'s zamba2 run,
    rehearsed at smoke size on the CPU.

Tolerance of the scan's gradients: 2e-4 (1 + |want|), the forward's
(``tests/test_kernels.py``)."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import tokens as jtokens
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import ssm
from repro_torch.tree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

ARCH = "zamba2-1.2b"
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)     # |got - want| <= 2e-4 (1 + |want|)
LOSS_TOL = 1e-5
LEAF_TOL = dict(rtol=1e-4, atol=1e-4)
# (B, S, H, dh, n, chunk, decay): tests/test_kernels.py's three cases
# (the second ragged), S off the chunk at the kernel's chunk of 32, and
# the two decay regimes of chip_smoke.py's scan checks
GRAD_CASES = [(2, 64, 4, 8, 16, 16, "recipe"), (1, 100, 2, 32, 64, 32, "recipe"),
              (2, 128, 3, 16, 24, 128, "recipe"), (2, 45, 3, 12, 10, 32, "recipe"),
              (1, 96, 2, 16, 8, 32, "none"), (1, 96, 2, 16, 8, 32, "underflow")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _scan_inputs(B, S, H, dh, n, seed, decay="recipe"):
    """The JAX test's recipe from numpy (xdt, B, C ~ N(0, 1), a_log =
    -softplus(N(0, 1))), with ``chip_smoke.scan_inputs``' decay regimes:
    "none" sets a_log = 0, "underflow" multiplies it by 30; and dy."""
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    a_log = -np.logaddexp(0.0, rng.normal(size=(B, S, H))).astype(np.float32)
    a_log = {"recipe": a_log, "none": 0 * a_log, "underflow": 30 * a_log}[decay]
    Bm = rng.normal(size=(B, S, n)).astype(np.float32)
    Cm = rng.normal(size=(B, S, n)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    return xdt, a_log.astype(np.float32), Bm, Cm, dy


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,dh,n,chunk,decay", GRAD_CASES)
def test_plain_backward_matches_the_vjp_of_the_jax_oracle(B, S, H, dh, n,
                                                          chunk, decay):
    """``ref.selective_scan_bwd`` at the case's chunk and at the kernel's
    32, and the wrapper's CPU backward (``ops.selective_scan`` under
    autograd, no launch counted), against ``jax.vjp`` of the sequential
    oracle from a zero state."""
    xdt, a_log, Bm, Cm, dy = _scan_inputs(B, S, H, dh, n, seed=S + n)
    h0 = jnp.zeros((B, H, dh, n))
    _, vjp = jax.vjp(lambda *a: jref.selective_scan(*a, h0)[0],
                     *map(jnp.asarray, (xdt, a_log, Bm, Cm)))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a) for a in (xdt, a_log, Bm, Cm, dy)]
    for ch in (chunk, 32):
        got = ref.selective_scan_bwd(*ts, chunk=ch)
        for g, w, a in zip(got, want, (xdt, a_log, Bm, Cm)):
            assert g.shape == a.shape and g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), _np(w), **SCAN_TOL)
    leaves = [t.clone().requires_grad_() for t in ts[:4]]
    ops.reset_launches()
    y = ops.selective_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad(y, leaves, ts[4])
    assert ops.launches["selective_scan"] == ops.launches["selective_scan_bwd"] == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **SCAN_TOL)


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (96, 32)])
def test_block_scan_gradient_matches_the_vjp_of_jax_ssd_chunked(S, chunk):
    """The Mamba2 block's scan (dt-scaled input and a_log formed from dt
    and A_log, then ``ops.selective_scan``) differentiated on the CPU,
    against ``jax.vjp`` of ``_ssd_chunked`` from a zero state: the
    gradients of xh, B, C, dt and A_log."""
    B, H, dh, n = 2, 4, 8, 16
    rng = np.random.default_rng(S + chunk)
    xh = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, n)).astype(np.float32) for _ in range(2))
    dt = np.logaddexp(0.0, rng.normal(size=(B, S, H))).astype(np.float32)
    A_log = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    h0 = jnp.zeros((B, H, dh, n))
    _, vjp = jax.vjp(lambda xh_, b, c, dt_, al: jssm._ssd_chunked(
        xh_, b, c, dt_, al, h0, chunk)[0], *map(jnp.asarray, (xh, Bm, Cm, dt, A_log)))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xh, Bm, Cm, dt, A_log)]
    xdt, a_log = ssm._scan_inputs(leaves[0], leaves[3], leaves[4])
    y = ops.selective_scan(xdt, a_log, leaves[1], leaves[2], chunk=chunk)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **SCAN_TOL)


def test_selective_scan_gradcheck_in_fp64():
    """The autograd Function's CPU backward (the plain backward in fp64,
    a ragged chunk) against finite differences of its forward."""
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(1, 13, 2, 3, generator=g, dtype=torch.float64),
            -torch.nn.functional.softplus(torch.randn(1, 13, 2, generator=g,
                                                      dtype=torch.float64)),
            torch.randn(1, 13, 3, generator=g, dtype=torch.float64),
            torch.randn(1, 13, 3, generator=g, dtype=torch.float64)]
    args = [a.requires_grad_() for a in args]
    assert torch.autograd.gradcheck(
        lambda *a: ops.selective_scan(*a, chunk=4), args)


def test_backward_wrapper_on_the_cpu_is_the_plain_backward():
    """Uncounted, the plain backward at the given chunk, an empty sequence
    giving zeros; off the CPU and the card it raises."""
    ts = [torch.from_numpy(a) for a in _scan_inputs(1, 40, 2, 4, 8, seed=3)]
    ops.reset_launches()
    got = ops.selective_scan_bwd(*ts, chunk=16)
    want = ref.selective_scan_bwd(*ts, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launches["selective_scan_bwd"] == 0
    empty = ops.selective_scan_bwd(*(t[:, :0] for t in ts))
    assert [tuple(e.shape) for e in empty] == [(1, 0, 2, 4), (1, 0, 2),
                                               (1, 0, 8), (1, 0, 8)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.selective_scan_bwd(*(t.to("meta") for t in ts))


def test_scan_bwd_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_scan_bwd`` at small shapes on the CPU: the
    checks (there the wrapper is the plain backward, so bitwise equal)
    and the decay regimes against the fp64 plain backward."""
    errs, times = chip_smoke.phase_scan_bwd(
        device="cpu", checks=[(2, 64, 4, 8, 16), (1, 37, 2, 33, 7)],
        regimes=[("none", (1, 128, 2, 16, 8)), ("underflow", (1, 128, 2, 16, 8))])
    assert all(e["ok"] and e["bitwise"] for e in errs.values()) and times == {}
    e = chip_smoke.scan_bwd_regime_check("recipe", 1, 200, 2, 16, 8, seed=1,
                                         device="cpu")
    assert e["ok"] and e["share_of_limit"] < 0.2, e


def test_train_agreement_rehearses_the_step_by_step_check_on_the_cpu():
    """``chip_smoke.train_agreement`` on zamba2-1.2b-smoke with the CPU in
    both places: the free-running steps, then ``adamw_forced_steps`` (each
    step from the reference run's state), the launch counts (none on the
    CPU) and the LoRA-LLM round; one device against itself is exact.  The
    one-ulp spread that bounds the free run: one step from a start moved
    by one ulp stays near 1e-6, the second passes 1e-4 (near-eps elements'
    updates follow the rounding), so a free run cannot be held at 1e-4."""
    r = chip_smoke.train_agreement(ARCH, steps=2, rounds=1,
                                   devices=("cpu", "cpu"))
    assert r["params_diff"] == r["free_running"][0] == r["adapters_diff"] == 0.0
    assert len(r["forced_loss"]["cpu"]) == 4 and r["route_margin"] is None
    assert r["free_curve"] == [(0.0, 0.0)] * 2
    curves = r["ulp_curves"]
    assert len(curves) == len(chip_smoke.ULP_SEEDS)
    assert all(len(c) == 2 and c[0][0] < 1e-4 for c in curves), curves
    assert max(c[1][0] for c in curves) > 1e-4, curves


# ---------------------------------------------------------------------------
# zamba2-1.2b-smoke training
# ---------------------------------------------------------------------------
def _cfgs():
    return (dataclasses.replace(jget_smoke(ARCH), dtype="float32"),
            dataclasses.replace(get_smoke_config(ARCH), dtype="float32"))


def _params(jcfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _same_leaves(got, want, tol=LEAF_TOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def test_zamba2_value_and_grad_matches_jax():
    """The loss within 1e-5 and every leaf's gradient at ``LEAF_TOL``, with
    the Mamba2 blocks remat'd in the port (the JAX hybrid loop is not):
    the scan runs forward twice, its backward once a block."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.forward(p, jcfg, jb, loss_chunk=16)[0]))(jp)
    loss, grads = train.value_and_grad(cfg, tp, torch.from_numpy(toks).long(),
                                       torch.from_numpy(labels).long(),
                                       loss_chunk=16)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    _same_leaves(grads, jgrads)


def test_zamba2_train_steps_match_the_jax_train_script():
    """3 steps of the port's training loop and of the JAX script's jitted
    ``train_step`` on the same stream, batches and schedule."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=3)
    steps, batch, seq, lr = 3, 2, 32, 3e-3
    tp, _, losses, _ = train.train(cfg, tp, steps=steps, batch=batch, seq=seq,
                                   lr=lr, log_every=steps)

    opt = jadamw_init(jp)
    sched = jwarmup_cosine(lr, warmup=20, total=steps)
    stream = jtokens.make_bigram_stream(500_000, jcfg.vocab_size, domain=0,
                                        n_domains=1, seed=0)
    batches = jtokens.batches_from_stream(stream, batch, seq, seed=0)

    @jax.jit
    def train_step(params, opt_state, toks, labels, lr_):
        loss, grads = jax.value_and_grad(lambda p: JT.forward(
            p, jcfg, {"tokens": toks, "labels": labels},
            q_chunk=min(seq, 2048), loss_chunk=256)[0])(params)
        params, opt_state = jadamw_update(params, grads, opt_state, lr_)
        return params, opt_state, loss

    jlosses = []
    for step in range(1, steps + 1):
        toks, labels = next(batches)
        jp, opt, loss = train_step(jp, opt, jnp.asarray(toks),
                                   jnp.asarray(labels), sched(step))
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
    _same_leaves(tp, jp)
