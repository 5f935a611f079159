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
from tf32_emulation import tf32_matmul

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


def _tf32_scan_bwd(xdt, a_log, Bm, Cm, dy, split, Q=32):
    """``csrc/selective_scan_bwd.cu``'s decomposition at its chunk Q, every
    tensor-core product emulated by ``tf32_matmul`` (split 3: 3xTF32; 1:
    single TF32) and summed in fp32 (the kernel sums each product's hi.hi
    terms apart from its hi.lo and lo.hi ones, which keeps the tensor
    cores' round-toward-zero sums near fp32's; not emulated): the states at
    every chunk's start as the forward writes them, (B, H, S/Q - 1, dh, n);
    B.C^T in fp32 (the Gram kernel); then per chunk, in reverse, with G the
    gradient of the state at its end,
    dX^T = dY^T.W + (G.B^T) diag(dend), G <- eq G + (diag(e) dY)^T.C,
    M = dY.X^T, per-head partial dB = diag(dend) X.G + (L o M)^T.C and
    dC = diag(e) dY.H0 + (L o M).B summed over the heads in order, and
    da_t in fp64 from p, q, eq <G, H0> and P = W o M's strictly lower
    column and row sums."""
    Bsz, S, H, dh = xdt.shape
    n = Bm.shape[-1]
    assert S % Q == 0
    nc = S // Q
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    lower = torch.tril(tri, -1)                                      # t > s
    chunks = lambda t: t.reshape(Bsz, nc, Q, H, -1).permute(0, 1, 3, 2, 4)
    xs, dys = chunks(xdt), chunks(dy)                                # (B,nc,H,Q,dh)
    bs, cs = Bm.reshape(Bsz, nc, 1, Q, n), Cm.reshape(Bsz, nc, 1, Q, n)
    las = a_log.reshape(Bsz, nc, Q, H).transpose(2, 3)               # (B,nc,H,Q)

    def decays(c):
        cum = torch.cumsum(las[:, c].double(), -1)
        diff = cum[..., :, None] - cum[..., None, :]
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0).float()), 0.0)
        return (L, torch.exp(cum.float()), torch.exp((cum[..., -1:] - cum).float()),
                torch.exp(cum[..., -1].float()))

    states, h = [], torch.zeros((Bsz, H, dh, n))
    for c in range(nc - 1):
        _, _, dend, eq = decays(c)
        h = eq[..., None, None] * h + tf32_matmul(
            (xs[:, c] * dend[..., None]).transpose(-1, -2), bs[:, c], split)
        states.append(h)
    G = torch.zeros((Bsz, H, dh, n))
    dxs, das, dbs, dcs = [], [], [], []
    for c in reversed(range(nc)):
        x, dyc, Bc, Cc = xs[:, c], dys[:, c], bs[:, c], cs[:, c]
        H0 = states[c - 1] if c else torch.zeros_like(G)
        L, e, dend, eq = decays(c)
        W = L * (Cc @ Bc.transpose(-1, -2))
        dxT = (tf32_matmul(dyc.transpose(-1, -2), W, split)
               + tf32_matmul(G, Bc.transpose(-1, -2), split) * dend[..., None, :])
        M = tf32_matmul(dyc, x.transpose(-1, -2), split)             # (B,H,t,s)
        LM, P = L * M, W * M
        XG = dend[..., None] * tf32_matmul(x, G, split)              # (B,H,s,n)
        YH = e[..., None] * tf32_matmul(dyc, H0, split)              # (B,H,t,n)
        dBh = XG + tf32_matmul(LM.transpose(-1, -2), Cc, split)
        dCh = YH + tf32_matmul(LM, Bc, split)
        dB, dC = dBh[:, 0], dCh[:, 0]
        for hh in range(1, H):                 # the heads' sums, in order
            dB, dC = dB + dBh[:, hh], dC + dCh[:, hh]
        p, q = (XG * Bc).sum(-1).double(), (YH * Cc).sum(-1).double()
        Pl = torch.where(lower, P, 0.0).double()
        dv = Pl.sum(-2) - Pl.sum(-1)           # colsum_v - rowsum_v
        base = (eq * (G * H0).sum((-2, -1))).double()[..., None]
        da = ((torch.cumsum(dv, -1) - dv) + q.flip(-1).cumsum(-1).flip(-1)
              + (torch.cumsum(p, -1) - p) + base)
        G = eq[..., None, None] * G + tf32_matmul(
            (dyc * e[..., None]).transpose(-1, -2), Cc, split)
        dxs.append(dxT.permute(0, 3, 1, 2))
        das.append(da.float().transpose(1, 2))
        dbs.append(dB)
        dcs.append(dC)
    cat = lambda ts: torch.cat(ts[::-1], 1)
    return cat(dxs), cat(das), cat(dbs), cat(dcs)


@pytest.mark.parametrize("decay", ["recipe", "none"])
def test_tf32_split_products_hold_the_scan_bwd_tolerance(decay):
    """The backward kernel's decomposition with its products in 3xTF32
    (``_tf32_scan_bwd``) against the plain backward in fp64, as
    ``test_torch_ssm.py`` holds the forward's: each of the four gradients
    within 2e-4 (1 + |want|), or, where the fp32 plain backward misses that
    limit too (no decay: the state and its gradient grow over all steps
    and terms cancel; da_log here), no further from the exact gradient
    than it.  Single TF32 misses by far.  The shares, the da_log share (the
    gradient that cancellation threatens) and each RMS error over the fp32
    plain backward's are printed (on the card ``[scan-bwd]`` holds that
    ratio within ``chip_smoke.SCAN_BWD_REGIME_RATIO`` at S=4096, where the
    kernel's sums of the hi.hi terms apart, its fp64 <G, H0> and its
    two-float carry of G, which this emulation does not model, keep it at
    0.62-1.00)."""
    B, S, H, dh, n = 1, 512, 2, 64, 32
    ins = [torch.from_numpy(a) for a in _scan_inputs(B, S, H, dh, n, seed=7,
                                                     decay=decay)]
    want = ref.selective_scan_bwd(*(t.double() for t in ins), chunk=32)
    plain = ref.selective_scan_bwd(*ins, chunk=32)
    limit = [SCAN_TOL["atol"] * (1 + w.abs()) for w in want]

    def shares(got):
        assert all(g.shape == w.shape and g.dtype == torch.float32
                   for g, w in zip(got, want))
        return [float(((g.double() - w).abs() / lim).max())
                for g, w, lim in zip(got, want, limit)]

    def rms(got):
        return [float((g.double() - w).pow(2).mean().sqrt())
                for g, w in zip(got, want)]

    split = {k: _tf32_scan_bwd(*ins, k) for k in (1, 3)}
    s1, s3, sp = shares(split[1]), shares(split[3]), shares(plain)
    ratio = [a / b for a, b in zip(rms(split[3]), rms(plain))]
    print(f"[tf32-bwd] decay={decay}: shares of the 2e-4 (1 + |want|) limit "
          f"(dxdt, da_log, dB, dC): 3xTF32 {[round(x, 4) for x in s3]}, "
          f"1xTF32 {[round(x, 4) for x in s1]}, fp32 plain "
          f"{[round(x, 4) for x in sp]}; da_log 3xTF32 {s3[1]:.4f}; RMS "
          f"error over the fp32 plain backward's {[round(x, 3) for x in ratio]}")
    assert all(a <= max(1.0, b) for a, b in zip(s3, sp)), (s3, sp)
    assert min(s1) > 1.0, s1            # single TF32 misses: the split matters


def test_tf32_scan_bwd_matches_the_vjp_of_jax_ssd_chunked():
    """``_tf32_scan_bwd`` in 3xTF32 through the Mamba2 block's scan inputs
    (dt-scaled input, a_log from dt and A_log) against ``jax.vjp`` of
    ``_ssd_chunked`` from a zero state: the gradients of xh, B, C, dt and
    A_log within 2e-4 (1 + |want|)."""
    B, S, H, dh, n, chunk = 1, 64, 2, 8, 16, 32
    rng = np.random.default_rng(11)
    xh = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, n)).astype(np.float32) for _ in range(2))
    dt = np.logaddexp(0.0, rng.normal(size=(B, S, H))).astype(np.float32)
    A_log = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    dy = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    h0 = jnp.zeros((B, H, dh, n))
    _, vjp = jax.vjp(lambda xh_, b, c, dt_, al: jssm._ssd_chunked(
        xh_, b, c, dt_, al, h0, chunk)[0], *map(jnp.asarray, (xh, Bm, Cm, dt, A_log)))
    want = vjp(jnp.asarray(dy))
    xh_t, dt_t, al_t = (torch.from_numpy(a).requires_grad_() for a in (xh, dt, A_log))
    xdt, a_log = ssm._scan_inputs(xh_t, dt_t, al_t)
    dxdt, da_log, dB, dC = _tf32_scan_bwd(xdt.detach(), a_log.detach(),
                                          torch.from_numpy(Bm), torch.from_numpy(Cm),
                                          torch.from_numpy(dy), 3, Q=chunk)
    gx, gdt, gal = torch.autograd.grad((xdt, a_log), (xh_t, dt_t, al_t),
                                       (dxdt, da_log))
    for g, w in zip((gx, dB, dC, gdt, gal), want):
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
    """Uncounted, the plain backward at the given chunk (the forward with
    states gives y and None there: the plain backward recomputes them), an
    empty sequence giving zeros; off the CPU and the card it raises."""
    ts = [torch.from_numpy(a) for a in _scan_inputs(1, 40, 2, 4, 8, seed=3)]
    ops.reset_launches()
    y, states = ops.selective_scan_fwd(*ts[:4], chunk=16, with_states=True)
    assert states is None and torch.equal(y, ops.selective_scan_fwd(*ts[:4], chunk=16))
    got = ops.selective_scan_bwd(*ts, states, chunk=16)
    want = ref.selective_scan_bwd(*ts, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launches["selective_scan_bwd"] == ops.launches["selective_scan"] == 0
    empty = ops.selective_scan_bwd(*(t[:, :0] for t in ts), None)
    assert [tuple(e.shape) for e in empty] == [(1, 0, 2, 4), (1, 0, 2),
                                               (1, 0, 8), (1, 0, 8)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.selective_scan_bwd(*(t.to("meta") for t in ts), None)


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
