"""The port's attention (``repro_torch.kernels``: plain ``flash_attention``
and ``decode_attention`` and their wrappers) against the JAX package: its
``repro.kernels.ref`` oracles and its Pallas kernels in interpret mode, on
the same numpy inputs, with the cases and tolerances of
``tests/test_kernels.py``.  The CUDA kernels against these plain versions
on the card are in ``test_torch_kernels_gpu.py``."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

FLASH_CASES = [                                       # tests/test_kernels.py
    dict(B=1, S=128, H=4, KV=4, hd=64, causal=True, window=None),
    dict(B=2, S=256, H=8, KV=2, hd=64, causal=True, window=None),
    dict(B=1, S=256, H=4, KV=4, hd=128, causal=True, window=64),
    dict(B=1, S=192, H=4, KV=1, hd=32, causal=True, window=None),   # odd S, MQA
    dict(B=1, S=128, H=4, KV=4, hd=64, causal=False, window=None),
]
DECODE_CASES = [
    dict(B=2, S=512, H=8, KV=2, hd=64, n_valid=300),
    dict(B=1, S=1024, H=4, KV=4, hd=128, n_valid=1024),
    dict(B=3, S=200, H=6, KV=1, hd=32, n_valid=7),
]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bf16" else \
        dict(rtol=2e-5, atol=2e-5)


def _qkv(B, Sq, Sk, H, KV, hd, dtype, seed):
    """numpy fp32 draws, rounded to the case's dtype once, handed to both
    packages."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)):
        x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jdt)
        t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
        out.append((x, t))
    return out


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles and the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_plain_matches_jax(case, dtype):
    B, S, H, KV, hd = case["B"], case["S"], case["H"], case["KV"], case["hd"]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, S, H, KV, hd, dtype, seed=S + H)
    kw = dict(causal=case["causal"], window=case["window"])
    got = ref.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(jref.flash_attention(jq, jk, jv, **kw)),
                               **_tol(dtype))
    want = pallas_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    # on CPU tensors the wrapper is the plain version, and counts nothing
    before = dict(ops.launches)
    np.testing.assert_array_equal(_np(ops.flash_attention(tq, tk, tv, **kw)),
                                  _np(got))
    assert ops.launches == before


@pytest.mark.parametrize("sq,sk,causal,window", [
    (80, 48, True, None),      # more queries than keys
    (64, 16, False, 8),        # rows past Sk + window - 1 see no key at all
    (16, 64, True, 4),         # fewer queries than keys, windowed
    (1, 33, False, None),
])
def test_flash_attention_plain_edges_match_jax_ref(sq, sk, causal, window):
    """Sq != Sk and rows with no valid key: the finite NEG_INF mask gives a
    uniform average over every key, never NaN."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, sq, sk, 4, 2, 32, "fp32", seed=sq)
    kw = dict(causal=causal, window=window)
    got = ref.flash_attention(tq, tk, tv, **kw)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(jref.flash_attention(jq, jk, jv, **kw)),
                               **_tol("fp32"))
    if not causal and window is not None:
        empty = np.arange(sq) >= sk + window - 1
        mean_v = tv.mean(dim=1)                     # (B, KV, hd)
        want = mean_v.repeat_interleave(2, dim=1)   # (B, H, hd)
        np.testing.assert_allclose(_np(got[:, empty]),
                                   _np(want[:, None].expand(-1, int(empty.sum()), -1, -1)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_attention_plain_matches_jax(case, dtype):
    B, S, H, KV, hd = case["B"], case["S"], case["H"], case["KV"], case["hd"]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, 1, S, H, KV, hd, dtype, seed=S + 1)
    valid_np = np.arange(S) < case["n_valid"]
    scale = 1.0 / np.sqrt(hd)
    got = ref.decode_attention(tq, tk, tv, torch.from_numpy(valid_np), scale=scale)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jvalid = jnp.asarray(valid_np)
    np.testing.assert_allclose(
        _np(got), _np(jref.decode_attention(jq, jk, jv, jvalid, scale=scale)),
        **_tol(dtype))
    want = pallas_decode(jq, jk, jv, jvalid, scale=scale, block_s=128,
                         interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    before = dict(ops.launches)
    np.testing.assert_array_equal(
        _np(ops.decode_attention(tq, tk, tv, torch.from_numpy(valid_np),
                                 scale=scale)), _np(got))
    assert ops.launches == before


def test_decode_attention_plain_ring_mask_and_no_valid_slot():
    """A ring-buffer mask with a hole in the middle, and a mask with no
    valid slot (uniform average, as the JAX oracle)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, 40, 4, 2, 64, "fp32", seed=5)
    for valid_np in (np.r_[np.ones(10), np.zeros(20), np.ones(10)].astype(bool),
                     np.zeros(40, bool)):
        got = ref.decode_attention(tq, tk, tv, torch.from_numpy(valid_np),
                                   scale=0.125)
        want = jref.decode_attention(jq, jk, jv, jnp.asarray(valid_np),
                                     scale=0.125)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(_np(got), _np(want), **_tol("fp32"))


# ---------------------------------------------------------------------------
# the decode kernel's split-and-combine arithmetic (csrc/attention.cu,
# dec::decode_attention_split and dec::decode_attention_combine), emulated on
# the CPU
# ---------------------------------------------------------------------------
KERNEL_TILE = 32                  # dec::kTK: keys per tile
LOG2E = 1.4426950408889634


def _split_decode(q, k, v, valid, scale, tiles_per_split):
    """The kernel's algorithm in fp32: S cut into splits of
    ``tiles_per_split`` 32-key tiles.  A split with a valid key visits only
    its tiles that have one; a split with none writes m = -1e30, l = 0,
    acc = 0 when another split has one, else visits every tile.  Within a
    split, stream r of the block (keys j = r mod ``streams`` of each tile,
    ``streams`` = 128 threads / (hd / 8) lanes per key) keeps an online
    softmax in log2 units from m = -1e30: scores -1e30 where masked, -inf
    past S.  The streams merge into the split's (m, l, acc), and the
    combine weighs the splits by exp2(m_i - max m).  Returns the output and
    the number of tiles visited."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    g, streams = H // KV, 1024 // hd
    passes = KERNEL_TILE // streams
    qg = q.float().reshape(B, KV, g, hd)
    kf, vf = k.float(), v.float()
    n_tiles = -(-S // KERNEL_TILE)
    n_split = -(-n_tiles // tiles_per_split)
    any_valid = bool(valid.any())
    neg = torch.tensor(ref.NEG_INF)
    recs, visited = [], 0
    for sp in range(n_split):
        tiles = range(sp * tiles_per_split,
                      min((sp + 1) * tiles_per_split, n_tiles))
        tile_any = [bool(valid[t * KERNEL_TILE:(t + 1) * KERNEL_TILE].any())
                    for t in tiles]
        split_any = any(tile_any)
        m = torch.full((B, KV, g, streams), ref.NEG_INF)
        l = torch.zeros((B, KV, g, streams))
        acc = torch.zeros((B, KV, g, streams, hd))
        if split_any or not any_valid:
            for t in (t for t, a in zip(tiles, tile_any) if a or not split_any):
                visited += 1
                keys = torch.arange(t * KERNEL_TILE, (t + 1) * KERNEL_TILE)
                inside = keys < S
                kk = keys.clamp(max=S - 1)
                s = torch.einsum("bkgh,bjkh->bkgj", qg, kf[:, kk]) * (scale * LOG2E)
                s = torch.where(valid[kk] & inside, s, neg)
                s = torch.where(inside, s, torch.tensor(-torch.inf))
                s = s.reshape(B, KV, g, passes, streams)
                vv = (vf[:, kk] * inside[None, :, None, None]).reshape(
                    B, passes, streams, KV, hd)
                mn = torch.maximum(m, s.amax(3))
                corr = torch.exp2(m - mn)
                p = torch.exp2(s - mn[:, :, :, None])
                l = l * corr + p.sum(3)
                acc = acc * corr[..., None] + torch.einsum(
                    "bkgpr,bprkh->bkgrh", p, vv)
                m = mn
        M = m.amax(-1, keepdim=True)
        f = torch.exp2(m - M)
        recs.append((M[..., 0], (l * f).sum(-1), (acc * f[..., None]).sum(-2)))
    ms = torch.stack([r[0] for r in recs])
    w = torch.exp2(ms - ms.amax(0))
    L = (w * torch.stack([r[1] for r in recs])).sum(0)
    out = (w[..., None] * torch.stack([r[2] for r in recs])).sum(0)
    out = out / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, hd), visited


def _mask(kind, S):
    key = np.arange(S)
    return {"prefix": key < 130,
            "ring_wraps": (key >= 150) | (key < 40),   # the valid run wraps
            "masked_split": (key < 64) | (key >= 128),  # split 1 all masked
            "none": np.zeros(S, bool),
            "serve": key < 96}[kind]


# (B, S, H, KV, hd): qwen3-1.7b's group (g 2, hd 128) at S = 196, whose
# last split (tiles_per_split 2) is ragged: 4 keys in, and streams 4-7 of
# its last tile see only keys past S; zamba2-1.2b's (g 1, hd 64)
SPLIT_SHAPES = {"qwen3": (2, 196, 4, 2, 128), "zamba2": (2, 256, 4, 4, 64)}


@pytest.mark.parametrize("shape,mask", [
    ("qwen3", "prefix"), ("qwen3", "ring_wraps"), ("qwen3", "masked_split"),
    ("qwen3", "none"), ("zamba2", "serve"), ("zamba2", "ring_wraps"),
    ("zamba2", "none")])
def test_split_decode_arithmetic_matches_jax(shape, mask):
    """The split kernel's arithmetic against the JAX oracle and the Pallas
    kernel in interpret mode (block_s = the split's 64 keys) at 2e-5 in
    fp32, and against the port's plain version: masked tiles skipped only
    when the row has a valid key, the uniform average over the S keys when
    it has none."""
    B, S, H, KV, hd = SPLIT_SHAPES[shape]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, 1, S, H, KV, hd, "fp32", seed=S + hd)
    valid_np = _mask(mask, S)
    scale = 1.0 / np.sqrt(hd)
    got, visited = _split_decode(tq, tk, tv, torch.from_numpy(valid_np), scale,
                                 tiles_per_split=2)
    n_tiles = -(-S // KERNEL_TILE)
    tiles_valid = sum(bool(valid_np[t * 32:(t + 1) * 32].any())
                      for t in range(n_tiles))
    assert visited == (tiles_valid if valid_np.any() else n_tiles)
    assert bool(torch.isfinite(got).all())
    jvalid = jnp.asarray(valid_np)
    tol = _tol("fp32")
    np.testing.assert_allclose(
        _np(got), _np(jref.decode_attention(jq, jk, jv, jvalid, scale=scale)),
        **tol)
    pallas = _np(pallas_decode(jq, jk, jv, jvalid, scale=scale,
                               block_s=2 * KERNEL_TILE, interpret=True))
    s_pad = -(-S // (2 * KERNEL_TILE)) * 2 * KERNEL_TILE
    if mask == "none" and s_pad != S:
        # the Pallas kernel's fault (not the port's): its zero-padded keys
        # past S score the finite -1e30 too, so with no valid slot it
        # averages over s_pad keys, S of them nonzero
        mean = _np(tv).mean(axis=1).repeat(H // KV, axis=1)[:, None]
        np.testing.assert_allclose(pallas, mean * S / s_pad, **tol)
    else:
        np.testing.assert_allclose(_np(got), pallas, **tol)
    np.testing.assert_allclose(
        _np(got), _np(ref.decode_attention(tq, tk, tv,
                                           torch.from_numpy(valid_np),
                                           scale=scale)), **tol)


# ---------------------------------------------------------------------------
# the wrappers refuse what the kernels do not take
# ---------------------------------------------------------------------------
def _z(*shape, dtype=torch.float32, device="cpu", grad=False):
    return torch.zeros(shape, dtype=dtype, device=device, requires_grad=grad)


@pytest.mark.parametrize("q,k,v,err,match", [
    (_z(1, 8, 4, 32), _z(1, 8, 2, 32), _z(1, 9, 2, 32), ValueError, "differ"),
    (_z(1, 8, 4, 32), _z(2, 8, 2, 32), _z(2, 8, 2, 32), ValueError, "batch"),
    (_z(1, 8, 4, 32), _z(1, 8, 2, 64), _z(1, 8, 2, 64), ValueError, "head dim"),
    (_z(1, 8, 4, 32), _z(1, 8, 3, 32), _z(1, 8, 3, 32), ValueError, "multiple"),
    (_z(8, 4, 32), _z(1, 8, 2, 32), _z(1, 8, 2, 32), ValueError, "4-d"),
    (_z(1, 8, 4, 32, dtype=torch.float16), _z(1, 8, 2, 32, dtype=torch.float16),
     _z(1, 8, 2, 32, dtype=torch.float16), TypeError, "dtype"),
    (_z(1, 8, 4, 32), _z(1, 8, 2, 32, dtype=torch.bfloat16), _z(1, 8, 2, 32),
     TypeError, "dtype"),
    (_z(1, 8, 4, 32), _z(1, 8, 2, 32, device="meta"), _z(1, 8, 2, 32),
     ValueError, "different devices"),
    (_z(1, 8, 4, 32, device="meta"), _z(1, 8, 2, 32, device="meta"),
     _z(1, 8, 2, 32, device="meta"), ValueError, "no kernel for device"),
])
def test_flash_wrapper_refuses(q, k, v, err, match):
    with pytest.raises(err, match=match):
        ops.flash_attention(q, k, v)


def test_flash_wrapper_takes_grad_through_its_backward_and_refuses_bad_window():
    """The kernel has a backward now: a device tensor that requires grad is
    no longer refused but reaches the autograd function, whose forward
    then finds no kernel for the meta device; on the CPU the plain
    forward and backward are taken.  A window < 1 still raises."""
    q = _z(1, 8, 4, 32, device="meta", grad=True)
    k = _z(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device") as info:
        ops.flash_attention(q, k, k)
    assert any(f.name == "forward" for f in info.traceback), info.traceback
    qc = torch.randn(1, 8, 4, 32, requires_grad=True)
    kc = torch.randn(1, 8, 2, 32)
    out = ops.flash_attention(qc, kc, kc)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.sum().backward()
    assert qc.grad is not None and bool(torch.isfinite(qc.grad).all())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(qc.detach(), kc, kc, window=0)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)


@pytest.mark.parametrize("q,valid,err,match", [
    (_z(1, 2, 4, 32), _z(8, dtype=torch.bool), ValueError, "query token"),
    (_z(1, 1, 4, 32), _z(7, dtype=torch.bool), ValueError, "validity"),
    (_z(1, 1, 4, 32), _z(8), ValueError, "validity"),
    (_z(1, 1, 4, 32, dtype=torch.bfloat16), _z(8, dtype=torch.bool), TypeError,
     "dtype"),
    (_z(1, 1, 4, 32), _z(8, dtype=torch.bool, device="meta"), ValueError,
     "different devices"),
])
def test_decode_wrapper_refuses(q, valid, err, match):
    k = _z(1, 8, 2, 32)
    with pytest.raises(err, match=match):
        ops.decode_attention(q, k, k, valid, scale=1.0)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_decode_wrapper_refuses_grad_off_the_cpu(which):
    """As for flash_attention: the kernel has no backward, so a device
    tensor that requires grad is refused before anything else (its output
    would carry no gradient); on the CPU the plain version is
    differentiable and is taken."""
    qkv = {"q": _z(1, 1, 4, 32, device="meta"), "k": _z(1, 8, 2, 32, device="meta"),
           "v": _z(1, 8, 2, 32, device="meta")}
    qkv[which].requires_grad_()
    valid = _z(8, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(qkv["q"], qkv["k"], qkv["v"], valid, scale=1.0)
    qkv = {"q": torch.randn(1, 1, 4, 32), "k": torch.randn(1, 8, 2, 32),
           "v": torch.randn(1, 8, 2, 32)}
    qkv[which].requires_grad_()
    ops.decode_attention(qkv["q"], qkv["k"], qkv["v"],
                         torch.arange(8) < 5, scale=1.0).sum().backward()
    grad = qkv[which].grad
    assert grad is not None and bool(torch.isfinite(grad).all())


# ---------------------------------------------------------------------------
# the tolerance that holds the CUDA kernels on the card
# ---------------------------------------------------------------------------
def _flash_with_bf16_p(q, k, v, causal, window):
    """The bf16 tensor-core kernel's arithmetic: fp32 scores and softmax
    sum, P rounded to bf16 for the PV product, the output rounded once."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float().reshape(B, S, KV, H // KV, hd),
                     k.float()) / hd ** 0.5
    pos = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, ref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bskh->bqkgh", p.bfloat16().float(), v.float())
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, H, hd).bfloat16()


@pytest.mark.parametrize("S,causal,window", [(1024, True, None),
                                             (768, True, 128),
                                             (640, False, None)])
def test_card_tolerance_takes_bf16_rounding_and_refuses_small_errors(S, causal,
                                                                     window):
    """``chip_smoke.attention_error`` passes the bf16 kernel's rounding of P
    and refuses an output 5% off on the last rows, where |out| is about
    sqrt(e / S): a fixed 3e-2 tolerance would pass that."""
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn((1, S, h, 128), generator=g).bfloat16()
               for h in (4, 2, 2))
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    got = _flash_with_bf16_p(q, k, v, causal, window)
    err = chip_smoke.attention_error(got, want)
    assert err["ok"] and err["share_of_limit"] < 0.75, err
    off = (got.float() * torch.where(torch.arange(S) >= S - 64, 1.05, 1.0)
           [None, :, None, None]).bfloat16()
    assert not chip_smoke.attention_error(off, want)["ok"]
    np.testing.assert_allclose(_np(off), _np(want), rtol=3e-2, atol=3e-2)
    assert not chip_smoke.attention_error(got.float(), want)["ok"]   # dtype


def _bwd_with_bf16_p_ds(q, k, v, out, lse, dout, causal, window):
    """The bf16 tensor-core backward's arithmetic: fp32 S and dP from the
    bf16 inputs, P and dS rounded to bf16 before the dV, dK and dQ
    products, each gradient rounded once."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g, scale = H // KV, hd ** -0.5
    f32 = torch.float32
    qg, dog, og = (t.to(f32).reshape(B, S, KV, g, hd) for t in (q, dout, out))
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(f32)) * scale
    pos = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, g, S, 1)), 0.0)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.to(f32))
    d = torch.einsum("bqkgh,bqkgh->bkgq", dog, og)[..., None]
    ds = torch.where(mask, p * (dp - d), 0.0)
    pb, dsb = p.bfloat16().to(f32), ds.bfloat16().to(f32)
    dv = torch.einsum("bkgqs,bqkgh->bskh", pb, dog)
    dk = torch.einsum("bkgqs,bqkgh->bskh", dsb, qg) * scale
    dq = torch.einsum("bkgqs,bskh->bqkgh", dsb, k.to(f32)) * scale
    return (dq.reshape(B, S, H, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


@pytest.mark.parametrize("S,causal,window", [(768, True, None),
                                             (640, True, 100),
                                             (512, False, None)])
def test_card_gradient_tolerance_takes_bf16_p_and_ds(S, causal, window):
    """``chip_smoke.GRAD_TOL`` passes the bf16 backward kernels' rounding of
    P and dS at hd 128 with room to spare (share of the limit < 0.75), and
    refuses a gradient 5% off on its last rows."""
    g = torch.Generator().manual_seed(S + 1)
    q, k, v, dout = (torch.randn((1, S, h, 128), generator=g).bfloat16()
                     for h in (4, 2, 2, 4))
    kw = dict(causal=causal, window=window, scale=128 ** -0.5)
    out, lse = ref.flash_attention_lse(q, k, v, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    got = _bwd_with_bf16_p_ds(q, k, v, out, lse, dout, causal, window)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        err = chip_smoke.attention_error(gt, w, chip_smoke.GRAD_TOL)
        assert err["ok"] and err["share_of_limit"] < 0.75, (name, err)
        off = (gt.float() * torch.where(torch.arange(S) >= S - 64, 1.05, 1.0)
               [None, :, None, None]).bfloat16()
        assert not chip_smoke.attention_error(off, w, chip_smoke.GRAD_TOL)["ok"]
