"""Plain PyTorch versions of the port's kernels.

The aggregation reductions are each a sequential fold over the participant
axis m, in the order of the JAX package's reference flush
(``repro/fl/comm/stream.py`` ``_float_reduce`` / ``_quant_reduce`` with
dispatch "off"): ``out = c_0·x_0``, then ``out = out + c_m·x_m``.
``kernels.ops`` takes them for tensors that lie on the CPU; ``chip_smoke.py``
holds the CUDA kernels against them on the card.  ``topk_fedagg``, the
scatter of sparse top-k payloads, is the same fold over m from exact zeros
(``repro/kernels/ref.py``'s ``lax.scan``), one fp32 product and one fp32 add
per touched position and participant.

The attention kernels follow ``repro/kernels/ref.py`` ``flash_attention`` and
``decode_attention``: fp32 scores and softmax, masking with the finite
``NEG_INF`` (a row with no valid key gets a uniform average, never NaN), and
the output cast to ``q``'s dtype.

``lora_matmul`` is ``repro/kernels/ref.py``'s: ``x@W`` and ``(x@A)@B`` in
the inputs' dtype, the rank-r product scaled and added in the base's dtype.

The SSD recurrence of Mamba2 has two plain versions: ``selective_scan``,
the sequential oracle of ``repro/kernels/ref.py``, and ``ssd_chunked``, the
chunked algorithm of ``repro/models/ssm.py``'s ``_ssd_chunked`` on formed
``xdt``/``a_log``.  ``selective_scan_bwd`` is its gradient from a zero
state, written out by chunks (not autograd of ``ssd_chunked``): the
algorithm of ``csrc/selective_scan_bwd.cu``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _fold(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    if x.shape[0] == 0:
        raise ValueError("a reduction over zero participants has no value")
    out = None
    for m in range(x.shape[0]):
        term = coef[m] * x[m].to(torch.float32)
        out = term if out is None else out + term
    return out


def fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp32/bf16; betas: (M,).  Returns (P,) in stacked's
    dtype = Σ_m β_m·stacked[m], accumulated in fp32 (Eq. 7)."""
    return _fold(stacked, betas.to(torch.float32)).to(stacked.dtype)


def float_fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp16/fp32 payloads; betas: (M,).  Returns (P,) fp32
    = Σ_m β_m·stacked[m]."""
    return _fold(stacked, betas.to(torch.float32))


def dequant_fedagg(q: torch.Tensor, scales: torch.Tensor,
                   betas: torch.Tensor) -> torch.Tensor:
    """q: (M, P) int8; scales, betas: (M,).  Returns (P,) fp32
    = Σ_m (β_m·s_m)·q[m]."""
    return _fold(q, betas.to(torch.float32) * scales.to(torch.float32))


def topk_fedagg(idx: torch.Tensor, vals: torch.Tensor, betas: torch.Tensor,
                n: int) -> torch.Tensor:
    """idx: (M, k) int32, indices unique within a row; vals: (M, k) fp32;
    betas: (M,).  Returns (n,) fp32 = Σ_m β_m·scatter(idx[m], vals[m]),
    folded over m in order from zeros: ``out[i] = out[i] + β_m·v``."""
    if idx.shape[0] == 0:
        raise ValueError("a reduction over zero participants has no value")
    out = torch.zeros(int(n), dtype=torch.float32, device=vals.device)
    b = betas.to(torch.float32)
    for m in range(idx.shape[0]):
        out.index_add_(0, idx[m].long(), b[m] * vals[m].to(torch.float32))
    return out


def _attention_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
                    device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _masked_scores(q, k, causal, window, scale):
    """(B, KV, g, Sq, Sk) fp32 scaled scores, NEG_INF where masked, and the
    (Sq, Sk) mask."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = _attention_mask(Sq, Sk, causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) -> (B,Sq,H,hd); query head h reads
    KV head h // (H/KV).  Query i and key j are positions i and j."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _attend(_masked_scores(q, k, causal, window, scale)[0], q, v)


def _attend(s, q, v):
    """softmax(s) V for the masked scores s: (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """``flash_attention``'s output and the row log-sum-exp that its
    backward consumes: lse (B, H, Sq) fp32 = logsumexp_j of the scaled,
    masked scores, in natural-log units.  A row with no valid key has every
    score at NEG_INF, so its lse is NEG_INF (ln Sk is below its rounding)."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s, _ = _masked_scores(q, k, causal, window, scale)
    lse = torch.logsumexp(s, dim=-1)                       # (B, KV, g, Sq)
    return _attend(s, q, v), lse.reshape(B, H, Sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The FlashAttention-2 backward of ``flash_attention`` from its saved
    output and ``lse``: returns (dq, dk, dv) in the inputs' dtypes.

        D  = rowsum(dO ∘ O)             P  = exp(S − lse)
        dV = Pᵀ dO                      dS = P ∘ (dO Vᵀ − D)
        dQ = dS K · scale               dK = dSᵀ Q · scale

    with the GQA group of each KV head summed into it.  A masked pair has
    dS = 0 (the mask is a ``where``); a row with no valid key at all
    (lse <= NEG_INF / 2) has the uniform P = 1/Sk that the forward averaged
    with, and dS = 0."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    f32 = torch.float32
    s, mask = _masked_scores(q, k, causal, window, scale)
    lse_g = lse.to(f32).reshape(B, KV, g, Sq, 1)
    empty = lse_g <= NEG_INF / 2
    p = torch.where(empty, torch.full_like(s, 1.0 / Sk), torch.exp(s - lse_g))
    do = dout.to(f32).reshape(B, Sq, KV, g, hd)
    o = out.to(f32).reshape(B, Sq, KV, g, hd)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", do, o)[..., None]
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, v.to(f32))
    ds = torch.where(mask & ~empty, p * (dp - delta), torch.zeros_like(p))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q.to(f32).reshape(
        B, Sq, KV, g, hd)) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q: (B,1,H,hd), k/v: (B,S,KV,hd), valid: (S,) bool, one mask for the
    whole batch -> (B,1,H,hd)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, KV, g, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, v.to(torch.float32))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             scale: float):
    """One slice of a sequence-sharded cache, as ``repro/models/attention.py``
    ``_gqa_decode_core_seq_sharded``'s body computes it before its pmax:
    q (B,1,H,hd), k/v (B,S_loc,KV,hd), valid (S_loc,) bool -> m (B,KV,g),
    the max of the scaled scores with masked keys at ``NEG_INF``; l and o,
    the sum of exp(s - m) and of exp(s - m)·v over the valid keys (relative
    to the slice's own max, where JAX's body subtracts the global one).  A
    slice with no valid key gives m = NEG_INF, l = 0, o = 0."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.to(torch.float32)) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    o = torch.einsum("bkgs,bskh->bkgh", p, v.to(torch.float32))
    return m, p.sum(dim=-1), o


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scaling: float) -> torch.Tensor:
    """x: (T, d), w: (d, o), a: (d, r), b: (r, o) -> (T, o)
    = x @ w + scaling * (x @ a) @ b."""
    base = x @ w
    delta = (x @ a) @ b
    return base + torch.tensor(scaling, dtype=base.dtype,
                               device=base.device) * delta.to(base.dtype)


# ---------------------------------------------------------------------------
# selective scan (Mamba2 SSD recurrence, per head)
# ---------------------------------------------------------------------------
def selective_scan(xdt: torch.Tensor, a_log: torch.Tensor, B_mat: torch.Tensor,
                   C_mat: torch.Tensor, h0: torch.Tensor):
    """Sequential oracle: h_t = exp(a_log_t)·h_{t-1} + xdt_t ⊗ B_t and
    y_t = C_t·h_t.  xdt: (B,S,H,dh) (already dt-scaled), a_log: (B,S,H),
    B_mat/C_mat: (B,S,n), h0: (B,H,dh,n).  Returns (y (B,S,H,dh), h_end)."""
    h = h0
    ys = []
    for t in range(xdt.shape[1]):
        a = torch.exp(a_log[:, t])                                   # (B,H)
        u = torch.einsum("bhd,bn->bhdn", xdt[:, t], B_mat[:, t])
        h = a[:, :, None, None] * h + u
        ys.append(torch.einsum("bhdn,bn->bhd", h, C_mat[:, t]))
    if not ys:
        return torch.zeros_like(xdt), h
    return torch.stack(ys, 1), h


def _exp_in(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """exp of an fp64 cumsum (or a difference of two), taken in the scan's
    dtype (fp32; fp64 inputs keep fp64, for ``gradcheck``)."""
    return torch.exp(x.to(dtype))


def ssd_chunked(xdt: torch.Tensor, a_log: torch.Tensor, B_mat: torch.Tensor,
                C_mat: torch.Tensor, h0: torch.Tensor, chunk: int):
    """The same recurrence by chunks of Q = min(chunk, S) steps: within a
    chunk y = ((C·Bᵀ) ∘ L)·xdt with L_ts = exp(cum_t - cum_s) for t >= s,
    plus the carried exp(cum_t)·C_t·h; the state then moves to the chunk's
    end.  Shapes as ``selective_scan``.  A ragged last chunk is padded with
    identity steps (a_log = 0, xdt = B = C = 0), which leave the state as
    it is, and cut from y.

    The in-chunk cumsum and its differences are taken in fp64, as the CUDA
    kernel takes them (the JAX ``_ssd_chunked`` keeps fp32): within a chunk
    the cumsum grows to tens below zero, and its fp32 rounding becomes
    relative error of exp(cum_t - cum_s) that cancelling terms keep."""
    Bsz, S, H, dh = xdt.shape
    n = B_mat.shape[-1]
    if S == 0:
        return torch.zeros_like(xdt), h0
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xdt = torch.nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
        a_log = torch.nn.functional.pad(a_log, (0, 0, 0, pad))
        B_mat = torch.nn.functional.pad(B_mat, (0, 0, 0, pad))
        C_mat = torch.nn.functional.pad(C_mat, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xs = xdt.reshape(Bsz, nc, Q, H, dh)
    bs, cs = B_mat.reshape(Bsz, nc, Q, n), C_mat.reshape(Bsz, nc, Q, n)
    las = a_log.reshape(Bsz, nc, Q, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    ex = lambda v: _exp_in(v, xdt.dtype)
    h, ys = h0, []
    for c in range(nc):
        xdt_c, B_c, C_c = xs[:, c], bs[:, c], cs[:, c]
        cums = torch.cumsum(las[:, c].to(torch.float64), dim=1)      # (B,Q,H)
        # intra-chunk: y[t] += sum_{s<=t} exp(cums_t - cums_s) (C_t.B_s) xdt_s
        Lm = ex(cums[:, :, None, :] - cums[:, None, :, :])       # (B,Q,Q,H)
        Lm = torch.where(tri[None, :, :, None], Lm, torch.zeros_like(Lm))
        CB = torch.einsum("bqn,bsn->bqs", C_c, B_c)                  # (B,Q,Q)
        y = torch.einsum("bqsh,bshd->bqhd", CB[..., None] * Lm, xdt_c)
        # inter-chunk: y[t] += exp(cums_t) C_t . h
        y = y + torch.einsum("bqn,bqh,bhdn->bqhd", C_c, ex(cums), h)
        # state update
        dec_end = ex(cums[:, -1:, :] - cums)                     # (B,Q,H)
        h = ex(cums[:, -1])[:, :, None, None] * h + \
            torch.einsum("bqh,bqn,bqhd->bhdn", dec_end, B_c, xdt_c)
        ys.append(y)
    return torch.cat(ys, 1)[:, :S], h


def selective_scan_bwd(xdt: torch.Tensor, a_log: torch.Tensor,
                       B_mat: torch.Tensor, C_mat: torch.Tensor,
                       dy: torch.Tensor, chunk: int = 32):
    """The gradient of ``selective_scan`` from a zero state: given its
    inputs and dy (B,S,H,dh), returns (dxdt, da_log, dB, dC), dB and dC
    (B,S,n) summed over the heads.

    By chunks of Q = min(chunk, S) steps (cum the in-chunk cumsum of a_log
    in fp64, L_ts = exp(cum_t - cum_s) for t >= s, e_t = exp(cum_t), dend_s
    = exp(cum_Q - cum_s)): a forward pass keeps the state H0 at each chunk's
    start; the reverse pass carries G, the gradient of the state at the
    chunk's end (M_ts = dy_t·x_s, P = L∘(C·Bᵀ)∘M):

        dX  = (L∘C·Bᵀ)ᵀ·dY + diag(dend)·B·Gᵀ
        dB  = Σ_h (L∘M)ᵀ·C + diag(dend)·X·G
        dC  = Σ_h (L∘M)·B + diag(e)·dY·H0
        da_t = Σ_{t'>=t>s} P_t's + Σ_{t'>=t} q_t' + Σ_{s<t} p_s + exp(cum_Q)<G, H0>
             q_t = e_t <dy_t, H0·C_t>,  p_s = dend_s <G·B_s, x_s>
        G  <- exp(cum_Q)·G + (diag(e)·dY)ᵀ·C

    da_log is a_t <g_t, h_{t-1}> term by term (each a_log_t scales the
    steps it lies between), not Σ_{k>=t} (<dy_k, y_k> - <x_k, dx_k>): that
    form is exact too, but its terms are large and cancel (at t = 0 to an
    exact 0), so its fp32 rounding is many times this one's.  A ragged last
    chunk is padded with identity steps.  fp32 (fp64 inputs keep fp64)."""
    f32 = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    ex = lambda v: _exp_in(v, f32)
    Bsz, S, H, dh = xdt.shape
    n = B_mat.shape[-1]
    if S == 0:
        return (torch.zeros_like(xdt), torch.zeros_like(a_log),
                torch.zeros_like(B_mat), torch.zeros_like(C_mat))
    Q = min(chunk, S)
    pad = (-S) % Q
    pad4 = lambda t: torch.nn.functional.pad(t.to(f32), (0, 0, 0, 0, 0, pad))
    pad3 = lambda t: torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad))
    nc = (S + pad) // Q
    xs = pad4(xdt).reshape(Bsz, nc, Q, H, dh)
    dys = pad4(dy).reshape(Bsz, nc, Q, H, dh)
    bs = pad3(B_mat).reshape(Bsz, nc, Q, n)
    cs = pad3(C_mat).reshape(Bsz, nc, Q, n)
    las = pad3(a_log).reshape(Bsz, nc, Q, H)
    ones = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device)
    tri, below = torch.tril(ones), torch.tril(ones, -1)

    def decays(c):
        cums = torch.cumsum(las[:, c].to(torch.float64), dim=1)      # (B,Q,H)
        L = ex(cums[:, :, None, :] - cums[:, None, :, :])            # (B,t,s,H)
        L = torch.where(tri[None, :, :, None], L, torch.zeros_like(L))
        return L, ex(cums), ex(cums[:, -1:, :] - cums), ex(cums[:, -1])

    starts = [torch.zeros((Bsz, H, dh, n), dtype=f32, device=xdt.device)]
    for c in range(nc - 1):
        _, _, dend, eq = decays(c)
        starts.append(eq[:, :, None, None] * starts[-1] + torch.einsum(
            "bqh,bqn,bqhd->bhdn", dend, bs[:, c], xs[:, c]))
    G = torch.zeros_like(starts[0])
    dxs, das, dbs, dcs = [], [], [], []
    for c in reversed(range(nc)):
        x, dyc, Bc, Cc, H0 = xs[:, c], dys[:, c], bs[:, c], cs[:, c], starts[c]
        L, e, dend, eq = decays(c)
        CB = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None]         # (B,t,s,1)
        M = torch.einsum("bthd,bshd->btsh", dyc, x)
        W, LM = CB * L, M * L
        dx = torch.einsum("btsh,bthd->bshd", W, dyc) + \
            dend[..., None] * torch.einsum("bhdn,bsn->bshd", G, Bc)
        GX = torch.einsum("bhdn,bshd->bshn", G, x)                   # (B,s,H,n)
        YH = torch.einsum("bthd,bhdn->bthn", dyc, H0)
        dB = torch.einsum("btsh,btn->bsn", LM, Cc) + \
            torch.einsum("bsh,bshn->bsn", dend, GX)
        dC = torch.einsum("btsh,bsn->btn", LM, Bc) + \
            torch.einsum("bth,bthn->btn", e, YH)
        # Z[t', t] = Σ_{s<t} P[t', s]; pairs[t] = Σ_{t'>=t} Z[t', t]
        P = W * M
        Z = torch.einsum("btsh,su->btuh", P, below.T.to(f32))
        pairs = torch.einsum("btuh,tu->buh", Z, tri.to(f32))
        q = e * torch.einsum("bthn,btn->bth", YH, Cc)
        p = dend * torch.einsum("bshn,bsn->bsh", GX, Bc)
        base = eq * (G * H0).sum((-2, -1))                           # (B,H)
        da = pairs + torch.flip(torch.cumsum(torch.flip(q, (1,)), 1), (1,)) + \
            (torch.cumsum(p, 1) - p) + base[:, None, :]
        G = eq[:, :, None, None] * G + torch.einsum("bth,bthd,btn->bhdn",
                                                    e, dyc, Cc)
        dxs.append(dx)
        das.append(da)
        dbs.append(dB)
        dcs.append(dC)
    cat = lambda ts: torch.cat(ts[::-1], 1)[:, :S]
    return cat(dxs), cat(das), cat(dbs), cat(dcs)
