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
``xdt``/``a_log``.
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


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """exp of an fp64 cumsum (or a difference of two), taken in fp32."""
    return torch.exp(x.to(torch.float32))


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
    h, ys = h0, []
    for c in range(nc):
        xdt_c, B_c, C_c = xs[:, c], bs[:, c], cs[:, c]
        cums = torch.cumsum(las[:, c].to(torch.float64), dim=1)      # (B,Q,H)
        # intra-chunk: y[t] += sum_{s<=t} exp(cums_t - cums_s) (C_t.B_s) xdt_s
        Lm = _exp32(cums[:, :, None, :] - cums[:, None, :, :])       # (B,Q,Q,H)
        Lm = torch.where(tri[None, :, :, None], Lm, torch.zeros_like(Lm))
        CB = torch.einsum("bqn,bsn->bqs", C_c, B_c)                  # (B,Q,Q)
        y = torch.einsum("bqsh,bshd->bqhd", CB[..., None] * Lm, xdt_c)
        # inter-chunk: y[t] += exp(cums_t) C_t . h
        y = y + torch.einsum("bqn,bqh,bhdn->bqhd", C_c, _exp32(cums), h)
        # state update
        dec_end = _exp32(cums[:, -1:, :] - cums)                     # (B,Q,H)
        h = _exp32(cums[:, -1])[:, :, None, None] * h + \
            torch.einsum("bqh,bqn,bqhd->bhdn", dec_end, B_c, xdt_c)
        ys.append(y)
    return torch.cat(ys, 1)[:, :S], h
