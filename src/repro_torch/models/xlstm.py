"""The xLSTM blocks of ``repro/models/xlstm.py`` [arXiv:2405.04517]: sLSTM
(scalar memory, strictly sequential recurrence with exponential gating
and a stabiliser) and mLSTM (matrix memory C = f C + i v kᵀ).

Both run as a Python loop over time carrying O(1) state, in place of the
JAX package's ``lax.scan``, with its casts: q, k, v, the gates and the
carry in fp32, the hidden state cast back to the input's dtype before the
z-gate and the norm.  The JAX package has no Pallas kernel here, and the
port adds none: every step is plain PyTorch.

Under autograd each step keeps its carry for the backward: at xlstm-125m's
full width (d_in 1,536, 4 heads of 384) one mLSTM block at B=8 × S=256
holds about 14.5 GB, so training runs each block under
``transformer._run_block``'s remat.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, dense_init, rmsnorm, rmsnorm_init

_M0 = -1e30   # the stabiliser's initial value


class MLSTMCache(NamedTuple):
    """``length`` (tokens seen) is a host ``int``, as in ``KVCache``."""
    C: torch.Tensor      # (B, H, dh, dh) matrix memory
    n: torch.Tensor      # (B, H, dh) normalizer
    m: torch.Tensor      # (B, H) log-stabilizer
    length: int


class SLSTMCache(NamedTuple):
    c: torch.Tensor      # (B, d_in) cell
    n: torch.Tensor      # (B, d_in)
    h: torch.Tensor      # (B, d_in) hidden (recurrent input)
    m: torch.Tensor      # (B, d_in) stabilizer
    length: int


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_num_heads or cfg.num_heads
    return d_in, H, d_in // H


def _log_sigmoid(f_pre):
    """-softplus(-f) in the JAX package's form, min(f, 0) - log1p(exp(-|f|))
    (``jax.nn.softplus`` is ``logaddexp(x, 0)``), which F.logsigmoid
    computes."""
    return F.logsigmoid(f_pre)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_in, H, _ = _dims(cfg)
    return {
        "up": dense_init(gen, d, 2 * d_in, dtype),       # [x_inner, z-gate]
        "wq": dense_init(gen, d_in, d_in, dtype),
        "wk": dense_init(gen, d_in, d_in, dtype),
        "wv": dense_init(gen, d_in, d_in, dtype),
        "w_if": dense_init(gen, d_in, 2 * H, torch.float32, bias=True),
        "norm": rmsnorm_init(d_in, dtype, gen.device),
        "down": dense_init(gen, d_in, d, dtype),
    }


def _mlstm_step(carry, qkvif):
    """qkvif: q, k, v (B,H,dh), the input gate's pre-activation and the
    forget gate's log sigmoid (B,H), which depends on no carry and is taken
    for every step at once."""
    C, n, m = carry
    q, k, v, i_pre, log_f = qkvif
    m_new = torch.maximum(log_f + m, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(log_f + m - m_new)
    C = f[..., None, None] * C + i[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f[..., None] * n + i[..., None] * k
    num = torch.matmul(C, q[..., None])[..., 0]
    den = torch.maximum(torch.abs((n * q).sum(-1)), torch.exp(-m_new))
    h = num / den[..., None]
    return (C, n, m_new), h


def _mlstm_qkvif(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    d_in, H, dh = _dims(cfg)
    xi, z = torch.chunk(dense(p["up"], x), 2, dim=-1)
    f32 = torch.float32
    q = dense(p["wq"], xi).reshape(B, S, H, dh).to(f32) / math.sqrt(dh)
    k = dense(p["wk"], xi).reshape(B, S, H, dh).to(f32) / math.sqrt(dh)
    v = dense(p["wv"], xi).reshape(B, S, H, dh).to(f32)
    # the JAX package's bf16 x fp32 product promotes x to fp32
    gif = dense(p["w_if"], xi.to(p["w_if"]["w"].dtype)).to(f32)
    gif = gif.reshape(B, S, H, 2)
    return q, k, v, gif[..., 0], gif[..., 1], z


def mlstm_forward(p, cfg: ModelConfig, x):
    """x: (B,S,d) -> (B,S,d), from a zero state."""
    B, S, _ = x.shape
    d_in, H, dh = _dims(cfg)
    q, k, v, i_pre, f_pre, z = _mlstm_qkvif(p, cfg, x)
    log_f = _log_sigmoid(f_pre)
    c = mlstm_init_cache(cfg, B, x.device)
    carry, hs = (c.C, c.n, c.m), []
    for t in range(S):
        carry, h = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t],
                                       i_pre[:, t], log_f[:, t]))
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d_in).to(x.dtype)
    h = h * F.silu(z)
    h = rmsnorm(p["norm"], h, cfg.norm_eps)
    return dense(p["down"], h)


def mlstm_init_cache(cfg: ModelConfig, batch: int, device) -> MLSTMCache:
    _, H, dh = _dims(cfg)
    f32 = torch.float32
    return MLSTMCache(
        C=torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        n=torch.zeros((batch, H, dh), dtype=f32, device=device),
        m=torch.full((batch, H), _M0, dtype=f32, device=device),
        length=0)


def mlstm_decode(p, cfg: ModelConfig, x, cache: MLSTMCache):
    """x: (B,1,d); one step.  Returns (out, new cache)."""
    B = x.shape[0]
    d_in, _, _ = _dims(cfg)
    q, k, v, i_pre, f_pre, z = _mlstm_qkvif(p, cfg, x)
    (C, n, m), h = _mlstm_step((cache.C, cache.n, cache.m),
                               (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                                _log_sigmoid(f_pre[:, 0])))
    h = h.reshape(B, 1, d_in).to(x.dtype) * F.silu(z)
    h = rmsnorm(p["norm"], h, cfg.norm_eps)
    return dense(p["down"], h), MLSTMCache(C=C, n=n, m=m,
                                           length=cache.length + 1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_in, _, _ = _dims(cfg)
    return {
        "w_zifo": dense_init(gen, d, 4 * d_in, dtype, bias=True),
        "r_zifo": dense_init(gen, d_in, 4 * d_in, dtype),   # recurrent
        "norm": rmsnorm_init(d_in, dtype, gen.device),
        "down": dense_init(gen, d_in, d, dtype),
    }


def _slstm_step(p, carry, x_t):
    """x_t: (B, 4*d_in) pre-projected input; carry: (c, n, h, m)."""
    c, n, h_prev, m = carry
    pre = (x_t + dense(p["r_zifo"], h_prev.to(x_t.dtype))).to(torch.float32)
    z_pre, i_pre, f_pre, o_pre = torch.chunk(pre, 4, dim=-1)
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(log_f + m - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.maximum(n_new, torch.ones_like(n_new))
    return (c_new, n_new, h_new, m_new), h_new


def slstm_forward(p, cfg: ModelConfig, x):
    """x: (B,S,d) -> (B,S,d), from a zero state."""
    B, S, _ = x.shape
    xp = dense(p["w_zifo"], x)                                   # (B,S,4*d_in)
    c = slstm_init_cache(cfg, B, x.device)
    carry, hs = (c.c, c.n, c.h, c.m), []
    for t in range(S):
        carry, h = _slstm_step(p, carry, xp[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = rmsnorm(p["norm"], h, cfg.norm_eps)
    return dense(p["down"], h)


def slstm_init_cache(cfg: ModelConfig, batch: int, device) -> SLSTMCache:
    d_in, _, _ = _dims(cfg)
    zero = torch.zeros((batch, d_in), dtype=torch.float32, device=device)
    return SLSTMCache(c=zero, n=zero.clone(), h=zero.clone(),
                      m=torch.full((batch, d_in), _M0, dtype=torch.float32,
                                   device=device),
                      length=0)


def slstm_decode(p, cfg: ModelConfig, x, cache: SLSTMCache):
    """x: (B,1,d); one step.  Returns (out, new cache)."""
    xp = dense(p["w_zifo"], x)[:, 0]
    (c, n, h, m), h_out = _slstm_step(p, (cache.c, cache.n, cache.h, cache.m),
                                      xp)
    y = h_out[:, None, :].to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return dense(p["down"], y), SLSTMCache(c=c, n=n, h=h, m=m,
                                           length=cache.length + 1)
