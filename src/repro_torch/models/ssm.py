"""The Mamba2 block of ``repro/models/ssm.py`` (SSD, state-space duality).

Recurrence per head (state n = ssm_state_size, head dim dh):
    h_t = a_t * h_{t-1} + dt_t * (x_t ⊗ B_t),   y_t = C_t · h_t + D * x_t
with a_t = exp(-dt_t * exp(A_log)).

``mamba2_forward`` (prefill / score / training) forms a_log = log a_t and
the dt-scaled input in fp32 and hands the scan to ``kernels.ops.
selective_scan``: on a CUDA tensor the kernel ``csrc/selective_scan.cu``
(its gradient ``csrc/selective_scan_bwd.cu``), on a CPU tensor the
chunked plain version (its gradient ``kernels.ref.selective_scan_bwd``).  ``_ssd_chunked`` is the JAX
package's chunked scan with an initial state, on the plain version.
Decode is the one-step recurrence in plain PyTorch (the JAX package has no
kernel for it either).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.layers import dense, dense_init, rmsnorm, rmsnorm_init


class MambaCache(NamedTuple):
    """``length`` (tokens seen) is a host ``int``, as in ``KVCache``."""
    h: torch.Tensor       # (B, H, dh, n) fp32 SSM state
    conv: torch.Tensor    # (B, w-1, d_in) conv tail
    length: int


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_num_heads or cfg.num_heads
    return d_in, H, d_in // H, cfg.ssm_state_size


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    d_in, H, _, n = _dims(cfg)
    dev = gen.device
    in_proj = dense_init(gen, d, 2 * d_in + 2 * n + H, dtype)
    conv_w = (torch.randn((cfg.ssm_conv_width, d_in), generator=gen,
                          device=dev) * 0.1).to(dtype)
    return {
        # order: [z (d_in), x (d_in), B (n), C (n), dt (H)]
        "in_proj": in_proj,
        "conv_w": conv_w,
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_in, dtype, dev),
        "out_proj": dense_init(gen, d_in, d, dtype),
    }


def _split_proj(p, cfg: ModelConfig, x):
    d_in, H, _, n = _dims(cfg)
    zxbcd = dense(p["in_proj"], x)
    z, xi, Bm, Cm, dt = torch.split(zxbcd, [d_in, d_in, n, n, H], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])             # (B,S,H)
    return z, xi, Bm, Cm, dt


def _causal_conv(p, xi, tail=None):
    """Depthwise causal conv.  xi: (B,S,d_in); tail: (B,w-1,d_in) or None."""
    w = p["conv_w"].shape[0]
    if tail is None:
        tail = xi.new_zeros((xi.shape[0], w - 1, xi.shape[2]))
    xpad = torch.cat([tail, xi], dim=1)
    S = xi.shape[1]
    out = sum(xpad[:, i:i + S] * p["conv_w"][i] for i in range(w))
    new_tail = xpad[:, xpad.shape[1] - (w - 1):]
    return F.silu(out), new_tail


def _scan_inputs(xh, dt, A_log):
    """(xdt (B,S,H,dh), a_log (B,S,H)) in fp32 from the conv output xh,
    dt (B,S,H) and A_log (H,)."""
    a_log = -dt * torch.exp(A_log)[None, None, :]                    # log a_t
    return xh.to(torch.float32) * dt[..., None], a_log


def _check_chunk(S: int, chunk: int) -> None:
    """The JAX package asserts that the chunk divides S (``ssm.py:74``)."""
    if S % min(chunk, S):
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")


def _ssd_chunked(xh, Bm, Cm, dt, A_log, h0, chunk: int):
    """xh: (B,S,H,dh); Bm/Cm: (B,S,n); dt: (B,S,H); h0: (B,H,dh,n) fp32.
    Returns (y (B,S,H,dh) fp32, h_end)."""
    _check_chunk(xh.shape[1], chunk)
    xdt, a_log = _scan_inputs(xh, dt, A_log)
    return kref.ssd_chunked(xdt, a_log, Bm.to(torch.float32),
                            Cm.to(torch.float32), h0, chunk)


def mamba2_forward(p, cfg: ModelConfig, x, chunk: int = 256):
    """x: (B,S,d) -> (B,S,d).  Training / prefill, from a zero state."""
    B, S, d = x.shape
    d_in, H, dh, _ = _dims(cfg)
    _check_chunk(S, chunk)
    z, xi, Bm, Cm, dt = _split_proj(p, cfg, x)
    xi, _ = _causal_conv(p, xi)
    xh = xi.reshape(B, S, H, dh)
    xdt, a_log = _scan_inputs(xh, dt, p["A_log"])
    y = kops.selective_scan(xdt, a_log, Bm.to(torch.float32).contiguous(),
                            Cm.to(torch.float32).contiguous(), chunk=chunk)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return dense(p["out_proj"], y)


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype,
                      device) -> MambaCache:
    d_in, H, dh, n = _dims(cfg)
    return MambaCache(
        h=torch.zeros((batch, H, dh, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, d_in), dtype=dtype,
                         device=device),
        length=0)


def mamba2_decode(p, cfg: ModelConfig, x, cache: MambaCache):
    """x: (B,1,d); one-step recurrence.  Returns (out, new cache)."""
    B = x.shape[0]
    d_in, H, dh, _ = _dims(cfg)
    z, xi, Bm, Cm, dt = _split_proj(p, cfg, x)
    xi, new_tail = _causal_conv(p, xi, cache.conv)
    xh = xi.reshape(B, H, dh).to(torch.float32)
    dt1 = dt[:, 0]                                                   # (B,H)
    a = torch.exp(-dt1 * torch.exp(p["A_log"])[None, :])             # (B,H)
    u = torch.einsum("bhd,bn->bhdn", xh * dt1[..., None],
                     Bm[:, 0].to(torch.float32))
    h = a[:, :, None, None] * cache.h + u
    y = torch.einsum("bhdn,bn->bhd", h, Cm[:, 0].to(torch.float32))
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return dense(p["out_proj"], y), MambaCache(h=h, conv=new_tail,
                                               length=cache.length + 1)
