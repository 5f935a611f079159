"""GQA attention of ``repro/models/attention.py`` (RoPE, qk-norm, sliding
window, bias), through the port's attention kernels.

  * ``gqa_forward`` (prefill / score forward) calls
    ``kernels.ops.flash_attention``;
  * ``gqa_decode`` (one token against a ring-buffer cache) calls
    ``kernels.ops.decode_attention``.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches the kernel.  MLA, cross-attention and the sequence-sharded decode
of the JAX package are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense, dense_init, rmsnorm,
                                       rmsnorm_init)


class KVCache(NamedTuple):
    """Ring-buffer KV cache.  For SWA archs ``k.shape[1]`` is the window.

    ``length`` (tokens seen so far) is a host ``int``, not a device scalar
    as in the JAX package: the ring slot and the validity vector are then
    computed without reading the device back."""
    k: torch.Tensor       # (B, S_cache, KV, hd)
    v: torch.Tensor       # (B, S_cache, KV, hd)
    length: int


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    if cfg.mla:
        raise NotImplementedError("MLA attention: not ported yet")
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, bias=cfg.attn_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, bias=cfg.attn_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, bias=cfg.attn_bias),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device)
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# GQA forward (prefill / score)
# ---------------------------------------------------------------------------
def gqa_forward(p, cfg: ModelConfig, x, positions):
    """Causal self-attention.  x: (B, S, d), positions: (B, S) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = kops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return dense(p["wo"], o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim))


# ---------------------------------------------------------------------------
# GQA decode (1 token against the ring-buffer cache)
# ---------------------------------------------------------------------------
def gqa_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                   device) -> KVCache:
    hd = cfg.resolved_head_dim
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, S, cfg.num_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def ring_valid(pos: int, S: int, window: Optional[int],
               device) -> torch.Tensor:
    """(S,) bool: which ring slots hold a token the query at absolute
    position ``pos`` may attend to, once ``pos`` is written to slot
    ``pos % S`` (``attention.py:277-291`` of the JAX package)."""
    slot = pos % S
    kpos = torch.arange(S, device=device)
    # absolute position currently stored in each slot of the ring buffer
    abs_pos = torch.where(kpos <= slot, pos - slot + kpos, pos - slot - S + kpos)
    valid = abs_pos >= 0
    if window:
        valid &= abs_pos > pos - window
    return valid


def gqa_decode(p, cfg: ModelConfig, x, cache: KVCache, valid: torch.Tensor):
    """x: (B, 1, d).  Returns (out, cache advanced by one token).

    The new k/v are written into ``cache.k``/``cache.v`` in place (the JAX
    package returns updated copies): a full-width cache is rewritten one
    slot per step, not copied.  ``valid`` is ``ring_valid(cache.length,
    ...)``, which ``transformer.decode_step`` computes once for all layers."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache.length
    S = cache.k.shape[1]
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, posb)
    slot = pos % S                                        # ring-buffer slot
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    o = kops.decode_attention(q, cache.k, cache.v, valid,
                              scale=1.0 / math.sqrt(hd))
    out = dense(p["wo"], o.reshape(B, 1, cfg.num_heads * hd))
    return out, KVCache(k=cache.k, v=cache.v, length=pos + 1)
