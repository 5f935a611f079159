"""Attention of ``repro/models/attention.py``: GQA (RoPE, qk-norm, sliding
window, bias) through the port's attention kernels, MLA (DeepSeek-V2
multi-head latent attention with the absorbed decode) and the enc-dec
cross-attention.

  * ``gqa_forward`` (prefill / score forward, causal or not) calls
    ``kernels.ops.flash_attention``;
  * ``gqa_decode`` (one token against a ring-buffer cache) calls
    ``kernels.ops.decode_attention``;
  * ``mla_forward`` and ``cross_attn_forward`` run ``sdpa``, the plain
    chunked attention of the JAX package's ``_sdpa`` (fp32 scores, a value
    head dim that may differ from the query's), as JAX runs them outside
    any Pallas kernel; ``mla_decode`` runs JAX's fp32 einsums.

On a CPU tensor each kernel wrapper takes its plain version; on a CUDA
tensor it launches the kernel.

Under a ``dist.MeshContext`` whose model axis the KV heads do not divide,
the cache is sequence-sharded as in the JAX package (§Perf A): each rank
holds a contiguous 1/ms of the ring's slots (``SeqShard``), writes the new
K/V only where it holds slot ``pos % S``, runs
``kernels.ops.decode_attention_partial`` over its slots and the ranks
combine the partial softmax (a ``pmax`` of the max, ``psum``s of the sum
and the unnormalised output over the model axis).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import dist
from repro_torch.models.layers import (apply_rope, dense, dense_init, rmsnorm,
                                       rmsnorm_init)


NEG_INF = -1e30


class SeqShard(NamedTuple):
    """Where one rank's slice of a sequence-sharded ring lies."""
    start: int            # the first global slot this rank holds
    slots: int            # the whole ring's slot count S


class KVCache(NamedTuple):
    """Ring-buffer KV cache.  For SWA archs ``k.shape[1]`` is the window.
    MLA keeps its latent cache in the same fields, not as a ring: ``k`` is
    c_kv (B, S, kv_lora_rank), ``v`` is k_rope (B, S, rope_head_dim).

    ``length`` (tokens seen so far) is a host ``int``, not a device scalar
    as in the JAX package: the ring slot and the validity vector are then
    computed without reading the device back.  ``shard``: where this
    rank's slots lie in a sequence-sharded ring (``k`` then holds
    ``S // model size`` of its slots), None for a whole cache."""
    k: torch.Tensor       # (B, S_cache, KV, hd)  — MLA: c_kv (B, S, lora)
    v: torch.Tensor       # (B, S_cache, KV, hd)  — MLA: k_rope (B, S, rope_hd)
    length: int
    shard: Optional[SeqShard] = None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    if cfg.mla:
        qh = cfg.mla_nope_head_dim + cfg.mla_rope_head_dim
        return {
            "q_down": dense_init(gen, cfg.d_model, cfg.mla_q_lora_rank, dtype),
            "q_norm": rmsnorm_init(cfg.mla_q_lora_rank, dtype, gen.device),
            "q_up": dense_init(gen, cfg.mla_q_lora_rank, cfg.num_heads * qh,
                               dtype),
            "kv_down": dense_init(
                gen, cfg.d_model, cfg.mla_kv_lora_rank + cfg.mla_rope_head_dim,
                dtype),
            "kv_norm": rmsnorm_init(cfg.mla_kv_lora_rank, dtype, gen.device),
            "kv_up": dense_init(
                gen, cfg.mla_kv_lora_rank,
                cfg.num_heads * (cfg.mla_nope_head_dim + cfg.mla_v_head_dim),
                dtype),
            "wo": dense_init(gen, cfg.num_heads * cfg.mla_v_head_dim,
                             cfg.d_model, dtype),
        }
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


def cross_attn_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, bias=cfg.attn_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, bias=cfg.attn_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, bias=cfg.attn_bias),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype),
    }


# ---------------------------------------------------------------------------
# plain scaled-dot-product attention with GQA and chunked queries
# ---------------------------------------------------------------------------
def sdpa(q, k, v, *, causal: bool, window: Optional[int], q_offset: int,
         scale: float, q_chunk: int = 2048):
    """The JAX package's ``_sdpa``: q (B, Sq, H, hd), k (B, Sk, KV, hd), v
    (B, Sk, KV, vd) -> (B, Sq, H, vd) in q's dtype, fp32 scores and
    softmax.  ``q_offset`` is the absolute position of q[0] minus that of
    k[0].  Queries go in chunks of ``q_chunk`` rows, which must then divide
    Sq, so that the scores of one chunk, (B, KV, H/KV, q_chunk, Sk) in fp32,
    are all that is held."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]                     # may differ from hd (MLA)
    groups = H // KV
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(Sk, device=q.device)[None, :]

    def attend(qc, off):
        C = qc.shape[1]
        qg = qc.reshape(B, C, KV, groups, hd).to(torch.float32)
        s = torch.einsum("bckgh,bskh->bkgcs", qg, kf) * scale
        qpos = off + torch.arange(C, device=q.device)[:, None]
        mask = torch.ones((C, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgcs,bskh->bckgh", p, vf)
        return o.reshape(B, C, H, vd).to(q.dtype)

    if Sq <= q_chunk:
        return attend(q, q_offset)
    if Sq % q_chunk:
        raise ValueError(f"sdpa: {Sq} query rows are not a multiple of "
                         f"q_chunk {q_chunk}")
    return torch.cat([attend(q[:, c:c + q_chunk], q_offset + c)
                      for c in range(0, Sq, q_chunk)], dim=1)


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
def gqa_forward(p, cfg: ModelConfig, x, positions, *, causal: bool = True):
    """Self-attention, causal unless an encoder asks otherwise.  x: (B, S,
    d), positions: (B, S) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = kops.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return dense(p["wo"], o.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim))


def cross_attn_forward(p, cfg: ModelConfig, x, enc_out, q_chunk: int = 2048):
    """Decoder queries against the encoder's output: no RoPE, no mask.
    x: (B, S, d), enc_out: (B, Se, d) -> (B, S, d)."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    hd = cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = dense(p["wk"], enc_out).reshape(B, Se, cfg.num_kv_heads, hd)
    v = dense(p["wv"], enc_out).reshape(B, Se, cfg.num_kv_heads, hd)
    o = sdpa(q, k, v, causal=False, window=None, q_offset=0,
             scale=1.0 / math.sqrt(hd), q_chunk=q_chunk)
    return dense(p["wo"], o.reshape(B, S, cfg.num_heads * hd))


# ---------------------------------------------------------------------------
# GQA decode (1 token against the ring-buffer cache)
# ---------------------------------------------------------------------------
def use_seq_sharded_cache(cfg: ModelConfig, cache_len: int, batch: int
                          ) -> Optional[dist.MeshContext]:
    """The installed context when the cache is sequence-sharded: the KV
    heads do not divide the model axis (head sharding impossible), the
    ring's slots do and the global batch shards over the batch axes or is
    1 (``repro/models/attention.py:168-180``)."""
    ctx = dist.get_mesh_context()
    if ctx is None:
        return None
    ms = ctx.model_size
    if cfg.num_kv_heads % ms == 0:       # head sharding works — keep it
        return None
    if cache_len % ms != 0:
        return None
    if batch % ctx.batch_size != 0 and batch != 1:
        return None
    return ctx


def gqa_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                   device) -> KVCache:
    """``batch`` is the global batch: under a ``dist.MeshContext`` the cache
    holds this rank's rows (``dist.local_batch``) and, where
    ``use_seq_sharded_cache`` takes it, its 1/ms of the ring's slots."""
    hd = cfg.resolved_head_dim
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    ctx = use_seq_sharded_cache(cfg, S, batch)
    shard, S_loc = None, S
    if ctx is not None:
        S_loc = S // ctx.model_size
        shard = SeqShard(dist.axis_index(ctx, ctx.model_axis) * S_loc, S)
    shape = (dist.local_batch(dist.get_mesh_context(), batch), S_loc,
             cfg.num_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0,
                   shard=shard)


def ring_valid(pos: int, S: int, window: Optional[int], device,
               start: int = 0, count: Optional[int] = None) -> torch.Tensor:
    """(count,) bool, count = S by default: which of ring slots start ..
    start + count - 1 hold a token the query at absolute position ``pos``
    may attend to, once ``pos`` is written to slot ``pos % S``
    (``attention.py:277-291`` of the JAX package; a rank's slice of a
    sequence-sharded ring as its body computes it, ``:210-216``)."""
    slot = pos % S
    kpos = start + torch.arange(S if count is None else count, device=device)
    # absolute position currently stored in each slot of the ring buffer
    abs_pos = torch.where(kpos <= slot, pos - slot + kpos, pos - slot - S + kpos)
    valid = abs_pos >= 0
    if window:
        valid &= abs_pos > pos - window
    return valid


def cache_valid(cache: KVCache, window: Optional[int],
                device) -> torch.Tensor:
    """``ring_valid`` for the slots ``cache`` holds (its k is (..., S_loc,
    KV, hd), stacked or not): all of the ring, or this rank's slice."""
    n = cache.k.shape[-3]
    if cache.shard is None:
        return ring_valid(cache.length, n, window, device)
    return ring_valid(cache.length, cache.shard.slots, window, device,
                      start=cache.shard.start, count=n)


def combine_partials(ctx: dist.MeshContext, m, l, o):
    """The ranks' (m, l, o) of ``decode_attention_partial`` combined over
    the model axis: o = Σ e^(m - M) o / max(Σ e^(m - M) l, 1e-30), M the
    max over the ranks.  JAX's body subtracts M before its sums; here each
    rank's sums are rescaled by e^(m - M), the same function."""
    m_glob = dist.pmax(m, ctx.model_axis)
    alpha = torch.exp(m - m_glob)
    l_glob = dist.psum(l * alpha, ctx.model_axis)
    o_glob = dist.psum(o * alpha[..., None], ctx.model_axis)
    return o_glob / torch.clamp_min(l_glob, 1e-30)[..., None]


def gqa_decode(p, cfg: ModelConfig, x, cache: KVCache, valid: torch.Tensor):
    """x: (B, 1, d).  Returns (out, cache advanced by one token).

    The new k/v are written into ``cache.k``/``cache.v`` in place (the JAX
    package returns updated copies): a full-width cache is rewritten one
    slot per step, not copied.  ``valid`` is ``cache_valid(cache, ...)``,
    which ``transformer.decode_step`` computes once for all layers.  A
    sequence-sharded cache (``cache.shard``) takes the distributed combine
    under its mesh context."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache.length
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, posb)
    scale = 1.0 / math.sqrt(hd)
    if cache.shard is None:
        slot = pos % cache.k.shape[1]                     # ring-buffer slot
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        o = kops.decode_attention(q, cache.k, cache.v, valid, scale=scale)
    else:
        # PERF (§Perf A of the JAX package): seq-sharded cache + distributed
        # flash combine, where the KV heads do not divide the model axis
        ctx = use_seq_sharded_cache(cfg, cache.shard.slots, 1)
        if ctx is None:
            raise RuntimeError("a sequence-sharded cache needs the mesh "
                               "context it was made under")
        off = pos % cache.shard.slots - cache.shard.start
        if 0 <= off < cache.k.shape[1]:                   # this rank's slot
            cache.k[:, off] = k[:, 0]
            cache.v[:, off] = v[:, 0]
        m, l, o = kops.decode_attention_partial(q, cache.k, cache.v, valid,
                                                scale=scale)
        o = combine_partials(ctx, m, l, o).reshape(q.shape).to(q.dtype)
    out = dense(p["wo"], o.reshape(B, 1, cfg.num_heads * hd))
    return out, cache._replace(length=pos + 1)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
def _mla_project_q(p, cfg: ModelConfig, x, B: int, S: int):
    q = dense(p["q_down"], x)
    q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    qh = cfg.mla_nope_head_dim + cfg.mla_rope_head_dim
    q = dense(p["q_up"], q).reshape(B, S, cfg.num_heads, qh)
    return torch.split(q, [cfg.mla_nope_head_dim, cfg.mla_rope_head_dim],
                       dim=-1)                                  # nope, rope


def _mla_project_kv(p, cfg: ModelConfig, x, positions):
    """(c_kv normed (B, S, lora), k_rope roped (B, S, 1, rope_hd)): one
    rope head, shared by every query head."""
    kv = dense(p["kv_down"], x)
    c_kv, k_rope = torch.split(kv, [cfg.mla_kv_lora_rank,
                                    cfg.mla_rope_head_dim], dim=-1)
    c_kv = rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps)
    return c_kv, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def mla_forward(p, cfg: ModelConfig, x, positions, q_chunk: int = 2048):
    """Prefill / score MLA: expand the latent, run ``sdpa`` with a query
    head dim of nope + rope and a value head dim of ``mla_v_head_dim``."""
    B, S, _ = x.shape
    nh, nd, rd, vd = (cfg.num_heads, cfg.mla_nope_head_dim,
                      cfg.mla_rope_head_dim, cfg.mla_v_head_dim)
    q_nope, q_rope = _mla_project_q(p, cfg, x, B, S)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_project_kv(p, cfg, x, positions)
    kvu = dense(p["kv_up"], c_kv).reshape(B, S, nh, nd + vd)
    k_nope, v = torch.split(kvu, [nd, vd], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, nh, rd)], dim=-1)
    o = sdpa(q, k, v, causal=True, window=cfg.sliding_window, q_offset=0,
             scale=1.0 / math.sqrt(nd + rd), q_chunk=q_chunk)
    return dense(p["wo"], o.reshape(B, S, nh * vd))


def mla_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                   device) -> KVCache:
    batch = dist.local_batch(dist.get_mesh_context(), batch)
    return KVCache(
        k=torch.zeros((batch, seq_len, cfg.mla_kv_lora_rank), dtype=dtype,
                      device=device),                          # c_kv
        v=torch.zeros((batch, seq_len, cfg.mla_rope_head_dim), dtype=dtype,
                      device=device),                          # k_rope
        length=0)


def mla_decode(p, cfg: ModelConfig, x, cache: KVCache):
    """Absorbed MLA decode: scores in the latent space, the cache never
    expanded, in fp32.  x: (B, 1, d).  Returns (out, cache advanced by one
    token), c_kv and k_rope written at ``cache.length`` in place.  The
    cache is no ring: a token past its end raises (the JAX package's
    ``dynamic_update_slice`` would clamp the write to the last slot)."""
    B = x.shape[0]
    nh, nd, rd, vd = (cfg.num_heads, cfg.mla_nope_head_dim,
                      cfg.mla_rope_head_dim, cfg.mla_v_head_dim)
    lora = cfg.mla_kv_lora_rank
    pos, S = cache.length, cache.k.shape[1]
    if pos >= S:
        raise ValueError(f"mla_decode: token {pos} past the end of a "
                         f"{S}-slot MLA cache (no ring)")
    q_nope, q_rope = _mla_project_q(p, cfg, x, B, 1)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)           # (B,1,H,rd)
    c_kv, k_rope = _mla_project_kv(p, cfg, x, posb)
    cache.k[:, pos] = c_kv[:, 0]
    cache.v[:, pos] = k_rope[:, 0, 0]
    ck, cr = cache.k.to(torch.float32), cache.v.to(torch.float32)
    # absorb kv_up into the query:  q_c[h] = W_uk[h]^T q_nope[h]
    w_kv = p["kv_up"]["w"].reshape(lora, nh, nd + vd).to(torch.float32)
    w_uk, w_uv = w_kv[:, :, :nd], w_kv[:, :, nd:]
    q_c = torch.einsum("bhn,lhn->bhl", q_nope[:, 0].to(torch.float32), w_uk)
    s = torch.einsum("bhl,bsl->bhs", q_c, ck)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(torch.float32), cr)
    s = s / math.sqrt(nd + rd)
    kpos = torch.arange(S, device=x.device)
    s = torch.where(kpos <= pos, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", w, ck)                  # (B,H,lora)
    o = torch.einsum("bhl,lhv->bhv", o_lat, w_uv)                # (B,H,vd)
    out = dense(p["wo"], o.reshape(B, 1, nh * vd).to(x.dtype))
    return out, KVCache(k=cache.k, v=cache.v, length=pos + 1)
