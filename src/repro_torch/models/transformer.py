"""The stacks of ``repro/models/transformer.py``, every architecture of
the JAX zoo:

  * the homogeneous stack: attention blocks (GQA with RoPE, optional
    qk-norm, attention bias and sliding window, or MLA) with a
    SwiGLU/GeGLU/GELU FFN or an MoE block (``models/moe.py``), tied or
    separate LM head (qwen3-1.7b, codeqwen1.5-7b, starcoder2-7b, gemma-7b,
    paper-vit-b16, which the JAX zoo also runs as a causal LM,
    mixtral-8x22b, deepseek-v2-236b).  deepseek's first ``first_k_dense``
    layers keep a dense FFN, under ``params["dense_layer_{i}"]`` ahead of
    the stack.  Layer params and decode caches stay stacked with a leading
    L dimension, as the JAX package's ``vmap``/``scan`` layout has them, so
    JAX params carry across leaf for leaf (``convert.params_from_jax``);
    the port loops over the layers in Python;
  * the encoder-decoder (seamless-m4t-large-v2): a non-causal encoder
    stack (``enc_layers``, ``enc_norm``) over the frame embeddings
    ``batch["encoder_embeds"]``, and decoder blocks with cross-attention
    to its output;
  * the VLM prefix (llava-next-mistral-7b): ``batch["image_embeds"]``
    prepended to the token embeddings, positions counted over both;
  * the ``block_pattern`` (hybrid) stacks of zamba2 and xlstm-125m: Mamba2
    (``models/ssm.py``), mLSTM and sLSTM (``models/xlstm.py``) blocks
    under ``params["blocks"][str(i)]`` and one
    ``params["shared_attn_block"]`` reused at every SHARED_ATTN position,
    each position with its own KV cache.

API (as the JAX package's):
  init_params(cfg, seed, device)                              -> params
  hidden_states(params, cfg, batch, remat, q_chunk)           -> ((B,S,d), aux)
  forward(params, cfg, batch, loss_chunk, remat, q_chunk)     -> (loss, metrics)
  init_decode_state(params, cfg, batch, cache_len, encoder_embeds) -> state
  decode_step(params, cfg, state, tokens (B,1))     -> (logits (B,V) fp32, state)
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, MAMBA2, MLSTM, SHARED_ATTN,
                                      SLSTM, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import dist
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import (embed_init, make_generator, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.loss import chunked_cross_entropy
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict[str, Any]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


HYBRID_KINDS = (MAMBA2, MLSTM, SLSTM, SHARED_ATTN)


class _Recurrent(NamedTuple):
    """A recurrent block kind: its params key, init, forward, one-token
    step and decode cache, ``init_cache(cfg, batch, dtype, device)``."""
    key: str
    init: Callable
    forward: Callable
    decode: Callable
    init_cache: Callable


_RECURRENT = {
    MAMBA2: _Recurrent("mamba", ssm.mamba2_init, ssm.mamba2_forward,
                       ssm.mamba2_decode, ssm.mamba2_init_cache),
    # the xLSTM caches are fp32 whatever the model's dtype
    MLSTM: _Recurrent("mlstm", xlstm.mlstm_init, xlstm.mlstm_forward,
                      xlstm.mlstm_decode, lambda cfg, b, _, dev:
                      xlstm.mlstm_init_cache(cfg, b, dev)),
    SLSTM: _Recurrent("slstm", xlstm.slstm_init, xlstm.slstm_forward,
                      xlstm.slstm_decode, lambda cfg, b, _, dev:
                      xlstm.slstm_init_cache(cfg, b, dev)),
}


def check_ported(cfg: ModelConfig) -> None:
    kinds = set(cfg.block_pattern or ()) - set(HYBRID_KINDS)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block_pattern kinds {sorted(kinds)} not ported yet")


def _layer_uses_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe and layer_idx >= cfg.first_k_dense


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------
def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype, *,
               use_moe: bool = False, cross: bool = False):
    d = cfg.d_model
    if kind in (ATTN, SHARED_ATTN):
        p = {"ln1": rmsnorm_init(d, dtype, gen.device),
             "attn": attn.attn_init(gen, cfg, dtype),
             "ln2": rmsnorm_init(d, dtype, gen.device)}
        if use_moe:
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype)
        else:
            p["ffn"] = ffn_mod.ffn_init(gen, cfg, dtype)
        if cross:
            p["ln_cross"] = rmsnorm_init(d, dtype, gen.device)
            p["cross"] = attn.cross_attn_init(gen, cfg, dtype)
        return p
    if kind in _RECURRENT:
        r = _RECURRENT[kind]
        return {"ln1": rmsnorm_init(d, dtype, gen.device),
                r.key: r.init(gen, cfg, dtype)}
    raise ValueError(kind)


def _ffn_or_moe(p, cfg: ModelConfig, h):
    """(the block's FFN or MoE output, the MoE's aux loss or None)."""
    if "moe" in p:
        return moe_mod.moe_forward(p["moe"], cfg, h)
    return ffn_mod.ffn_forward(p["ffn"], cfg, h), None


def block_forward(p, cfg: ModelConfig, kind: str, x, positions, *,
                  enc_out=None, causal: bool = True, q_chunk: int = 2048):
    """Returns (x, aux loss or None): an MoE block's scaled aux loss, None
    for every other block (the JAX package returns a zero there)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        r = _RECURRENT[kind]
        return x + r.forward(p[r.key], cfg, h), None
    if cfg.mla:
        a = attn.mla_forward(p["attn"], cfg, h, positions, q_chunk=q_chunk)
    else:
        a = attn.gqa_forward(p["attn"], cfg, h, positions, causal=causal)
    x = x + a
    if "cross" in p:
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn.cross_attn_forward(p["cross"], cfg, hc, enc_out,
                                        q_chunk=q_chunk)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    f, aux = _ffn_or_moe(p, cfg, h2)
    return x + f, aux


def block_decode(p, cfg: ModelConfig, kind: str, x, cache,
                 valid: Optional[torch.Tensor], *, enc_out=None):
    """``valid``: the ring slots a GQA block may read (unused by MLA, whose
    cache is no ring, and by the recurrent blocks).  An MoE block's aux
    loss is dropped, as in the JAX package."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        r = _RECURRENT[kind]
        y, cache = r.decode(p[r.key], cfg, h, cache)
        return x + y, cache
    if cfg.mla:
        a, cache = attn.mla_decode(p["attn"], cfg, h, cache)
    else:
        a, cache = attn.gqa_decode(p["attn"], cfg, h, cache, valid)
    x = x + a
    if "cross" in p:
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn.cross_attn_forward(p["cross"], cfg, hc, enc_out)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn_or_moe(p, cfg, h2)[0], cache


def _layer(stacked, i: int):
    return tree_map(lambda t: t[i], stacked)


def _unstack(stacked, n: int):
    """The n layers of a stacked (L, ...) tree, each leaf unbound once: under
    autograd each leaf's gradient is then stacked once, where n selects
    ``t[i]`` would each add a full-size (L, ...) zero gradient."""
    leaves, spec = tree_flatten(stacked)
    per_leaf = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(spec, [u[i] for u in per_leaf]) for i in range(n)]


def _run_block(remat: bool, p, cfg, kind, x, positions, **kw):
    """``block_forward``, recomputed in the backward when ``remat`` and a
    gradient is being taken."""
    if remat and torch.is_grad_enabled():
        return checkpoint(functools.partial(block_forward, **kw), p, cfg,
                          kind, x, positions, use_reentrant=False)
    return block_forward(p, cfg, kind, x, positions, **kw)


def _add_aux(total, a):
    return total if a is None else (a if total is None else total + a)


def n_stacked(cfg: ModelConfig) -> int:
    """Layers in the homogeneous stack: those after the dense ones."""
    return cfg.num_layers - cfg.first_k_dense


def _block_params(params, kind: str, i: int):
    """A hybrid stack's layer i: the shared block at SHARED_ATTN positions."""
    return params["shared_attn_block"] if kind == SHARED_ATTN \
        else params["blocks"][str(i)]


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------
def _stacked_init(n: int, make: Callable[[], Params]) -> Params:
    """n layers of ``make()`` stacked leaf by leaf into (n, ...) tensors,
    each layer copied in as it is drawn: the peak holds the stack and one
    layer, not a list of all of them beside it."""
    first = make()
    leaves, spec = tree_flatten(first)
    stacked = [t.new_empty((n, *t.shape)) for t in leaves]
    for i in range(n):
        for dst, src in zip(stacked, leaves if i == 0 else
                            tree_flatten(make())[0]):
            dst[i] = src
    return tree_unflatten(spec, stacked)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random init drawn on ``device`` from a generator seeded with ``seed``
    (a full-width normal draw on the host would take minutes).  The draws
    are not the JAX package's; tests carry JAX params across with
    ``convert.params_from_jax`` instead.  ``device="meta"`` gives the
    shapes and dtypes alone (the dry-run plan)."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = make_generator(dev, seed)
    dtype = torch_dtype(cfg)
    params: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
                      "final_norm": rmsnorm_init(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    if cfg.block_pattern is None:
        cross = cfg.encoder_decoder
        for i in range(cfg.first_k_dense):
            params[f"dense_layer_{i}"] = block_init(gen, cfg, ATTN, dtype,
                                                    cross=cross)
        params["layers"] = _stacked_init(n_stacked(cfg), lambda: block_init(
            gen, cfg, ATTN, dtype, use_moe=cfg.moe, cross=cross))
        if cfg.encoder_decoder:
            params["enc_layers"] = _stacked_init(
                cfg.num_encoder_layers, lambda: block_init(gen, cfg, ATTN, dtype))
            params["enc_norm"] = rmsnorm_init(cfg.d_model, dtype, dev)
        return params
    blocks = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind != SHARED_ATTN:
            blocks[str(i)] = block_init(gen, cfg, kind, dtype,
                                        use_moe=_layer_uses_moe(cfg, i))
        elif "shared_attn_block" not in params:
            params["shared_attn_block"] = block_init(gen, cfg, kind, dtype)
    params["blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# Forward (prefill / score)
# ---------------------------------------------------------------------------
def embed_tokens(params, cfg: ModelConfig, tokens):
    """The token embeddings; gemma's are scaled by sqrt(d_model), rounded
    to the embeddings' dtype first, as ``repro/models/transformer.py``
    ``_embed_tokens`` does (keyed on the config's name there too)."""
    x = params["embed"]["embedding"][tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_head_w(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].T
    return params["lm_head"]["embedding"].T


def encode(params, cfg: ModelConfig, encoder_embeds, *, remat: bool = True,
           q_chunk: int = 2048):
    """The enc-dec encoder: (B, Se, d) frame embeddings through
    ``enc_layers`` (non-causal ``flash_attention``) and ``enc_norm``."""
    e = encoder_embeds.to(torch_dtype(cfg))
    Be, Se, _ = e.shape
    epos = torch.arange(Se, dtype=torch.int32, device=e.device).expand(Be, Se)
    for p in _unstack(params["enc_layers"], cfg.num_encoder_layers):
        e, _ = _run_block(remat, p, cfg, ATTN, e, epos, causal=False,
                          q_chunk=q_chunk)
    return rmsnorm(params["enc_norm"], e, cfg.norm_eps)


def hidden_states(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  remat: bool = True, q_chunk: int = 2048):
    """Backbone forward.  batch: "tokens" (B, St) int; "image_embeds" (B,
    Ni, d) for a VLM, prepended to the tokens' embeddings; "encoder_embeds"
    (B, Se, d) for the enc-dec.  Returns ((B, Ni + St, d) after the final
    norm, aux loss): the MoE blocks' summed aux loss, 0 without MoE.
    ``remat``: under autograd each layer keeps only its input and is
    recomputed in the backward, as the JAX package's per-layer
    ``jax.checkpoint`` of its scanned stack (no effect without a gradient).
    The JAX package's hybrid loop has no checkpoint; the port's does, since
    an mLSTM block's time loop keeps its carry at every step
    (``models/xlstm.py``).  ``q_chunk``: the query rows a chunk of the
    plain attention (``attention.sdpa``: MLA, cross-attention) takes."""
    check_ported(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.vision_frontend and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux = None
    if cfg.block_pattern is None:
        kw = dict(q_chunk=q_chunk)
        if cfg.encoder_decoder:
            kw["enc_out"] = encode(params, cfg, batch["encoder_embeds"],
                                   remat=remat, q_chunk=q_chunk)
        for i in range(cfg.first_k_dense):
            x, a = _run_block(remat, params[f"dense_layer_{i}"], cfg, ATTN,
                              x, positions, **kw)
            aux = _add_aux(aux, a)
        for p in _unstack(params["layers"], n_stacked(cfg)):
            x, a = _run_block(remat, p, cfg, ATTN, x, positions, **kw)
            aux = _add_aux(aux, a)
    else:
        for i, kind in enumerate(cfg.layer_kinds()):
            x, a = _run_block(remat, _block_params(params, kind, i), cfg, kind,
                              x, positions, q_chunk=q_chunk)
            aux = _add_aux(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            loss_chunk: int = 512, remat: bool = True, q_chunk: int = 2048):
    """Next-token LM loss plus the MoE aux loss.  batch["labels"]: (B,
    Ni + St) int, negatives masked (a VLM's image positions among them).
    metrics: "ce_loss" (the LM loss alone), "aux_loss", "target_tokens"."""
    h, aux = hidden_states(params, cfg, batch, remat=remat, q_chunk=q_chunk)
    loss, cnt = chunked_cross_entropy(h, lm_head_w(params, cfg),
                                      batch["labels"], chunk=loss_chunk)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux, "target_tokens": cnt}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_decode_state(params, cfg: ModelConfig, batch: int, cache_len: int,
                      encoder_embeds: Optional[torch.Tensor] = None):
    """Homogeneous: {"layers": KVCache with stacked (L, ...) k/v and length
    0, "dense_layer_{i}": its own KVCache for each of the first
    ``first_k_dense`` layers}; a GQA cache is (B, S_cache, KV, hd) (the
    ring), an MLA cache c_kv (B, cache_len, lora) and k_rope (B,
    cache_len, rope_hd) (no ring).  The enc-dec adds "enc_out", the
    encoder's output over ``encoder_embeds`` (B, Se, d), computed once here.
    Hybrid: {"blocks": {str(i): MambaCache, MLSTMCache, SLSTMCache or
    KVCache}}, one cache for every layer, the shared-attention positions
    included.

    ``batch`` and ``cache_len`` are global, as in the JAX package.  Under a
    ``dist.MeshContext`` each cache holds this rank's batch rows
    (``dist.local_batch``), and a GQA ring whose KV heads do not divide the
    model axis holds this rank's 1/ms of its slots (``KVCache.shard``:
    ``attention.use_seq_sharded_cache``); ``decode_step`` then takes this
    rank's tokens.

    ``decode_step`` writes each new k/v into these caches in place
    (``attention.gqa_decode``, ``attention.mla_decode``), so a caller that
    decodes more than once from a saved state (rollback, beam search) must
    copy the state first."""
    check_ported(cfg)
    dev = params["embed"]["embedding"].device
    dtype = torch_dtype(cfg)
    if cfg.block_pattern is not None:
        def block_cache(kind):
            if kind in _RECURRENT:
                return _RECURRENT[kind].init_cache(
                    cfg, dist.local_batch(dist.get_mesh_context(), batch),
                    dtype, dev)
            return attn.gqa_init_cache(cfg, batch, cache_len, dtype, dev)
        return {"blocks": {str(i): block_cache(kind)
                           for i, kind in enumerate(cfg.layer_kinds())}}

    def attn_cache():
        init = attn.mla_init_cache if cfg.mla else attn.gqa_init_cache
        return init(cfg, batch, cache_len, dtype, dev)

    one, L = attn_cache(), n_stacked(cfg)
    state: Dict[str, Any] = {"layers": attn.KVCache(
        k=one.k.new_zeros((L, *one.k.shape)),
        v=one.v.new_zeros((L, *one.v.shape)), length=0, shard=one.shard)}
    for i in range(cfg.first_k_dense):
        state[f"dense_layer_{i}"] = attn_cache()
    if cfg.encoder_decoder:
        if encoder_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             "encoder_embeds")
        state["enc_out"] = encode(params, cfg, encoder_embeds, remat=False)
    return state


def decode_step(params, cfg: ModelConfig, state, tokens):
    """tokens: (B, 1) int -> (logits (B, V) fp32, state advanced by one
    token).  The KV caches in ``state`` are updated in place; a recurrent
    block's cache is replaced.  The enc-dec's cross-attention recomputes
    its K/V from ``state["enc_out"]`` every step, as the JAX package does."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.block_pattern is not None:
        blocks, valid = dict(state["blocks"]), None
        for i, kind in enumerate(cfg.layer_kinds()):
            c = blocks[str(i)]
            if kind == SHARED_ATTN and valid is None:   # one length for all
                valid = attn.cache_valid(c, cfg.sliding_window, x.device)
            x, blocks[str(i)] = block_decode(_block_params(params, kind, i),
                                             cfg, kind, x, c, valid)
        state = dict(state, blocks=blocks)
    else:
        cache, enc_out = state["layers"], state.get("enc_out")
        # MLA masks by position in its own cache; GQA reads the ring's slots
        valid = None if cfg.mla else attn.cache_valid(
            cache, cfg.sliding_window, x.device)
        state = dict(state)
        for i in range(cfg.first_k_dense):
            x, state[f"dense_layer_{i}"] = block_decode(
                params[f"dense_layer_{i}"], cfg, ATTN, x,
                state[f"dense_layer_{i}"], valid, enc_out=enc_out)
        for i in range(n_stacked(cfg)):
            layer_cache = attn.KVCache(cache.k[i], cache.v[i], cache.length,
                                       cache.shard)
            x, _ = block_decode(_layer(params["layers"], i), cfg, ATTN, x,
                                layer_cache, valid, enc_out=enc_out)
        state["layers"] = cache._replace(length=cache.length + 1)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (h[:, 0] @ lm_head_w(params, cfg)).to(torch.float32)
    return logits, state
