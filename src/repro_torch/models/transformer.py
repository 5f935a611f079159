"""The decoder stacks of ``repro/models/transformer.py`` that the port has:

  * the homogeneous stack: dense GQA attention blocks with a
    SwiGLU/GeGLU/GELU FFN, RoPE, optional qk-norm, attention bias and
    sliding window, tied or separate LM head (qwen3-1.7b, codeqwen1.5-7b,
    starcoder2-7b, gemma-7b at head dim 256, and paper-vit-b16, which the
    JAX zoo also runs as a causal LM).  Layer params and decode caches
    stay stacked with a leading L dimension, as the JAX package's
    ``vmap``/``scan`` layout has them, so JAX params carry across leaf for
    leaf (``convert.params_from_jax``); the port loops over the layers in
    Python;
  * the ``block_pattern`` (hybrid) stacks of zamba2 and xlstm-125m: Mamba2
    (``models/ssm.py``), mLSTM and sLSTM (``models/xlstm.py``) blocks
    under ``params["blocks"][str(i)]`` and one
    ``params["shared_attn_block"]`` reused at every SHARED_ATTN position,
    each position with its own KV cache.

API (as the JAX package's):
  init_params(cfg, seed, device)                    -> params
  hidden_states(params, cfg, batch, remat)          -> ((B,S,d), aux)
  forward(params, cfg, batch, loss_chunk, remat)    -> (loss, metrics)
  init_decode_state(params, cfg, batch, cache_len)  -> state
  decode_step(params, cfg, state, tokens (B,1))     -> (logits (B,V) fp32, state)

MoE, MLA, encoder-decoder and the VLM frontend are not ported yet and
raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, MAMBA2, MLSTM, SHARED_ATTN,
                                      SLSTM, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import embed_init, rmsnorm, rmsnorm_init
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
    for flag, what in ((bool(kinds), f"block_pattern kinds {sorted(kinds)}"),
                       (cfg.moe, "MoE"), (cfg.mla, "MLA"),
                       (cfg.encoder_decoder, "encoder-decoder"),
                       (cfg.vision_frontend, "the VLM frontend"),
                       (cfg.first_k_dense > 0, "first_k_dense layers")):
        if flag:
            raise NotImplementedError(f"{cfg.name}: {what} not ported yet")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------
def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype):
    d = cfg.d_model
    if kind in (ATTN, SHARED_ATTN):
        return {"ln1": rmsnorm_init(d, dtype, gen.device),
                "attn": attn.attn_init(gen, cfg, dtype),
                "ln2": rmsnorm_init(d, dtype, gen.device),
                "ffn": ffn_mod.ffn_init(gen, cfg, dtype)}
    if kind in _RECURRENT:
        r = _RECURRENT[kind]
        return {"ln1": rmsnorm_init(d, dtype, gen.device),
                r.key: r.init(gen, cfg, dtype)}
    raise ValueError(kind)


def block_forward(p, cfg: ModelConfig, kind: str, x, positions):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        r = _RECURRENT[kind]
        return x + r.forward(p[r.key], cfg, h)
    x = x + attn.gqa_forward(p["attn"], cfg, h, positions)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn_mod.ffn_forward(p["ffn"], cfg, h2)


def block_decode(p, cfg: ModelConfig, kind: str, x, cache,
                 valid: Optional[torch.Tensor]):
    """``valid``: the ring slots an attention block may read (unused by the
    recurrent blocks)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind in _RECURRENT:
        r = _RECURRENT[kind]
        y, cache = r.decode(p[r.key], cfg, h, cache)
        return x + y, cache
    a, cache = attn.gqa_decode(p["attn"], cfg, h, cache, valid)
    x = x + a
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn_mod.ffn_forward(p["ffn"], cfg, h2), cache


def _layer(stacked, i: int):
    return tree_map(lambda t: t[i], stacked)


def _unstack(stacked, n: int):
    """The n layers of a stacked (L, ...) tree, each leaf unbound once: under
    autograd each leaf's gradient is then stacked once, where n selects
    ``t[i]`` would each add a full-size (L, ...) zero gradient."""
    leaves, spec = tree_flatten(stacked)
    per_leaf = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(spec, [u[i] for u in per_leaf]) for i in range(n)]


def _run_block(remat: bool, p, cfg, kind, x, positions):
    """``block_forward``, recomputed in the backward when ``remat`` and a
    gradient is being taken."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block_forward, p, cfg, kind, x, positions,
                          use_reentrant=False)
    return block_forward(p, cfg, kind, x, positions)


def _block_params(params, kind: str, i: int):
    """A hybrid stack's layer i: the shared block at SHARED_ATTN positions."""
    return params["shared_attn_block"] if kind == SHARED_ATTN \
        else params["blocks"][str(i)]


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random init drawn on ``device`` from a generator seeded with ``seed``
    (a full-width normal draw on the host would take minutes).  The draws
    are not the JAX package's; tests carry JAX params across with
    ``convert.params_from_jax`` instead."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    params: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
                      "final_norm": rmsnorm_init(cfg.d_model, dtype, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    if cfg.block_pattern is None:
        layers = [block_init(gen, cfg, ATTN, dtype) for _ in range(cfg.num_layers)]
        params["layers"] = tree_map(lambda *ls: torch.stack(ls), *layers)
        return params
    blocks = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind != SHARED_ATTN:
            blocks[str(i)] = block_init(gen, cfg, kind, dtype)
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


def hidden_states(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  remat: bool = True):
    """Backbone forward.  batch["tokens"]: (B, S) int.  Returns
    ((B, S, d) after the final norm, aux loss), aux being 0 for the
    ported (dense and hybrid) stacks.  ``remat``: under autograd each layer
    keeps only its input and is recomputed in the backward, as the JAX
    package's per-layer ``jax.checkpoint`` of its scanned stack (no effect
    without a gradient).  The JAX package's hybrid loop has no checkpoint;
    the port's does, since an mLSTM block's time loop keeps its carry at
    every step (``models/xlstm.py``)."""
    check_ported(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if cfg.block_pattern is None:
        for p in _unstack(params["layers"], cfg.num_layers):
            x = _run_block(remat, p, cfg, ATTN, x, positions)
    else:
        for i, kind in enumerate(cfg.layer_kinds()):
            x = _run_block(remat, _block_params(params, kind, i), cfg, kind,
                           x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            loss_chunk: int = 512, remat: bool = True):
    """Next-token LM loss.  batch["labels"]: (B, S) int, negatives masked."""
    h, aux = hidden_states(params, cfg, batch, remat=remat)
    loss, cnt = chunked_cross_entropy(h, lm_head_w(params, cfg),
                                      batch["labels"], chunk=loss_chunk)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux, "target_tokens": cnt}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_decode_state(params, cfg: ModelConfig, batch: int, cache_len: int):
    """Homogeneous: {"layers": KVCache with (L, B, S_cache, KV, hd) k/v and
    length 0}.  Hybrid: {"blocks": {str(i): MambaCache, MLSTMCache,
    SLSTMCache or KVCache}}, one cache for every layer, the
    shared-attention positions included.

    ``decode_step`` writes each new k/v into these caches in place
    (``attention.gqa_decode``), so a caller that decodes more than once
    from a saved state (rollback, beam search) must copy the state first."""
    check_ported(cfg)
    dev = params["embed"]["embedding"].device
    dtype = torch_dtype(cfg)
    if cfg.block_pattern is not None:
        def block_cache(kind):
            if kind in _RECURRENT:
                return _RECURRENT[kind].init_cache(cfg, batch, dtype, dev)
            return attn.gqa_init_cache(cfg, batch, cache_len, dtype, dev)
        return {"blocks": {str(i): block_cache(kind)
                           for i, kind in enumerate(cfg.layer_kinds())}}
    one = attn.gqa_init_cache(cfg, batch, cache_len, dtype, dev)
    L = cfg.num_layers
    return {"layers": attn.KVCache(k=one.k.new_zeros((L, *one.k.shape)),
                                   v=one.v.new_zeros((L, *one.v.shape)),
                                   length=0)}


def decode_step(params, cfg: ModelConfig, state, tokens):
    """tokens: (B, 1) int -> (logits (B, V) fp32, state advanced by one
    token).  The KV caches in ``state`` are updated in place; a recurrent
    block's cache is replaced."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.block_pattern is not None:
        blocks, valid = dict(state["blocks"]), None
        for i, kind in enumerate(cfg.layer_kinds()):
            c = blocks[str(i)]
            if kind == SHARED_ATTN and valid is None:   # one length for all
                valid = attn.ring_valid(c.length, c.k.shape[1],
                                        cfg.sliding_window, x.device)
            x, blocks[str(i)] = block_decode(_block_params(params, kind, i),
                                             cfg, kind, x, c, valid)
        state = dict(state, blocks=blocks)
    else:
        cache = state["layers"]
        S = cache.k.shape[2]
        valid = attn.ring_valid(cache.length, S, cfg.sliding_window, x.device)
        for i in range(cfg.num_layers):
            layer_cache = attn.KVCache(cache.k[i], cache.v[i], cache.length)
            x, _ = block_decode(_layer(params["layers"], i), cfg, ATTN, x,
                                layer_cache, valid)
        state = dict(state, layers=attn.KVCache(cache.k, cache.v,
                                                cache.length + 1))
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (h[:, 0] @ lm_head_w(params, cfg)).to(torch.float32)
    return logits, state
