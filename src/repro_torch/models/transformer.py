"""The homogeneous decoder stack of ``repro/models/transformer.py``: dense
GQA attention blocks with a SwiGLU/GeGLU/GELU FFN, RoPE, optional qk-norm
and sliding window, tied or separate LM head.

Layer params and decode caches stay stacked with a leading L dimension, as
the JAX package's ``vmap``/``scan`` layout has them, so JAX params carry
across leaf for leaf (``convert.params_from_jax``); the port loops over the
layers in Python.

API (as the JAX package's):
  init_params(cfg, seed, device)                    -> params
  hidden_states(params, cfg, batch)                 -> ((B,S,d), aux)
  forward(params, cfg, batch)                       -> (loss, metrics)
  init_decode_state(params, cfg, batch, cache_len)  -> state
  decode_step(params, cfg, state, tokens (B,1))     -> (logits (B,V) fp32, state)

MoE, MLA, encoder-decoder, the VLM frontend and ``block_pattern`` archs are
not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import embed_init, rmsnorm, rmsnorm_init
from repro_torch.models.loss import chunked_cross_entropy
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    for flag, what in ((cfg.block_pattern is not None, "block_pattern stacks"),
                       (cfg.moe, "MoE"), (cfg.mla, "MLA"),
                       (cfg.encoder_decoder, "encoder-decoder"),
                       (cfg.vision_frontend, "the VLM frontend"),
                       (cfg.first_k_dense > 0, "first_k_dense layers")):
        if flag:
            raise NotImplementedError(f"{cfg.name}: {what} not ported yet")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------
def block_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    return {"ln1": rmsnorm_init(d, dtype, gen.device),
            "attn": attn.attn_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(d, dtype, gen.device),
            "ffn": ffn_mod.ffn_init(gen, cfg, dtype)}


def block_forward(p, cfg: ModelConfig, x, positions):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], cfg, h, positions)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn_mod.ffn_forward(p["ffn"], cfg, h2)


def block_decode(p, cfg: ModelConfig, x, cache: attn.KVCache,
                 valid: torch.Tensor):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, cache = attn.gqa_decode(p["attn"], cfg, h, cache, valid)
    x = x + a
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn_mod.ffn_forward(p["ffn"], cfg, h2), cache


def _layer(stacked, i: int):
    return tree_map(lambda t: t[i], stacked)


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
    layers = [block_init(gen, cfg, dtype) for _ in range(cfg.num_layers)]
    params["layers"] = tree_map(lambda *ls: torch.stack(ls), *layers)
    return params


# ---------------------------------------------------------------------------
# Forward (prefill / score)
# ---------------------------------------------------------------------------
def lm_head_w(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].T
    return params["lm_head"]["embedding"].T


def hidden_states(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Backbone forward.  batch["tokens"]: (B, S) int.  Returns
    ((B, S, d) after the final norm, aux loss), aux being 0 for the
    ported (dense) stacks."""
    check_ported(cfg)
    x = params["embed"]["embedding"][batch["tokens"]]
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    for i in range(cfg.num_layers):
        x = block_forward(_layer(params["layers"], i), cfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            loss_chunk: int = 512):
    """Next-token LM loss.  batch["labels"]: (B, S) int, negatives masked."""
    h, aux = hidden_states(params, cfg, batch)
    loss, cnt = chunked_cross_entropy(h, lm_head_w(params, cfg),
                                      batch["labels"], chunk=loss_chunk)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux, "target_tokens": cnt}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_decode_state(params, cfg: ModelConfig, batch: int, cache_len: int):
    """{"layers": KVCache with (L, B, S_cache, KV, hd) k/v and length 0}."""
    check_ported(cfg)
    dev = params["embed"]["embedding"].device
    one = attn.gqa_init_cache(cfg, batch, cache_len, torch_dtype(cfg), dev)
    L = cfg.num_layers
    return {"layers": attn.KVCache(k=one.k.new_zeros((L, *one.k.shape)),
                                   v=one.v.new_zeros((L, *one.v.shape)),
                                   length=0)}


def decode_step(params, cfg: ModelConfig, state, tokens):
    """tokens: (B, 1) int -> (logits (B, V) fp32, state advanced by one
    token).  The caches in ``state`` are updated in place."""
    x = params["embed"]["embedding"][tokens]
    cache = state["layers"]
    S = cache.k.shape[2]
    valid = attn.ring_valid(cache.length, S, cfg.sliding_window, x.device)
    for i in range(cfg.num_layers):
        layer_cache = attn.KVCache(cache.k[i], cache.v[i], cache.length)
        x, _ = block_decode(_layer(params["layers"], i), cfg, x, layer_cache,
                            valid)
    state = dict(state, layers=attn.KVCache(cache.k, cache.v, cache.length + 1))
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = (h[:, 0] @ lm_head_w(params, cfg)).to(torch.float32)
    return logits, state
