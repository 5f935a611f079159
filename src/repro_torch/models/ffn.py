"""Feed-forward variants of ``repro/models/ffn.py``: SwiGLU / GeGLU (gated)
and the plain GELU MLP with bias."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, dense_init, gelu


def ffn_init(gen: torch.Generator, cfg: ModelConfig, dtype, d_ff=None):
    d_ff = d_ff or cfg.d_ff
    if cfg.ffn_activation in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, cfg.d_model, d_ff, dtype),
            "w_up": dense_init(gen, cfg.d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, cfg.d_model, dtype),
        }
    return {  # plain MLP (starcoder2 / seamless style, with bias)
        "w_up": dense_init(gen, cfg.d_model, d_ff, dtype, bias=True),
        "w_down": dense_init(gen, d_ff, cfg.d_model, dtype, bias=True),
    }


def ffn_forward(p, cfg: ModelConfig, x):
    if cfg.ffn_activation in ("swiglu", "geglu"):
        g = dense(p["w_gate"], x)
        u = dense(p["w_up"], x)
        act = torch.nn.functional.silu(g) if cfg.ffn_activation == "swiglu" \
            else gelu(g)
        return dense(p["w_down"], act * u)
    return dense(p["w_down"], gelu(dense(p["w_up"], x)))
