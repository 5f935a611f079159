"""Mixture-of-Experts block of ``repro/models/moe.py``: its local path
(``_moe_local``), which the JAX package takes on one device and holds its
expert-parallel bodies against.

Routing runs in fp32: the top-k of the router's softmax, renormalized,
with the Switch-style load-balance loss.  The (token, k) pairs are sorted
by expert (a stable sort), each expert's contiguous rows go through its
gated FFN as plain matrix products (``jax.lax.ragged_dot`` in JAX, which
reaches no Pallas kernel), and each token's gated results are summed in
x's dtype in the order of JAX's scatter-add (ascending expert id), without
atomics, so the sum repeats bitwise.  The group sizes are read back to
the host once per call, so that each expert's rows are sliced and empty
experts skipped; ``readbacks["moe_group_sizes"]`` counts those reads.

The expert-parallel bodies (``_moe_sharded_body*``) run under a mesh,
which the port does not have: ``moe_forward`` always takes the local path.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import dense_init, gelu

#: host reads of the device, by kind (``reset_readbacks`` zeroes them)
readbacks: Dict[str, int] = {"moe_group_sizes": 0}


def reset_readbacks() -> None:
    for k in readbacks:
        readbacks[k] = 0


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The router (fp32, as JAX's), the (E, d, d_ff) gate and up stacks and
    the (E, d_ff, d) down stack, and the shared experts' FFN (hidden width
    ``moe_d_ff × num_shared_experts``) where the config has them.  Each
    expert is drawn on its own, so the fp32 draw never holds a whole
    stack."""
    d_ff = cfg.moe_d_ff or cfg.d_ff
    E, d = cfg.num_experts, cfg.d_model

    def experts(d_in, d_out):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=gen.device)
        for e in range(E):
            w[e] = torch.randn((d_in, d_out), generator=gen,
                               device=gen.device) * (1.0 / math.sqrt(d_in))
        return w

    p = {"router": dense_init(gen, d, E, torch.float32),
         "w_gate": experts(d, d_ff), "w_up": experts(d, d_ff),
         "w_down": experts(d_ff, d)}
    if cfg.num_shared_experts:
        p["shared"] = ffn_mod.ffn_init(gen, cfg, dtype,
                                       d_ff=d_ff * cfg.num_shared_experts)
    return p


def _activation(cfg: ModelConfig, g, u):
    act = torch.nn.functional.silu(g) if cfg.ffn_activation == "swiglu" \
        else gelu(g)
    return act * u


def _route(p, cfg: ModelConfig, x2d):
    """x2d: (T, d) -> (gates (T, k) fp32, eids (T, k) int64, aux scalar).
    On equal probabilities the lower expert id ranks first, as
    ``lax.top_k`` keeps it."""
    logits = x2d.to(torch.float32) @ p["router"]["w"]              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    top_p, eids = order.values[:, :k], order.indices[:, :k]
    gates = top_p / top_p.sum(dim=-1, keepdim=True)                # renormalize
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=0)                                         # (E,)
    fe = torch.bincount(eids.reshape(-1), minlength=E).to(torch.float32) \
        / x2d.shape[0]                                             # (E,)
    aux = E * (fe * me).sum()
    return gates, eids, aux


def _grouped_ffn(cfg: ModelConfig, x_sel, w_gate, w_up, w_down, group_sizes):
    """x_sel: (R, d) rows grouped contiguously by expert; each group through
    its expert's FFN, empty groups skipped.  One host read of the sizes.
    Each expert stack is unbound once, so that under autograd its gradient
    is stacked once (selecting w[e] per expert would add a full-size zero
    gradient per expert); each group's rows are written into their slice
    of the output, whose gradient is that slice of the output's."""
    sizes = group_sizes.tolist()
    readbacks["moe_group_sizes"] += 1
    wg, wu, wd = (torch.unbind(w) for w in (w_gate, w_up, w_down))
    y = x_sel.new_empty((x_sel.shape[0], w_down.shape[-1]))
    o = 0
    for e, n in enumerate(sizes):
        if n:
            rows = x_sel[o:o + n]
            h = _activation(cfg, rows @ wg[e], rows @ wu[e])
            y[o:o + n] = h @ wd[e]
            o += n
    return y


def _moe_local(p, cfg: ModelConfig, x2d):
    T, d = x2d.shape
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    gates, eids, aux = _route(p, cfg, x2d)
    tok = torch.arange(T, device=x2d.device).repeat_interleave(k)
    se, perm = torch.sort(eids.reshape(T * k), stable=True)
    tok_s, gate_s = tok[perm], gates.reshape(T * k)[perm]
    group_sizes = torch.bincount(se, minlength=E)
    y_sel = _grouped_ffn(cfg, x2d[tok_s], p["w_gate"], p["w_up"],
                         p["w_down"], group_sizes)
    gated = (y_sel.to(torch.float32) * gate_s[:, None]).to(x2d.dtype)
    return _combine(gated, tok_s, T, k), aux


def _combine(gated, tok_s, T: int, k: int):
    """The (T*k, d) gated rows, sorted by expert, summed per token in
    ``gated``'s dtype.  JAX's scatter-add adds the sorted rows in turn, so
    each token sums its k rows in ascending expert id, rounding after each
    add; a stable sort by token gives those rows in that order, and the sum
    runs in a fixed order on every device (no atomics)."""
    rows = gated[torch.sort(tok_s, stable=True).indices].view(T, k, -1)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def moe_forward(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss scaled by
    ``router_aux_loss_coef``).  Adds the shared experts."""
    B, S, d = x.shape
    out2d, aux = _moe_local(p, cfg, x.reshape(B * S, d))
    out = out2d.reshape(B, S, d)
    if cfg.num_shared_experts:
        out = out + ffn_mod.ffn_forward(p["shared"], cfg, x)
    return out, aux * cfg.router_aux_loss_coef
