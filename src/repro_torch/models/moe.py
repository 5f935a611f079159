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

Under a ``dist.MeshContext`` ``moe_forward`` takes JAX's sharded bodies,
chosen as JAX chooses them: each rank holds its batch shard x, replicated
over the model axis, and its own experts.  ``_moe_sharded_body`` (experts
divide the model axis) sorts the (token, k) pairs routed to its E/ms
experts to a prefix, with the sentinel E_loc for the others, keeps
``capacity`` of them, runs them (sentinel rows through the last local
expert at gate 0) and ``psum``s out over the model axis;
``_moe_sharded_body_virtual`` (the model axis a multiple of E, JAX's §Perf
B) gives each real expert's hidden dim to ms/E ranks, whose partial sums
the same ``psum`` adds.  aux is ``pmean``ed over the batch axes.  Each body
reads the group sizes back once, as the local path does; ``dropped``
counts the local pairs past ``capacity`` (the sharded result equals the
local path's only when none are).  Each token's kept rows are summed in
x's dtype in ascending expert id, in a fixed order (no atomics).  The bodies are
forward only: a gradient through the ``psum`` is a later step.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dist
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import dense_init, gelu

#: host reads of the device, by kind (``reset_readbacks`` zeroes them)
readbacks: Dict[str, int] = {"moe_group_sizes": 0}
#: (token, k) pairs a sharded body dropped past its capacity
dropped: Dict[str, int] = {"moe_pairs": 0}


def reset_readbacks() -> None:
    for k in readbacks:
        readbacks[k] = 0
    dropped["moe_pairs"] = 0


def _read_sizes(counts: torch.Tensor) -> List[int]:
    """The one host read of a call: group sizes (or counts) to a list."""
    readbacks["moe_group_sizes"] += 1
    return counts.tolist()


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
        if w.is_meta:          # shapes only: nothing to draw
            return w
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
    its expert's FFN, empty groups skipped.  ``group_sizes``: a tensor, read
    to the host here (one read), or a list already read.  Each expert stack
    is unbound once, so that under autograd its gradient is stacked once
    (selecting w[e] per expert would add a full-size zero gradient per
    expert); each group's rows are written into their slice of the output,
    whose gradient is that slice of the output's."""
    sizes = (_read_sizes(group_sizes) if isinstance(group_sizes, torch.Tensor)
             else group_sizes)
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


def _combine_kept(gated, tok_s, T: int, k: int):
    """``_combine`` for a sharded body's kept rows, of which a token has
    anywhere from 0 to k: the rows, in the same order, go into a (T, k)
    table of row indices (a row of zeros where a token has fewer), whose
    k gathers add them in a fixed order.  The rows per token are counted
    on the device (no read-back)."""
    n, d = gated.shape
    order = torch.sort(tok_s, stable=True).indices
    tok_o = tok_s[order]
    per_tok = torch.zeros(T, dtype=torch.long, device=gated.device)
    per_tok.index_add_(0, tok_o, torch.ones_like(tok_o))
    first = torch.cumsum(per_tok, 0) - per_tok
    j = torch.arange(n, device=gated.device) - first[tok_o]
    table = torch.full((T, k), n, dtype=torch.long, device=gated.device)
    table[tok_o, j] = order
    rows = torch.cat([gated, gated.new_zeros((1, d))])
    out = rows[table[:, 0]]
    for i in range(1, k):
        out = out + rows[table[:, i]]
    return out


def _pairs(p_router, cfg: ModelConfig, x2d):
    """Routing of a body: (gates (T*k,), eids (T*k,), tok (T*k,), aux)."""
    T = x2d.shape[0]
    gates, eids, aux = _route({"router": {"w": p_router}}, cfg, x2d)
    tok = torch.arange(T, device=x2d.device).repeat_interleave(
        cfg.num_experts_per_tok)
    return gates.reshape(-1), eids.reshape(-1), tok, aux


def _moe_sharded_body(x, wr, wg, wu, wd, *, cfg: ModelConfig,
                      ctx: dist.MeshContext, capacity: int):
    """One rank's expert-parallel body (``repro/models/moe.py:100-132``).
    x: (B_loc, S, d), this rank's batch shard, replicated over the model
    axis; wg/wu/wd: its (E_loc, ...) experts."""
    B, S, d = x.shape
    T, k, E_loc = B * S, cfg.num_experts_per_tok, wg.shape[0]
    midx = dist.axis_index(ctx, ctx.model_axis)
    x2d = x.reshape(T, d)
    gflat, eflat, tok, aux = _pairs(wr, cfg, x2d)
    local = torch.div(eflat, E_loc, rounding_mode="floor") == midx
    # sort key: local expert id for local pairs, E_loc (sentinel) otherwise
    # -- local pairs become a contiguous prefix grouped by local expert
    key = torch.where(local, eflat - midx * E_loc, E_loc)
    sk, perm = torch.sort(key, stable=True)
    counts = _read_sizes(torch.bincount(key, minlength=E_loc + 1))
    n_local = sum(counts[:E_loc])
    kept = min(n_local, capacity)
    dropped["moe_pairs"] += n_local - kept
    sk, perm = sk[:capacity], perm[:capacity]
    tok_s = tok[perm]
    gate_s = torch.where(sk < E_loc, gflat[perm], 0.0)  # sentinel rows: weight 0
    # bincount(min(sk, E_loc - 1)) of the kept rows, from the counts: the
    # sentinel rows run through the last local expert
    sizes, left = [], capacity
    for c in counts[:E_loc]:
        sizes.append(min(c, left))
        left -= sizes[-1]
    sizes[-1] += left
    y_sel = _grouped_ffn(cfg, x2d[tok_s], wg, wu, wd, sizes)
    gated = (y_sel.to(torch.float32) * gate_s[:, None]).to(x.dtype)
    out = _combine_kept(gated[:kept], tok_s[:kept], T, k)
    out = dist.psum(out, ctx.model_axis)
    aux = dist.pmean(aux, ctx.batch_axes)      # identical over the model axis
    return out.reshape(B, S, d), aux


def _moe_sharded_body_virtual(x, wr, wg, wu, wd, *, cfg: ModelConfig,
                              ctx: dist.MeshContext, within: int,
                              capacity: int):
    """One rank's virtual-expert body (``repro/models/moe.py:135-168``) for
    num_experts < model-axis size: each real expert's FFN hidden dim is
    split over ``within`` ranks; wg/wu arrive as (1, d, f/within) and wd as
    (1, f/within, d) slices (``virtual_expert_slice``).  The psum over the
    model axis reduces the partial hidden sums within an expert and
    combines disjoint experts' tokens at once."""
    B, S, d = x.shape
    T, k = B * S, cfg.num_experts_per_tok
    real_e = dist.axis_index(ctx, ctx.model_axis) // within
    x2d = x.reshape(T, d)
    gflat, eflat, tok, aux = _pairs(wr, cfg, x2d)
    local = eflat == real_e
    # bring local pairs to a contiguous prefix, truncate at capacity
    key = torch.where(local, 0, 1)
    sk, perm = torch.sort(key, stable=True)
    n_local = _read_sizes(local.sum().reshape(1))[0]
    kept = min(n_local, capacity)
    dropped["moe_pairs"] += n_local - kept
    sk, perm = sk[:capacity], perm[:capacity]
    tok_s = tok[perm]
    gate_s = torch.where(sk == 0, gflat[perm], 0.0)
    x_sel = x2d[tok_s]                                   # (cap, d)
    h = _activation(cfg, x_sel @ wg[0], x_sel @ wu[0])   # (cap, f/within)
    y_sel = h @ wd[0]                                    # partial over hidden
    gated = (y_sel.to(torch.float32) * gate_s[:, None]).to(x.dtype)
    out = _combine_kept(gated[:kept], tok_s[:kept], T, k)
    out = dist.psum(out, ctx.model_axis)
    aux = dist.pmean(aux, ctx.batch_axes)
    return out.reshape(B, S, d), aux


def virtual_expert_slice(w: torch.Tensor, name: str, within: int,
                         index: int) -> torch.Tensor:
    """Slice ``index`` of E*within of an expert stack (``..., E, d, f)`` for
    w_gate/w_up, ``(..., E, f, d)`` for w_down), as
    ``repro/models/moe.py:206-211``'s reshape hands it to model rank
    ``index``: expert index // within, hidden columns (rows for w_down)
    [j·f/within, (j+1)·f/within) for j = index % within; the expert dim
    kept, of size 1."""
    e, j = divmod(index, within)
    hid = -2 if name == "w_down" else -1
    f_loc = w.shape[hid] // within
    return w[..., e:e + 1, :, :].narrow(hid, j * f_loc, f_loc)


def moe_forward(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss scaled by
    ``router_aux_loss_coef``).  Adds the shared experts.

    Under a ``dist.MeshContext`` x is this rank's batch shard (so JAX's
    ``B % batch_size == 0`` holds by construction) and the body is chosen
    as ``repro/models/moe.py:171-220`` chooses it: expert-parallel when the
    experts divide the model axis, virtual experts when the model axis is a
    multiple of E whose quotient divides d_ff, else the local path.  Each
    expert stack is then this rank's own, as
    ``launch/sharding.shard_params`` gives it: (E/ms, ...) experts, or one
    expert's hidden slice (``virtual_expert_slice``)."""
    B, S, d = x.shape
    ctx = dist.get_mesh_context()
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    ms = ctx.model_size if ctx is not None else 0
    d_ff = cfg.moe_d_ff or cfg.d_ff
    T_loc = B * S
    ws = [p[n] for n in ("w_gate", "w_up", "w_down")]
    if ctx is not None and E % ms == 0:
        _refuse_grad(x, p)
        E_loc = E // ms
        _check_local(ws, E_loc, d_ff, "expert-parallel")
        # expected local load = T_loc*k*E_loc/E, scaled by the capacity
        # factor (default 2x), clamped to all pairs
        capacity = min(T_loc * k, int(cfg.moe_capacity_factor * T_loc * k *
                                      E_loc / E) + 64)
        out, aux = _moe_sharded_body(x, p["router"]["w"], *ws, cfg=cfg,
                                     ctx=ctx, capacity=capacity)
    elif ctx is not None and ms % E == 0 and d_ff % (ms // E) == 0:
        # virtual experts: E real experts x (ms/E) hidden slices (§Perf B)
        _refuse_grad(x, p)
        within = ms // E
        _check_local(ws, 1, d_ff // within, "virtual-expert")
        capacity = min(T_loc * k, int(cfg.moe_capacity_factor * T_loc * k / E)
                       + 64)
        out, aux = _moe_sharded_body_virtual(
            x, p["router"]["w"], *ws, cfg=cfg, ctx=ctx, within=within,
            capacity=capacity)
    else:
        out2d, aux = _moe_local(p, cfg, x.reshape(B * S, d))
        out = out2d.reshape(B, S, d)
    if cfg.num_shared_experts:
        out = out + ffn_mod.ffn_forward(p["shared"], cfg, x)
    return out, aux * cfg.router_aux_loss_coef


def _check_local(ws, n_experts: int, f: int, body: str) -> None:
    """The rank's own stacks: (n_experts, d, f), (n_experts, d, f) and
    (n_experts, f, d)."""
    wg, wu, wd = ws
    ok = (wg.shape[0] == wu.shape[0] == wd.shape[0] == n_experts and
          wg.shape[-1] == wu.shape[-1] == wd.shape[-2] == f)
    if not ok:
        raise ValueError(
            f"the {body} body takes this rank's expert stacks, ({n_experts}, "
            f"d, {f}) and ({n_experts}, {f}, d) (launch/sharding.shard_params"
            f"), got {tuple(wg.shape)}, {tuple(wu.shape)}, {tuple(wd.shape)}")


def _refuse_grad(x, p) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p[n].requires_grad for n in ("w_gate", "w_up", "w_down"))):
        raise NotImplementedError(
            "the sharded MoE bodies are forward only: their gradient (what "
            "the psum over the model axis transposes to) is ROADMAP queue 1's "
            "'gradient through the sharded bodies'")
