"""Sharding rules, as ``repro/launch/sharding.py``: logical-axis rules for
activations and path-based partition specs for every parameter of the zoo.

Layout summary (single-pod ('data','model'); multi-pod adds 'pod'):
  batch/tokens            -> ('pod','data')
  attention heads, FFN hidden, vocab, MoE experts -> 'model'
  large archs (≥ fsdp_threshold params) additionally shard the non-'model'
  weight dimension over 'data' (FSDP).

A spec is a plain tuple, one entry per dim: an axis name, a tuple of axis
names or None, as JAX's ``PartitionSpec`` holds them.  ``param_pspecs``
mirrors the port's param tree (``convert``'s leaf names) leaf for leaf.
``to_placements`` gives a spec as DTensor placements and ``shard_params``
gives each rank its slices.  The port executes the MoE expert stacks
sharded (``models/moe.py``'s bodies) and every other layer whole on each
rank (no GSPMD runs the dense layers tensor-parallel):
``execution_pspecs`` is that layout.  Meshes are ``launch/mesh.MeshShape``
or live ``DeviceMesh``es.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dist import axis_sizes, to_placements  # noqa: F401
from repro_torch.models.moe import virtual_expert_slice

FSDP_THRESHOLD = 8e9        # params; above this, weights also shard over 'data'

Spec = Tuple


def logical_rules(mesh, cfg: Optional[ModelConfig] = None) -> Dict[str, object]:
    batch = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    msize = axis_sizes(mesh)["model"]
    rules = {
        "batch": batch if len(batch) > 1 else batch[0],
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        # decode-cache layout: follows the cache (replicated when kv heads
        # don't divide the tensor axis) — see models/attention.gqa_decode
        "kv_cache_heads": None,
    }
    if cfg is not None and cfg.num_kv_heads % msize == 0:
        rules["kv_cache_heads"] = "model"
    return rules


def _spec_for(path: str, ndim: int, cfg: ModelConfig, fsdp: Optional[str]
              ) -> Spec:
    """Spec for one (unstacked) param. path: '/'-joined key names."""
    leaf = path.rsplit("/", 1)[-1]

    def pick():
        # ---- embeddings / lm head: shard vocab over model
        if "embed" in path or "lm_head" in path:
            return ("model", fsdp)
        # ---- MoE
        if "/moe/" in path or path.startswith("moe/"):
            if "router" in path:
                return (None, None)
            if "shared" in path:
                if leaf == "b":
                    return ("model",) if "w_up" in path or "w_gate" in path \
                        else (None,)
                if "w_down" in path:
                    return ("model", fsdp)
                return (fsdp, "model")
            if cfg.num_experts % 16 == 0:
                if "w_down" in path:
                    return ("model", None, fsdp)   # (E, f, d): experts sharded
                return ("model", fsdp, None)       # (E, d, f)
            # virtual-expert layout: E < model size — shard the expert FFN
            # hidden dim instead
            if "w_down" in path:
                return (None, "model", fsdp)       # (E, f, d)
            return (None, fsdp, "model")           # (E, d, f)
        # ---- MLA attention
        if cfg.mla and "/attn/" in path:
            if "q_up" in path or "kv_up" in path:
                return (None, "model")
            if "q_down" in path or "kv_down" in path:
                return (fsdp, None)
            if leaf == "w" and "wo" in path:
                return ("model", fsdp)
            return (None,)
        # ---- GQA attention / cross attention
        if "/attn/" in path or "/cross/" in path:
            if leaf == "w":
                if "wo" in path:
                    return ("model", fsdp)
                return (fsdp, "model")              # wq/wk/wv
            if leaf == "b":
                return (None,) if "wo" in path else ("model",)
            return (None,)                           # q_norm/k_norm scales
        # ---- dense FFN
        if "/ffn/" in path or path.startswith("ffn/"):
            if leaf == "w":
                return ("model", fsdp) if "w_down" in path else (fsdp, "model")
            if leaf == "b":
                return (None,) if "w_down" in path else ("model",)
            return (None,)
        # ---- Mamba2 / xLSTM (small models: replicate or fsdp only)
        if "/mamba/" in path or "/mlstm/" in path or "/slstm/" in path:
            if leaf == "w" and ndim == 2:
                return (fsdp, None)
            return (None,)
        # ---- norms, scalars, everything else
        return (None,) * min(ndim, 1)

    parts = list(pick()) + [None] * ndim      # pad/truncate to ndim
    return tuple(parts[:ndim])


def _axis_product(mesh, ax) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params, cfg: ModelConfig, mesh):
    """Mirror ``params`` (tensors of any device, meta included) with specs.
    Scanned stacks (paths under layers/ or enc_layers/) get a None for the
    layer dim; an axis that does not divide its dim is dropped."""
    fsdp = ("data" if cfg.param_count() >= FSDP_THRESHOLD
            and "data" in mesh.mesh_dim_names else None)

    def one(path, leaf):
        scanned = path.startswith("layers/") or path.startswith("enc_layers/")
        ndim = leaf.dim() - (1 if scanned else 0)
        spec = _spec_for(path, ndim, cfg, fsdp)
        if scanned:
            spec = (None,) + spec
        # sanity: never shard an axis that does not divide
        return tuple(ax if ax is None or dim % _axis_product(mesh, ax) == 0
                     else None for dim, ax in zip(leaf.shape, spec))

    return _map_with_path(one, params)


def execution_pspecs(params, cfg: ModelConfig, mesh):
    """The layout the port runs under a mesh: each MoE expert stack as
    ``models/moe.py``'s bodies take it (experts over 'model' where they
    divide it; the virtual-expert hidden slices where 'model' is a multiple
    of E), every other leaf whole."""
    ms = axis_sizes(mesh)["model"]

    def one(path, leaf):
        spec = [None] * leaf.dim()
        name = path.rsplit("/", 1)[-1]
        experts = ("/moe/" in path or path.startswith("moe/")) and \
            name in ("w_gate", "w_up", "w_down")
        if experts and cfg.num_experts % ms == 0:
            spec[-3] = "model"
        elif experts and ms % cfg.num_experts == 0:
            spec[-2 if name == "w_down" else -1] = "model"
        return tuple(spec)

    return _map_with_path(one, params)


def _is_virtual(path: str, leaf: torch.Tensor, spec: Spec, mesh) -> bool:
    """An expert stack whose spec splits its hidden dim over 'model' where
    'model' is a multiple of its experts: the virtual-expert layout."""
    name = path.rsplit("/", 1)[-1]
    if not (("/moe/" in path or path.startswith("moe/"))
            and name in ("w_gate", "w_up", "w_down") and leaf.dim() >= 3):
        return False
    hid = -2 if name == "w_down" else -1
    E, ms = leaf.shape[-3], axis_sizes(mesh)["model"]
    return spec[hid] == "model" and spec[-3] is None and ms % E == 0 \
        and ms > E


def shard_params(params, specs, mesh, coords: Optional[Dict[str, int]] = None):
    """This rank's slice of every leaf: each dim split over its spec's axes
    (row-major over a tuple of axes) at the rank's coordinates, ``coords``
    ({axis: index}; by default the live ``DeviceMesh``'s own).  An expert
    stack in the virtual-expert layout gives model rank m the slice that
    ``repro/models/moe.py:206-211``'s reshape hands it
    (``moe.virtual_expert_slice``: one expert's hidden slice, not a slice
    of every expert's), other axes of its spec as above.  Slices are views
    of the whole leaf; the caller copies them where it needs to."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = {a: mesh.get_local_rank(mesh_dim=a) for a in sizes}

    def spec_at(path):
        node = specs
        for k in path.split("/"):
            node = node[k]
        return node

    def one(path, leaf):
        spec = spec_at(path)
        if _is_virtual(path, leaf, spec, mesh):
            name = path.rsplit("/", 1)[-1]
            within = sizes["model"] // leaf.shape[-3]
            leaf = virtual_expert_slice(leaf, name, within, coords["model"])
            spec = tuple(None if ax == "model" else ax for ax in spec)
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n, i = 1, 0
            for a in axes:
                n, i = n * sizes[a], i * sizes[a] + coords[a]
            size = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, i * size, size)
        return leaf

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# Input specs per (arch × input shape): shapes and dtypes, and specs
# ---------------------------------------------------------------------------
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
    # extra (not part of the assigned 40): one full FFT round — K parallel
    # clients on the data axis + β-weighted aggregation collective (Eq. 7)
    "fft_round_4k": dict(seq_len=4096, global_batch=256, kind="fft_round",
                         clients=16, client_batch=16),
}

# archs whose attention is not sub-quadratic-capable -> skip long_500k
LONG_CONTEXT_OK = {
    "llava-next-mistral-7b", "starcoder2-7b", "mixtral-8x22b",
    "xlstm-125m", "zamba2-1.2b",
}


def batch_pspec(mesh) -> Spec:
    batch = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return (batch if len(batch) > 1 else batch[0],)


def input_specs(cfg: ModelConfig, shape_name: str, mesh):
    """(name -> (shape, dtype), name -> spec) for train/prefill; decode
    shapes are handled by the dry-run via init_decode_state."""
    sh = INPUT_SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    b0 = batch_pspec(mesh)[0]
    shapes: Dict[str, Tuple[tuple, torch.dtype]] = {}
    pspecs: Dict[str, Spec] = {}

    def add(name, shape, dtype, spec):
        shapes[name] = (shape, dtype)
        pspecs[name] = spec

    if cfg.vision_frontend:
        n_img = cfg.num_image_tokens
        s_txt = S - n_img
        add("tokens", (B, s_txt), torch.int32, (b0, None))
        add("image_embeds", (B, n_img, cfg.d_model), torch.bfloat16,
            (b0, None, None))
        add("labels", (B, S), torch.int32, (b0, None))
    elif cfg.encoder_decoder:
        s_enc = min(S, 4096)
        add("tokens", (B, S), torch.int32, (b0, None))
        add("encoder_embeds", (B, s_enc, cfg.d_model), torch.bfloat16,
            (b0, None, None))
        add("labels", (B, S), torch.int32, (b0, None))
    else:
        add("tokens", (B, S), torch.int32, (b0, None))
        add("labels", (B, S), torch.int32, (b0, None))
    return shapes, pspecs
