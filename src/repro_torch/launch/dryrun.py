"""Multi-pod dry-run plan, as ``repro/launch/dryrun.py``: for every
(architecture × input shape × mesh), lay the params, the decode state and
the inputs out on the production mesh and report what each device holds and
the analytic H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out plan.json

The JAX module lowers and compiles each step for 512 forced host devices
and reads the compiled module's cost, memory and collectives.  PyTorch has
no such compiler, so ``run_one`` builds the params (and the decode state)
on the meta device, applies ``param_pspecs`` and ``decode_state_pspecs`` on
the mesh shape, checks that every sharded dim divides, and reports the
per-device bytes of params, decode state and inputs, ``model_flops`` and
``analytic_roofline``.  The fields that only a compiled module gives
(``flops_per_device``, ``bytes_per_device``, ``collectives``, ``mem`` and
what derives from them) are ``None``.  Skips and failures follow JAX's
rules: ``long_500k`` is skipped for archs outside ``LONG_CONTEXT_OK``, and
a plan that raises is a ``fail`` row.  Nothing here needs a process group
or sets the environment.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (ATTN, MAMBA2, MLSTM, SHARED_ATTN, SLSTM,
                                      ModelConfig)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import MeshShape, batch_axes, make_production_mesh
from repro_torch.launch.sharding import (FSDP_THRESHOLD, INPUT_SHAPES,
                                         LONG_CONTEXT_OK, axis_sizes,
                                         input_specs, param_pspecs)
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import MambaCache
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache


# ---------------------------------------------------------------------------
# decode-state partition specs (mirrors transformer.init_decode_state)
# ---------------------------------------------------------------------------
def _maybe(mesh, ax, dim: int):
    if ax is None:
        return None
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
    return ax if dim % size == 0 else None


def decode_state_pspecs(cfg: ModelConfig, mesh, batch: int, cache_len: int):
    baxes = batch_axes(mesh)
    b = _maybe(mesh, baxes if len(baxes) > 1 else baxes[0], batch)
    H = cfg.ssm_num_heads or cfg.num_heads
    d_in = cfg.ssm_expand * cfg.d_model

    def kv(scanned: bool):
        ms = axis_sizes(mesh)["model"]
        if cfg.mla:
            k = v = (b, None, None)
        elif cfg.num_kv_heads % ms != 0 and cache_len % ms == 0:
            # seq-sharded cache (distributed flash decode — §Perf A)
            k = v = (b, "model", None, None)
        else:
            kvh = _maybe(mesh, "model", cfg.num_kv_heads)
            k = v = (b, None, kvh, None)
        if scanned:
            k = v = (None,) + k
        return KVCache(k=k, v=v, length=(None,) if scanned else ())

    def block_spec(kind: str):
        if kind in (ATTN, SHARED_ATTN):
            return kv(False)
        if kind == MAMBA2:
            return MambaCache(h=(b, _maybe(mesh, "model", H), None, None),
                              conv=(b, None, _maybe(mesh, "model", d_in)),
                              length=())
        if kind == MLSTM:
            return MLSTMCache(C=(b, _maybe(mesh, "model", H), None, None),
                              n=(b, _maybe(mesh, "model", H), None),
                              m=(b, _maybe(mesh, "model", H)), length=())
        if kind == SLSTM:
            return SLSTMCache(c=(b, None), n=(b, None), h=(b, None),
                              m=(b, None), length=())
        raise ValueError(kind)

    state: Dict[str, object] = {}
    if cfg.block_pattern is None:
        state["layers"] = kv(True)
        for i in range(cfg.first_k_dense):
            state[f"dense_layer_{i}"] = kv(False)
    else:
        state["blocks"] = {str(i): block_spec(k)
                           for i, k in enumerate(cfg.layer_kinds())}
    if cfg.encoder_decoder:
        state["enc_out"] = (b, None, None)
    return state


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------
def _shards(mesh, spec, shape, what: str) -> int:
    """How many pieces ``spec`` cuts a leaf of ``shape`` into; raises where a
    sharded dim does not divide."""
    sizes, n = axis_sizes(mesh), 1
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        k = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
        if dim % k:
            raise ValueError(f"{what}: dim {dim} does not divide over {ax} "
                             f"({k} devices)")
        n *= k
    return n


def _with_specs(tree, specs, path=""):
    """(path, tensor, spec) of a tree and its spec tree, caches included."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _with_specs(tree[k], specs[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            v = getattr(tree, f)
            if isinstance(v, torch.Tensor):
                yield f"{path}/{f}", v, getattr(specs, f)
    else:
        yield path, tree, specs


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    total = 0
    for path, t, spec in _with_specs(tree, specs):
        total += t.numel() * t.element_size() // _shards(mesh, spec, t.shape,
                                                         path)
    return total


def _input_bytes(shapes, specs, mesh) -> int:
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               // _shards(mesh, specs[name], shape, name)
               for name, (shape, dt) in shapes.items())


@functools.lru_cache(maxsize=None)
def _meta_params(arch: str):
    return T.init_params(get_config(arch), device="meta")


def _meta_decode_state(params, cfg: ModelConfig, batch: int, cache_len: int):
    """``init_decode_state`` on the meta device; the enc-dec's ``enc_out``
    (which it would compute through the encoder) as a (B, 4096, d) leaf."""
    if not cfg.encoder_decoder:
        return T.init_decode_state(params, cfg, batch, cache_len)
    state = T.init_decode_state(
        params, dataclasses.replace(cfg, encoder_decoder=False), batch,
        cache_len)
    state["enc_out"] = torch.empty((batch, 4096, cfg.d_model),
                                   dtype=T.torch_dtype(cfg), device="meta")
    return state


# ---------------------------------------------------------------------------
# one dry-run
# ---------------------------------------------------------------------------
def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def run_one(arch: str, shape_name: str, multi_pod: bool,
            verbose: bool = True, mesh_override: Optional[str] = None) -> Dict:
    cfg = get_config(arch)
    sh = INPUT_SHAPES[shape_name]
    mesh_name = mesh_override or ("multi" if multi_pod else "single")
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": "full-attention arch (DESIGN.md §4)"}
    t0 = time.time()
    if mesh_override:
        # exploration mesh, e.g. "64x4" -> (data=64, model=4)
        d_, m_ = (int(v) for v in mesh_override.split("x"))
        mesh = MeshShape(("data", "model"), (d_, m_))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        params = _meta_params(arch)
        pspecs = param_pspecs(params, cfg, mesh)
        param_bytes = per_device_bytes(params, pspecs, mesh)
        B, S = sh["global_batch"], sh["seq_len"]
        state_bytes = 0
        if sh["kind"] == "fft_round":
            K, b = sh["clients"], sh["client_batch"]
            shapes = {"tokens": ((K, b, S), torch.int32),
                      "labels": ((K, b, S), torch.int32),
                      "betas": ((K,), torch.float32)}
            in_specs = {"tokens": ("data", None, None),
                        "labels": ("data", None, None), "betas": (None,)}
        elif sh["kind"] in ("train", "prefill"):
            shapes, in_specs = input_specs(cfg, shape_name, mesh)
            if sh["kind"] == "prefill":
                shapes.pop("labels")
                in_specs.pop("labels")
        else:  # decode
            clen = cache_len_for(cfg, S)
            state = _meta_decode_state(params, cfg, B, clen)
            st_specs = decode_state_pspecs(cfg, mesh, B, clen)
            state_bytes = per_device_bytes(state, st_specs, mesh)
            baxes = batch_axes(mesh)
            bax = _maybe(mesh, baxes if len(baxes) > 1 else baxes[0], B)
            shapes = {"tokens": ((B, 1), torch.int32)}
            in_specs = {"tokens": (bax, None)}
        input_bytes = _input_bytes(shapes, in_specs, mesh)
        t_plan = time.time() - t0

        mf = rl.model_flops(cfg, sh)
        sizes = axis_sizes(mesh)
        n_dev = math.prod(sizes.values())
        msh = sizes["model"]
        analytic = rl.analytic_roofline(
            cfg, sh, n_devices=n_dev, batch_shards=n_dev // msh,
            model_shards=msh, fsdp=cfg.param_count() >= FSDP_THRESHOLD)
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "plan_s": round(t_plan, 2),
            "param_bytes_per_device": param_bytes,
            "state_bytes_per_device": state_bytes,
            "input_bytes_per_device": input_bytes,
            # what only a compiled module gives (no compiler here)
            "flops_per_device": None, "bytes_per_device": None,
            "collective_bytes_per_device": None, "collectives": None,
            "useful_flops_frac": None,
            "compute_s": None, "memory_s": None, "collective_s": None,
            "dominant": None, "mem": None,
            "model_flops_total": mf,
            "model_flops_per_device": mf / n_dev,
            **analytic,
        }
        if verbose:
            print(f"[ok] {arch:24s} {shape_name:12s} {mesh_name:6s} "
                  f"params/dev={param_bytes / 2**30:.3f} GiB "
                  f"state/dev={state_bytes / 2**30:.3f} GiB "
                  f"a_step={analytic['a_step_s']:.3e}s "
                  f"dom={analytic['a_dominant']}")
        return result
    except Exception as e:  # noqa: BLE001 — a failed plan is a result
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh_name}: {e}")
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "fail", "error": f"{type(e).__name__}: {e}"}


ASSIGNED = [
    "deepseek-v2-236b", "llava-next-mistral-7b", "starcoder2-7b",
    "mixtral-8x22b", "xlstm-125m", "qwen3-1.7b", "codeqwen1.5-7b",
    "zamba2-1.2b", "gemma-7b", "seamless-m4t-large-v2",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remesh", default=None,
                    help="exploration mesh 'DxM' (e.g. 64x4) instead of the "
                         "production meshes")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    if args.shape is None:
        # the assigned 4 shapes; fft_round_4k is an extra, run explicitly
        shapes = [s for s, v in INPUT_SHAPES.items() if v["kind"] != "fft_round"]
    else:
        shapes = [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    jsonl = (args.out + ".jsonl") if args.out else None
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in (meshes if not args.remesh else [False]):
                r = run_one(arch, shape, mp, mesh_override=args.remesh)
                results.append(r)
                if jsonl:                      # incremental, crash-safe
                    with open(jsonl, "a") as f:
                        f.write(json.dumps(r) + "\n")
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    fail = sum(r["status"] == "fail" for r in results)
    print(f"\nDRYRUN SUMMARY: {ok} ok, {sk} skipped, {fail} failed / {len(results)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
