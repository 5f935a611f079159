"""Roofline terms for the H100, as ``repro/launch/roofline.py``.

Three per-device terms, in seconds:

    compute    = FLOPs_per_device / 989e12         (H100 SXM bf16 dense peak)
    memory     = bytes_per_device / 3.35e12        (H100 SXM HBM3)
    collective = collective_bytes_per_device / 450e9  (NVLink 4, each way)

The published H100 SXM figures take the place of the JAX module's TPU v5e
constants; nothing else of the model changes.  ``collective_bytes`` reads
``models/dist.py``'s counter of the collectives a run made (the port
compiles no HLO to parse) and names the kinds as XLA does.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 / device, dense
HBM_BW = 3.35e12             # bytes / s / device
NVLINK_BW = 450e9              # bytes / s / device, NVLink each way

#: ``models/dist.py``'s wrappers -> the collective XLA would emit
XLA_KIND = {"psum": "all-reduce", "pmax": "all-reduce", "pmean": "all-reduce"}


def collective_bytes(counter: Optional[Dict[str, Dict[str, int]]] = None
                     ) -> Dict[str, int]:
    """Bytes per collective kind (``{"all-reduce": n}``) of the collectives
    counted in ``counter`` (``models/dist.collectives`` by default) since
    its last reset."""
    if counter is None:
        from repro_torch.models.dist import collectives as counter
    out: Dict[str, int] = {}
    for name, rec in counter.items():
        if rec["count"]:
            kind = XLA_KIND[name]
            out[kind] = out.get(kind, 0) + rec["bytes"]
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: int) -> Dict[str, float]:
    t_c = flops / PEAK_FLOPS
    t_m = bytes_accessed / HBM_BW
    t_x = coll_bytes / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom}


def model_flops(cfg, shape_info: dict) -> float:
    """MODEL_FLOPS: 6·N_active·tokens for training, 2·N_active·tokens for a
    decode/prefill step."""
    n = cfg.active_param_count()
    B, S = shape_info["global_batch"], shape_info["seq_len"]
    if shape_info["kind"] in ("train", "fft_round"):
        return 6.0 * n * B * S
    if shape_info["kind"] == "prefill":
        return 2.0 * n * B * S
    return 2.0 * n * B          # decode: one token per sequence


def analytic_roofline(cfg, shape_info: dict, *, n_devices: int,
                      batch_shards: int, model_shards: int,
                      fsdp: bool = False) -> dict:
    """Napkin-math three-term roofline per device, the JAX module's model
    with the H100 constants (the port's dry-run has no compiled module to
    count, so this is its only per-device estimate).

    Model (bf16 = 2 bytes, fp32 master math folded into the constants):
      compute  = MODEL_FLOPS/device ÷ peak  (+ ~1/3 remat re-forward when
                 training, matching per-layer remat)
      memory   = params traffic + activation traffic + KV-cache traffic
      collective = TP output all-reduces (2/layer fwd [+2 bwd]) on
                 (tokens_dev × d_model) + DP/FSDP gradient reduce-scatter +
                 all-gather when training.
    """
    B, S = shape_info["global_batch"], shape_info["seq_len"]
    kind = shape_info["kind"]
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    L = cfg.num_layers + (cfg.num_encoder_layers if cfg.encoder_decoder else 0)
    d = cfg.d_model
    bytes_p = 2.0

    tokens = B * S if kind in ("train", "prefill", "fft_round") else B
    tokens_dev = tokens / batch_shards
    params_dev = n_total * bytes_p / (model_shards * (batch_shards if fsdp else 1))

    if kind in ("train", "fft_round"):
        flops_dev = 6.0 * n_active * tokens / n_devices * (8.0 / 6.0)  # remat
        # params: fwd read + remat re-read + bwd read + grad write + update
        mem = 5.0 * params_dev
        # activations: ~6 (tokens_dev·d) tensors per layer r/w with remat
        mem += 6.0 * L * tokens_dev * d * bytes_p
        coll = 4.0 * L * tokens_dev * d * bytes_p          # TP psums fwd+bwd
        if fsdp:
            coll += 4.0 * params_dev * batch_shards        # AG + RS per step
        elif batch_shards > 1:
            coll += 2.0 * params_dev                       # DP grad all-reduce
    elif kind == "prefill":
        flops_dev = 2.0 * n_active * tokens / n_devices
        mem = params_dev + 4.0 * L * tokens_dev * d * bytes_p
        coll = 2.0 * L * tokens_dev * d * bytes_p
        if fsdp:
            coll += params_dev * batch_shards
    else:  # decode: one token, full cache read
        flops_dev = 2.0 * n_active * tokens / n_devices
        cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
        if cfg.mla:
            kv_bytes = cache_len * (cfg.mla_kv_lora_rank + cfg.mla_rope_head_dim)
        elif cfg.block_pattern is not None:
            # recurrent states: O(1) per layer
            kv_bytes = (cfg.ssm_expand * d * cfg.ssm_state_size)
        else:
            kv_bytes = cache_len * 2 * cfg.num_kv_heads * cfg.resolved_head_dim
        mem = params_dev + B / batch_shards * L * kv_bytes * bytes_p
        coll = 2.0 * L * tokens_dev * d * bytes_p + \
            tokens_dev * cfg.vocab_size * bytes_p / model_shards
        if fsdp:
            coll += params_dev * batch_shards

    t_c = flops_dev / PEAK_FLOPS
    t_m = mem / HBM_BW
    t_x = coll / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    bound = max(t_c, t_m, t_x)
    return {"a_compute_s": t_c, "a_memory_s": t_m, "a_collective_s": t_x,
            "a_dominant": dom, "a_step_s": bound,
            "a_mfu_bound": t_c / bound if bound else 0.0}
