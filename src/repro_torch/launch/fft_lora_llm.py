"""FedAuto fine-tuning of a transformer LM with LoRA adapters, the loop of
``examples/fft_lora_llm.py`` (paper §V-C generalized to the LLM zoo):
clients hold domain-specific token streams, only rank-4 adapters on
``wq/w`` and ``wv/w`` travel, and FedAuto's class-histogram machinery runs
on hashed token buckets.  Each round the server model and every client
whose uplink holds (``rng.uniform > 0.35``) take ``local_steps`` SGD steps
on their adapters from the global ones; FedAuto's weights (Module 2) then
aggregate them through ``aggregate_pytrees``, one ``fedagg`` launch per
adapter leaf on a CUDA device.

    PYTHONPATH=src python -m repro_torch.launch.fft_lora_llm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fft_lora_llm \
        --smoke-scale=false --rounds 3

The adapters are merged into the frozen base with ``apply_lora`` for every
forward, as the JAX example does, so attention runs the ``flash_attention``
kernels forward and backward and ``lora_matmul`` stays off this path.
mixtral-8x22b's adapters sit beside its MoE blocks, llava-next-mistral-7b
trains on text; deepseek-v2-236b (MLA: no ``wq/w`` or ``wv/w``) and
seamless-m4t-large-v2 (no encoder embeddings in the streams) raise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.aggregation import aggregate_pytrees, fedauto_weights
from repro_torch.data.tokens import (batches_from_stream, make_bigram_stream,
                                     token_class_histogram)
from repro_torch.fl.lora import LoRAConfig, apply_lora, lora_init
from repro_torch.launch.train import check_trainable
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

N_BUCKETS = 32
LR = 1e-2
LORA = LoRAConfig(rank=4, alpha=8.0,
                  match=lambda p: p.endswith("wq/w") or p.endswith("wv/w"))


def run(cfg, *, rounds: int = 8, clients: int = 4, local_steps: int = 4,
        seq: int = 64, device="cuda", base=None, adapters=None):
    """The example's loop.  ``base`` and ``adapters`` default to a random
    init drawn on ``device`` (seeds 0 and 1); tests pass the JAX package's.
    Returns {"adapters", "base", "connected" (per round, bool per client),
    "beta", "server_loss", "round_s"}."""
    check_trainable(cfg)
    if cfg.mla:
        raise ValueError(f"{cfg.name}: no wq/w or wv/w weight to adapt (MLA "
                         "projects queries and values through its own "
                         "latents): the rounds would train nothing")
    dev = resolve_device(device)
    if base is None:
        base = T.init_params(cfg, 0, dev)
    if adapters is None:
        adapters = lora_init(torch.Generator(device=dev).manual_seed(1),
                             base, LORA)
    print(f"arch={cfg.name}: {len(tree_leaves(base))} base tensors frozen, "
          f"{len(tree_leaves(adapters))} LoRA tensors trainable")

    # domain-specific client corpora + hashed-bucket histograms (Remark 2)
    streams = [make_bigram_stream(20_000, cfg.vocab_size, domain=i,
                                  n_domains=clients, seed=0)
               for i in range(clients)]
    server_stream = np.concatenate(
        [make_bigram_stream(4_000, cfg.vocab_size, domain=i,
                            n_domains=clients, seed=1)
         for i in range(clients)])
    hists = np.stack([token_class_histogram(s, N_BUCKETS) for s in streams])
    server_hist = token_class_histogram(server_stream, N_BUCKETS)
    global_hist = server_hist + hists.sum(0)

    def local_update(ad, toks, labels):
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        for _ in range(local_steps):
            leaves, spec = tree_flatten(ad)
            leaves = [a.detach().requires_grad_() for a in leaves]
            params = apply_lora(base, tree_unflatten(spec, leaves), LORA)
            loss, _ = T.forward(params, cfg, batch, loss_chunk=seq)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                ad = tree_unflatten(spec, [a - LR * g
                                           for a, g in zip(leaves, grads)])
        return ad, loss.detach()

    iters = [batches_from_stream(s, 4, seq, seed=i)
             for i, s in enumerate(streams)]
    server_iter = batches_from_stream(server_stream, 4, seq, seed=99)
    rng = np.random.default_rng(0)
    out = {"connected": [], "beta": [], "server_loss": [], "round_s": []}
    for r in range(1, rounds + 1):
        t0 = time.perf_counter()
        up = rng.uniform(size=clients) > 0.35        # unreliable uplinks
        models, rows = [], []
        server_model, sl = local_update(adapters, *next(server_iter))
        models.append(server_model)
        rows.append(server_hist / server_hist.sum())
        for i in range(clients):
            if not up[i]:
                continue
            m, _ = local_update(adapters, *next(iters[i]))
            models.append(m)
            rows.append(hists[i] / hists[i].sum())
        beta = fedauto_weights(np.stack(rows), global_hist / global_hist.sum(),
                               np.ones(len(rows), bool), 0, device=dev)
        adapters = aggregate_pytrees(models, beta)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["round_s"].append(time.perf_counter() - t0)
        out["connected"].append(up)
        out["beta"].append(beta)
        out["server_loss"].append(float(sl))
        print(f"round {r}: connected={int(up.sum())}/{clients} "
              f"server_loss={float(sl):.3f} beta={np.round(beta, 3).tolist()} "
              f"wall_s={out['round_s'][-1]:.3f}")
    out.update(adapters=adapters, base=base)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke-scale", default="true")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    smoke = args.smoke_scale.lower() in ("1", "true", "yes")
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    out = run(cfg, rounds=args.rounds, clients=args.clients,
              local_steps=args.local_steps, seq=args.seq, device=args.device)
    print("done — adapters aggregated with FedAuto weights each round")
    return out


if __name__ == "__main__":
    main()
