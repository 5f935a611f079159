"""End-to-end training entry point, as ``repro/launch/train.py``: train a model
of the zoo on a synthetic bigram token stream with AdamW and a warmup-cosine
schedule, then optionally save ``{"params", "step"}`` in the JAX package's
checkpoint format.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 300 \
        --batch 8 --seq 256 --smoke-scale=false
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke-scale=true --steps 30 --device cpu

The default arch is the JAX script's, xlstm-125m, whose mLSTM and sLSTM
blocks are plain PyTorch loops over time (no kernel), each block
recomputed in the backward.  On a CUDA device every attention layer runs
the ``flash_attention`` kernel forward (twice a step: each layer is
recomputed in the backward) and its backward kernels
(``kernels/csrc/attention_bwd.cu``); ``--device cpu`` runs the plain
versions.  The weights are a random init drawn on the device from seed 0.

Not ported: training zamba2-1.2b, whose ``selective_scan`` kernel has no
backward yet, and training the MoE, MLA, encoder-decoder and VLM configs
(mixtral-8x22b, deepseek-v2-236b, seamless-m4t-large-v2,
llava-next-mistral-7b); they raise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import MAMBA2
from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.tree import tree_flatten, tree_unflatten


def check_trainable(cfg) -> None:
    """Raise for a config whose training path has a kernel without a
    backward (a Mamba2 block's ``selective_scan``), whose training the port
    does not hold against the JAX package yet (MoE and its aux loss, MLA,
    the encoder-decoder, the VLM prefix), or that the port does not run at
    all."""
    T.check_ported(cfg)
    if MAMBA2 in (cfg.block_pattern or ()):
        raise NotImplementedError(
            f"{cfg.name}: training the Mamba2 blocks needs a selective_scan "
            "backward, not ported yet")
    for flag, what in ((cfg.moe, "MoE"), (cfg.mla, "MLA"),
                       (cfg.encoder_decoder, "encoder-decoder"),
                       (cfg.vision_frontend, "VLM")):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: training the {what} blocks is not ported yet")


def value_and_grad(cfg, params, toks, labels, *, loss_chunk: int,
                   remat: bool = True):
    """(loss, grads): the LM loss of ``T.forward`` and its gradient with
    respect to every leaf of ``params``, as a tree of the same structure."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss, _ = T.forward(tree_unflatten(spec, leaves), cfg,
                        {"tokens": toks, "labels": labels},
                        loss_chunk=loss_chunk, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(spec, list(grads))


LOSS_CHUNK = 256   # the JAX script's


def make_train_step(cfg, *, remat: bool = True):
    """step(params, opt_state, toks, labels, lr) -> (params, opt_state,
    loss): one AdamW step on the LM loss, as the JAX script's jitted
    ``train_step``."""

    def step(params, opt_state, toks, labels, lr):
        loss, grads = value_and_grad(cfg, params, toks, labels,
                                     loss_chunk=LOSS_CHUNK, remat=remat)
        with torch.no_grad():
            params, opt_state = adamw_update(params, grads, opt_state, lr)
        return params, opt_state, loss

    return step


def train(cfg, params, *, steps: int, batch: int, seq: int, lr: float,
          log_every: int = 10):
    """The training loop from ``params``: AdamW under ``warmup_cosine(lr,
    20, steps)`` on batches of the seed-0 bigram stream.  Returns (params,
    opt_state, losses, wall seconds)."""
    dev = tree_flatten(params)[0][0].device
    opt_state = adamw_init(params)
    sched = warmup_cosine(lr, warmup=20, total=steps)
    stream = make_bigram_stream(500_000, cfg.vocab_size, domain=0,
                                n_domains=1, seed=0)
    batches = batches_from_stream(stream, batch, seq, seed=0)
    step_fn = make_train_step(cfg)
    t0 = time.time()
    losses = []
    for step in range(1, steps + 1):
        toks, labels = next(batches)
        params, opt_state, loss = step_fn(
            params, opt_state, torch.from_numpy(toks).to(dev),
            torch.from_numpy(labels).to(dev), sched(step))
        losses.append(float(loss))
        if step % log_every == 0 or step == 1:
            tps = batch * seq * step / (time.time() - t0)
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"({np.mean(losses[-10:]):.4f} avg10) tok/s={tps:,.0f}")
    return params, opt_state, losses, time.time() - t0


def main(argv=None):
    """Returns {"params", "opt_state", "losses", "wall_s", "cfg"} after the
    JAX script's checks."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke-scale", default="false")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    smoke = args.smoke_scale.lower() in ("1", "true", "yes")
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    check_trainable(cfg)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params≈{cfg.param_count() / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq} device={dev}")
    params = T.init_params(cfg, 0, dev)
    params, opt_state, losses, wall = train(
        cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, log_every=args.log_every)
    print(f"loss: first={losses[0]:.4f} last10={np.mean(losses[-10:]):.4f} "
          f"wall={wall:.1f}s")
    if not np.mean(losses[-10:]) < losses[0]:
        raise RuntimeError("training did not reduce loss")
    if args.checkpoint:
        save(args.checkpoint, {"params": params, "step": args.steps})
        print(f"checkpoint -> {args.checkpoint}")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "wall_s": wall, "cfg": cfg}


if __name__ == "__main__":
    main()
