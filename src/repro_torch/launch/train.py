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
(``kernels/csrc/attention_bwd.cu``); zamba2-1.2b's Mamba2 blocks run the
``selective_scan`` kernel forward (twice a step) and its backward
(``kernels/csrc/selective_scan_bwd.cu``); ``--device cpu`` runs the plain
versions.  The MoE configs (mixtral-8x22b, deepseek-v2-236b) read their
group sizes back twice a MoE layer a step (the forward and its
recompute); llava-next-mistral-7b trains on text alone (no image
embeddings in the stream), as the JAX driver does.  The weights are a
random init drawn on the device from seed 0.

seamless-m4t-large-v2 raises: an encoder-decoder needs encoder
embeddings, which the token stream does not give (the JAX driver fails
there with a KeyError); ``value_and_grad(..., extra={"encoder_embeds":
...})`` trains it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.tree import tree_flatten, tree_unflatten


def check_trainable(cfg) -> None:
    """Raise for a config that the token-stream drivers (this script,
    ``fl/parallel.py``'s round, ``launch/fft_lora_llm.py``) cannot train:
    an encoder-decoder, whose encoder embeddings no token stream gives, and
    a config the port does not run at all.  Called before any init."""
    T.check_ported(cfg)
    if cfg.encoder_decoder:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder trains on encoder_embeds, which "
            "the token stream does not give; call value_and_grad with "
            "extra={'encoder_embeds': ...}")


def value_and_grad(cfg, params, toks, labels, *, loss_chunk: int,
                   remat: bool = True, q_chunk: int = 2048, extra=None):
    """(loss, grads): the LM loss of ``T.forward`` (plus the MoE aux loss)
    and its gradient with respect to every leaf of ``params``, as a tree of
    the same structure.  ``extra``: the batch's other entries
    ("image_embeds" for a VLM, "encoder_embeds" for an encoder-decoder),
    which ``T.forward`` reads as the JAX package's does."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    batch = {"tokens": toks, "labels": labels, **(extra or {})}
    loss, _ = T.forward(tree_unflatten(spec, leaves), cfg, batch,
                        loss_chunk=loss_chunk, remat=remat, q_chunk=q_chunk)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(spec, list(grads))


LOSS_CHUNK = 256   # the JAX script's


def make_train_step(cfg, *, remat: bool = True):
    """step(params, opt_state, toks, labels, lr, extra=None) -> (params,
    opt_state, loss): one AdamW step on the LM loss, as the JAX script's
    jitted ``train_step``; ``extra`` as ``value_and_grad``'s."""

    def step(params, opt_state, toks, labels, lr, extra=None):
        loss, grads = value_and_grad(cfg, params, toks, labels,
                                     loss_chunk=LOSS_CHUNK, remat=remat,
                                     extra=extra)
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
