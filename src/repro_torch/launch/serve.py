"""Batched serving driver: prefill a prompt batch, then decode with the
ring-buffer KV cache, as ``repro/launch/serve.py`` ``--mode decode``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke-scale=false --batch 4 --prompt-len 64 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --smoke-scale=false

Every decode step runs each attention layer through the
``decode_attention`` kernel (``kernels/csrc/attention.cu``) on a CUDA
device: qwen3's 28 layers, or zamba2's shared block at its 6 positions,
each with its own cache, while zamba2's 32 Mamba2 blocks take the one-step
recurrence in plain PyTorch.  ``--device cpu`` runs the plain versions
instead.  The weights are a random init drawn on the device from
``--seed``.  ``--mode broadcast`` (the federated downlink's paged broadcast
cache) is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts: torch.Tensor, decode_steps: int,
             cache_len: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Dict:
    """Prefill ``prompts`` (B, P) by teacher-forcing them through
    ``decode_step`` (the KV path that serves), then decode ``decode_steps``
    tokens, greedy or sampled at ``temperature`` from ``generator``.

    Returns {"tokens": (B, decode_steps + 1) on the device (the token after
    the prompt, then one per decode step), "logits" (B, V) of the last step,
    "prefill_s", "decode_s", "tok_s"}.  The clocks stop after a device
    synchronize; no step reads the device back."""
    B, P = prompts.shape
    if P < 1:
        raise ValueError("generate needs a prompt of at least one token")
    dev = prompts.device
    state = T.init_decode_state(params, cfg, B, cache_len)
    t0 = time.perf_counter()
    for t in range(P):
        logits, state = T.decode_step(params, cfg, state, prompts[:, t:t + 1])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(decode_steps):
        logits, state = T.decode_step(params, cfg, state, tok)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, 1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_s": B * decode_steps / t_decode if t_decode > 0 else 0.0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="decode", choices=("decode", "broadcast"))
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--smoke-scale", default="true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.mode == "broadcast":
        raise NotImplementedError("--mode broadcast: not ported yet (it comes "
                                  "with the codec slice)")
    smoke = args.smoke_scale.lower() in ("1", "true", "yes")
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    B = args.batch
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=gen, device=dev)
    res = generate(params, cfg, prompts, args.decode_steps, args.cache_len,
                   temperature=args.temperature, generator=gen)
    print(f"arch={cfg.name} B={B} prefill({args.prompt_len} tok)="
          f"{res['prefill_s']:.2f}s decode={args.decode_steps} steps "
          f"{res['decode_s']:.2f}s -> {res['tok_s']:,.1f} tok/s")
    print("sample:", res["tokens"][0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
