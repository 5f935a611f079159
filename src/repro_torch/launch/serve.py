"""Batched serving driver: prefill a prompt batch, then decode with the
ring-buffer KV cache, as ``repro/launch/serve.py`` ``--mode decode``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke-scale=false --batch 4 --prompt-len 64 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --smoke-scale=false
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        --smoke-scale=false
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --smoke-scale=false
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --smoke-scale=false

``--arch`` takes every arch of the zoo: qwen3-1.7b, zamba2-1.2b,
xlstm-125m, the dense codeqwen1.5-7b, starcoder2-7b (its cache is the
4,096-slot window's ring), gemma-7b (head dim 256) and paper-vit-b16, the
MoE mixtral-8x22b, deepseek-v2-236b (MLA and MoE), the encoder-decoder
seamless-m4t-large-v2 and llava-next-mistral-7b (served on text, as the
JAX script serves it).  Every decode step runs each GQA attention layer
through the ``decode_attention`` kernel (``kernels/csrc/attention.cu``)
on a CUDA device: every layer of a dense stack, or zamba2's shared block
at its 6 positions, each with its own cache, while zamba2's 32 Mamba2
blocks and xlstm-125m's mLSTM and sLSTM blocks take their one-step
recurrences in plain PyTorch (xlstm-125m has no attention layer), and
deepseek's MLA its absorbed fp32 decode.  For the enc-dec, ``main`` draws
(B, prompt_len, d) encoder frame embeddings from ``--seed``, as the JAX
script does.  ``--device cpu`` runs the plain versions instead.  The
weights are a random init drawn on the device from ``--seed``.  Full
width does not fit one 80 GB card for mixtral-8x22b (281 GB) and
deepseek-v2-236b (479 GB), as it does not for the JAX script either;
``chip_smoke.py``'s ``[zoo]`` phase serves them at a cut depth.

``--mode broadcast`` serves the federated downlink instead: the
``PagedBroadcastCache`` below encodes the global model once per (round,
downlink rung) on the device into fixed-size host pages and serves every
client on that rung from the cache:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode broadcast \
        --clients 256 --rungs int8,qsgd:4,sign1 --rounds 3
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.fl.comm import make_codec
from repro_torch.models import transformer as T
from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.tree import tree_leaves, tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts: torch.Tensor, decode_steps: int,
             cache_len: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             encoder_embeds: Optional[torch.Tensor] = None) -> Dict:
    """Prefill ``prompts`` (B, P) by teacher-forcing them through
    ``decode_step`` (the KV path that serves), then decode ``decode_steps``
    tokens, greedy or sampled at ``temperature`` from ``generator``.  An
    enc-dec config takes ``encoder_embeds`` (B, Se, d), encoded once
    before the prefill's clock starts, as the JAX script times it.

    Returns {"tokens": (B, decode_steps + 1) on the device (the token after
    the prompt, then one per decode step), "logits" (B, V) of the last step,
    "prefill_s", "decode_s", "tok_s"}.  The clocks stop after a device
    synchronize.  No step reads the device back but an MoE layer's, which
    reads its expert group sizes once a step (``models/moe.py``
    ``readbacks``)."""
    B, P = prompts.shape
    if P < 1:
        raise ValueError("generate needs a prompt of at least one token")
    dev = prompts.device
    state = T.init_decode_state(params, cfg, B, cache_len,
                                encoder_embeds=encoder_embeds)
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


# --------------------------------------------------------------------------
# Paged broadcast cache (FL downlink serving)
# --------------------------------------------------------------------------

#: default page size: small enough that a sign1 broadcast still spans
#: several pages, large enough that page bookkeeping is negligible
PAGE_BYTES = 1 << 16


def _pack_pages(payload, page_bytes: int) -> List[np.ndarray]:
    """Flatten a codec payload's wire tensors, leaf by leaf in the payload's
    key order, into fixed-size host uint8 pages (the last may be short):
    the JAX package's bytes for the same payload.  Pages are immutable and
    shared by reference across every client served from them."""
    blob = b"".join(v.detach().cpu().numpy().tobytes()
                    for el in payload.leaves for v in el.data.values())
    if not blob:
        return [np.zeros(0, np.uint8)]
    return [np.frombuffer(blob[o:o + page_bytes], np.uint8)
            for o in range(0, len(blob), page_bytes)]


class PagedBroadcastCache:
    """Encode-once, serve-many downlink cache keyed ``(round, rung)``.

    The first client of a round on a rung pays the encode (``encode_fn``);
    its payload is split into fixed-size pages and every later client on
    that rung is served the same page list by reference.  Rounds that fall
    ``keep_rounds`` behind the newest round seen are evicted wholesale, so
    resident pages stay O(#rungs · keep_rounds), independent of the cohort.
    A live ``telemetry`` hub counts ``broadcast.cache_hit`` and
    ``broadcast.cache_miss`` (``repro/launch/serve.py:67-104``).
    """

    def __init__(self, *, page_bytes: int = PAGE_BYTES, keep_rounds: int = 2,
                 telemetry=NULL_TELEMETRY):
        if page_bytes <= 0:
            raise ValueError(f"page_bytes must be > 0, got {page_bytes}")
        if keep_rounds < 1:
            raise ValueError(f"keep_rounds must be >= 1, got {keep_rounds}")
        self.page_bytes = int(page_bytes)
        self.keep_rounds = int(keep_rounds)
        self.telemetry = telemetry
        # (round, rung) -> (payload, pages); insertion-ordered
        self._entries: Dict[Tuple[int, str], Tuple[Any, List[np.ndarray]]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_served = 0.0
        self.peak_pages = 0

    @property
    def n_pages(self) -> int:
        return sum(len(pages) for _, pages in self._entries.values())

    def serve(self, rnd: int, rung: str, encode_fn) -> List[np.ndarray]:
        """Pages of the ``(rnd, rung)`` broadcast; encodes on first use."""
        key = (int(rnd), str(rung))
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            payload = encode_fn()
            ent = (payload, _pack_pages(payload, self.page_bytes))
            self._entries[key] = ent
            self._evict(int(rnd))
            self.peak_pages = max(self.peak_pages, self.n_pages)
            if self.telemetry:
                self.telemetry.counter("broadcast.cache_miss")
        else:
            self.hits += 1
            if self.telemetry:
                self.telemetry.counter("broadcast.cache_hit")
        self.bytes_served += float(sum(p.nbytes for p in ent[1]))
        return ent[1]

    def payload_for(self, rnd: int, rung: str):
        """The cached payload behind a served key (what a client decodes),
        or None when the key was never encoded or was evicted."""
        ent = self._entries.get((int(rnd), str(rung)))
        return ent[0] if ent is not None else None

    def _evict(self, current_rnd: int) -> None:
        horizon = current_rnd - self.keep_rounds
        for key in [k for k in self._entries if k[0] <= horizon]:
            del self._entries[key]
            self.evictions += 1

    @property
    def stats(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "resident_pages": self.n_pages,
                "peak_pages": self.peak_pages,
                "bytes_served": self.bytes_served}


def serve_broadcast(tree, rungs: List[str], clients: int, rounds: int,
                    page_bytes: int = PAGE_BYTES, seed: int = 0,
                    log=print) -> Tuple[PagedBroadcastCache, List[float]]:
    """Serve ``tree`` (fp32 leaves, on any device) to a cohort of
    ``clients``, each on a rung of ``rungs`` drawn from ``seed``, for
    ``rounds`` rounds through one ``PagedBroadcastCache``.  Returns the
    cache and each round's wall seconds (ending after the round's encodes
    synchronized the device)."""
    codecs = {r: make_codec(r) for r in rungs}
    rng = np.random.default_rng(seed)
    client_rung = [rungs[i] for i in rng.integers(0, len(rungs), clients)]
    cache = PagedBroadcastCache(page_bytes=page_bytes)
    dev = tree_leaves(tree)[0].device
    walls = []
    for rnd in range(1, rounds + 1):
        t0 = time.perf_counter()
        m0 = cache.misses
        for rung in client_rung:
            cache.serve(rnd, rung, lambda rung=rung: codecs[rung].encode(tree))
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        log(f"round {rnd}: served {clients} clients, "
            f"{cache.misses - m0} encodes, {cache.n_pages} resident pages, "
            f"{walls[-1]:.3f}s")
    return cache, walls


def broadcast_main(args) -> PagedBroadcastCache:
    """The paged broadcast cache on ``--arch``'s smoke model (fp32 leaves,
    a random init on ``--device`` from ``--seed``): a mixed-rung cohort is
    served the global model each round; encodes happen once per (round,
    rung), everyone else hits pages."""
    dev = resolve_device(args.device)
    params = T.init_params(get_smoke_config(args.arch), args.seed, dev)
    tree = tree_map(lambda p: p.to(torch.float32), params)
    rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]
    cache, _ = serve_broadcast(tree, rungs, args.clients, args.rounds,
                               page_bytes=args.page_bytes)
    s = cache.stats
    total = s["hits"] + s["misses"]
    print(f"cache: {s['hits']:.0f}/{total:.0f} hits "
          f"({100 * s['hits'] / max(total, 1):.1f}%), "
          f"{s['misses']:.0f} encodes, {s['evictions']:.0f} evictions, "
          f"peak {s['peak_pages']:.0f} pages, "
          f"{s['bytes_served'] / 1e6:.1f} MB served")
    return cache


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
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--rungs", default="int8,qsgd:4,sign1")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--page-bytes", type=int, default=PAGE_BYTES)
    args = ap.parse_args(argv)

    if args.mode == "broadcast":
        return broadcast_main(args)
    smoke = args.smoke_scale.lower() in ("1", "true", "yes")
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    B = args.batch
    enc = None
    if cfg.encoder_decoder:
        enc = torch.randn((B, args.prompt_len, cfg.d_model), generator=gen,
                          device=dev).to(T.torch_dtype(cfg))
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=gen, device=dev)
    res = generate(params, cfg, prompts, args.decode_steps, args.cache_len,
                   temperature=args.temperature, generator=gen,
                   encoder_embeds=enc)
    print(f"arch={cfg.name} B={B} prefill({args.prompt_len} tok)="
          f"{res['prefill_s']:.2f}s decode={args.decode_steps} steps "
          f"{res['decode_s']:.2f}s -> {res['tok_s']:,.1f} tok/s")
    print("sample:", res["tokens"][0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
