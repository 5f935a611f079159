"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit, TF32 switched off for matmul and cuDNN;
2. build: nvcc for sm_90a, one compile per source started together, with
   the ptxas register/shared-memory/spill lines;
3. kernels: every aggregation kernel against its plain PyTorch version on
   the card, over M in {1, 3, 22, 64} and P in {1, 100, 4097, 2359296,
   11223140}, then timed at M=22 against its plain version, its bytes bound
   and (where one PyTorch call computes the same function) that call, with
   the device time per call (``device_ms``) beside the events time;
3b. topk kernels: ``ops.topk_fedagg`` bitwise against its plain version on
   the card at M=22, k=235,930, n=2,359,296 (ResNet-18's widest leaf at
   top-10%, rows overlapping, β from 1e-3 to 5) and on its edges
   (``TOPK_EDGES``: M=1, k=1, n off the tile, a row touching n-1, k=n,
   300 rows, an unsorted row, indices outside [0, n)); the flush entry
   ``ops.topk_fedagg_into`` bitwise on each of them, on ResNet-18-GN's 76
   leaves from ``TopKCodec`` payloads at M=5 and 20, on a flush with an
   unsorted row and an out-of-range index in two leaves, and at M=300; then
   the one-leaf entry timed in turns with the ``index_add_`` sequence beside
   its plain version and bound, the flush entry's host time, and the whole
   ``StreamAccumulator`` top-k flush at M=5 and 20 (``flush_timing``: wall,
   events, device elapsed, device operations per flush);
4. attention kernels: flash_attention and decode_attention against their
   plain versions on the card (qwen3-1.7b's heads at S up to 32768, a
   windowed, an odd-S and an fp32 case, the bf16 flash kernel's tiling
   edges, zamba2-1.2b's shape, gemma-7b's hd 256, the padded head dims
   8, 16, 24, 48, 96 and 136, the other dense configs' forward and
   serve shapes, starcoder2-7b's S=16,384 in blocks of query rows, and
   ``[zoo]``'s forward and serve shapes: mixtral-8x22b (48/8, window
   4096), llava-next-mistral-7b (32/8, window 4096), seamless-m4t-large-v2's
   non-causal encoder and causal decoder (16/16, hd 64);
   ``attention_error`` gives the tolerance), then
   timed against their plain versions, their bounds and
   ``F.scaled_dot_product_attention`` (each kernel and SDPA in turns), at
   qwen3-1.7b's and gemma-7b's shapes;
5. federated round: the synchronous FedAuto round on full-width
   ResNet-18-GN (CIFAR-100 shapes, 20 clients, mixed failures): FedAvg 2
   rounds, FedAuto 2 rounds (fp32 streaming), FedAuto 1 round with int8
   uploads and FedAuto 1 round with the materializing path, with the launch
   counters of every kernel read around the runs, then one FedAuto round
   timed and profiled (kernel time, busy share, top kernels); then
   ``[strategies]``: the paper's baselines (FedProx, SCAFFOLD, FedLAW,
   TF-Aggregation, FedAWE, centralized) and FedAuto's three Table-5
   ablations 2 rounds each on the same problem, FedProx 1 round with int8
   uploads, each held to the launch counts its code implies
   (``expected_launches``), SCAFFOLD's and FedLAW's rounds profiled; the
   aggregation kernels are also checked on the strategies' inputs
   (``STRATEGY_INPUTS``: unnormalised weights, signed 1e-3 deltas);
   ``[codecs]``: FedAuto on the same problem with qsgd:4, sign1 and
   topk:0.1 uploads (1 round each, streaming), an int8 downlink (2 rounds,
   the fp32 enrollment then one compressed broadcast) and topk:0.1 on the
   materializing path, held to ``expected_launches``, and
   ``aggregate_quantized`` on 20 qsgd:4 payloads against decode-then-sum;
   ``[broadcast]``: ``launch/serve.py``'s paged broadcast cache serving the
   full-width global model to 1,024 clients over int8, qsgd:4, sign1 and
   topk:0.1 for 3 rounds (4 encodes, 1,020 hits a round), then
   ``serve.main(["--mode", "broadcast"])`` on the smoke model;
   ``[async]``: the same problem under ``scenario:diurnal`` (tau_max 4,
   buffer_k 4, the deadline ``choose_async_deadline`` finds on the host):
   sync FedAuto, async and buffered FedAuto-Async 4 rounds each, FedAsync
   and FedBuff 3 rounds each, one materializing FedAuto-Async round, each
   held to the launches its reductions imply (``ReductionLedger``);
   ``[adaptive]``: FedAuto and FedAuto-Async (async) under
   ``adaptive:sign1-fp32``, 3 rounds each, with the rungs of every round
   and an fp32 or fp16 and a quantized flush in one round; ``[replay]``:
   the async run's trace replayed (the realization exactly equal), then
   with ``cudnn.deterministic`` a recorded run replayed twice, the
   realization exactly equal and the params within 1e-4; ``[telemetry]``:
   run telemetry (``FFTConfig.telemetry``) on the same problem, sync
   FedAuto (fp32, ``mixed``), async FedAuto-Async (``[async]``'s world)
   and sync FedAuto under ``adaptive:sign1-fp32``, 3 rounds each with
   telemetry off, ``"full"`` (NDJSON log, Chrome trace, health) and
   ``"sketch"`` in turns under ``cudnn.deterministic``: params bitwise
   equal and launches equal across the modes (and ``expected_launches``),
   ``reconcile`` and ``verify_trace`` passing, each full run's phase table
   per round and the round walls of the three modes; ``[population]``:
   ``simulate_population`` over 100,000 clients (host work);
6. agreement: small runs of FedAuto, every baseline and every ablation,
   FedAuto with qsgd:4, sign1 and topk:0.1 uploads and an int8 downlink,
   FedAuto under ``adaptive:sign1-fp32``, and async FedAuto-Async and
   FedBuff and buffered FedAuto-Async under ``scenario:diurnal``, on the
   card against the same runs on the CPU (plain versions), params within
   1e-4 (the lossy codecs: ``quantized_agreement``, a few elements up to
   one quantization step apart), participants and staleness equal; then
   ``telemetry_toy_agreement``: the async toy (FedAuto-Async, fp32) and
   sync FedAuto under ``adaptive:sign1-fp32`` with ``telemetry="full"``,
   outcomes, resolutions, rungs, bytes, participants and counters equal,
   β within 1e-5, distortions within 1e-3·|d| + 1e-6;
7. serve: ``launch/serve.py``'s ``generate`` on full-width qwen3-1.7b (28
   layers, random init from a seed), B=4, prompt 64, decode 32, cache 256,
   with exactly 96 x 28 decode_attention launches, then a few decode steps
   profiled; then ``[serve-long]``: 16 greedy decode steps from a
   32,768-slot cache (every layer's K/V filled from a seeded generator,
   30,001 valid slots), with exactly 16 x 28 decode_attention launches,
   and 4 steps profiled;
8. forward: ``models/transformer.py``'s ``forward`` on full-width
   qwen3-1.7b at B=4, S=4096 on ``data/tokens.py`` batches, with exactly 28
   flash_attention launches and a loss near ln(151936) at init, then
   profiled; ``[dense]``: codeqwen1.5-7b, starcoder2-7b, gemma-7b (hd 256)
   and paper-vit-b16 at full width in bf16, one at a time: serve (B=4,
   prompt 64, 32 greedy steps, 256 slots) and score (B=4 x S=4096;
   paper-vit-b16 B=64 x S=197), starcoder2-7b also at B=1 x S=16,384 and 16
   decode steps from a wrapped 4,096-slot ring, each with one
   flash_attention launch per layer a forward and one decode_attention
   launch per layer a step, each forward's loss within 0.05 of its
   prediction from the hidden states (``init_loss_prediction``) and its
   first tokens' hidden states as close to the same forward with the
   plain attention as twice the distance that rounding P to bf16 in the
   plain attention puts between them; ``[zoo]``: mixtral-8x22b (MoE, 8 of
   56 layers) and deepseek-v2-236b (MLA and MoE, its dense layer and 5 MoE
   layers) at published width and expert count, seamless-m4t-large-v2
   (encoder-decoder) and llava-next-mistral-7b (VLM prefix) as published,
   in bf16, one at a time: serve as ``[dense]`` (seamless with 64 encoder
   frames) and score (B=4 x S=4096: llava 1,152 image embeddings and 2,944
   tokens, seamless 4,096 frames and tokens), each with its launch counts
   (``zoo_launches``: none for deepseek's MLA), the MoE read-backs (one per
   MoE layer a forward or step), and its ``ce_loss`` within 0.05 of its
   prediction from the hidden states;
9. LLM agreement: the smoke configs of qwen3-1.7b, zamba2-1.2b, the
   four dense configs and the four ``[zoo]`` configs in fp32 on the card
   against the CPU (forward loss and decode logits within 1e-4,
   starcoder2's hd 24 and gemma's hd 48 on the padded kernels;
   ``llm_agreement``, which ``tests/test_torch_kernels_gpu.py`` runs
   too);
9b. the LLM training path: ``[flash-bwd]``, the backward kernels of
   ``csrc/attention_bwd.cu`` against the plain backward and the forward
   kernel's lse against the plain one (``FLASH_BWD_CHECKS``: the train
   shape, qwen3's forward shape, a window, an odd S, g = 1 at hd 64,
   Sq < Sk, rows with no valid key in fp32 and bf16, hd 32 in fp32 and
   bf16, ``[fft-lora-llm]``'s S=64, hd 256 in both dtypes causal and
   windowed with GQA, the LoRA-LLM shapes of ``[fft-lora-llm-dense]``
   (codeqwen1.5-7b's g = 1, starcoder2-7b's g = 9 windowed, gemma-7b's hd
   256), the padded head dims 8, 24, 48, 136 and 200), each repeated
   bitwise, then timed
   against the plain backward, the bound and SDPA's backward, and forward
   + backward against SDPA's, in turns, with each call's device time
   (``device_elapsed``) and the profiler's split over its kernels;
   ``[train]``,
   ``launch/train.py`` on full-width qwen3-1.7b, B=8 x S=256, 30 AdamW
   steps (the loss falls), exactly 56 flash_attention and 28
   flash_attention_bwd launches a step, its checkpoint loaded back
   bitwise, then step wall, tok/s and peak memory with remat on and off,
   one step profiled, and once more with each layer's leaves selected
   t[i] (the launches the one unbind saves); ``[fft-round]``,
   ``fl/parallel.py``'s round at full width, K=4, b=2, S=256, one β at 0
   (bitwise blind to that client's tokens); ``[fft-lora-llm]``,
   ``launch/fft_lora_llm.py`` at full width for 3 rounds, exactly 4
   fedagg launches a round, the frozen base bitwise unchanged;
   ``[fft-lora-llm-dense]``, the same loop on full-width codeqwen1.5-7b,
   starcoder2-7b and gemma-7b (hd 256), 2 rounds each, with exactly 4
   fedagg launches a round and one flash_attention_bwd launch per layer
   and local step of every model trained, the base bitwise unchanged,
   round walls and peak memory; ``[xlstm]``, full-width xlstm-125m (no
   kernel: its mLSTM and sLSTM blocks are loops over time in plain
   PyTorch) trained 4 AdamW steps at B=8 x S=256, served (B=4, prompt
   64, 32 greedy steps) and scored (B=4 x S=1024), each with its wall and
   peak memory, and its kernel launches a step profiled; ``[scan-bwd]``,
   the forward with its states and the backward kernels of
   ``csrc/selective_scan_bwd.cu`` given them, as the main path calls them,
   against the plain versions (``SCAN_BWD_CHECKS``: zamba2-1.2b's train
   shape, B=4 x S=4096, n 16 and 128, S and dh off the tiles, the JAX
   test's shapes, a single step, dh 192 at H = 1), each backward repeated
   bitwise, in the no-decay and underflow regimes against the fp64 plain
   backward, then timed against the plain backward and the bound at the
   train and the forward's layer shape, with the forward with and without
   its states output;
   ``[zoo-train]``, zamba2-1.2b's ``launch/train.py`` loop (38 layers,
   B=8 x S=256, 4 steps, 64 scans and 32 scan backwards a step, a step
   profiled), seamless-m4t-large-v2 AdamW steps with 256 encoder frames,
   deepseek-v2-236b at its dense layer and 1 MoE layer (160 experts) one
   value_and_grad and SGD step with 2 read-backs, and LoRA-LLM rounds on
   mixtral-8x22b (8 layers) and llava-next-mistral-7b, each with its
   launch counts, walls and peak memory; ``[train agreement]``,
   the smoke configs of qwen3-1.7b, gemma-7b (hd 48), starcoder2-7b (hd
   24, windowed), xlstm-125m, zamba2-1.2b (step by step), mixtral-8x22b,
   deepseek-v2-236b, seamless-m4t-large-v2 and llava-next-mistral-7b in
   fp32, 5 AdamW steps and 2 LoRA-LLM rounds (none for deepseek and
   seamless) on the card against the CPU, every leaf within 1e-4, the
   params where no step's gradient was near AdamW's eps, the MoE routing
   margins held (``train_agreement``, which the ``gpu`` tests run too);
10. lora kernel: ``ops.lora_matmul`` against its plain version in fp32 on
   the card (``tests/test_kernels.py``'s shapes in fp32 and bf16, the ViT
   ``qkv`` of phase 11, qwen3-1.7b's ``wq`` and ``wv`` at B=4 x S=4096 in
   bf16 at rank 4, 8 and 64, and the bf16 kernel's edges on both its TMA
   and its cp.async route; ``lora_error`` gives the tolerance), then timed
   in turns with cuBLAS ``x @ W`` alone and the three-call
   ``torch.addmm(x @ W, x @ A, B, alpha=s)``, against its plain version and
   its bound, with the device time per call of all three;
11. LoRA rounds: Table 4 (``benchmarks/bench_table4.py``) at full size:
   the registered ViT with rank-8 adapters on ``qkv``, 20 clients, mixed
   failures, FedAvg, FedEx-LoRA and FedAuto 2 rounds each and FedProx,
   SCAFFOLD, FedLAW, FedAWE and centralized training 1 round each, with the
   exact launch counts of ``float_fedagg``, ``fedagg`` and ``lora_matmul``
   and the frozen base checked after each;
12. lora entry point: ``repro_torch.fl.lora.lora_matmul`` on each of the six
   ``qkv/w`` layers that the FedAuto run leaves, against ``x @ W_eff`` of
   the merged layer, with exactly 6 launches;
13. LoRA agreement: a small LoRA run (ViT at image 8, rank 4, FedEx-LoRA and
   FedAuto, 2 rounds) on the card against the same run on the CPU, adapters
   and base within 1e-4;
14. ssm kernel: ``ops.selective_scan`` against the sequential plain version
   on the card (``tests/test_kernels.py``'s three cases, one zamba2-1.2b
   layer at B=4 x S=4096 and the kernel's tiling edges), within
   2e-4 (1 + |want|), and in two decay regimes (none, underflowing)
   against the exact recurrence in fp64; then timed against the chunked
   plain version and its bound; flash_attention and decode_attention at
   zamba2's heads (hd 64, H = KV = 32);
15. ssm forward: ``forward`` on full-width zamba2-1.2b (38 layers: 32 Mamba2,
   6 shared attention) at B=4, S=4096 on ``data/tokens.py`` batches, with
   exactly 32 selective_scan and 6 flash_attention launches and a loss near
   ln(32000) at init, then profiled;
16. ssm serve: ``generate`` on full-width zamba2-1.2b, B=4, prompt 64,
   decode 32, cache 256, with exactly 96 x 6 decode_attention launches and
   no selective_scan, then a few decode steps profiled;
17. ssm agreement: zamba2-1.2b-smoke in fp32 on the card against the CPU
   (forward loss and hidden states within 1e-4, identical greedy tokens;
   ``ssm_agreement``, which ``tests/test_torch_kernels_gpu.py`` runs too);
18. dist: the mesh paths, each rank a process (``phase_dist``):
   ``decode_attention_partial`` against its plain version and timed in
   turns with its plain version and ATen's memory-efficient attention;
   mixtral-8x22b's MoE layer at published width on 4 gloo ranks sharing
   the card, expert-parallel (8 experts) and virtual experts (2), and on
   one NCCL rank, each against the local path; starcoder2-7b's attention
   at 2 layers decoding 16 steps from a wrapped 4,096-slot ring
   sequence-sharded over 8 gloo ranks against the replicated decode, with
   exactly 16 x 2 ``decode_attention_partial`` launches on every rank.

Every time is the median and quartiles of CUDA-event samples
(``cuda_times``).  The last two lines are a JSON object with one entry per
kernel and the JSON result line ``{"ok": true, "device": {...}}``.  Exits
non-zero (and prints no result) without CUDA or outside a checkout of the
repository.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/fedagg.cu"
ATTN_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
LORA_SOURCE = "src/repro_torch/kernels/csrc/lora_matmul.cu"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
FP32_FLOP_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
BF16_FLOP_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
M_SWEEP = (1, 3, 22, 64)
P_SWEEP = (1, 100, 4097, 2_359_296, 11_223_140)
P_TIMED = (2_359_296, 11_223_140)   # widest ResNet-18 leaf; whole model
M_TIMED = 22

# (wrapper, input dtype, output dtype, TPU kernel it replaces)
CASES = [
    ("float_fedagg", torch.float32, torch.float32,
     "src/repro/kernels/dequant_agg.py:94"),
    ("float_fedagg", torch.float16, torch.float32,
     "src/repro/kernels/dequant_agg.py:94"),
    ("dequant_fedagg", torch.int8, torch.float32,
     "src/repro/kernels/dequant_agg.py:84"),
    ("fedagg", torch.float32, torch.float32, "src/repro/kernels/fedagg.py:36"),
    ("fedagg", torch.bfloat16, torch.bfloat16, "src/repro/kernels/fedagg.py:36"),
]
MAIN_DTYPE = {"float_fedagg": torch.float32, "dequant_fedagg": torch.int8,
              "fedagg": torch.float32}


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def tolerance(out_dtype):
    # fp32 out: the fold and the kernel's FMA chain round differently;
    # bf16 out: one bf16 rounding of the fp32 sum (as tests/test_kernels.py)
    return (2e-2, 2e-2) if out_dtype == torch.bfloat16 else (1e-5, 1e-6)


def make_inputs(dtype, M, P, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (M, P), generator=g, device="cuda",
                          dtype=torch.int8)
    else:
        x = torch.randn((M, P), generator=g, device="cuda").to(dtype)
    betas = torch.softmax(torch.randn((M,), generator=g, device="cuda"), 0)
    scales = torch.rand((M,), generator=g, device="cuda") * 0.01 + 1e-3
    return x, scales, betas


# the strategies' inputs to fedagg and float_fedagg (fp32): TF-Aggregation's
# weights p_i / (s_i (1 - eps_i)) / K are not normalised, SCAFFOLD reduces
# signed deltas of about 1e-3 with weights 1/n; M in {4, 20} at ResNet-18's
# widest leaf
STRATEGY_INPUTS = [(kind, M) for kind in ("tf_weights", "scaffold_deltas")
                   for M in (4, 20)]
STRATEGY_P = 2_359_296


def strategy_inputs(kind, M, P, seed, device="cuda"):
    """(x, betas) of a strategy's reduction.  ``tf_weights``: unit-normal
    rows and weights spaced geometrically from 1e-3 to 5 in a random order
    (Σβ 5.31 at M=4, 13.8 at M=20); ``scaffold_deltas``: rows of signed
    deltas of scale 1e-3 and the uniform weights 1/M."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "tf_weights":
        x = torch.randn((M, P), generator=g, device=device)
        b = torch.logspace(-3.0, float(np.log10(5.0)), M, device=device)
        b = b[torch.randperm(M, generator=g, device=device)]
    else:
        x = 1e-3 * torch.randn((M, P), generator=g, device=device)
        b = torch.full((M,), 1.0 / M, device=device)
    return x, b


def strategy_tolerance(x, b):
    """rtol 1e-5 and atol 1e-6 · Σ|β| · max|x|: the fold and the kernel's FMA
    chain round differently, by an amount that scales with the terms."""
    return 1e-5, 1e-6 * float(b.abs().sum()) * float(x.abs().max())


def call(ops_or_ref, name, x, scales, betas):
    if name == "dequant_fedagg":
        return ops_or_ref.dequant_fedagg(x, scales, betas)
    return getattr(ops_or_ref, name)(x, betas)


class Ms(float):
    """A time in ms per launch: the median of CUDA-event samples (the float's
    value), carrying the first and third quartile.  Formats as
    "median [q1, q3]", so every timing line prints all three."""

    def __new__(cls, samples):
        q1, med, q3 = np.percentile(samples, [25, 50, 75])
        t = super().__new__(cls, med)
        t.q1, t.q3 = float(q1), float(q3)
        return t

    def __format__(self, spec):
        return f"{float(self):{spec}} [{self.q1:{spec}}, {self.q3:{spec}}]"


def cuda_times(fns, iters, rounds=3):
    """One ``Ms`` per function of ``fns``: after a warm-up, ``rounds`` rounds
    each time every function's loop of ``iters`` launches by CUDA events,
    in turns forward and back (a, b, b, a), so each function gets
    2 * rounds samples and two versions are compared on the same card in
    the same minutes."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    samples = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            start.record()
            for _ in range(iters):
                fns[i]()
            end.record()
            torch.cuda.synchronize()
            samples[i].append(start.elapsed_time(end) / iters)
    return [Ms(s) for s in samples]


def cuda_ms(fn, iters):
    return cuda_times([fn], iters)[0]


def timing(ms, plain_ms, bound_ms, bound_by, library_ms):
    """A kernel's entry of the ``kernels`` JSON line: the medians under the
    contract's keys, each measured median beside its quartiles."""
    out = dict(ms=float(ms), ms_q1=ms.q1, ms_q3=ms.q3, plain_ms=float(plain_ms),
               plain_ms_q1=plain_ms.q1, plain_ms_q3=plain_ms.q3,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    if library_ms is not None:
        out.update(library_ms=float(library_ms), library_ms_q1=library_ms.q1,
                   library_ms_q3=library_ms.q3)
    return out


def bound(name, in_dtype, out_dtype, M, P):
    isz = torch.empty((), dtype=in_dtype).element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    vectors = 8 * M if name == "dequant_fedagg" else 4 * M
    nbytes = M * P * isz + P * osz + vectors
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * P / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_card():
    print(f"[card] {nvidia_smi()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build():
    from repro_torch.kernels import build
    info = build.build(force=True)
    build.load()
    print(f"[build] nvcc {' '.join(build.ARCH_FLAGS)}, "
          f"{len(info.ptxas)} sources in parallel + link: {info.seconds:.2f} s "
          f"-> {os.path.relpath(info.path, ROOT)}")
    for src, report in info.ptxas.items():
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                print(f"[build] {src}: {line.strip()}")


def phase_kernels():
    from repro_torch.kernels import ops, ref
    errs = {}
    for ci, (name, dt, odt, _) in enumerate(CASES):
        rtol, atol = tolerance(odt)
        for M in M_SWEEP:
            for P in P_SWEEP:
                x, s, b = make_inputs(dt, M, P, seed=1000 * ci + 10 * M + P % 7)
                got = call(ops, name, x, s, b)
                want = call(ref, name, x, s, b)
                torch.cuda.synchronize()
                assert got.dtype == odt and got.shape == (P,), (got.dtype, got.shape)
                err = (got.float() - want.float()).abs()
                bad = err > atol + rtol * want.float().abs()
                max_err = float(err.max())
                errs[(name, dt)] = max(errs.get((name, dt), 0.0), max_err)
                print(f"[kernel] {name:14s} {str(dt)[6:]:8s} M={M:2d} P={P:9d} "
                      f"max_abs_err={max_err:.3e} "
                      f"{'FAIL' if bool(bad.any()) else 'ok'}")
                if bool(bad.any()):
                    raise AssertionError(f"{name} {dt} M={M} P={P} disagrees "
                                         f"with its plain version")
                del x, got, want, err, bad
    for si, (kind, M) in enumerate(STRATEGY_INPUTS):
        x, b = strategy_inputs(kind, M, STRATEGY_P, seed=500 + si)
        rtol, atol = strategy_tolerance(x, b)
        for name in ("fedagg", "float_fedagg"):
            got, want = getattr(ops, name)(x, b), getattr(ref, name)(x, b)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == (STRATEGY_P,)
            err = (got - want).abs()
            bad = bool((err > atol + rtol * want.abs()).any())
            print(f"[kernel] {name:14s} {kind} M={M:2d} P={STRATEGY_P} "
                  f"sum_beta={float(b.sum()):.4f} max_abs_err={float(err.max()):.3e}"
                  f" atol={atol:.3e} {'FAIL' if bad else 'ok'}")
            assert not bad, f"{name} {kind} M={M} disagrees with its plain version"
        del x, got, want, err
    torch.cuda.empty_cache()

    timings = {}
    for ci, (name, dt, odt, _) in enumerate(CASES):
        for P in P_TIMED:
            x, s, b = make_inputs(dt, M_TIMED, P, seed=7 + ci)
            k_ms = cuda_ms(lambda: call(ops, name, x, s, b), 50)
            p_ms = cuda_ms(lambda: call(ref, name, x, s, b), 20)
            lib_ms = None
            if dt == torch.float32:      # Σ_m β_m x[m] in one PyTorch call
                lib_ms = cuda_ms(lambda: b @ x, 50)
            dev = device_ms(lambda: call(ops, name, x, s, b))
            b_ms, b_by = bound(name, dt, odt, M_TIMED, P)
            timings[(name, dt, P)] = dict(
                timing(k_ms, p_ms, b_ms, b_by, lib_ms), device_ms=dev)
            lib = f"{lib_ms:.4f}" if lib_ms is not None else "null"
            dev_share = f"{b_ms / dev:.3f}" if dev else "not measured"
            print(f"[time] {name:14s} {str(dt)[6:]:8s} M={M_TIMED} P={P:9d} "
                  f"kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"share_of_bound={b_ms / k_ms:.3f} plain_ms={p_ms:.4f} "
                  f"library_ms={lib} device_ms(profiler)={dev} "
                  f"device_share_of_bound={dev_share}")
            del x
    torch.cuda.empty_cache()
    return errs, timings


# ---------------------------------------------------------------------------
# topk_fedagg
# ---------------------------------------------------------------------------
TOPK_SOURCE = "src/repro_torch/kernels/csrc/topk_fedagg.cu"
# the row-8 shape: M=22 participants at ResNet-18's widest leaf, top-10%
TOPK_SHAPE = (22, 235_930, 2_359_296)
# (label, M, k, n, kind): the kernel's edges; kind "sorted" (what TopKCodec
# sends), "dense" (k = n), "unsorted" (one row shuffled: summed by a whole-row
# scan), "out_of_range" (an index past n and one below 0 in a row: dropped)
TOPK_EDGES = [("M=1 k=1 n=1", 1, 1, 1, "sorted"),
              ("M=1 k=1 touches n-1", 1, 1, 5, "last"),
              ("M=5 k=1 overlapping", 5, 1, 3, "sorted"),
              ("n not a multiple of the tile", 5, 2000, 3 * 2048 + 77, "last"),
              ("k = n", 3, 10_000, 10_000, "dense"),
              ("300 rows (ten row chunks)", 300, 50, 5000, "sorted"),
              ("an unsorted row", 4, 5000, 50_000, "unsorted"),
              ("indices outside [0, n)", 3, 100, 10_000, "out_of_range")]


def topk_inputs(M, k, n, seed, kind="sorted", device="cuda"):
    """(idx, vals, betas) of ``topk_fedagg``: each row k distinct indices
    drawn from [0, n) (rows overlap wherever their draws meet), sorted
    ascending unless ``kind`` says otherwise, unit-normal values, and
    STRATEGY_INPUTS' weights: geometric from 1e-3 to 5 in a random order."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "dense":
        idx = torch.arange(n, device=device).repeat(M, 1)
    else:
        idx = torch.stack([torch.randperm(n, generator=g, device=device)[:k]
                           for _ in range(M)])
        if kind == "last" and not bool((idx[0] == n - 1).any()):
            idx[0, 0] = n - 1
        idx = idx.sort(dim=1).values
        if kind == "unsorted":
            idx[M // 2] = idx[M // 2][torch.randperm(k, generator=g, device=device)]
        if kind == "out_of_range":
            idx[1, -1], idx[1, 0] = n + 5, -3
    vals = torch.randn((M, k), generator=g, device=device)
    b = torch.logspace(-3.0, float(np.log10(5.0)), M, device=device)
    b = b[torch.randperm(M, generator=g, device=device)]
    return idx.to(torch.int32).contiguous(), vals, b


def topk_plain(idx, vals, b, n):
    """The plain version; entries outside [0, n) dropped, as on the card."""
    from repro_torch.kernels import ref
    keep = (idx >= 0) & (idx < n)
    if bool(keep.all()):
        return ref.topk_fedagg(idx, vals, b, n)
    out = torch.zeros(n, dtype=torch.float32, device=idx.device)
    for m in range(idx.shape[0]):
        out.index_add_(0, idx[m][keep[m]].long(), b[m] * vals[m][keep[m]])
    return out


def topk_bound(M, k, n):
    """Each (index, value) pair read once, β read once, out written once."""
    return (8.0 * M * k + 4.0 * n + 4.0 * M) / HBM_BYTES_PER_S * 1e3, "bytes"


def topk_flush_bounds(M, ks, ns):
    """A flush into an accumulator: each pair read once, the accumulator
    read and written once (the bound); and the floor of the two-pass design,
    which reads the indices once more."""
    k, n = float(sum(ks)), float(sum(ns))
    return ((8.0 * M * k + 8.0 * n) / HBM_BYTES_PER_S * 1e3,
            (12.0 * M * k + 8.0 * n) / HBM_BYTES_PER_S * 1e3)


def resnet18_template(device="cuda"):
    """ResNet-18-GN's parameters for CIFAR-100 from a seed, as the main path
    builds them: 76 leaves, 11,223,140 parameters."""
    from repro_torch.models.vision import make_model
    return make_model("resnet18", 100, 32, 3, device=device)[0](0)


def topk_payloads(template, M, seed, spec="topk:0.1"):
    """M ``TopKCodec`` payloads of unit-normal trees shaped like
    ``template`` and their β (``topk_inputs``' weights) as floats."""
    from repro_torch.fl.comm import make_codec
    from repro_torch.tree import tree_leaves, tree_map
    device = tree_leaves(template)[0].device
    g = torch.Generator(device=device).manual_seed(seed)
    codec = make_codec(spec)
    pays = [codec.encode(tree_map(
        lambda l: torch.randn(l.shape, generator=g, device=device), template))
        for _ in range(M)]
    b = torch.logspace(-3.0, float(np.log10(5.0)), M, device=device)
    return pays, b[torch.randperm(M, generator=g, device=device)].tolist()


def payload_rows(pays):
    """``topk_fedagg_into``'s rows of top-k payloads, where they lie."""
    return ([[el.data["idx"] for el in p.leaves] for p in pays],
            [[el.data["val"] for el in p.leaves] for p in pays])


def topk_flush_inputs(ns, M, seed, faults=(), frac=0.1, device="cuda"):
    """(idx_rows, val_rows, betas) of ``topk_fedagg_into`` over leaves of
    sizes ``ns``: leaf l's rows are views of one ``topk_inputs`` draw of
    ⌈frac·n⌉ pairs (so most rows start off 16 bytes); ``faults`` maps a
    leaf to the kind of its draw ("unsorted", "out_of_range")."""
    faults = dict(faults)
    idx_rows, val_rows = [[] for _ in range(M)], [[] for _ in range(M)]
    for l, n in enumerate(ns):
        k = max(1, int(np.ceil(frac * n)))
        idx, vals, _ = topk_inputs(M, k, n, seed + l, faults.get(l, "sorted"),
                                   device)
        for m in range(M):
            idx_rows[m].append(idx[m])
            val_rows[m].append(vals[m])
    _, _, b = topk_inputs(M, 1, 1, seed - 1, device=device)
    return idx_rows, val_rows, b


def topk_flush_plain(accs, idx_rows, val_rows, b):
    """The flush's plain version: per leaf ``topk_plain`` of the stacked
    rows, then ``acc + part``."""
    return [acc + topk_plain(torch.stack([r[l] for r in idx_rows]),
                             torch.stack([r[l] for r in val_rows]), b,
                             acc.numel())
            for l, acc in enumerate(accs)]


def topk_flush_check(label, ns, idx_rows, val_rows, b, seed):
    """``ops.topk_fedagg_into`` on a unit-normal accumulator with leaves of
    sizes ``ns`` against its plain version: bitwise, one launch count.
    Returns the largest error."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    accs = [torch.randn(n, generator=g, device="cuda") for n in ns]
    want = topk_flush_plain(accs, idx_rows, val_rows, b)
    before = ops.launches["topk_fedagg"]
    ops.topk_fedagg_into(accs, idx_rows, val_rows, b)
    torch.cuda.synchronize()
    n_launch = ops.launches["topk_fedagg"] - before
    same = all(torch.equal(a.view(torch.int32), w.view(torch.int32))
               for a, w in zip(accs, want))
    err = max(float((a - w).abs().max()) for a, w in zip(accs, want))
    M, L = len(idx_rows), len(accs)
    print(f"[kernel] topk_fedagg_into {label}: M={M} leaves={L} "
          f"pairs/row={sum(t.numel() for t in idx_rows[0])} "
          f"launches={n_launch} max_abs_err={err:.3e} "
          f"bitwise={'ok' if same else 'FAIL'}")
    assert n_launch == 1, label
    assert same, f"topk_fedagg_into {label} is not bitwise its plain version"
    return err
def phase_topk():
    """``ops.topk_fedagg`` and ``ops.topk_fedagg_into`` bitwise against
    their plain versions on the card: the one-leaf entry at the row-8 shape
    and on its edges (``TOPK_EDGES``), the flush entry on each of them too
    (a one-leaf flush into a non-zero accumulator), on ResNet-18-GN's 76
    leaves from ``TopKCodec`` payloads at M = 5 and 20, on a flush with an
    unsorted row in one leaf and an index outside [0, n) in another, and at
    M = 300 (ten row chunks); one launch count per call.  Then timed:
    ``topk_timing`` (row 8), the flush entry's host time, and
    ``flush_timing`` at M = 5 and 20."""
    from repro_torch.kernels import ops
    cases = [("row-8 shape", *TOPK_SHAPE, "sorted")] + TOPK_EDGES
    max_err = 0.0
    for i, (label, M, k, n, kind) in enumerate(cases):
        idx, vals, b = topk_inputs(M, k, n, seed=900 + i, kind=kind)
        before = ops.launches["topk_fedagg"]
        got = ops.topk_fedagg(idx, vals, b, n)
        torch.cuda.synchronize()
        want = topk_plain(idx, vals, b, n)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] topk_fedagg    {label}: M={M} k={k} n={n} {kind} "
              f"launches={ops.launches['topk_fedagg'] - before} "
              f"max_abs_err={err:.3e} bitwise={'ok' if same else 'FAIL'}")
        assert ops.launches["topk_fedagg"] == before + 1, label
        assert same, f"topk_fedagg {label} is not bitwise its plain version"
        max_err = max(max_err, topk_flush_check(
            label, [n], [[idx[m]] for m in range(M)],
            [[vals[m]] for m in range(M)], b, seed=950 + i))
        del idx, vals, b, got, want
    template = resnet18_template()
    ns = [l.numel() for l in _leaves(template)]
    for M in (5, 20):
        pays, betas = topk_payloads(template, M, seed=31 + M)
        max_err = max(max_err, topk_flush_check(
            f"ResNet-18-GN topk:0.1 payloads", ns, *payload_rows(pays),
            torch.tensor(betas, device="cuda"), seed=M))
        del pays
    max_err = max(max_err, topk_flush_check(
        "76 leaves, an unsorted row in leaf 3, indices outside [0, n) in "
        "leaf 40", ns, *topk_flush_inputs(ns, 5, seed=60,
                                          faults={3: "unsorted",
                                                  40: "out_of_range"}),
        seed=61))
    max_err = max(max_err, topk_flush_check(
        "M=300 (row chunks)", TOPK_CHUNKED, *topk_flush_inputs(
            TOPK_CHUNKED, 300, seed=70), seed=71))
    timing_ = topk_timing()
    for M in (5, 20):
        entry_host_ms(template, M)
    flush = {M: flush_timing(M, template) for M in (5, 20)}
    torch.cuda.empty_cache()
    return max_err, dict(timing_, flush_m5=flush[5], flush_m20=flush[20])


# leaf sizes of the M = 300 flush: under one tile, across tiles, 50 tiles
TOPK_CHUNKED = (64, 5000, 102_400)


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def topk_timing():
    """``ops.topk_fedagg`` at the row-8 shape, timed in turns with the
    ``index_add_`` sequence (not fold-ordered: on the card its adds are
    atomics), beside its plain version, its bound and the device time of
    both.  Uses only what the parent commits had, so it also times theirs."""
    from repro_torch.kernels import ops, ref
    M, k, n = TOPK_SHAPE
    idx, vals, b = topk_inputs(M, k, n, seed=7)
    flat = idx.flatten()

    def library():
        return torch.zeros(n, device="cuda").index_add_(
            0, flat.long(), (b[:, None] * vals).flatten())

    def kernel():
        return ops.topk_fedagg(idx, vals, b, n)

    k_ms, l_ms = cuda_times([kernel, library], 20)
    p_ms = cuda_ms(lambda: ref.topk_fedagg(idx, vals, b, n), 5)
    dev, parts = device_profile(kernel)
    el = device_elapsed(kernel)
    lib_dev = device_ms(library)
    b_ms, b_by = topk_bound(M, k, n)
    print(f"[time] topk_fedagg    M={M} k={k} n={n}: kernel_ms={k_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / k_ms:.3f} "
          f"plain_ms={p_ms:.4f} library_ms(index_add_ sequence, not "
          f"fold-ordered, in turns)={l_ms:.4f} device_elapsed_ms={el:.4f} "
          f"device_ms(profiler): kernel={dev} library={lib_dev}; per call "
          f"(count, device ms): {json.dumps(parts)}")
    del idx, vals, b, flat
    return dict(timing(k_ms, p_ms, b_ms, b_by, l_ms), device_ms=dev,
                device_elapsed_ms=float(el), library_device_ms=lib_dev)


def entry_host_ms(template, M, calls=50):
    """The host time of one ``ops.topk_fedagg_into`` call on M
    ``TopKCodec`` payloads of ``template`` with a kept plan, as a
    ``StreamAccumulator`` makes it (checks, the row table into a
    fresh pinned buffer, its copy and the launches; the device is not
    waited for), and of the row table's part alone."""
    from repro_torch.kernels import ops
    pays, betas = topk_payloads(template, M, seed=5)
    idx_rows, val_rows = payload_rows(pays)
    accs = [torch.zeros(l.numel(), device="cuda") for l in _leaves(template)]
    b = torch.tensor(betas, device="cuda")
    flat = [t for r in idx_rows for t in r] + [t for r in val_rows for t in r]
    flat += accs
    ptrs = np.fromiter(map(torch.Tensor.data_ptr, flat), np.int64, len(flat))
    dst = ops.topk_row_table(b.device, ptrs)
    plan = ops.TopkPlan()
    entry, table = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.topk_fedagg_into(accs, idx_rows, val_rows, b, plan=plan)
        t1 = time.perf_counter()
        ops.topk_row_table(b.device, ptrs, dst=dst)
        t2 = time.perf_counter()
        entry.append((t1 - t0) * 1e3)
        table.append((t2 - t1) * 1e3)
    torch.cuda.synchronize()
    e_ms, t_ms = Ms(entry), Ms(table)
    print(f"[time] topk_fedagg_into host M={M} ({len(flat)} tensors): "
          f"entry_host_ms={e_ms:.4f} of which row_table_host_ms={t_ms:.4f} "
          f"(pointers gathered, a fresh pinned buffer, one non-blocking copy)")
    return e_ms, t_ms


def flush_timing(M, template, seed=21, calls=20):
    """The whole ``StreamAccumulator`` top-k flush of M ``TopKCodec``
    topk:0.1 payloads of ``template``, host included: M ``add`` calls and
    ``total()``, into one accumulator.  Wall (host clock to a synchronize,
    per flush), CUDA-event time (a loop of flushes), device time and the
    device operations per flush (profiler), launches counted, beside the
    flush bound and the two-pass floor.  Uses only ``make_codec``,
    ``StreamAccumulator.add``/``total`` and ``make_model``, which the parent
    commit has too, so it also times the parent's flush."""
    from repro_torch.fl.comm import StreamAccumulator
    from repro_torch.kernels import ops
    pays, betas = topk_payloads(template, M, seed)
    ns = [l.numel() for l in _leaves(template)]
    ks = [el.data["idx"].numel() for el in pays[0].leaves]
    acc = StreamAccumulator(template)

    def flush():
        for p, bm in zip(pays, betas):
            acc.add(p, bm)
        return acc.total()

    flush()
    torch.cuda.synchronize()
    before = ops.launches["topk_fedagg"]
    flush()
    torch.cuda.synchronize()
    launches = ops.launches["topk_fedagg"] - before
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        flush()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = Ms(walls)
    ev = cuda_ms(flush, 10)
    el = device_elapsed(flush)
    dev, ops_per = device_profile(flush)
    b_ms, floor_ms = topk_flush_bounds(M, ks, ns)
    n_ops = sum(c for c, _ in ops_per.values())
    print(f"[time] topk flush M={M} leaves={len(ns)} sum_k={sum(ks)} "
          f"sum_n={sum(ns)}: wall_ms={wall:.4f} events_ms={ev:.4f} "
          f"device_elapsed_ms={el:.4f} device_ms(profiler)={dev} "
          f"bound_ms={b_ms:.4f} two_pass_floor_ms="
          f"{floor_ms:.4f} share_of_bound(wall)={b_ms / wall:.4f} "
          f"share_of_bound(device_elapsed)={b_ms / el:.4f} "
          f"topk_fedagg_launches={launches} device_ops_per_flush={n_ops:g} "
          f"(per flush: count, device ms) {json.dumps(ops_per)}")
    del pays, acc
    return dict(wall_ms=float(wall), wall_ms_q1=wall.q1, wall_ms_q3=wall.q3,
                events_ms=float(ev), events_ms_q1=ev.q1, events_ms_q3=ev.q3,
                device_elapsed_ms=float(el), device_ms=dev, bound_ms=b_ms,
                launches=launches, device_ops=n_ops)


# ---------------------------------------------------------------------------
def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cifar100_split(n_samples=6000, image_size=32, seed=0):
    from repro_torch.data.synthetic import fft_split, make_dataset, train_test_split
    from repro_torch.fl.partition import partition
    ds = make_dataset(n_samples, n_classes=100, image_size=image_size,
                      channels=3, seed=seed)
    train, test = train_test_split(ds, n_samples // 6, seed=1)
    public, private = fft_split(train, public_per_class=5, seed=seed)
    parts, _ = partition("group_classes", private.y, n_clients=20,
                         n_classes=100, classes_per_group=10, seed=seed)
    assert all(len(p) > 0 for p in parts), [len(p) for p in parts]
    return public, private, test, parts


# the main path's federated problem: FFTConfig fields
MAIN_CONFIG = dict(n_clients=20, k_selected=20, local_steps=5, batch_size=32,
                   lr=0.05, failure_mode="mixed", seed=0, eval_every=1)


def round_timing(codec="topk:0.1", rounds=4, device="cuda"):
    """Round walls (host clock to a synchronize, evaluation included) of
    FedAuto under ``codec`` on the main path's full-width problem from its
    seed, without pretraining: a warm-up round, then ``rounds`` rounds, each
    from the same parameters and failure draw.  Uses only what the parent
    commit has too, so parent and change can be timed in turns."""
    from repro_torch.core.strategies import FedAuto
    from repro_torch.fl.runtime import FFTConfig, FFTRunner
    from repro_torch.kernels import ops
    from repro_torch.models.vision import make_model
    public, private, test, parts = cifar100_split()
    init_fn, apply_fn = make_model("resnet18", 100, 32, 3, device=device)
    r = FFTRunner(FFTConfig(**MAIN_CONFIG, codec=codec), init_fn, apply_fn,
                  public, parts, private, test, device=device)
    g0, walls = r.global_params, []
    for _ in range(rounds + 1):
        r.global_params = g0
        r.rng = np.random.default_rng(42)
        before = dict(ops.launches)
        sync(device)
        t0 = time.perf_counter()
        r.run(FedAuto(), 1)
        sync(device)
        walls.append(time.perf_counter() - t0)
    delta = {k: v - before[k] for k, v in ops.launches.items() if v > before[k]}
    print(f"[time] round FedAuto {codec}: warm-up {walls[0]:.4f} s, then "
          f"round_wall_s={[round(w, 4) for w in walls[1:]]} median "
          f"{float(np.median(walls[1:])):.4f}; participants "
          f"{r.loop.participants_per_round[-1]}, launches of the last {delta}")
    return walls[1:]


def phase_main_path(device="cuda", model="resnet18", image_size=32,
                    n_samples=6000):
    """The main path at full width on ``device``; the CPU rehearsal of this
    script passes a smaller model and data set."""
    from repro_torch.core.strategies import FedAuto, FedAvg
    from repro_torch.fl.runtime import FFTConfig, FFTRunner
    from repro_torch.kernels import ops
    from repro_torch.models.vision import make_model
    from repro_torch.tree import tree_leaves

    cuda = torch.device(device).type == "cuda"
    public, private, test, parts = cifar100_split(n_samples, image_size)
    init_fn, apply_fn = make_model(model, 100, image_size, 3, device=device)
    t0 = time.perf_counter()
    runner = FFTRunner(FFTConfig(**MAIN_CONFIG), init_fn, apply_fn, public,
                       parts, private, test, pretrain_steps=10, device=device)
    sync(device)
    g0 = runner.global_params

    def rebuild(**over):
        """A runner of the same problem under config overrides, from g0."""
        return FFTRunner(FFTConfig(**dict(MAIN_CONFIG, **over)), lambda seed: g0,
                         apply_fn, public, parts, private, test, device=device)

    leaves = tree_leaves(g0)
    n_params = sum(l.numel() for l in leaves)
    print(f"[main] {model} {n_params} params in {len(leaves)} leaves, "
          f"widest {max(l.numel() for l in leaves)}; data {len(private.y)} "
          f"private / {len(public.y)} public / {len(test.y)} test; "
          f"set-up + pretrain {time.perf_counter() - t0:.2f} s, "
          f"pretrained acc {runner.evaluate():.4f}")
    if model == "resnet18":
        assert n_params == 11_223_140 and len(leaves) == 76

    runs = [("fedavg fp32 streaming", FedAvg, {}, 2, "float_fedagg", 2),
            ("fedauto fp32 streaming", FedAuto, {}, 2, "float_fedagg", 2),
            ("fedauto int8 streaming", FedAuto, {"codec": "int8"}, 1,
             "dequant_fedagg", 1),
            ("fedauto materializing", FedAuto, {"streaming_agg": "off"}, 1,
             "fedagg", 1)]
    totals = {k: 0 for k in ops.launches}
    ops.reset_launches()
    for label, strat, over, rounds, kernel, per_round in runs:
        if "codec" in over:
            r = rebuild(**over)
        else:
            r = runner
            r.cfg.streaming_agg = over.get("streaming_agg", "auto")
        r.global_params = g0
        r.rng = np.random.default_rng(42)
        before = dict(ops.launches)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        stamps = [time.perf_counter()]

        def log(rnd, acc):
            sync(device)
            stamps.append(time.perf_counter())

        hist = r.run(strat(), rounds, log=log)
        walls = np.diff(stamps)
        delta = {k: ops.launches[k] - before[k] for k in ops.launches}
        for k in totals:
            totals[k] += delta[k]
        parts_rounds = r.loop.participants_per_round
        expect = per_round * len(leaves) * sum(1 for n in parts_rounds if n > 0)
        if per_round == 2:       # dense terms flush even in an empty round
            expect += len(leaves) * sum(1 for n in parts_rounds if n == 0)
        print(f"[main] {label}: rounds={rounds} round_wall_s="
              f"{[round(float(w), 4) for w in walls]} participants={parts_rounds} "
              f"acc={hist} peak_mem_bytes="
              f"{torch.cuda.max_memory_allocated() if cuda else 'not measured'} "
              f"launches={delta} expected_{kernel}={expect}")
        if cuda:
            assert delta[kernel] > 0, f"{label}: {kernel} was never launched"
            if kernel == "dequant_fedagg":
                assert delta["float_fedagg"] > 0, "int8 run: dense terms not reduced"
        for leaf, ref_leaf in zip(tree_leaves(r.global_params), leaves):
            assert leaf.shape == ref_leaf.shape and leaf.dtype == ref_leaf.dtype
            assert bool(torch.isfinite(leaf).all()), f"{label}: non-finite params"
        assert all(0.0 <= a <= 1.0 for a in hist) and len(hist) == rounds
        r.cfg.streaming_agg = "auto"
    return totals, runner, g0, rebuild


def phase_profile(runner, g0):
    """One FedAuto fp32 round timed on the host clock, then the same round
    under torch.profiler for the kernels that take the device time."""
    from repro_torch.core.strategies import FedAuto

    def one_round():
        runner.global_params = g0
        runner.rng = np.random.default_rng(42)
        runner.run(FedAuto(), 1)

    profile_kernels(one_round, "fedauto fp32 round",
                    {"aggregation_kernels": "coef_reduce_kernel"}, top=12)


# (label, strategy from a strategies module, config overrides, rounds): the
# paper's baselines and FedAuto's Table-5 ablations (benchmarks/bench_table1.py
# and bench_table5.py), FedProx once more with int8 uploads
STRATEGY_RUNS = [
    ("fedprox", lambda S: S.FedProx(), {}, 2),
    ("scaffold", lambda S: S.Scaffold(), {}, 2),
    ("fedlaw", lambda S: S.FedLAW(), {}, 2),
    ("tf_aggregation", lambda S: S.TFAggregation(), {}, 2),
    ("fedawe", lambda S: S.FedAWE(), {}, 2),
    ("centralized_public", lambda S: S.CentralizedPublic(), {}, 2),
    ("fedauto m1 off m2 off",
     lambda S: S.FedAuto(use_module1=False, use_module2=False), {}, 2),
    ("fedauto m1 on m2 off",
     lambda S: S.FedAuto(use_module1=True, use_module2=False), {}, 2),
    ("fedauto m1 off m2 on",
     lambda S: S.FedAuto(use_module1=False, use_module2=True), {}, 2),
    ("fedprox int8", lambda S: S.FedProx(), {"codec": "int8"}, 1),
]


def upload_kernel(codec):
    """The kernel that reduces a streaming round's uploads under ``codec``:
    int8-family payloads (int8, qsgd, sign1) dequant_fedagg, top-k payloads
    topk_fedagg, fp16/fp32 float_fedagg."""
    fam = codec.split(":")[0]
    if fam in ("int8", "qsgd", "sign1"):
        return "dequant_fedagg"
    return "topk_fedagg" if fam == "topk" else "float_fedagg"


def expected_launches(strategy, connected, n_leaves, codec, streaming=None):
    """The launches a run implies, from the connected masks of its rounds.
    Streaming strategies flush the dense terms (server, compensatory model)
    through float_fedagg in every round and the uploads through
    ``upload_kernel(codec)`` when anyone connected (once per leaf; a top-k
    flush once for every leaf); FedAuto on the
    materializing path (``streaming=False``) reduces through fedagg once per
    leaf in every round; SCAFFOLD and FedLAW through fedagg once per leaf in
    a round with a participant, TF-Aggregation in a round with a
    participant whose selection probability is positive; CentralizedPublic
    reduces nothing."""
    from repro_torch.kernels import ops
    expect = dict.fromkeys(ops.launches, 0)
    busy = sum(1 for c in connected if c.any())
    streaming = strategy.streaming if streaming is None else streaming
    if streaming:
        expect["float_fedagg"] = n_leaves * len(connected)
        kernel = upload_kernel(codec)
        # a top-k flush is one launch count over every leaf
        expect[kernel] += (1 if kernel == "topk_fedagg" else n_leaves) * busy
    elif strategy.name == "fedauto":
        expect["fedagg"] = n_leaves * len(connected)
    elif strategy.name in ("scaffold", "fedlaw"):
        expect["fedagg"] = n_leaves * busy
    elif strategy.name == "tf_aggregation":
        expect["fedagg"] = n_leaves * sum(
            1 for c in connected if (c & (strategy.s > 0)).any())
    return expect


def phase_strategies(runner, g0, rebuild, device="cuda"):
    """Every synchronous baseline and ablation on the main path's
    full-width problem from its pretrained g0: round walls, participants,
    accuracy, peak memory and the launches per kernel, held to the counts
    the code implies; then one round of SCAFFOLD and of FedLAW profiled
    (kernel time, busy share against the unprofiled first round, the top
    kernels).  Returns the launches."""
    from repro_torch.core import strategies as S
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    leaves = tree_leaves(g0)
    totals = {k: 0 for k in ops.launches}
    for label, make, over, rounds in STRATEGY_RUNS:
        r = rebuild(**over) if over else runner
        codec = over.get("codec", "fp32")

        def run(n, log=None):
            r.global_params = g0
            r.rng = np.random.default_rng(42)
            strat = make(S)
            connected = []
            aggregate = strat.aggregate

            def recording(ctx):
                connected.append(ctx.connected.copy())
                return aggregate(ctx)

            strat.aggregate = recording
            return strat, connected, r.run(strat, n, log=log)

        before = dict(ops.launches)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        stamps = [time.perf_counter()]

        def log(rnd, acc):
            sync(device)
            stamps.append(time.perf_counter())

        strat, connected, hist = run(rounds, log)
        walls = np.diff(stamps)
        delta = {k: ops.launches[k] - before[k] for k in ops.launches}
        for k in totals:
            totals[k] += delta[k]
        expect = expected_launches(strat, connected, len(leaves), codec)
        if not cuda:
            expect = dict.fromkeys(expect, 0)
        print(f"[strategies] {label}: rounds={rounds} round_wall_s="
              f"{[round(float(w), 4) for w in walls]} participants="
              f"{r.loop.participants_per_round} acc={hist} peak_mem_bytes="
              f"{torch.cuda.max_memory_allocated() if cuda else 'not measured'}"
              f" launches={delta}")
        assert delta == expect, (label, delta, expect)
        for leaf, ref_leaf in zip(tree_leaves(r.global_params), leaves):
            assert leaf.shape == ref_leaf.shape and leaf.dtype == ref_leaf.dtype
            assert bool(torch.isfinite(leaf).all()), f"{label}: non-finite params"
        assert all(0.0 <= a <= 1.0 for a in hist) and len(hist) == rounds
        if cuda and strat.name in ("scaffold", "fedlaw"):
            profile_kernels(lambda: run(1), f"strategies: one {label} round",
                            {"aggregation": "coef_reduce_kernel"},
                            wall_ms=float(walls[0]) * 1e3)
    return totals


# (label, config overrides, rounds): the compressed rungs on the main path's
# problem and start, FedAuto each
CODEC_RUNS = [("fedauto qsgd:4 streaming", {"codec": "qsgd:4"}, 1),
              ("fedauto sign1 streaming", {"codec": "sign1"}, 1),
              ("fedauto topk:0.1 streaming", {"codec": "topk:0.1"}, 1),
              ("fedauto fp32, int8 downlink", {"downlink_codec": "int8"}, 2),
              ("fedauto topk:0.1 materializing",
               {"codec": "topk:0.1", "streaming_agg": "off"}, 1)]


def phase_codecs(g0, rebuild, device="cuda"):
    """FedAuto under each of ``CODEC_RUNS`` on the main path's full-width
    problem from its pretrained g0: round walls, participants, upload
    distortions, wire bytes, peak memory and the launches per kernel, held
    to ``expected_launches``; the int8 downlink's bytes are the fp32
    enrollment plus one compressed broadcast.  Then ``aggregate_quantized``
    on 20 qsgd:4 payloads of a ResNet-18-sized delta against decode-then-sum
    (launches not counted).  Returns the runs' launches."""
    from repro_torch.core.strategies import FedAuto
    from repro_torch.fl.comm import aggregate_quantized, make_codec
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves, tree_map
    cuda = torch.device(device).type == "cuda"
    leaves = tree_leaves(g0)
    totals = dict.fromkeys(ops.launches, 0)
    for label, over, rounds in CODEC_RUNS:
        r = rebuild(**over)
        r.global_params = g0
        r.rng = np.random.default_rng(42)
        strat, connected = FedAuto(), []
        aggregate = strat.aggregate

        def recording(ctx):
            connected.append(ctx.connected.copy())
            return aggregate(ctx)

        strat.aggregate = recording
        before = dict(ops.launches)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        stamps = [time.perf_counter()]

        def log(rnd, acc):
            sync(device)
            stamps.append(time.perf_counter())

        hist = r.run(strat, rounds, log=log)
        walls = np.diff(stamps)
        delta = {k: ops.launches[k] - before[k] for k in ops.launches}
        for k in totals:
            totals[k] += delta[k]
        expect = expected_launches(strat, connected, len(leaves),
                                   r.comm.codec.name, streaming=r.loop.streaming)
        if not cuda:
            expect = dict.fromkeys(expect, 0)
        dist = [sorted(round(v, 4) for v in d.values())
                for d in r.loop.distortion_history]
        print(f"[codecs] {label}: rounds={rounds} round_wall_s="
              f"{[round(float(w), 4) for w in walls]} participants="
              f"{r.loop.participants_per_round} acc={hist} distortions={dist} "
              f"upload_bytes={r.upload_bytes:.0f} download_bytes="
              f"{r.download_bytes:.0f} total_uplink={r.comm.total_uplink_bytes:.0f}"
              f" total_downlink={r.comm.total_downlink_bytes:.0f} peak_mem_bytes="
              f"{torch.cuda.max_memory_allocated() if cuda else 'not measured'}"
              f" launches={delta}")
        assert delta == expect, (label, delta, expect)
        if "downlink_codec" in over:
            assert r.comm.total_downlink_bytes == (
                r.comm.ref_bytes + (rounds - 1) * r.comm.download_bytes)
        for leaf, ref_leaf in zip(tree_leaves(r.global_params), leaves):
            assert leaf.shape == ref_leaf.shape and leaf.dtype == ref_leaf.dtype
            assert bool(torch.isfinite(leaf).all()), f"{label}: non-finite params"
        assert all(0.0 <= a <= 1.0 for a in hist) and len(hist) == rounds
        # the recording wrapper closes a cycle through strat: collect it, so
        # the next run's peak memory holds no residuals of this one
        del r, strat, aggregate, recording
        gc.collect()

    # aggregate_quantized against decode-then-sum (a check, not counted)
    g = torch.Generator(device=device).manual_seed(11)
    codec = make_codec("qsgd:4")
    payloads = [codec.encode(tree_map(
        lambda l: 1e-3 * torch.randn(l.shape, generator=g, device=device), g0))
        for _ in range(20)]
    betas = torch.softmax(torch.randn(20, generator=g, device=device), 0)
    before = ops.launches["dequant_fedagg"]
    got = tree_leaves(aggregate_quantized(payloads, betas))
    n_launch = ops.launches["dequant_fedagg"] - before
    want = None
    for bm, p in zip(betas, payloads):
        d = [bm * x for x in tree_leaves(codec.decode(p))]
        want = d if want is None else [w + x for w, x in zip(want, d)]
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    lim = max(float(1e-6 + 1e-5 * w.abs().max()) for w in want)
    print(f"[codecs] aggregate_quantized: 20 qsgd:4 payloads of "
          f"{sum(l.numel() for l in leaves)} params, {n_launch} dequant_fedagg "
          f"launches, max |fused - decode-then-sum|={err:.3e} (limit {lim:.3e})")
    assert err <= lim and n_launch == (len(leaves) if cuda else 0)
    return totals


BROADCAST_RUNGS = ["int8", "qsgd:4", "sign1", "topk:0.1"]


def phase_broadcast(g0, clients=1024, rounds=3, smoke=False):
    """``launch/serve.py``'s paged broadcast cache serving the full-width
    global model g0 to ``clients`` clients (on average 256 a rung over
    ``BROADCAST_RUNGS``) for ``rounds`` rounds: 4 encodes on the device and
    clients - 4 hits a round; then ``serve.main(["--mode", "broadcast"])``
    once on the smoke model."""
    from repro_torch.launch import serve
    cache, walls = serve.serve_broadcast(
        g0, BROADCAST_RUNGS, clients, rounds,
        log=lambda line: print(f"[broadcast] {line}"))
    s = cache.stats
    print(f"[broadcast] {clients} clients x {rounds} rounds over "
          f"{','.join(BROADCAST_RUNGS)}: round_wall_s="
          f"{[round(w, 4) for w in walls]} hits={s['hits']} misses={s['misses']}"
          f" evictions={s['evictions']} resident_pages={s['resident_pages']} "
          f"peak_pages={s['peak_pages']} bytes_served={s['bytes_served']:.0f}")
    n_rungs = len(BROADCAST_RUNGS)
    assert s["misses"] == n_rungs * rounds
    assert s["hits"] == (clients - n_rungs) * rounds
    argv = ["--mode", "broadcast", "--clients", "24", "--rounds", "3",
            "--rungs", ",".join(BROADCAST_RUNGS)]
    if smoke:
        argv += ["--device", "cpu"]
    small = serve.main(argv)
    assert small.misses == n_rungs * 3 and small.hits == (24 - n_rungs) * 3


def record_steps(codec):
    """Wrap ``codec``'s encode so that each payload records, per leaf, the
    most one element of its decode can move when the element's input sits
    on a boundary of the codec: the ``scale`` of an int8/qsgd leaf (one
    level), twice it for sign1 (a sign), the smallest kept magnitude of a
    top-k leaf (an entry kept or dropped).  Returns the list the records
    go to, one per payload."""
    steps = []
    encode = codec.encode

    def recording(tree):
        p = encode(tree)
        row = []
        for el in p.leaves:
            if "scale" in el.data:
                row.append(float(el.data["scale"]) * (2 if p.codec == "sign1" else 1))
            else:
                row.append(float(el.data["val"].abs().min()))
        steps.append(row)
        return p

    codec.encode = recording
    return steps


def quantized_agreement(got, want, steps, atol=1e-4, share=0.01):
    """Two runs of one problem under a lossy codec, leaf by leaf (``got``,
    ``want``: lists of CPU tensors or arrays).  A quantizer's input differs
    between two devices or frameworks by fp32 noise (~1e-7 in the weights),
    which can put an element on either side of a rounding boundary (a
    level, a sign, the top-k threshold): that element then differs by one
    step.  So each element is within ``atol``, or within ``atol`` + the
    leaf's largest step over the run (``steps``, from ``record_steps``) for
    at most ``share`` of the leaf's elements.  Returns {"max_abs_err",
    "flips" (elements past ``atol``), "worst_share", "ok"}."""
    out = dict(max_abs_err=0.0, flips=0, worst_share=0.0, ok=True)
    step = np.max(np.asarray(steps, dtype=np.float64), axis=0)
    for li, (a, b) in enumerate(zip(got, want)):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        n_flip = int((d > atol).sum())
        out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
        out["flips"] += n_flip
        out["worst_share"] = max(out["worst_share"], n_flip / d.size)
        if n_flip > share * d.size or bool((d > atol + step[li]).any()):
            out["ok"] = False
    return out


def record_rung_steps(comm, rungs):
    """``record_steps`` for every lossy rung of an adaptive run (``rungs``,
    resolved through ``comm.codec_named``): the quantized rungs as
    ``record_steps``, fp16 one ulp at the leaf's largest magnitude, fp32
    nothing (it is exact).  Returns one list of records per lossy rung."""
    lists = []
    for name in rungs:
        codec = comm.codec_named(name)
        if name == "fp16":
            rows, encode = [], codec.encode

            def fp16(tree, encode=encode, rows=rows):
                p = encode(tree)
                rows.append([float(el.data["v"].float().abs().max()) * 2.0 ** -10
                             for el in p.leaves])
                return p
            codec.encode = fp16
            lists.append(rows)
        elif name != "fp32":
            lists.append(record_steps(codec))
    return lists


# ---------------------------------------------------------------------------
# the async and buffered server, the adaptive controller, replay, population
# ---------------------------------------------------------------------------
# benchmarks/bench_async.py's settings; the deadline is chosen for the main
# path's world by choose_async_deadline
ASYNC_CONFIG = dict(failure_mode="scenario:diurnal", tau_max=4, buffer_k=4)
RESNET18_BYTES = 44_892_560              # fp32 bytes of ResNet-18-GN's params
FAMILY_KERNEL = {"fp32": "float_fedagg", "fp16": "float_fedagg",
                 "quant": "dequant_fedagg"}


def deadline_shares(deadline_s, n=20, seed=0, rounds=4, tau_max=4,
                    model_bytes=RESNET18_BYTES):
    """Rounds 1..``rounds`` of the main path's diurnal world (its channels,
    fp32 uploads and broadcasts) under ``deadline_s``, from the port's
    timing engine alone: per round, the share of the up clients that miss
    the deadline and the number of late uploads that land within the
    (tau_max + 1)·deadline horizon."""
    from repro_torch.fl.network import build_network
    from repro_torch.fl.scenarios import make_scenario_model
    m = make_scenario_model("diurnal", n, model_bytes=model_bytes,
                            deadline_s=deadline_s, compute_s=2.0, seed=seed,
                            channels=build_network(n, seed=seed))
    m.set_payload_bytes(upload_bytes=np.full(n, float(model_bytes)),
                        download_bytes=np.full(n, float(model_bytes)))
    out = []
    for r in range(1, rounds + 1):
        ev = m.draw_events(r)
        up, met, fin = ev.up_mask(), ev.deadline_mask(), ev.finish_array()
        late = up & ~met
        out.append((float(late.sum()) / max(int(up.sum()), 1),
                    int((late & (fin <= (tau_max + 1) * deadline_s)).sum())))
    return out


def choose_async_deadline(grid=range(10, 205, 5), **kw):
    """The ``[async]`` deadline: of a 5 s grid, the deadline under which
    every round 1-4 misses between a quarter and three quarters of the up
    clients and lands a late upload within the horizon, with the worst
    round's share closest to one half (the smallest on a tie).  Returns
    (deadline_s, ``deadline_shares`` of it)."""
    best = None
    for d in grid:
        s = deadline_shares(float(d), **kw)
        if all(0.25 <= share <= 0.75 and n > 0 for share, n in s):
            worst = max(abs(share - 0.5) for share, _ in s)
            if best is None or worst < best[0] - 1e-12:
                best = (worst, float(d), s)
    assert best is not None, "no deadline on the grid meets the criteria"
    return best[1], best[2]


class ReductionLedger:
    """The launches the strategies' reductions imply, call by call, while
    the ledger is entered: ``_accumulate`` one ``fedagg`` per leaf;
    ``_stream_accumulate`` one ``float_fedagg`` per leaf for its dense terms
    (server, compensatory model, distinct origin globals) and, per rung
    family of its payloads, one flush per 64 payloads (``float_fedagg`` per
    leaf for fp32 and fp16, ``dequant_fedagg`` per leaf for the quantized
    rungs, one ``topk_fedagg`` count); ``_stream_delta_sum`` the family
    flushes alone (its dense terms add in place).  A payload outside every
    family is decoded alone (``fallbacks``), no launch.  ``by_family``
    holds the payload flushes' launches per family."""

    def __init__(self, n_leaves):
        from repro_torch.kernels import ops
        self.n_leaves = n_leaves
        self.expect = dict.fromkeys(ops.launches, 0)
        self.by_family = collections.Counter()
        self.fallbacks = 0

    def _families(self, packed):
        from repro_torch.fl.comm.stream import payload_family
        fams = collections.Counter(payload_family(pu.payload)
                                   for _, pu in packed)
        for fam, m in fams.items():
            if fam is None:
                self.fallbacks += m
                continue
            kernel = FAMILY_KERNEL.get(fam, "topk_fedagg")
            n = -(-m // 64) * (1 if kernel == "topk_fedagg" else self.n_leaves)
            self.expect[kernel] += n
            self.by_family[fam] += n

    def __enter__(self):
        from repro_torch.core import strategies as S
        self._saved = acc, stream, delta = (S._accumulate, S._stream_accumulate,
                                            S._stream_delta_sum)

        def accumulate(ctx, models, betas):
            self.expect["fedagg"] += self.n_leaves
            return acc(ctx, models, betas)

        def stream_accumulate(ctx, dense, packed):
            self.expect["float_fedagg"] += self.n_leaves
            self._families(packed)
            return stream(ctx, dense, packed)

        def stream_delta_sum(ctx, dense, packed):
            self._families(packed)
            return delta(ctx, dense, packed)

        S._accumulate, S._stream_accumulate, S._stream_delta_sum = (
            accumulate, stream_accumulate, stream_delta_sum)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import strategies as S
        S._accumulate, S._stream_accumulate, S._stream_delta_sum = self._saved
        return False


def recording_draws(runner):
    """Record each round's (up, met_deadline, finish_s) as the round loop
    draws it; returns the list the rounds go to."""
    draws, draw = [], runner._draw_network

    def recording(rnd):
        up, met, ev = draw(rnd)
        draws.append((up.copy(), met.copy(), ev.finish_array().copy()))
        return up, met, ev

    runner._draw_network = recording
    return draws


def fl_run(tag, label, r, strat, rounds, g0, device, snap_round=None):
    """``rounds`` rounds of ``strat`` on runner ``r`` from g0 and the same
    selection stream, evaluating every round: prints the round walls (host
    clock to a synchronize, evaluation included), the simulated clock,
    participants, the staleness histogram, unreachable and evicted uploads,
    the launches by kernel and the peak device memory; holds the launches to
    the ``ReductionLedger`` and every parameter to finite.  Returns a dict
    of what it printed, the launches of each round and, at ``snap_round``,
    the params on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    leaves = tree_leaves(g0)
    r.global_params = g0
    r.rng = np.random.default_rng(42)
    before = dict(ops.launches)
    marks, fams, snap = [dict(ops.launches)], [collections.Counter()], []
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    stamps = [time.perf_counter()]
    with ReductionLedger(len(leaves)) as ledger:
        def log(rnd, acc):
            sync(device)
            stamps.append(time.perf_counter())
            marks.append(dict(ops.launches))
            fams.append(collections.Counter(ledger.by_family))
            if rnd == snap_round:
                snap.extend(l.cpu().clone() for l in tree_leaves(r.global_params))

        hist = r.run(strat, rounds, log=log)
    walls = [round(float(w), 4) for w in np.diff(stamps)]
    delta = {k: ops.launches[k] - before[k] for k in ops.launches}
    per_round = [{k: b[k] - a[k] for k in a if b[k] > a[k]}
                 for a, b in zip(marks, marks[1:])]
    fam_rounds = [dict(b - a) for a, b in zip(fams, fams[1:])]
    loop = r.loop
    stale = dict(sorted(collections.Counter(
        getattr(loop, "staleness_applied", [])).items()))
    buf = getattr(loop, "buffer", None)
    out = dict(walls=walls, clock=[t.t_s for t in r.timeline], hist=hist,
               participants=list(loop.participants_per_round),
               staleness=list(getattr(loop, "staleness_applied", [])),
               stale_hist=stale,
               unreachable=getattr(loop, "n_unreachable", 0),
               evicted=buf.n_evicted if buf is not None else 0,
               launches=delta, per_round=per_round, fam_rounds=fam_rounds,
               peak=torch.cuda.max_memory_allocated() if cuda else None,
               snap=snap)
    print(f"[{tag}] {label}: rounds={rounds} round_wall_s={walls} "
          f"sim_clock_s={[round(c, 3) for c in out['clock']]} participants="
          f"{out['participants']} staleness={stale} unreachable="
          f"{out['unreachable']} evicted={out['evicted']} acc={hist} "
          f"peak_mem_bytes={out['peak'] if cuda else 'not measured'} "
          f"launches={ {k: v for k, v in delta.items() if v} } "
          f"per_round={per_round}")
    expect = ledger.expect if cuda else dict.fromkeys(ledger.expect, 0)
    assert delta == expect, (label, delta, ledger.expect)
    for leaf, ref_leaf in zip(tree_leaves(r.global_params), leaves):
        assert leaf.shape == ref_leaf.shape and leaf.dtype == ref_leaf.dtype
        assert bool(torch.isfinite(leaf).all()), f"{label}: non-finite params"
    assert len(hist) == rounds and all(0.0 <= a <= 1.0 for a in hist)
    return out


# (label, server_mode, strategy name, config overrides, rounds, kernels that
# must launch on the card); the first run records the trace that [replay]
# replays on fresh runners, so it runs first, on a fresh runner too (the
# minibatch generator starts from the seed)
ASYNC_RUNS = [
    ("async fedauto_async", "async", "fedauto_async", {}, 4,
     ("float_fedagg",)),
    ("sync fedauto", "sync", "fedauto", {}, 4, ("float_fedagg",)),
    ("buffered fedauto_async", "buffered", "fedauto_async", {}, 4,
     ("float_fedagg",)),
    ("async fedasync", "async", "fedasync", {}, 3, ("float_fedagg",)),
    ("async fedbuff", "async", "fedbuff", {}, 3, ("float_fedagg",)),
    ("async fedauto_async materializing", "async", "fedauto_async",
     {"streaming_agg": "off"}, 1, ("fedagg",)),
]


def phase_async(g0, rebuild, device="cuda", trace_path=None, model_bytes=None):
    """The async and buffered server on the main path's full-width problem
    from its pretrained g0 (``ASYNC_RUNS``), under ``scenario:diurnal`` and
    the deadline ``choose_async_deadline`` finds; the async FedAuto-Async
    run records its trace to ``trace_path``.  ``model_bytes`` prices a
    smaller model as ResNet-18 (the CPU rehearsal).  Returns (launches,
    deadline, the async run's result with its draws)."""
    from repro_torch.core.strategies import STRATEGIES
    from repro_torch.kernels import ops
    cuda = torch.device(device).type == "cuda"
    deadline, shares = choose_async_deadline()
    print(f"[async] deadline_s={deadline} (choose_async_deadline, host only: "
          f"rounds 1-4 share of up clients late, late landing within "
          f"{ASYNC_CONFIG['tau_max'] + 1} deadlines: "
          f"{[(round(s, 3), n) for s, n in shares]})")
    over = dict(ASYNC_CONFIG, deadline_s=deadline)
    if model_bytes:
        over["model_bytes"] = model_bytes
    r = rebuild(**over)
    draws = recording_draws(r)
    totals = dict.fromkeys(ops.launches, 0)
    results = {}
    for label, mode, name, extra, rounds, must in ASYNC_RUNS:
        r.cfg.server_mode = mode
        r.cfg.streaming_agg = extra.get("streaming_agg", "auto")
        record = label == "async fedauto_async" and trace_path
        r.cfg.trace_record = trace_path if record else None
        del draws[:]
        res = fl_run("async", label, r, STRATEGIES[name](), rounds, g0,
                     device, snap_round=3 if record else None)
        res["draws"] = list(draws)
        results[label] = res
        for k in totals:
            totals[k] += res["launches"][k]
        if cuda:
            for k in must:
                assert res["launches"][k] > 0, f"{label}: {k} never launched"
        r.cfg.trace_record = None
    live = results["async fedauto_async"]
    assert max(live["staleness"]) > 0, "no late upload was aggregated"
    r.cfg.server_mode, r.cfg.streaming_agg = "async", "auto"
    del r
    gc.collect()
    return totals, deadline, live


def phase_adaptive(g0, rebuild, deadline, device="cuda", model_bytes=None):
    """FedAuto (sync) and FedAuto-Async (async) under ``adaptive:sign1-fp32``
    on the main path's full-width problem, 3 rounds each: the rung
    histogram of every round, the payload flushes by rung family and the
    launches of ``float_fedagg`` and ``dequant_fedagg``; on the card one
    round must flush both an fp32 or fp16 family and the quantized one.
    Returns the launches."""
    from repro_torch.core.strategies import FedAuto, FedAutoAsync
    from repro_torch.kernels import ops
    cuda = torch.device(device).type == "cuda"
    over = dict(ASYNC_CONFIG, deadline_s=deadline, codec="adaptive:sign1-fp32")
    if model_bytes:
        over["model_bytes"] = model_bytes
    totals = dict.fromkeys(ops.launches, 0)
    for mode, strat in (("sync", FedAuto), ("async", FedAutoAsync)):
        r = rebuild(server_mode=mode, **over)
        res = fl_run("adaptive", f"{mode} {strat.name} adaptive:sign1-fp32",
                     r, strat(), 3, g0, device)
        rungs = []
        for rnd in (1, 2, 3):
            a = r.controller.assignments[rnd]
            sel = a.selected if a.selected is not None else np.ones(
                r.n_clients, bool)
            rungs.append(dict(collections.Counter(
                c for c, s in zip(a.codecs, sel) if s)))
        print(f"[adaptive] {mode}: rungs per round {rungs}; payload flush "
              f"launches by family per round {res['fam_rounds']} "
              f"(float_fedagg f32 = fp32, f16 = fp16, dequant_fedagg = "
              f"quant); downlink {r.downlink_codec_resolved}")
        both = [f for f in res["fam_rounds"]
                if f.get("quant") and (f.get("fp32") or f.get("fp16"))]
        if cuda:
            assert both, f"{mode}: no round flushed a float and the quant family"
        for k in totals:
            totals[k] += res["launches"][k]
        del r
        gc.collect()
    return totals


def replay_run(rebuild, over, g0, device, label, live=None):
    """3 rounds of async FedAuto-Async from g0 on a fresh runner under
    ``over`` (a ``trace_record`` or ``trace_replay`` run); with ``live``,
    its realization (up, met_deadline, finish_s), participants and
    staleness must equal the live run's.  Returns ``fl_run``'s result with
    the draws."""
    from repro_torch.core.strategies import FedAutoAsync
    r = rebuild(**over)
    draws = recording_draws(r)
    res = fl_run("replay", label, r, FedAutoAsync(), 3, g0, device,
                 snap_round=3)
    res["draws"] = list(draws)
    if live is not None:
        n3 = sum(live["participants"][:3])
        assert len(draws) == 3
        for (u, m, f), (lu, lm, lf) in zip(draws, live["draws"]):
            assert (u == lu).all() and (m == lm).all(), "replayed masks differ"
            assert np.array_equal(f, lf), "replayed arrival times differ"
        assert res["participants"] == live["participants"][:3]
        assert res["staleness"] == live["staleness"][:n3]
        res["diff"] = max(float((a - b).abs().max())
                          for a, b in zip(res["snap"], live["snap"]))
        res["bitwise"] = all(bool((a == b).all())
                             for a, b in zip(res["snap"], live["snap"]))
        print(f"[replay] {label}: realization equal over 3 rounds, max "
              f"|param diff| against the live run {res['diff']:.3e}, "
              f"bitwise {res['bitwise']}")
    del r
    gc.collect()
    return res


def phase_replay(g0, rebuild, deadline, live, trace_path, device="cuda",
                 model_bytes=None):
    """Trace replay of async FedAuto-Async on the main path's problem.
    First the ``[async]`` run's trace, replayed once under cuDNN's default
    algorithms: the realization (up, met_deadline, finish_s), participants
    and staleness of rounds 1-3 exactly the live run's; the parameters'
    distance is printed (the default weight-gradient algorithms accumulate
    in no fixed order, so it grows over the rounds).  Then with
    ``cudnn.deterministic``: a live run records its first 3 rounds and is
    replayed twice, the realization exactly equal and the params within
    1e-4 per leaf of the live run (whether bitwise is printed).  Returns
    the launches of the four runs."""
    over = dict(ASYNC_CONFIG, deadline_s=deadline, server_mode="async")
    if model_bytes:
        over["model_bytes"] = model_bytes
    runs = [replay_run(rebuild, dict(over, trace_replay=trace_path), g0,
                       device, "replay of [async]'s trace, default cuDNN "
                       "algorithms", live)]
    det_path = trace_path + ".deterministic"
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rec = replay_run(rebuild, dict(over, trace_record=det_path), g0, device,
                     "deterministic live run, recording")
    runs.append(rec)
    for k in (1, 2):
        runs.append(replay_run(rebuild, dict(over, trace_replay=det_path), g0,
                               device, f"deterministic replay {k}", rec))
        assert runs[-1]["diff"] <= 1e-4, runs[-1]["diff"]
    torch.backends.cudnn.deterministic = saved
    return {k: sum(res["launches"][k] for res in runs) for k in rec["launches"]}


def phase_population(n=100_000, rounds=3):
    """``simulate_population`` of the diurnal world over ``n`` clients with
    the adaptive controller and straggler skipping: host work (numpy on the
    CPU), the card idle."""
    from repro_torch.fl.scenarios import simulate_population
    t0 = time.perf_counter()
    stats = simulate_population("diurnal", n, rounds,
                                adaptive="adaptive:sign1-fp32",
                                skip_stragglers=True)
    dt = time.perf_counter() - t0
    print(f"[population] diurnal, {n} clients, {rounds} rounds, "
          f"adaptive:sign1-fp32, skip_stragglers: {dt / rounds * 1e6:.0f} us "
          f"per simulated round (host work, numpy on the CPU; the card "
          f"idle); selected {[s.n_selected for s in stats]} connected "
          f"{[s.n_connected for s in stats]} missed "
          f"{[s.n_missed for s in stats]} skipped {[s.n_skipped for s in stats]}")
    assert len(stats) == rounds
    assert all(0 < s.n_connected <= s.n_selected <= n for s in stats)


# the async server on phase_agreement's cnn: stale uploads land one or two
# steps late (the calibration of tests/test_torch_async.py)
AGREE_ASYNC = dict(failure_mode="scenario:diurnal", deadline_s=3.0,
                   model_bytes=0.2e6, tau_max=4)


def async_toy_agreement(mode, name, rounds=4, devices=("cuda", "cpu")):
    """``fl.toy``'s cnn (8×8, 6 clients, E=2) under ``AGREE_ASYNC`` with
    ``server_mode=mode`` and strategy ``name``, ``rounds`` rounds on each
    device from one init and one minibatch stream, TF32 off: participants,
    staleness and the simulated clock equal; returns the largest parameter
    difference (``tests/test_torch_kernels_gpu.py`` holds it to 1e-4)."""
    from repro_torch.core.strategies import STRATEGIES
    from repro_torch.fl.runtime import FFTConfig
    from repro_torch.fl.toy import make_toy_runner
    from repro_torch.models.vision import make_model
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(n_clients=6, k_selected=6, local_steps=2, batch_size=8,
               lr=0.05, seed=0, eval_every=1, server_mode=mode, **AGREE_ASYNC)
    p0 = make_model("cnn", 4, 8, 1, device="cpu")[0](0)
    out = []
    for dev in devices:
        rng = np.random.default_rng(5)
        r = make_toy_runner(
            FFTConfig(**cfg), n_samples=600, public_per_class=10,
            pretrain_steps=9, device=dev,
            init_fn=lambda seed: tree_map(lambda x: x.to(dev), p0),
            batch_indices=lambda n, E, bs: torch.as_tensor(
                rng.integers(0, n, (E, bs)), device=dev))
        r.run(STRATEGIES[name](), rounds)
        out.append(([l.cpu() for l in tree_leaves(r.global_params)],
                    list(r.loop.participants_per_round),
                    list(r.loop.staleness_applied),
                    [p.t_s for p in r.timeline]))
    (pa, *rest_a), (pb, *rest_b) = out
    assert rest_a == rest_b, (mode, name, rest_a, rest_b)
    assert max(rest_a[1]) > 0 or mode == "buffered"
    return max(float((a - b).abs().max()) for a, b in zip(pa, pb))


# ---------------------------------------------------------------------------
# run telemetry
# ---------------------------------------------------------------------------
# the phase timers of a round, in the order the phase table prints them
TELEMETRY_PHASES = ("local_update", "weight_solve", "accumulate", "uplink",
                    "uplink_decode", "downlink", "network_draw", "controller",
                    "buffer", "aggregate", "eval")


def telemetry_view(runner):
    """What a full-mode telemetry run recorded that another run of the same
    realization must share: final outcomes per (round, client), resolutions,
    β rows per round, participants, byte totals, the rung histogram, the
    counters, the gauge names of each round, the health alarms (kind,
    round) and the accuracy curve."""
    rep = runner.report
    return dict(outcomes=rep.final_outcomes(),
                resolutions=list(rep.resolutions),
                betas=[list(r.get("betas", ())) for r in rep.rounds],
                participants=rep.participants_per_round(),
                upload_bytes=rep.total_upload_bytes(),
                download_bytes=rep.total_download_bytes(),
                rungs=rep.rung_histogram(),
                counters=dict(rep.summary.get("counters", {})),
                gauges=[sorted(r["gauges"]) for r in rep.rounds],
                health=[(h["monitor"], h["round"]) for h in rep.health],
                acc=rep.accuracy_curve())


def _rows_agree(a, b, beta_atol, what):
    """One outcome or β row against another: the same fields, ``beta``
    within ``beta_atol``, ``distortion`` within 1e-3·|d| + 1e-6, the rest
    exactly.  Returns (|Δβ|, |Δd|)."""
    assert set(a) == set(b), (what, a, b)
    db = dd = 0.0
    for k, va in a.items():
        vb = b[k]
        if k == "beta":
            db = abs(va - vb)
            assert db <= beta_atol, (what, a, b)
        elif k == "distortion":
            dd = abs(va - vb)
            assert dd <= 1e-3 * abs(vb) + 1e-6, (what, a, b)
        else:
            assert va == vb, (what, k, a, b)
    return db, dd


def telemetry_agreement(a, b, beta_atol=1e-5):
    """Hold two ``telemetry_view``s of one realization to each other:
    outcomes and resolutions, rungs, bytes, participants, counters, gauge
    names and health alarms exactly; β within ``beta_atol`` (0 for the
    heuristic weights, 1e-5 for FedAuto's float32 FISTA); distortions
    within 1e-3·|d| + 1e-6.  The accuracy curve is the caller's (its
    tolerance is one test sample).  Returns the largest β and distortion
    differences."""
    for key in ("resolutions", "participants", "upload_bytes",
                "download_bytes", "rungs", "counters", "gauges", "health"):
        assert a[key] == b[key], (key, a[key], b[key])
    assert a["outcomes"].keys() == b["outcomes"].keys()
    worst = [0.0, 0.0]
    pairs = [(a["outcomes"][k], b["outcomes"][k], f"outcome {k}")
             for k in a["outcomes"]]
    assert len(a["betas"]) == len(b["betas"])
    for rnd, (ra, rb) in enumerate(zip(a["betas"], b["betas"]), start=1):
        assert len(ra) == len(rb), (rnd, ra, rb)
        pairs += [(x, y, f"beta row of round {rnd}") for x, y in zip(ra, rb)]
    for x, y, what in pairs:
        for i, d in enumerate(_rows_agree(x, y, beta_atol, what)):
            worst[i] = max(worst[i], d)
    return dict(beta=worst[0], distortion=worst[1])


def telemetry_toy_agreement(mode, name, codec="fp32", rounds=3,
                            devices=("cuda", "cpu")):
    """``async_toy_agreement``'s cnn under ``AGREE_ASYNC`` with
    ``server_mode=mode``, strategy ``name``, ``codec`` and
    ``telemetry="full"``, ``rounds`` rounds on each device from one init and
    one minibatch stream, TF32 off: both flight records reconcile and agree
    by ``telemetry_agreement`` (β within 1e-5), the accuracies within one
    test sample.  Returns the largest parameter difference and the
    agreement's β and distortion differences."""
    from repro_torch.core.strategies import STRATEGIES
    from repro_torch.fl.runtime import FFTConfig
    from repro_torch.fl.toy import make_toy_runner
    from repro_torch.models.vision import make_model
    from repro_torch.obs import reconcile
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(n_clients=6, k_selected=6, local_steps=2, batch_size=8,
               lr=0.05, seed=0, eval_every=1, server_mode=mode, codec=codec,
               telemetry="full", **AGREE_ASYNC)
    p0 = make_model("cnn", 4, 8, 1, device="cpu")[0](0)
    views, params = [], []
    for dev in devices:
        rng = np.random.default_rng(5)
        r = make_toy_runner(
            FFTConfig(**cfg), n_samples=600, public_per_class=10,
            pretrain_steps=9, device=dev,
            init_fn=lambda seed: tree_map(lambda x: x.to(dev), p0),
            batch_indices=lambda n, E, bs: torch.as_tensor(
                rng.integers(0, n, (E, bs)), device=dev))
        r.run(STRATEGIES[name](), rounds)
        reconcile(r.report, r)
        views.append(telemetry_view(r))
        params.append([l.cpu() for l in tree_leaves(r.global_params)])
    out = telemetry_agreement(views[0], views[1])
    for (ra, aa), (rb, ab) in zip(views[0]["acc"], views[1]["acc"]):
        assert ra == rb and abs(aa - ab) <= 1 / 120 + 1e-12, (ra, aa, ab)
    out["params"] = max(float((a - b).abs().max())
                        for a, b in zip(*params))
    return out


# the toy runs telemetry_toy_agreement holds card against CPU: (server mode,
# strategy, codec)
TELEMETRY_AGREE = [("async", "fedauto_async", "fp32"),
                   ("sync", "fedauto", "adaptive:sign1-fp32")]


def phase_rows(report):
    """Per round of a telemetry report: the round wall and each phase's
    seconds, with ``untimed`` the rest of the wall.  Asserts that a round's
    phases never claim more than its wall."""
    rows = []
    for rec in report.rounds:
        g = rec["gauges"]
        wall = g["round_wall_s"]
        secs = {k[len("phase."):]: v for k, v in g.items()
                if k.startswith("phase.")}
        claimed = sum(secs.values())
        assert claimed <= wall + 1e-9, (rec["round"], claimed, wall)
        rows.append(dict(round=rec["round"], wall=wall, untimed=wall - claimed,
                         **secs))
    return rows


def reseed_batches(runner, seed):
    """Give ``runner`` the minibatch stream a fresh runner of ``seed`` has
    (``FFTRunner``'s default ``batch_indices``), so runs on one runner
    repeat one another."""
    gen = torch.Generator(device=runner.device).manual_seed(seed)
    dev = runner.device
    runner.batch_indices = lambda n, E, bs: torch.randint(
        0, n, (E, bs), generator=gen, device=dev)


# (label, strategy name, config overrides): the main path's sync FedAuto
# (phase 5), FedAuto-Async on [async]'s world, sync FedAuto on [adaptive]'s;
# the scenario ones take [async]'s deadline
TELEMETRY_RUNS = [
    ("sync fedauto fp32", "fedauto", {}),
    ("async fedauto_async", "fedauto_async",
     dict(ASYNC_CONFIG, server_mode="async")),
    ("sync fedauto adaptive:sign1-fp32", "fedauto",
     dict(ASYNC_CONFIG, codec="adaptive:sign1-fp32")),
]


def _quartiles(xs):
    q = np.percentile(xs, [0, 25, 50, 75, 100])
    return "median %.4f [%.4f, %.4f], min %.4f, max %.4f" % (
        q[2], q[1], q[3], q[0], q[4])


def phase_telemetry(g0, rebuild, deadline, tmp, device="cuda",
                    model_bytes=None, rounds=3):
    """Run telemetry on the main path's full-width problem from g0: each of
    ``TELEMETRY_RUNS`` for ``rounds`` rounds with telemetry off, ``"full"``
    (NDJSON log, Chrome trace and health into ``tmp``) and ``"sketch"``, in
    turns on one runner with the minibatch stream reseeded, under
    ``cudnn.deterministic`` (restored after); the order of the three modes
    rotates from one configuration to the next, so each mode runs first,
    second and third once.  The final parameters must be
    bitwise equal across the three modes and the launches equal (and, for
    the sync fp32 run, ``expected_launches``; every run is held to its
    ``ReductionLedger``); ``reconcile`` must close in both modes,
    ``verify_trace`` pass and every round's phases fit its wall.  Prints
    each full run's phase table per round and the round walls of the three
    modes.  Returns the launches."""
    from repro_torch.core.strategies import STRATEGIES
    from repro_torch.kernels import ops
    from repro_torch.obs import load_report, reconcile, verify_trace
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    n_leaves = len(tree_leaves(g0))
    totals = dict.fromkeys(ops.launches, 0)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    walls = {m: [] for m in ("off", "full", "sketch")}
    modes = ["off", "full", "sketch"]
    try:
        for label, name, over in TELEMETRY_RUNS:
            over = dict(over)
            if "failure_mode" in over:
                over["deadline_s"] = deadline
                if model_bytes:
                    over["model_bytes"] = model_bytes
            r = rebuild(**over)
            res = {}
            slug = label.replace(" ", "_").replace(":", "_")
            for mode in modes:
                log = os.path.join(tmp, f"{slug}_{mode}.ndjson")
                trace = os.path.join(tmp, f"{slug}.trace.json")
                r.cfg.telemetry = False if mode == "off" else mode
                r.cfg.telemetry_log = None if mode == "off" else log
                r.cfg.telemetry_trace = trace if mode == "full" else None
                reseed_batches(r, r.cfg.seed)
                strat = STRATEGIES[name]()
                connected, aggregate = [], strat.aggregate

                def recording(ctx, aggregate=aggregate, connected=connected):
                    connected.append(ctx.connected.copy())
                    return aggregate(ctx)

                if strat.name == "fedauto" and "codec" not in over:
                    strat.aggregate = recording
                out = fl_run("telemetry", f"{label} telemetry={mode}", r,
                             strat, rounds, g0, device, snap_round=rounds)
                res[mode] = out
                walls[mode].extend(out["walls"])
                for k in totals:
                    totals[k] += out["launches"][k]
                if connected:
                    expect = expected_launches(strat, connected, n_leaves,
                                               "fp32")
                    if not cuda:
                        expect = dict.fromkeys(expect, 0)
                    assert out["launches"] == expect, (label, mode, expect)
                if mode == "off":
                    assert r.report is None
                    continue
                nums = reconcile(r.report, r)
                back = load_report(log)
                assert type(back) is type(r.report)
                reconcile(back, r)
                rows = phase_rows(r.report)
                if mode == "full":
                    stats = verify_trace(trace, r.report)
                    assert stats["rounds_checked"] == rounds, stats
                    print(f"[telemetry] {label}: reconcile {nums}; trace "
                          f"verified {stats}; health "
                          f"{r.report.health_verdict()}")
                    for row in rows:
                        w = row["wall"]
                        cells = " ".join(
                            f"{p}={row[p]:.4f}({row[p] / w:.3f})"
                            for p in TELEMETRY_PHASES + ("untimed",)
                            if p in row)
                        print(f"[telemetry] {label} phase table round "
                              f"{row['round']}: wall {w:.4f} s; {cells}")
                else:
                    print(f"[telemetry] {label} sketch: reconcile {nums}; "
                          f"phase gauges within the wall in every round")
            for mode in ("full", "sketch"):
                assert res[mode]["launches"] == res["off"]["launches"], (
                    label, mode, res[mode]["launches"], res["off"]["launches"])
                same = all(bool(torch.equal(a, b)) for a, b in
                           zip(res[mode]["snap"], res["off"]["snap"]))
                assert same, f"{label}: params with telemetry={mode} differ"
                assert res[mode]["participants"] == res["off"]["participants"]
            used = {k: v for k, v in res["off"]["launches"].items() if v}
            print(f"[telemetry] {label}: params bitwise equal off/full/sketch, "
                  f"launches equal {used}; run order {'/'.join(modes)}; "
                  f"round_wall_s off {res['off']['walls']} full "
                  f"{res['full']['walls']} sketch {res['sketch']['walls']}")
            r.cfg.telemetry, r.cfg.telemetry_log = False, None
            r.cfg.telemetry_trace = None
            modes = modes[1:] + modes[:1]
            del r
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = saved
    for mode, w in walls.items():
        print(f"[telemetry] round walls telemetry={mode}, {len(w)} rounds: "
              f"{_quartiles(w)} s")
    ratio = [f / o for f, o in zip(walls["full"], walls["off"])]
    ratio_s = [s / o for s, o in zip(walls["sketch"], walls["off"])]
    print(f"[telemetry] round wall over off, round by round: full "
          f"{_quartiles(ratio)}; sketch {_quartiles(ratio_s)}")
    return totals


def phase_agreement(devices=("cuda", "cpu")):
    """Small runs of FedAuto and of every baseline and ablation of
    ``STRATEGY_RUNS`` (fp32), 2 rounds each from the same pretrained start,
    then FedAuto under the lossy codecs and ``adaptive:sign1-fp32`` and the
    async and buffered server (``AGREE_ASYNC``), on the card and on the CPU
    from the same init and minibatch indices: the CUDA kernels and cuDNN
    (TF32 off) against the plain versions."""
    from repro_torch.core import strategies as S
    from repro_torch.data.synthetic import fft_split, make_dataset, train_test_split
    from repro_torch.fl.partition import partition
    from repro_torch.fl.runtime import FFTConfig, FFTRunner
    from repro_torch.models.vision import make_model
    from repro_torch.tree import tree_leaves, tree_map

    ds = make_dataset(600, n_classes=10, image_size=16, channels=1, seed=0)
    train, test = train_test_split(ds, 120, seed=1)
    public, private = fft_split(train, public_per_class=5, seed=0)
    parts, _ = partition("group_classes", private.y, n_clients=6,
                         n_classes=10, classes_per_group=2, seed=0)
    cfg = dict(n_clients=6, k_selected=6, local_steps=2, batch_size=8,
               lr=0.05, failure_mode="mixed", seed=0, eval_every=1)
    init_cpu, apply_fn = make_model("cnn", 10, 16, 1, device="cpu")
    p0 = init_cpu(0)
    runs = [("fedauto", lambda S: S.FedAuto(), {})] + [
        (label, make, {}) for label, make, over, _ in STRATEGY_RUNS if not over]
    runs += [(f"fedauto {spec}", lambda S: S.FedAuto(), {"codec": spec})
             for spec in ("qsgd:4", "sign1", "topk:0.1")]
    runs += [("fedauto int8 downlink", lambda S: S.FedAuto(),
              {"downlink_codec": "int8"})]
    runs += [("fedauto adaptive:sign1-fp32", lambda S: S.FedAuto(),
              dict(AGREE_ASYNC, codec="adaptive:sign1-fp32")),
             ("async fedauto_async", lambda S: S.FedAutoAsync(),
              dict(AGREE_ASYNC, server_mode="async")),
             ("buffered fedauto_async", lambda S: S.FedAutoAsync(),
              dict(AGREE_ASYNC, server_mode="buffered")),
             ("async fedbuff", lambda S: S.FedBuff(),
              dict(AGREE_ASYNC, server_mode="async"))]
    out, steps = {}, {}
    for dev in devices:
        rng = np.random.default_rng(5)

        def batch_indices(n, E, bs):
            return torch.as_tensor(rng.integers(0, n, (E, bs)), device=dev)

        r = FFTRunner(FFTConfig(**cfg),
                      lambda seed: tree_map(lambda t: t.to(dev), p0), apply_fn,
                      public, parts, private, test, pretrain_steps=4,
                      device=dev, batch_indices=batch_indices)
        g0 = r.global_params
        for label, make, over in runs:
            rr = r if not over else FFTRunner(
                FFTConfig(**dict(cfg, **over)), lambda seed: g0, apply_fn,
                public, parts, private, test, device=dev,
                batch_indices=batch_indices)
            if dev == devices[1] and rr.controller is not None:
                steps[(dev, label)] = record_rung_steps(rr.comm,
                                                        rr.controller.rungs)
            elif dev == devices[1] and ("codec" in over
                                        or "downlink_codec" in over):
                steps[(dev, label)] = [record_steps(
                    rr.comm.downlink_codec or rr.comm.codec)]
            rr.global_params = g0
            rr.rng = np.random.default_rng(42)
            hist = rr.run(make(S), 2)
            out[(dev, label)] = (hist, [l.cpu() for l in tree_leaves(rr.global_params)],
                                 list(rr.loop.participants_per_round),
                                 list(getattr(rr.loop, "staleness_applied", [])))
    for label, _, over in runs:
        (hc, pc, nc, sc), (hp, pp, npart, sp) = (out[(devices[0], label)],
                                                 out[(devices[1], label)])
        diff = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
        line = (f"[agree] cnn {label} 2 rounds: acc cuda={hc} cpu={hp} "
                f"participants={nc} staleness={sc} max |param diff|={diff:.3e}")
        assert sc == sp, (label, sc, sp)
        if (devices[1], label) in steps:
            rows = [row for rec in steps[(devices[1], label)] for row in rec]
            res = quantized_agreement(pc, pp, rows or [[0.0] * len(pp)])
            print(f"{line} (elements past 1e-4: {res['flips']}, worst share "
                  f"{res['worst_share']:.2e}, within one step: {res['ok']})")
            assert res["ok"], (label, res)
        else:
            print(line)
            assert diff < 1e-4, (label, diff)
        assert nc == npart, (label, nc, npart)
        assert max(abs(a - b) for a, b in zip(hc, hp)) <= 1 / 120, (label, hc, hp)
    for mode, name, codec in TELEMETRY_AGREE:
        res = telemetry_toy_agreement(mode, name, codec, devices=devices)
        print(f"[agree] telemetry=full toy {mode} {name} {codec} 3 rounds: "
              f"outcomes, resolutions, rungs, bytes, participants, counters, "
              f"gauge names and alarms equal; max |beta diff| "
              f"{res['beta']:.3e}, max |distortion diff| "
              f"{res['distortion']:.3e}, max |param diff| {res['params']:.3e}")
        if codec == "fp32":
            assert res["params"] < 1e-4, res


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------
# |got - want| <= atol + rtol * |want| + row * RMS of want's output row (one
# head's hd values).  fp32 out: as tests/test_kernels.py.  bf16 out: both
# sides round an fp32 result once, which differs by at most one bf16 ulp,
# 2^-7 of |want| (under rtol); before that rounding the tensor-core flash
# kernel rounds P to bf16 (unit roundoff 2^-8), an error of about 2^-8 of
# the row's scale spread over its keys, under a 2% share of the row's RMS.
# The row's RMS is about sqrt(e / n) after n keys, so the limit shrinks with
# the output instead of staying a fixed 3e-2 that would exceed it.
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5, row=0.0),
            torch.bfloat16: dict(atol=0.0, rtol=1e-2, row=2e-2)}


def attention_error(got, want, tols=ATTN_TOL):
    """{"max_abs_err", "max_err_over_row_rms" (|got - want| over the RMS of
    its output row), "share_of_limit" (the largest |got - want| over its
    limit in ``tols``, ``ATTN_TOL`` unless given), "ok" (right dtype,
    shape, finite, within the limit everywhere)}."""
    tol = tols[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    limit = tol["atol"] + tol["rtol"] * w.abs() + tol["row"] * rms + \
        tol.get("tensor", 0.0) * w.pow(2).mean().sqrt()
    share = float((err / limit.clamp_min(1e-30)).max())
    return {"max_abs_err": float(err.max()),
            "max_err_over_row_rms": float((err / rms.clamp_min(1e-30)).max()),
            "share_of_limit": share,
            "ok": (got.dtype == want.dtype and got.shape == want.shape
                   and share <= 1.0 and bool(torch.isfinite(g).all()))}


# gemma-7b's forward (B=4 x S=4096, H = KV = 16, hd 256, causal): PERF.md
# section 6 row 5c
FLASH_GEMMA = (4, 4096, 4096, 16, 16, 256, True, None, torch.bfloat16)
# (B, Sq, Sk, H, KV, hd, causal, window, dtype); the first is qwen3-1.7b's
# prefill at train_4k's length, the shape the forward phase gives the kernel;
# then the bf16 kernel's tiling edges (128-row q and key tiles): S of 129,
# 255 and 1000, Sq != Sk, Sk under one key tile, rows with no valid key,
# g = H/KV of 1, 2 and 4, a window of 100 across tile edges, hd 32, 64 and
# 128; zamba2-1.2b's shared attention at its forward's shape; then the head
# dims past 128 and between the instantiations: gemma-7b's forward (hd
# 256, 16/16 heads) in bf16 and (shorter) in fp32, hd 256 with a window,
# with Sq != Sk and ragged tiles, with rows with no valid key; the smoke
# configs' hd 24 (starcoder2, windowed) and 48 (gemma); hd 96; hd 136,
# whose fourth 64-column box lies wholly past hd (TMA fills it with zeros);
# hd 8 and 16 (a 16- and 32-byte row under HD 32's 64-byte box); then the
# other dense configs' forwards as ``[dense]`` gives them: codeqwen1.5-7b
# (32/32 heads, hd 128), starcoder2-7b (36/4, g = 9, window 4096) and
# paper-vit-b16 (B=64 x S=197, 12/12, hd 64); then ``[zoo]``'s: the score
# forwards (B=4 x S=4096) of mixtral-8x22b (48/8, g = 6, window 4096) and
# llava-next-mistral-7b (32/8, window 4096, over 1,152 image positions and
# 2,944 tokens), seamless-m4t-large-v2's encoder (non-causal) and decoder
# (causal) at 16/16, hd 64, and its encoder over the 64 frames it serves
FLASH_CHECKS = [
    (4, 4096, 4096, 16, 8, 128, True, None, torch.bfloat16),
    (2, 2048, 2048, 16, 8, 128, True, 512, torch.bfloat16),
    (2, 1027, 1027, 16, 8, 128, True, None, torch.bfloat16),
    (1, 1500, 1500, 16, 8, 128, False, None, torch.bfloat16),
    (2, 777, 777, 16, 8, 128, True, None, torch.float32),
    (2, 300, 1000, 8, 2, 64, True, 128, torch.bfloat16),
    (2, 129, 129, 8, 8, 64, True, None, torch.bfloat16),
    (2, 255, 255, 8, 2, 32, True, None, torch.bfloat16),
    (1, 1000, 1000, 16, 8, 128, True, 100, torch.bfloat16),
    (2, 1000, 255, 8, 2, 64, False, None, torch.bfloat16),
    (2, 300, 100, 8, 2, 128, True, None, torch.bfloat16),
    (3, 255, 40, 8, 2, 32, False, 100, torch.bfloat16),
    (2, 1000, 1000, 16, 4, 128, False, 100, torch.bfloat16),
    (4, 4096, 4096, 32, 32, 64, True, None, torch.bfloat16),
    FLASH_GEMMA,
    (2, 1024, 1024, 16, 16, 256, True, None, torch.float32),
    (2, 1000, 1000, 16, 16, 256, True, 100, torch.bfloat16),
    (2, 300, 1000, 8, 2, 256, True, 128, torch.bfloat16),
    (1, 777, 777, 8, 8, 256, False, None, torch.float32),
    (2, 200, 40, 4, 4, 256, False, 8, torch.bfloat16),
    (2, 255, 255, 6, 2, 24, True, 64, torch.bfloat16),
    (2, 255, 255, 6, 2, 24, True, 64, torch.float32),
    (2, 300, 300, 4, 4, 48, True, None, torch.bfloat16),
    (2, 300, 300, 4, 4, 48, True, None, torch.float32),
    (2, 1000, 1000, 8, 2, 96, True, None, torch.bfloat16),
    (1, 500, 500, 8, 2, 96, False, None, torch.float32),
    (2, 500, 500, 4, 2, 136, True, None, torch.bfloat16),
    (2, 300, 300, 4, 2, 8, True, None, torch.bfloat16),
    (2, 300, 300, 4, 2, 8, True, None, torch.float32),
    (1, 500, 500, 4, 4, 16, False, 64, torch.bfloat16),
    (1, 500, 500, 4, 4, 16, False, 64, torch.float32),
    (4, 4096, 4096, 32, 32, 128, True, None, torch.bfloat16),
    (4, 4096, 4096, 36, 4, 128, True, 4096, torch.bfloat16),
    (64, 197, 197, 12, 12, 64, True, None, torch.bfloat16),
    (4, 4096, 4096, 48, 8, 128, True, 4096, torch.bfloat16),
    (4, 4096, 4096, 32, 8, 128, True, 4096, torch.bfloat16),
    (4, 4096, 4096, 16, 16, 64, False, None, torch.bfloat16),
    (4, 4096, 4096, 16, 16, 64, True, None, torch.bfloat16),
    (4, 64, 64, 16, 16, 64, False, None, torch.bfloat16),
]
# starcoder2-7b's forward at its published context (B=1 x S=16,384, window
# 4096), whose plain version over all rows would hold 38 GB of scores: the
# kernel runs on the whole sequence and each block of query rows [r0, r0 +
# n) is held against the plain version over rows and keys from r0 - window
# + 1 (keys before that are out of every row's window), blocks that lie
# before the first window's end, across it and 2 and 3.75 windows in
FLASH_LONG_CHECKS = [((1, 16384, 16384, 36, 4, 128, True, 4096, torch.bfloat16),
                      (0, 3584, 8192, 15360), 1024)]
# decode at hd 256: gemma-7b's serve run at its last step, and a 4,096-slot
# cache (PERF.md section 6 row 6b)
DECODE_GEMMA = [(4, 256, 16, 16, 256, 96, torch.bfloat16),
                (4, 4096, 16, 16, 256, 3001, torch.bfloat16)]
# (B, S, H, KV, hd, n_valid, dtype): qwen3-1.7b's group (g=2, hd=128); the
# first is the serve phase's cache at its last step, the first four are
# timed; the valid run wraps around the ring when n_valid < S.  Then
# zamba2-1.2b's serve shape (g=1, hd 64) and a ring at S=32,768 whose hole
# covers whole splits of the kernel; then gemma-7b's (hd 256) in bf16 and
# fp32, starcoder2-7b's group of 9 (G = 1) over a full 4,096-slot ring, the
# smoke configs' hd 24 and 48 and the padded hd 96 and 136, hd 8 and 16;
# then the serve shapes of codeqwen1.5-7b (32/32), starcoder2-7b (36/4),
# paper-vit-b16 (12/12, hd 64), mixtral-8x22b (48/8), llava-next-mistral-7b
# (32/8) and seamless-m4t-large-v2 (16/16, hd 64) at the serve run's last
# step
DECODE_CHECKS = [
    (4, 256, 16, 8, 128, 96, torch.bfloat16),
    (4, 4096, 16, 8, 128, 3001, torch.bfloat16),
    (4, 32768, 16, 8, 128, 30000, torch.bfloat16),
    (4, 32768, 16, 8, 128, 32768, torch.bfloat16),
    (4, 4096, 16, 8, 128, 4000, torch.float32),
    (4, 256, 32, 32, 64, 96, torch.bfloat16),
    (4, 32768, 16, 8, 128, 16384, torch.bfloat16),
    *DECODE_GEMMA,
    (4, 4096, 16, 16, 256, 4000, torch.float32),
    (4, 4096, 36, 4, 128, 4096, torch.bfloat16),
    (2, 64, 6, 2, 24, 40, torch.bfloat16),
    (2, 64, 6, 2, 24, 40, torch.float32),
    (2, 256, 4, 4, 48, 96, torch.bfloat16),
    (2, 256, 4, 4, 48, 96, torch.float32),
    (4, 1000, 8, 2, 96, 700, torch.bfloat16),
    (2, 500, 4, 2, 136, 300, torch.float32),
    (2, 300, 4, 2, 8, 200, torch.bfloat16),
    (2, 300, 4, 2, 8, 200, torch.float32),
    (2, 256, 4, 4, 16, 96, torch.bfloat16),
    (2, 256, 4, 4, 16, 96, torch.float32),
    (4, 256, 32, 32, 128, 96, torch.bfloat16),
    (4, 256, 36, 4, 128, 96, torch.bfloat16),
    (4, 256, 12, 12, 64, 96, torch.bfloat16),
    (4, 256, 48, 8, 128, 96, torch.bfloat16),
    (4, 256, 32, 8, 128, 96, torch.bfloat16),
    (4, 256, 16, 16, 64, 96, torch.bfloat16),
]


def attn_inputs(B, Sq, Sk, H, KV, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def flash_pairs(Sq, Sk, causal, window):
    """Unmasked (query, key) pairs: the work these inputs need."""
    qpos = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(qpos, max=Sk - 1) if causal else torch.full_like(qpos, Sk - 1)
    lo = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_bound(B, Sq, Sk, H, KV, hd, causal, window, dtype):
    isz = torch.empty((), dtype=dtype).element_size()
    flops = 4.0 * B * H * hd * flash_pairs(Sq, Sk, causal, window)
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * isz
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_bound(B, S, H, KV, hd, n_valid, dtype):
    """K/V rows of the valid slots, q, out and the mask: each read or written
    once.  Masked slots need not be read."""
    isz = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * n_valid * KV * hd + 2 * B * H * hd) * isz + S
    flops = 4.0 * B * H * hd * n_valid
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(name, got, want, label):
    torch.cuda.synchronize()
    e = attention_error(got, want)
    print(f"[attn] {name:16s} {label} max_abs_err={e['max_abs_err']:.3e} "
          f"max_err/row_rms={e['max_err_over_row_rms']:.3e} "
          f"share_of_limit={e['share_of_limit']:.3f} {'ok' if e['ok'] else 'FAIL'}")
    if not e["ok"]:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    return e["max_abs_err"]


def device_elapsed(fn, calls=10, sleep_cycles=20_000_000):
    """Device time from the start of ``fn``'s first kernel to the end of its
    last, host time excluded: CUDA events around one call enqueued behind a
    ``torch.cuda._sleep`` of ~10 ms, so the host has queued the call before
    the device reaches it; an ``Ms`` over ``calls`` samples."""
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    fn()
    samples = []
    for _ in range(calls):
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return Ms(samples)


def device_profile(fn, calls=20):
    """``device_ms`` of ``fn`` and, per call, each device operation's count
    and time by (shortened) name: kernels and copies, as the profiler
    records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in evs)
    per = {e.key[:60]: [e.count / calls,
                        round(e.self_device_time_total / 1e3 / calls, 6)]
           for e in evs}
    return (us / 1e3 / calls if us else None), per


def device_ms(fn, calls=20):
    """Device time per call of ``fn``: the CUDA kernels' time that
    torch.profiler records over ``calls`` calls, over ``calls``.  Where the
    host takes longer per call than the device, as for a short cache,
    ``cuda_times`` measures the host; this measures the kernels.  None
    when the profiler records no device events."""
    return device_profile(fn, calls)[0]


def decode_timing(B, S, H, KV, hd, nv, dt, label):
    """decode_attention with a prefix of ``nv`` valid slots, timed in turns
    with SDPA on the same inputs (kernel, SDPA, SDPA, kernel), then its
    plain version, then the device time per call of the kernel and of
    SDPA (``device_ms``); prints one line and returns the ``kernels``
    entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q, k, v = attn_inputs(B, 1, S, H, KV, hd, dt, seed=8)
    valid = torch.arange(S, device="cuda") < nv
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = valid[None, None, None, :]
    scale = 1.0 / hd ** 0.5

    def kernel():
        return ops.decode_attention(q, k, v, valid, scale=scale)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    k_ms, l_ms = cuda_times([kernel, sdpa], 50)
    p_ms = cuda_ms(lambda: ref.decode_attention(q, k, v, valid, scale=scale), 20)
    k_dev, l_dev = device_ms(kernel), device_ms(sdpa)
    b_ms, b_by = decode_bound(B, S, H, KV, hd, nv, dt)
    print(f"[{label}] decode_attention B={B} S={S} n_valid={nv} H={H} KV={KV} "
          f"hd={hd} {str(dt)[6:]}: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}) share_of_bound={b_ms / k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms(sdpa, in turns)={l_ms:.4f} device_ms(profiler): "
          f"kernel={k_dev} sdpa={l_dev}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(timing(k_ms, p_ms, b_ms, b_by, l_ms), device_ms=k_dev,
                library_device_ms=l_dev)


def flash_forward_timing(case=None):
    """flash_attention at qwen3-1.7b's forward shape (``FLASH_CHECKS[0]``,
    unless ``case`` gives another causal shape, as ``FLASH_GEMMA``; no lse:
    the serve and score paths' call) timed in turns with SDPA, then its
    plain version; prints one line and returns the ``kernels`` entry.  It
    calls only ``ops.flash_attention``, so it also times an older tree of
    the port (``PYTHONPATH`` at its ``src``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, Sq, Sk, H, KV, hd, causal, window, dt = case or FLASH_CHECKS[0]
    q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=7)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k_ms, l_ms = cuda_times([   # in turns: kernel, SDPA, SDPA, kernel
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)], 10)
    p_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True), 3)
    b_ms, b_by = flash_bound(B, Sq, Sk, H, KV, hd, causal, window, dt)
    print(f"[attn-time] flash_attention B={B} S={Sq} H={H} KV={KV} hd={hd} "
          f"causal bf16: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms(sdpa)={l_ms:.4f} "
          f"kernel_TFLOP/s={4.0 * B * H * hd * flash_pairs(Sq, Sk, True, None) / k_ms / 1e9:.2f}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return timing(k_ms, p_ms, b_ms, b_by, l_ms)


def phase_attention():
    """Each attention kernel against its plain version on the card, then
    timed by CUDA events at the main paths' shapes (and longer caches)
    against the plain version, the bound and SDPA (a yardstick only: the
    port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    errs = {"flash_attention": {}, "decode_attention": {},
            "flash_attention@hd256": {}, "decode_attention@hd256": {}}
    for i, (B, Sq, Sk, H, KV, hd, causal, window, dt) in enumerate(FLASH_CHECKS):
        q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=100 + i)
        kw = dict(causal=causal, window=window)
        e = check("flash_attention", ops.flash_attention(q, k, v, **kw),
                  ref.flash_attention(q, k, v, **kw),
                  f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
                  f"window={window} {str(dt)[6:]}")
        errs["flash_attention"][dt] = max(errs["flash_attention"].get(dt, 0.0), e)
        if hd == 256:
            errs["flash_attention@hd256"][dt] = max(
                errs["flash_attention@hd256"].get(dt, 0.0), e)
        del q, k, v
        torch.cuda.empty_cache()
    for i, (case, starts, n) in enumerate(FLASH_LONG_CHECKS):
        B, Sq, Sk, H, KV, hd, causal, window, dt = case
        q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=150 + i)
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, **kw)
        for r0 in starts:
            lo = max(0, r0 - window + 1)
            want = ref.flash_attention(q[:, lo:r0 + n], k[:, lo:r0 + n],
                                       v[:, lo:r0 + n], **kw)[:, r0 - lo:]
            e = check("flash_attention", got[:, r0:r0 + n], want,
                      f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                      f"causal={causal} window={window} {str(dt)[6:]} "
                      f"rows {r0}..{r0 + n - 1}")
            errs["flash_attention"][dt] = max(errs["flash_attention"].get(dt, 0.0), e)
            del want
        del q, k, v, got
        torch.cuda.empty_cache()
    for i, (B, S, H, KV, hd, nv, dt) in enumerate(DECODE_CHECKS):
        q, k, v = attn_inputs(B, 1, S, H, KV, hd, dt, seed=200 + i)
        valid = torch.arange(S, device="cuda") < nv
        if nv < S:                 # a ring buffer: the valid run wraps around
            valid = valid.roll(S // 3)
        scale = 1.0 / hd ** 0.5
        n_split = ops.decode_splits(q, k)
        e = check("decode_attention", ops.decode_attention(q, k, v, valid, scale=scale),
                  ref.decode_attention(q, k, v, valid, scale=scale),
                  f"B={B} S={S} H={H} KV={KV} hd={hd} n_valid={nv} "
                  f"{str(dt)[6:]} splits={n_split}")
        errs["decode_attention"][dt] = max(errs["decode_attention"].get(dt, 0.0), e)
        if hd == 256:
            errs["decode_attention@hd256"][dt] = max(
                errs["decode_attention@hd256"].get(dt, 0.0), e)
        del q, k, v
    torch.cuda.empty_cache()

    timings = {"flash_attention": flash_forward_timing()}
    B, Sq, Sk, H, KV, hd, causal, window, dt = FLASH_CHECKS[0]
    q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=7)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    # the fp32 variant (FMA pipes) at the same shape, off the model's path
    q, k, v = (t.float() for t in (q, k, v))
    qt, kt, vt = (t.float() for t in (qt, kt, vt))
    k32 = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), 3)
    l32 = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 3)
    b32, by32 = flash_bound(B, Sq, Sk, H, KV, hd, causal, window, torch.float32)
    print(f"[attn-time] flash_attention B={B} S={Sq} H={H} KV={KV} hd={hd} "
          f"causal fp32: kernel_ms={k32:.4f} bound_ms={b32:.4f} ({by32}) "
          f"share_of_bound={b32 / k32:.4f} library_ms(sdpa)={l32:.4f}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    for i, shape in enumerate(DECODE_CHECKS[:4]):
        t = decode_timing(*shape, label="attn-time")
        if i == 0:                         # the serve phase's shape
            timings["decode_attention"] = t
    # rows 5c and 6b: gemma-7b's forward and decode at hd 256
    timings["flash_attention@hd256"] = flash_forward_timing(FLASH_GEMMA)
    for i, shape in enumerate(DECODE_GEMMA):
        t = decode_timing(*shape, label="attn-time")
        if i == 0:
            timings["decode_attention@hd256"] = t
    torch.cuda.empty_cache()
    return errs, timings


# ---------------------------------------------------------------------------
# the LLM serving path
# ---------------------------------------------------------------------------
def profile_kernels(fn, label, ours, wall_ms=None, top=10, host_ops=False):
    """``fn`` timed on the host clock (unless its unprofiled ``wall_ms`` is
    given), then run again under torch.profiler: device kernel time, busy
    share (kernel time over the unprofiled wall), launches, the time of the
    kernels named in ``ours`` and the ``top`` kernels.  The profiler traces
    the device alone, at about a third of the cost of tracing the host's
    operators too and with the same kernel time, but on the H100 it kept
    only about 65.6k kernel records of a 68.8k-launch LoRA round: a run of
    more launches than that passes ``host_ops=True``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if wall_ms is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    label = f"{label} (profiled in {time.perf_counter() - t0:.1f} s)"
    if not kernels:
        print(f"[profile] {label}: wall_ms={wall_ms:.1f} device time: not "
              "measured (the profiler recorded no device events)")
        return
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    own = {name: sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3
           for name, key in ours.items()}
    print(f"[profile] {label}: wall_ms={wall_ms:.1f} kernel_ms={dev_ms:.1f} "
          f"busy_share={dev_ms / wall_ms:.3f} "
          f"kernel_launches={sum(e.count for e in kernels)} "
          + " ".join(f"{n}_ms={t:.3f}" for n, t in own.items()))
    for e in kernels[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:100]}")


def phase_serve(device="cuda", smoke=False):
    """``generate`` on full-width qwen3-1.7b, as ``python -m
    repro_torch.launch.serve --smoke-scale=false`` runs it.  The CPU
    rehearsal of this script passes ``device="cpu", smoke=True``."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("qwen3-1.7b")
    B, P, steps, cache_len = 4, 64, 32, 256
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device)
    sync(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[serve] {cfg.name}: {n_params} params ({cfg.dtype}), "
          f"{cfg.num_layers} layers, init {time.perf_counter() - t0:.2f} s")
    norms = cfg.num_layers * (2 * cfg.d_model + 2 * cfg.resolved_head_dim) + cfg.d_model
    assert n_params == cfg.param_count() + norms, n_params   # full width and depth
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                            generator=torch.Generator(device=device).manual_seed(0))
    generate(params, cfg, prompts[:, :2], 1, cache_len)         # warm-up
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = generate(params, cfg, prompts, steps, cache_len)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    print(f"[serve] arch={cfg.name} B={B} prefill({P} tok)={res['prefill_s']:.4f}s "
          f"decode={steps} steps {res['decode_s']:.4f}s -> {res['tok_s']:.1f} tok/s "
          f"({res['decode_s'] / steps * 1e3:.3f} ms/step) peak_mem_bytes={peak} "
          f"launches={launches}")
    expect = (P + steps) * cfg.num_layers if cuda else 0
    assert launches["decode_attention"] == expect, launches
    assert not cuda or smoke or expect == 2688
    assert launches["flash_attention"] == 0, launches
    toks = res["tokens"]
    assert toks.shape == (B, steps + 1) and int(toks.min()) >= 0 \
        and int(toks.max()) < cfg.vocab_size
    assert res["logits"].shape == (B, cfg.vocab_size) and \
        bool(torch.isfinite(res["logits"]).all())
    print(f"[serve] sample: {toks[0][:16].tolist()}")
    if not cuda:
        return launches

    state = T.init_decode_state(params, cfg, B, cache_len)
    for t in range(8):
        _, state = T.decode_step(params, cfg, state, prompts[:, t:t + 1])

    def four_steps():
        nonlocal state
        for _ in range(4):
            _, state = T.decode_step(params, cfg, state, prompts[:, :1])

    profile_kernels(four_steps, f"serve: 4 decode steps of {cfg.name} B={B}",
                    {"decode_attention": "decode_attention"})
    return launches


def phase_serve_long(device="cuda", smoke=False, cache_len=32768,
                     length=30000, steps=16):
    """qwen3-1.7b decoding from a long cache: full width and depth from seed
    0, B=4, a ``cache_len``-slot cache (qwen3's published context) whose
    every layer's K and V are filled in place with bf16 normal values from a
    seeded generator on the device, the state advanced to ``length`` (after
    the next write a prefix of length + 1 valid slots); ``steps`` greedy
    ``decode_step``s timed after a synchronize, then 4 more profiled.  The
    CPU rehearsal passes ``device="cpu", smoke=True`` and a short cache."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("qwen3-1.7b")
    B = 4
    params = T.init_params(cfg, 0, device)
    state = T.init_decode_state(params, cfg, B, cache_len)
    k, v = state["layers"].k, state["layers"].v
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    for i in range(cfg.num_layers):
        k[i].normal_(generator=gen)
        v[i].normal_(generator=gen)
    sync(device)
    fill_s = time.perf_counter() - t0
    cache_bytes = 2 * k.numel() * k.element_size()
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=device, generator=gen)
    T.decode_step(params, cfg, {"layers": KVCache(k, v, length)}, tok)  # warm-up
    state = {"layers": KVCache(k, v, length)}   # slot `length` is rewritten
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = T.decode_step(params, cfg, state, tok)
        tok = logits.argmax(-1, keepdim=True)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    print(f"[serve-long] {cfg.name} B={B} cache={cache_len} slots "
          f"({cache_bytes} bytes of K/V, filled in {fill_s:.2f} s) from "
          f"length {length}: {steps} decode steps {wall:.4f} s -> "
          f"{wall / steps * 1e3:.3f} ms/step {B * steps / wall:.1f} tok/s "
          f"peak_mem_bytes={peak} launches={launches}")
    expect = steps * cfg.num_layers if cuda else 0
    assert launches["decode_attention"] == expect, launches
    assert not cuda or smoke or expect == 448
    assert state["layers"].length == length + steps
    assert logits.shape == (B, cfg.vocab_size) and \
        bool(torch.isfinite(logits).all())
    if cuda:
        def four_steps():
            nonlocal state
            for _ in range(4):
                _, state = T.decode_step(params, cfg, state, tok)

        profile_kernels(four_steps, f"serve-long: 4 decode steps of {cfg.name} "
                        f"B={B} from a {cache_len}-slot cache",
                        {"decode_attention": "decode_attention"})
    return {"ms_per_step": wall / steps * 1e3, "launches": launches}


def phase_forward(device="cuda", smoke=False, S=4096):
    """``forward`` (prefill / score) on full-width qwen3-1.7b, B=4, S=4096,
    under ``torch.no_grad()``.  The CPU rehearsal passes ``device="cpu",
    smoke=True`` and a short S."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("qwen3-1.7b")
    B = 4
    params = T.init_params(cfg, 1, device)
    stream = make_bigram_stream(8 * S, cfg.vocab_size, domain=0, n_domains=1, seed=0)
    toks, labels = next(batches_from_stream(stream, B, S, seed=0))
    batch = {"tokens": torch.from_numpy(toks).long().to(device),
             "labels": torch.from_numpy(labels).long().to(device)}
    with torch.no_grad():
        T.forward(params, cfg, {k: v[:, :512] for k, v in batch.items()})  # warm-up
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, metrics = T.forward(params, cfg, batch)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        ln_v = float(np.log(cfg.vocab_size))
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        print(f"[forward] {cfg.name} B={B} S={S}: loss={float(loss):.4f} "
              f"(ln V = {ln_v:.4f}) tokens={int(metrics['target_tokens'])} "
              f"wall_s={wall:.4f} tok/s={B * S / wall:.1f} "
              f"peak_mem_bytes={peak} launches={launches}")
        assert launches["flash_attention"] == (cfg.num_layers if cuda else 0), launches
        assert not cuda or smoke or launches["flash_attention"] == 28
        assert launches["decode_attention"] == 0, launches
        assert bool(torch.isfinite(loss)) and abs(float(loss) - ln_v) < 1.0, float(loss)
        if cuda:
            profile_kernels(lambda: T.forward(params, cfg, batch),
                            f"forward: {cfg.name} B={B} S={S}",
                            {"flash_attention": "flash_attention"})
    return launches


# the dense configs served and scored at full width by ``[dense]``
DENSE_ARCHS = ("codeqwen1.5-7b", "starcoder2-7b", "gemma-7b", "paper-vit-b16")
# MoE, MLA with MoE, the encoder-decoder and the VLM prefix (``[zoo]``)
ZOO_ARCHS = ("mixtral-8x22b", "deepseek-v2-236b", "seamless-m4t-large-v2",
             "llava-next-mistral-7b")
# every arch the port serves, held card against CPU by ``llm_agreement``
LLM_ARCHS = ("qwen3-1.7b", "zamba2-1.2b") + DENSE_ARCHS + ZOO_ARCHS


def dense_extra_params(cfg):
    """What ``ModelConfig.param_count`` leaves out of the homogeneous stack:
    the norms' scales, the attention biases and the GELU FFN's biases."""
    hd, per_layer = cfg.resolved_head_dim, 2 * cfg.d_model
    if cfg.qk_norm:
        per_layer += 2 * hd
    if cfg.attn_bias:
        per_layer += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    if cfg.ffn_activation == "gelu":
        per_layer += cfg.d_ff + cfg.d_model
    return cfg.num_layers * per_layer + cfg.d_model


def attn_launches(launches):
    return {k: launches[k] for k in ("flash_attention", "decode_attention")}


# |loss - init_loss_prediction| in nats: the label's and the own token's
# logits are exact, and the sum of the other V - 1 exp(z_j), lognormal with
# s^2|h|^2 of about 1.2-1.8, strays from its expectation by about
# sqrt(e^(s^2|h|^2) - 1 / V), under 1% of a token's sum at V >= 32,000 and
# averaged over thousands of tokens; bf16 rounds each logit by up to 2^-9
# of itself, with either sign
DENSE_LOSS_TOL = 0.05
# how far the kernels may move a forward's last hidden states from the
# plain attention's, as a multiple of how far the one rounding that the
# bf16 flash kernel adds, P to bf16 before P V
# (``plain_attention_bf16_p``), moves them: through 28-32 random layers
# that rounding alone moves them by 1-2% of their RMS, so a fixed share
# would not tell the rounding from a fault, which moves them by O(1)
DENSE_HIDDEN_RATIO = 2.0


@contextlib.contextmanager
def plain_flash_attention(plain=None):
    """``ops.flash_attention`` swapped for ``plain`` (its plain version
    unless given) while the block runs: the models call it through the
    module, so a forward inside runs the same weights and tokens with the
    plain attention (no launch)."""
    from repro_torch.kernels import ops, ref
    kernel = ops.flash_attention
    ops.flash_attention = plain or ref.flash_attention
    try:
        yield
    finally:
        ops.flash_attention = kernel


def plain_attention_bf16_p(q, k, v, *, causal=True, window=None, scale=None):
    """The plain flash_attention with the rounding that the bf16 kernel
    adds to it: P = exp(s - row max) rounded to q's dtype before P V, the
    row sum taken from the unrounded P (the kernel rounds against its
    running max, so its rounding differs but is of the same size)."""
    from repro_torch.kernels import ref
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / hd ** 0.5
    s, _ = ref._masked_scores(q, k, causal, window, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p.to(q.dtype).float() / p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def init_loss_prediction(h, w, tokens, labels):
    """The next-token loss that a model at init gives on its last hidden
    states ``h`` (B, S, d, after the final norm) and head ``w`` (d, V),
    token by token ln sum_j exp(z_j) - z_label with z = h w: the label's
    logit and the input token's own logit z_x taken exactly (a tied head
    makes z_x large where the token's embedding dominates the residual
    stream, as gemma's, scaled by sqrt(d), do), and the other V - 1 by their
    expectation, (V - 1) exp(s^2 |h|^2 / 2), s^2 the head's mean square (its
    columns drawn independently of h).  Masked labels (< 0) are left out."""
    m = labels >= 0
    hf = h[m].float()
    zx = (hf * w[:, tokens[m]].T.float()).sum(-1)
    zy = (hf * w[:, labels[m]].T.float()).sum(-1)
    s2 = sum(float(c.float().pow(2).sum(dtype=torch.float64))
             for c in w.split(8192, dim=1)) / w.numel()
    rest = float(np.log(w.shape[1] - 1)) + 0.5 * s2 * hf.pow(2).sum(-1)
    return float((torch.logaddexp(rest, zx) - zy).mean())


def dense_score(params, cfg, B, S, device, label, plain_len=6144):
    """``forward`` under ``torch.no_grad()`` at (B, S) after a warm-up: one
    flash_attention launch per layer and none of decode_attention on the
    card; a finite loss within ``DENSE_LOSS_TOL`` of
    ``init_loss_prediction`` on the same batch's hidden states (and, but
    for gemma's, whose own-token logits lift it, within 0.5 of ln V +
    σ²/2, σ² = 0.02² d); and the last hidden states of the first rows'
    first ``plain_len`` tokens as close to the same forward with the plain
    attention (``plain_flash_attention``; causal, so the slice's states do
    not depend on the tokens after it) as ``DENSE_HIDDEN_RATIO`` times the
    distance that rounding P to bf16 in the plain attention puts between
    them (``plain_attention_bf16_p``), each the RMS of the difference over
    the RMS of the plain forward's states.  Returns the printed numbers."""
    from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cuda = torch.device(device).type == "cuda"
    stream = make_bigram_stream(max(8 * S * B, 200_000), cfg.vocab_size,
                                domain=0, n_domains=1, seed=0)
    toks, labels = next(batches_from_stream(stream, B, S, seed=0))
    batch = {"tokens": torch.from_numpy(toks).long().to(device),
             "labels": torch.from_numpy(labels).long().to(device)}
    chunk = 512 if S % 512 == 0 else S
    with torch.no_grad():
        T.forward(params, cfg, {k: v[:1, :min(S, 256)] for k, v in batch.items()},
                  loss_chunk=min(chunk, 256))                        # warm-up
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, metrics = T.forward(params, cfg, batch, loss_chunk=chunk)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        h, _ = T.hidden_states(params, cfg, batch)
        pred = init_loss_prediction(h, T.lm_head_w(params, cfg),
                                    batch["tokens"], batch["labels"])
        rows, n = (1, min(S, plain_len)) if S > plain_len // 4 else (B, S)
        sl = {k: v[:rows, :n] for k, v in batch.items()}
        with plain_flash_attention():
            h_plain = T.hidden_states(params, cfg, sl)[0].float()
        with plain_flash_attention(plain_attention_bf16_p):
            h_round = T.hidden_states(params, cfg, sl)[0].float()
        rms = h_plain.pow(2).mean().sqrt()
        h_err = float((h[:rows, :n].float() - h_plain).pow(2).mean().sqrt() / rms)
        h_floor = float((h_round - h_plain).pow(2).mean().sqrt() / rms)
        del h, h_plain, h_round
    naive = float(np.log(cfg.vocab_size)) + 0.5 * 0.02 ** 2 * cfg.d_model
    print(f"[dense] {label} forward B={B} S={S}: loss={float(loss):.4f} "
          f"(predicted from the hidden states {pred:.4f}; ln V + σ²/2 = "
          f"{naive:.4f}) wall_s={wall:.4f} tok/s={B * S / wall:.1f} "
          f"peak_mem_bytes={peak} launches={attn_launches(launches)}; "
          f"last hidden states of {rows} x {n} tokens against the plain "
          f"attention: rms err / rms={h_err:.3e}, with P rounded to bf16 "
          f"{h_floor:.3e} (ratio {h_err / max(h_floor, 1e-30):.3f})")
    assert launches["flash_attention"] == (cfg.num_layers if cuda else 0), launches
    assert launches["decode_attention"] == 0, launches
    assert int(metrics["target_tokens"]) > 0
    assert bool(torch.isfinite(loss)), float(loss)
    assert abs(float(loss) - pred) <= DENSE_LOSS_TOL, (float(loss), pred)
    if not cfg.name.startswith("gemma"):
        assert abs(float(loss) - naive) < 0.5, (float(loss), naive)
    assert h_err <= DENSE_HIDDEN_RATIO * h_floor, (h_err, h_floor)
    return {"wall_s": wall, "tok_s": B * S / wall, "peak": peak,
            "launches": launches, "loss": float(loss), "predicted": pred,
            "hidden_err": h_err, "hidden_floor": h_floor}


def dense_ring_decode(params, cfg, device, cache_len=4096, length=6000,
                      steps=16, B=4):
    """``steps`` greedy ``decode_step``s from a ``cache_len``-slot ring (the
    sliding window's size) whose every layer's K and V are filled in place
    from a seeded generator, the state advanced to ``length`` past
    ``cache_len``, so the ring has wrapped and every slot holds a key of the
    window; one decode_attention launch per layer and step on the card."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache
    cuda = torch.device(device).type == "cuda"
    state = T.init_decode_state(params, cfg, B, cache_len)
    k, v = state["layers"].k, state["layers"].v
    assert k.shape[2] == min(cache_len, cfg.sliding_window or cache_len)
    gen = torch.Generator(device=device).manual_seed(0)
    for i in range(cfg.num_layers):
        k[i].normal_(generator=gen)
        v[i].normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=device, generator=gen)
    T.decode_step(params, cfg, {"layers": KVCache(k, v, length)}, tok)  # warm-up
    state = {"layers": KVCache(k, v, length)}
    sync(device)
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = T.decode_step(params, cfg, state, tok)
        tok = logits.argmax(-1, keepdim=True)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    print(f"[dense] {cfg.name} ring decode B={B} cache={k.shape[2]} slots "
          f"from length {length}: {steps} steps {wall:.4f} s -> "
          f"{wall / steps * 1e3:.3f} ms/step "
          f"launches={attn_launches(launches)}")
    assert launches["decode_attention"] == (steps * cfg.num_layers if cuda else 0)
    assert launches["flash_attention"] == 0, launches
    assert bool(torch.isfinite(logits).all())
    return wall / steps * 1e3


def phase_dense(device="cuda", smoke=False, S=4096, long_S=16384,
                ring_len=4096, ring_at=6000):
    """The dense configs at full width and depth in bf16, one at a time
    (each freed before the next), from seed 0, as ``python -m
    repro_torch.launch.serve --arch <name> --smoke-scale=false`` and
    ``transformer.forward`` run them: params and init time; serve
    (``generate``, B=4, prompt 64, 32 greedy steps, 256 slots) with one
    decode_attention launch per layer and step; score (``forward`` under
    ``torch.no_grad()``, B=4 x S=4096, paper-vit-b16 B=64 x S=197: 196
    patches and a class token) with one flash_attention launch per layer;
    for starcoder2-7b's 4,096-token window also a forward at B=1 x S=16,384
    (its published context: the window prunes most key tiles) and 16
    decode steps from a wrapped 4,096-slot ring.  The CPU rehearsal passes
    ``device="cpu", smoke=True`` and short lengths.  Returns {arch:
    numbers}."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    out = {}
    for arch in DENSE_ARCHS:
        cfg = (get_smoke_config if smoke else get_config)(arch)
        t0 = time.perf_counter()
        params = T.init_params(cfg, 0, device)
        sync(device)
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[dense] {cfg.name}: {n_params} params ({cfg.dtype}), "
              f"{cfg.num_layers} layers, hd {cfg.resolved_head_dim}, "
              f"H/KV {cfg.num_heads}/{cfg.num_kv_heads}, init {init_s:.2f} s")
        assert n_params == cfg.param_count() + dense_extra_params(cfg), n_params
        r = {"params": n_params, "init_s": init_s}

        B, P, steps, cache_len = 4, 64, 32, 256
        prompts = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                                generator=torch.Generator(device=device).manual_seed(0))
        generate(params, cfg, prompts[:, :2], 1, cache_len)         # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        res = generate(params, cfg, prompts, steps, cache_len)
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        ms_step = res["decode_s"] / steps * 1e3
        print(f"[dense] {cfg.name} serve B={B} prefill({P} tok)="
              f"{res['prefill_s']:.4f}s decode={steps} steps "
              f"{res['decode_s']:.4f}s -> {res['tok_s']:.1f} tok/s "
              f"({ms_step:.3f} ms/step) peak_mem_bytes={peak} "
              f"launches={attn_launches(launches)}")
        assert launches["decode_attention"] == \
            ((P + steps) * cfg.num_layers if cuda else 0), launches
        assert launches["flash_attention"] == 0, launches
        toks = res["tokens"]
        assert toks.shape == (B, steps + 1) and int(toks.min()) >= 0 \
            and int(toks.max()) < cfg.vocab_size
        assert bool(torch.isfinite(res["logits"]).all())
        r.update(prefill_s=res["prefill_s"], ms_per_step=ms_step,
                 decode_tok_s=res["tok_s"], serve_peak=peak,
                 serve_launches=launches)

        sB, sS = (64, 197) if arch == "paper-vit-b16" else (4, S)
        r["score"] = dense_score(params, cfg, sB, sS, device, cfg.name)
        if cfg.sliding_window:
            r["score_long"] = dense_score(params, cfg, 1, long_S, device,
                                          f"{cfg.name} (window "
                                          f"{cfg.sliding_window})")
            r["ring_ms_per_step"] = dense_ring_decode(
                params, cfg, device, cache_len=ring_len, length=ring_at)
        out[arch] = r
        del params, res, prompts
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def llm_agreement(arch="qwen3-1.7b"):
    """``arch``'s smoke config in fp32, the same params and tokens on the
    card and on the CPU: the forward loss and 40 decode steps' logits (the
    32-slot ring wraps; starcoder2's and the windowed configs' 64-token
    window holds the whole ring; deepseek's MLA cache is no ring and has 64
    slots); the VLM scores 16 image embeddings before its tokens, the
    enc-dec 24 encoder frames, encoded once more for the decode.  The
    attention kernels (at the smoke configs' head dims: 24, 32, 48 and 64,
    the padded ones zero-filled in the kernel) and cuBLAS (TF32 off)
    against the plain versions.  Returns {"loss": {dev: loss},
    "loss_diff", "logit_diff", "launches": {dev: counts}, "expected":
    counts} after asserting ``zoo_launches``' counts (a flash_attention
    launch per GQA layer a forward, plus one per encoder layer and
    encoding; a decode_attention launch per GQA layer a step) and
    agreement within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    fwd, per_step = zoo_launches(cfg)
    n_enc = cfg.num_encoder_layers if cfg.encoder_decoder else 0
    p_cpu = T.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    extra, labels = {}, toks.roll(-1, 1)
    if cfg.vision_frontend:
        extra["image_embeds"] = torch.randn(2, cfg.num_image_tokens,
                                            cfg.d_model, generator=g)
        labels = torch.cat([torch.full((2, cfg.num_image_tokens), -1), labels], 1)
    if cfg.encoder_decoder:
        extra["encoder_embeds"] = torch.randn(2, 24, cfg.d_model, generator=g)
    loss, logits, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        batch = {"tokens": toks.to(dev), "labels": labels.to(dev),
                 **{k: v.to(dev) for k, v in extra.items()}}
        ops.reset_launches()
        loss[dev] = float(T.forward(p, cfg, batch, loss_chunk=16)[0])
        state = T.init_decode_state(p, cfg, 2, 64 if cfg.mla else 32,
                                    encoder_embeds=batch.get("encoder_embeds"))
        steps = []
        for t in range(40):
            lg, state = T.decode_step(p, cfg, state, batch["tokens"][:, t:t + 1])
            steps.append(lg.cpu())
        logits[dev] = torch.stack(steps)
        launches[dev] = dict(ops.launches)
    expected = {"flash_attention": fwd + n_enc, "decode_attention": 40 * per_step}
    d_loss = abs(loss["cuda"] - loss["cpu"])
    d_logit = float((logits["cuda"] - logits["cpu"]).abs().max())
    for name, n in expected.items():
        assert launches["cuda"][name] == n, (launches, expected)
        assert launches["cpu"][name] == 0, launches
    assert d_loss <= 1e-4 * (1 + abs(loss["cpu"])), d_loss
    assert d_logit <= 1e-4, d_logit
    return {"loss": loss, "loss_diff": d_loss, "logit_diff": d_logit,
            "launches": launches, "expected": expected}


def phase_llm_agreement():
    for arch in LLM_ARCHS:
        r = llm_agreement(arch)
        print(f"[agree-llm] {arch}-smoke fp32: loss cuda={r['loss']['cuda']:.6f} "
              f"cpu={r['loss']['cpu']:.6f} |diff|={r['loss_diff']:.3e}; 40 "
              f"decode steps max |logit diff|={r['logit_diff']:.3e}; cuda "
              f"launches={r['launches']['cuda']}")


# ---------------------------------------------------------------------------
# the rest of the zoo: MoE, MLA with MoE, the encoder-decoder, the VLM prefix
# ---------------------------------------------------------------------------
# the depth the two MoE configs run at on one 80 GB card, at their published
# width and expert count (281 GB and 479 GB of bf16 weights at full depth):
# 8 of mixtral-8x22b's 56 layers, deepseek-v2-236b's dense layer 0 and 5 of
# its 59 MoE layers
ZOO_LAYERS = {"mixtral-8x22b": 8, "deepseek-v2-236b": 6}
# the query rows of one chunk of deepseek's plain MLA attention when it
# scores B=4 x S=4096: 4 x 128 heads x 256 rows x 4,096 keys of fp32 scores
# are 2.1 GB (a 2,048-row chunk, the default, would be 17 GB, and the mask
# and the softmax each hold another)
ZOO_Q_CHUNK = {"deepseek-v2-236b": 256}
# the kernels ``[zoo]``'s profiles sum by name: ours, cuBLAS's GEMMs
# (``gemm``, and the ``nvjet`` kernels of cuBLASLt) and the MoE's sorts
ZOO_PROFILE_KEYS = {"flash_attention": "flash_attention",
                    "decode_attention": "decode_attention", "gemm": "gemm",
                    "nvjet": "nvjet", "sort": "sort"}


def zoo_config(arch, smoke=False):
    """``arch``'s smoke config, or its published one cut to ``ZOO_LAYERS``."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    if smoke:
        return get_smoke_config(arch)
    cfg = get_config(arch)
    if arch in ZOO_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=ZOO_LAYERS[arch])
    return cfg


def zoo_launches(cfg):
    """(flash_attention launches a forward, decode_attention launches a
    decode step) on the card: one of each per GQA attention layer, and a
    non-causal flash launch per encoder layer; MLA launches neither (its
    attention is the plain ``sdpa`` and the absorbed fp32 decode)."""
    from repro_torch.configs.base import ATTN, SHARED_ATTN
    gqa = 0 if cfg.mla else sum(k in (ATTN, SHARED_ATTN)
                                for k in cfg.layer_kinds())
    return gqa + (cfg.num_encoder_layers if cfg.encoder_decoder else 0), gqa


def zoo_inputs(cfg, B, S, device, seed=0):
    """A score batch of S positions from ``seed``: bigram-stream tokens (S
    minus the image positions for the VLM) and their next tokens as labels,
    N(0, 1) image embeddings (VLM, ``num_image_tokens`` of them, labels -1
    there) or S encoder frames (enc-dec), as the JAX package's smoke tests
    draw them.  Returns (batch, the tokens aligned with the labels, 0 at
    image positions, for ``init_loss_prediction``)."""
    from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
    from repro_torch.models.transformer import torch_dtype
    n_img = cfg.num_image_tokens if cfg.vision_frontend else 0
    St = S - n_img
    stream = make_bigram_stream(max(8 * St * B, 200_000), cfg.vocab_size,
                                domain=0, n_domains=1, seed=seed)
    toks, labels = (torch.from_numpy(a).long().to(device) for a in
                    next(batches_from_stream(stream, B, St, seed=seed)))
    batch = {"tokens": toks, "labels": labels}
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg)
    aligned = toks
    if n_img:
        batch["image_embeds"] = torch.randn((B, n_img, cfg.d_model), generator=gen,
                                            device=device).to(dt)
        pad = torch.full((B, n_img), -1, dtype=torch.long, device=device)
        batch["labels"] = torch.cat([pad, labels], 1)
        aligned = torch.cat([pad.clamp_min(0), toks], 1)
    if cfg.encoder_decoder:
        batch["encoder_embeds"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                              device=device).to(dt)
    return batch, aligned


def zoo_score(params, cfg, B, S, device, q_chunk):
    """``forward`` under ``torch.no_grad()`` at B x S positions
    (``zoo_inputs``) after a warm-up: ``zoo_launches``' flash_attention
    count and no decode_attention on the card, one MoE read-back per MoE
    layer, a finite ``ce_loss`` within ``DENSE_LOSS_TOL`` of
    ``init_loss_prediction`` on the same batch's hidden states (``loss``
    adds the aux loss).  Returns the printed numbers."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cuda = torch.device(device).type == "cuda"
    batch, aligned = zoo_inputs(cfg, B, S, device)
    n_img = cfg.num_image_tokens if cfg.vision_frontend else 0
    chunk = 512 if S % 512 == 0 else S
    with torch.no_grad():
        warm, _ = zoo_inputs(cfg, 1, n_img + min(S - n_img, 256), device, seed=1)
        T.forward(params, cfg, warm, loss_chunk=warm["labels"].shape[1],
                  q_chunk=q_chunk)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        moe.reset_readbacks()
        t0 = time.perf_counter()
        loss, metrics = T.forward(params, cfg, batch, loss_chunk=chunk,
                                  q_chunk=q_chunk)
        sync(device)
        wall = time.perf_counter() - t0
        launches, readbacks = dict(ops.launches), moe.readbacks["moe_group_sizes"]
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        h, _ = T.hidden_states(params, cfg, batch, q_chunk=q_chunk)
        pred = init_loss_prediction(h, T.lm_head_w(params, cfg), aligned,
                                    batch["labels"])
        del h
        if cuda:
            profile_kernels(lambda: T.forward(params, cfg, batch, loss_chunk=chunk,
                                              q_chunk=q_chunk),
                            f"zoo: score forward of {cfg.name} B={B} S={S}",
                            ZOO_PROFILE_KEYS, wall_ms=wall * 1e3)
    ce, aux = float(metrics["ce_loss"]), float(metrics["aux_loss"])
    what = (f"{n_img} image embeddings + {S - n_img} tokens" if n_img else
            f"{S} encoder frames + {S} tokens" if cfg.encoder_decoder else
            f"{S} tokens")
    print(f"[zoo] {cfg.name} score B={B} x {what}: ce_loss={ce:.4f} "
          f"(predicted from the hidden states {pred:.4f}) aux_loss={aux:.6f} "
          f"wall_s={wall:.4f} tok/s={B * S / wall:.1f} peak_mem_bytes={peak} "
          f"launches={attn_launches(launches)} moe_readbacks={readbacks}"
          f"{f' q_chunk={q_chunk}' if cfg.mla else ''}")
    want_fwd = zoo_launches(cfg)[0]
    assert launches["flash_attention"] == (want_fwd if cuda else 0), launches
    assert launches["decode_attention"] == 0, launches
    assert readbacks == (T.n_stacked(cfg) if cfg.moe else 0), readbacks
    assert int(metrics["target_tokens"]) > 0
    assert bool(torch.isfinite(loss)), float(loss)
    assert (aux > 0) == cfg.moe, aux
    assert abs(ce - pred) <= DENSE_LOSS_TOL, (ce, pred)
    return {"wall_s": wall, "tok_s": B * S / wall, "peak": peak,
            "launches": launches, "readbacks": readbacks, "loss": ce,
            "aux_loss": aux, "predicted": pred}


def phase_zoo(device="cuda", smoke=False, S=4096, score_B=4):
    """The rest of the zoo in bf16 from seed 0, one config at a time (each
    freed before the next): mixtral-8x22b and deepseek-v2-236b at their
    published width and expert count, cut to ``ZOO_LAYERS``;
    seamless-m4t-large-v2 and llava-next-mistral-7b as published.  For
    each: params and init time; serve as ``python -m
    repro_torch.launch.serve --arch <name> --smoke-scale=false`` runs it
    (``generate``, B=4, prompt 64, 32 greedy steps, 256 slots; seamless
    with 64 encoder frames from the seed, encoded once in
    ``init_decode_state``), with ``zoo_launches``' decode_attention count a
    step (seamless's encoding adds one non-causal flash_attention launch
    per encoder layer) and one MoE read-back per MoE layer a step, and a
    short serve run twice with its tokens and logits equal bit for bit; score
    (``zoo_score``, B=4 x S=4096: llava 1,152 image embeddings and 2,944
    tokens, seamless 4,096 frames and 4,096 tokens, deepseek's MLA in
    ``ZOO_Q_CHUNK`` rows).  On the card 4 decode steps and the score
    forward are profiled (kernel time, busy share, launches, the top
    kernels).  The CPU rehearsal passes ``device="cpu",
    smoke=True`` and a short S.  Returns {arch: numbers}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    out = {}
    for arch in ZOO_ARCHS:
        cfg = zoo_config(arch, smoke)
        t0 = time.perf_counter()
        params = T.init_params(cfg, 0, device)
        sync(device)
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[zoo] {cfg.name}: {n_params} params ({cfg.dtype}), "
              f"{cfg.num_layers} decoder layers"
              f"{f' of {T.n_stacked(cfg)} stacked' if cfg.first_k_dense else ''}"
              f"{f', {cfg.num_encoder_layers} encoder layers' if cfg.encoder_decoder else ''}, "
              f"{f'MLA, ' if cfg.mla else f'hd {cfg.resolved_head_dim}, H/KV {cfg.num_heads}/{cfg.num_kv_heads}, '}"
              f"{f'{cfg.num_experts} experts top-{cfg.num_experts_per_tok}, ' if cfg.moe else ''}"
              f"init {init_s:.2f} s")
        r = {"params": n_params, "init_s": init_s}

        B, P, steps, cache_len = 4, 64, 32, 256
        gen = torch.Generator(device=device).manual_seed(0)
        enc = torch.randn((B, P, cfg.d_model), generator=gen, device=device).to(
            T.torch_dtype(cfg)) if cfg.encoder_decoder else None
        prompts = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                                generator=gen)
        generate(params, cfg, prompts[:, :2], 1, cache_len,
                 encoder_embeds=enc)                                # warm-up
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        moe.reset_readbacks()
        res = generate(params, cfg, prompts, steps, cache_len,
                       encoder_embeds=enc)
        launches = dict(ops.launches)
        readbacks = moe.readbacks["moe_group_sizes"]
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        ms_step = res["decode_s"] / steps * 1e3
        per_step = readbacks / (P + steps)
        print(f"[zoo] {cfg.name} serve B={B} prefill({P} tok)="
              f"{res['prefill_s']:.4f}s decode={steps} steps "
              f"{res['decode_s']:.4f}s -> {res['tok_s']:.1f} tok/s "
              f"({ms_step:.3f} ms/step) peak_mem_bytes={peak} "
              f"launches={attn_launches(launches)} moe_readbacks={readbacks} "
              f"({per_step:g} a step)")
        n_enc = cfg.num_encoder_layers if cfg.encoder_decoder else 0
        assert launches["decode_attention"] == \
            ((P + steps) * zoo_launches(cfg)[1] if cuda else 0), launches
        assert launches["flash_attention"] == (n_enc if cuda else 0), launches
        assert readbacks == (P + steps) * (T.n_stacked(cfg) if cfg.moe else 0), \
            readbacks
        toks = res["tokens"]
        assert toks.shape == (B, steps + 1) and int(toks.min()) >= 0 \
            and int(toks.max()) < cfg.vocab_size
        assert bool(torch.isfinite(res["logits"]).all())
        # served tokens and logits repeat bit for bit (each token sums its
        # experts' rows in a fixed order, no atomics)
        again = [generate(params, cfg, prompts[:, :16], 8, cache_len,
                          encoder_embeds=enc) for _ in range(2)]
        assert torch.equal(again[0]["tokens"], again[1]["tokens"]), cfg.name
        assert torch.equal(again[0]["logits"], again[1]["logits"]), cfg.name
        print(f"[zoo] {cfg.name} serve repeats bitwise: 16-token prompt + 8 "
              f"steps twice, tokens and last logits equal")
        del again
        r.update(prefill_s=res["prefill_s"], ms_per_step=ms_step,
                 decode_tok_s=res["tok_s"], serve_peak=peak,
                 serve_launches=launches, readbacks_per_step=per_step)
        if cuda:
            state = T.init_decode_state(params, cfg, B, cache_len,
                                        encoder_embeds=enc)
            for t in range(8):
                _, state = T.decode_step(params, cfg, state, prompts[:, t:t + 1])

            def four_steps():
                nonlocal state
                for _ in range(4):
                    _, state = T.decode_step(params, cfg, state, prompts[:, :1])

            profile_kernels(four_steps, f"zoo: 4 decode steps of {cfg.name} "
                            f"B={B}", ZOO_PROFILE_KEYS)
            del state
        del res, prompts, enc
        r["score"] = zoo_score(params, cfg, score_B, S, device,
                               ZOO_Q_CHUNK.get(arch, 2048))
        out[arch] = r
        del params
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the LoRA path
# ---------------------------------------------------------------------------
# The kernel against its plain version in fp32 on the same inputs.  fp32
# out: tests/test_kernels.py's measure, |got - want| within 1e-4 of mean
# |want|.  bf16 out: the kernel rounds its fp32 result once, by up to half
# an ulp, 2^-8 |want|.  tests/test_kernels.py's bf16 limit (2e-2 of mean
# |want|) admits that only while max |y| < 5 mean |y|: at 33M outputs near
# N(0, 1.2²) some |y| exceed 8, where half an ulp is 2^-4 / 2 = 0.031, about
# 3% of mean |y|.  So each bf16 element is held to 2^-8 |want| (the
# rounding) + 1e-4 mean |want| (the fp32 summation order), and the old
# measure is printed beside it.
LORA_TOL = {torch.float32: dict(rel=0.0, mean=1e-4),
            torch.bfloat16: dict(rel=2.0 ** -8, mean=1e-4)}
LORA_ALPHA = 16.0                    # LoRAConfig's default: s = 16 / r
# (T, d, o, r, dtype, x_offset, label); T = 32 x 17 tokens for the ViT
# (batch 32, 16 patches + cls), B=4 x S=4096 for qwen3-1.7b's attention
# projections; x_offset elements between x's buffer and x (1 moves its base
# 2 bytes off 16 bytes)
LORA_CHECKS = [
    (64, 128, 128, 8, torch.float32, 0, "test_kernels"),
    (64, 128, 128, 8, torch.bfloat16, 0, "test_kernels"),
    (100, 300, 200, 16, torch.float32, 0, "test_kernels"),
    (100, 300, 200, 16, torch.bfloat16, 0, "test_kernels"),
    (8, 512, 1024, 4, torch.float32, 0, "test_kernels"),
    (8, 512, 1024, 4, torch.bfloat16, 0, "test_kernels"),
    (544, 192, 576, 8, torch.float32, 0, "vit qkv"),
    (16384, 2048, 2048, 4, torch.bfloat16, 0, "qwen3 wq"),
    (16384, 2048, 2048, 8, torch.bfloat16, 0, "qwen3 wq"),
    (16384, 2048, 1024, 4, torch.bfloat16, 0, "qwen3 wv"),
    (16384, 2048, 1024, 8, torch.bfloat16, 0, "qwen3 wv"),
    (16384, 2048, 2048, 64, torch.bfloat16, 0, "qwen3 wq"),
    # the bf16 kernel's edges: an odd rank, a ragged last row tile, d = 300
    # at a base 2 bytes off 16 and a sliced x at qwen3 width (the cp.async
    # route), o short of a 256-column tile on both routes
    (4096, 2048, 2048, 5, torch.bfloat16, 0, "rank 5"),
    (16383, 2048, 2048, 8, torch.bfloat16, 0, "T 16383"),
    (1000, 300, 200, 16, torch.bfloat16, 1, "d 300 off 2B"),
    (4096, 2048, 2048, 8, torch.bfloat16, 1, "x off 2B"),
    (1000, 2048, 1000, 8, torch.bfloat16, 0, "o 1000"),
    (1000, 2048, 1001, 8, torch.bfloat16, 0, "o 1001"),
]
# the ViT qkv (fp32) and the qwen3 shapes are timed
LORA_TIMED = [c for c in LORA_CHECKS
              if c[6] in ("vit qkv", "qwen3 wq", "qwen3 wv")]
LORA_JSON_CASE = (16384, 2048, 2048, 8, torch.bfloat16)


def lora_inputs(T, d, o, r, dtype, seed, device="cuda", x_offset=0):
    """x ~ N(0, 1) and the weights at the scales the model gives them: W and
    A ~ N(0, 1/d) (``dense_init``, ``lora_init``), B ~ N(0, 0.1²) (it starts
    at zero and grows in training), so y = x@W + s·(x@A)@B is about
    N(0, 1 + 0.04·s²·r) and both terms count.  x is contiguous and starts
    ``x_offset`` elements into its buffer."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=device) * std).to(dtype)

    x = randn(T * d + x_offset)[x_offset:].view(T, d)
    return (x, randn(d, o, std=d ** -0.5), randn(d, r, std=d ** -0.5),
            randn(r, o, std=0.1))


def lora_error(got, want):
    """{"max_abs_err", "err_over_mean" (max |got - want| / mean |want|),
    "share_of_limit" (the largest |got - want| over its ``LORA_TOL``
    limit), "ok"}, and for bf16 "differs_from_rounded" (the share of
    outputs other than ``want`` rounded to bf16): ``want`` is the plain
    version in fp32."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    mean = float(w.abs().mean())
    tol = LORA_TOL[got.dtype]
    limit = tol["rel"] * w.abs() + tol["mean"] * mean
    share = float((err / limit.clamp_min(1e-30)).max())
    out = {"max_abs_err": float(err.max()),
           "err_over_mean": float(err.max()) / (mean + 1e-30),
           "share_of_limit": share,
           "ok": (got.shape == want.shape and share <= 1.0
                  and bool(torch.isfinite(g).all()))}
    if got.dtype == torch.bfloat16:
        out["differs_from_rounded"] = float(
            (got != want.to(torch.bfloat16)).float().mean())
    return out


def lora_bound(T, d, o, r, dtype):
    """flops 2·T·d·(o + r) + 2·T·r·o; bytes: x, W, A, B read once and the
    output written once."""
    isz = torch.empty((), dtype=dtype).element_size()
    flops = 2.0 * T * d * (o + r) + 2.0 * T * r * o
    nbytes = (T * d + d * o + d * r + r * o + T * o) * isz
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lora_check(T, d, o, r, dtype, seed, x_offset=0):
    """One ``ops.lora_matmul`` launch against ``ref.lora_matmul`` in fp32 on
    the same inputs; returns ``lora_error``'s dict and, for bf16, the
    kernel's route (``ops.lora_route``)."""
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, a, b = lora_inputs(T, d, o, r, dtype, seed, x_offset=x_offset)
    s = LORA_ALPHA / r
    got = ops.lora_matmul(x, w, a, b, s)
    torch.cuda.synchronize()
    want = ref.lora_matmul(x.float(), w.float(), a.float(), b.float(), s)
    assert got.dtype == dtype and got.shape == (T, o)
    e = lora_error(got, want)
    e["route"] = ops.lora_route(x, w, b) if dtype == torch.bfloat16 else "fma"
    return e


def lora_timing(T, d, o, r, dt, label):
    """``ops.lora_matmul`` timed by CUDA events in turns with the
    three-call ``torch.addmm(x @ W, x @ A, B, alpha=s)`` and cuBLAS ``x @
    W`` alone (yardsticks only: the port calls neither), then its plain
    version, then the device time per call of all three (``device_ms``);
    prints one line and returns the ``kernels`` entry.  Uses only what the
    parent commits had, so it also times their kernel."""
    from repro_torch.kernels import ops, ref
    x, w, a, b = lora_inputs(T, d, o, r, dt, seed=9)
    s = LORA_ALPHA / r
    iters = 20 if T > 1000 else 200

    def kernel():
        return ops.lora_matmul(x, w, a, b, s)

    def three():
        return torch.addmm(x @ w, x @ a, b, alpha=s)

    def cublas():
        return x @ w

    k_ms, l_ms, mm_ms = cuda_times([kernel, three, cublas], iters)
    p_ms = cuda_ms(lambda: ref.lora_matmul(x, w, a, b, s), iters)
    k_dev, l_dev, mm_dev = device_ms(kernel), device_ms(three), device_ms(cublas)
    b_ms, b_by = lora_bound(T, d, o, r, dt)
    flops = 2.0 * T * d * (o + r) + 2.0 * T * r * o
    print(f"[lora-time] {label:8s} T={T} d={d} o={o} r={r} {str(dt)[6:]}: "
          f"kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms(addmm(x@W, x@A, B), 3 calls, in turns)={l_ms:.4f} "
          f"cublas_x@W_ms(in turns)={mm_ms:.4f} "
          f"kernel_TFLOP/s={flops / k_ms / 1e9:.2f} device_ms(profiler): "
          f"kernel={k_dev} three_calls={l_dev} cublas_x@W={mm_dev}")
    del x, w, a, b
    torch.cuda.empty_cache()
    return dict(timing(k_ms, p_ms, b_ms, b_by, l_ms), device_ms=k_dev,
                library_device_ms=l_dev, cublas_ms=float(mm_ms),
                cublas_device_ms=mm_dev)


def phase_lora_kernel():
    """``ops.lora_matmul`` against its plain version at every shape of
    ``LORA_CHECKS`` (each bf16 case on the route it takes), then timed at
    ``LORA_TIMED``'s shapes (``lora_timing``)."""
    errs, routes = {}, set()
    for i, (T, d, o, r, dt, off, label) in enumerate(LORA_CHECKS):
        e = lora_check(T, d, o, r, dt, seed=300 + i, x_offset=off)
        errs[(T, d, o, r, dt)] = e
        routes.add(e["route"])
        print(f"[lora] {label:12s} T={T} d={d} o={o} r={r} x_offset={off} "
              f"{str(dt)[6:]:8s} route={e['route']} "
              f"max_abs_err={e['max_abs_err']:.3e} "
              f"err/mean={e['err_over_mean']:.3e} "
              f"share_of_limit={e['share_of_limit']:.3f} "
              f"differs_from_rounded={e.get('differs_from_rounded', 'n/a')} "
              f"{'ok' if e['ok'] else 'FAIL'}")
        if not e["ok"]:
            raise AssertionError(f"lora_matmul {label} T={T} r={r} {dt} "
                                 "disagrees with its plain version")
    assert routes == {"fma", "tma", "cp.async"}, routes
    torch.cuda.empty_cache()
    timings = {}
    for T, d, o, r, dt, _, label in LORA_TIMED:
        timings[(T, d, o, r, dt)] = lora_timing(T, d, o, r, dt, label)
    return errs, timings


def table4_problem(device="cuda", n_samples=6000):
    """Table 4 as ``benchmarks/common.py`` ``make_problem(non_iid=True,
    failure_mode="mixed", quick=False, model="vit")`` builds it, from the
    port's own data and partition code: 16x16x1 images, 10 classes, noise
    0.8, n/5 test, 30 public per class, ``group_classes`` with 2 classes per
    group and groups of 4 over 20 clients, all selected; E=5, batch 32,
    lr 0.02, 0.86 MB uploads, 100 pretraining steps; rank-8 LoRA on the
    ``qkv`` weights of the registered ViT (d 192, depth 6, 3 heads, patch
    4).  Evaluation every round (the benchmark evaluates at the end only)."""
    from repro_torch.data.synthetic import fft_split, make_dataset, train_test_split
    from repro_torch.fl.lora import LoRAConfig
    from repro_torch.fl.partition import partition
    from repro_torch.fl.runtime import FFTConfig, FFTRunner
    from repro_torch.models.vision import make_model
    ds = make_dataset(n_samples, n_classes=10, image_size=16, channels=1,
                      noise=0.8, seed=0)
    train, test = train_test_split(ds, n_samples // 5, seed=1)
    pub, priv = fft_split(train, public_per_class=30, seed=0)
    parts, _ = partition("group_classes", priv.y, 20, 10, classes_per_group=2,
                         group_size=4, seed=0)
    init_fn, apply_fn = make_model("vit", 10, 16, 1, device=device)
    cfg = FFTConfig(n_clients=20, k_selected=20, local_steps=5, batch_size=32,
                    lr=0.02, failure_mode="mixed", seed=0, eval_every=1,
                    model_bytes=0.86e6)
    return FFTRunner(cfg, init_fn, apply_fn, pub, parts, priv, test,
                     lora_cfg=LoRAConfig(rank=8, match=lambda p: "qkv/w" in p),
                     pretrain_steps=100, device=device)


def phase_lora_rounds(device="cuda", n_samples=6000):
    """Table 4's eight strategies from the same pretrained adapters and
    base: FedAvg, FedEx-LoRA and FedAuto 2 rounds each, then FedProx,
    SCAFFOLD, FedLAW, FedAWE and centralized training 1 round each.  The
    streaming ones (FedAvg, FedProx, FedAWE, FedAuto) reduce the adapter
    uploads through float_fedagg: per round one launch per adapter leaf for
    the dense terms, and one more per leaf when anyone connected.
    FedEx-LoRA, SCAFFOLD and FedLAW reduce through fedagg, one launch per
    leaf in a round with a participant; centralized training reduces
    nothing.  Only FedEx-LoRA moves the base.  No round merges through
    lora_matmul.  Then one FedAuto round is profiled.  Returns the runner as
    the FedAuto run leaves it and the launch counts of the runs."""
    from repro_torch.core.strategies import (CentralizedPublic, FedAuto,
                                             FedAvg, FedAWE, FedExLoRA,
                                             FedLAW, FedProx, Scaffold)
    from repro_torch.fl.lora import _get, _iter_paths
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves, tree_map
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    runner = table4_problem(device, n_samples)
    sync(device)
    base0 = tree_map(lambda t: t, runner.base_params)
    g0 = runner.global_params
    n_leaves = len(tree_leaves(g0))
    paths = sorted(g0)
    n_params = sum(t.numel() for t in tree_leaves(base0))
    n_adapter = sum(t.numel() for t in tree_leaves(g0))
    print(f"[lora-rounds] vit {n_params} base params, {n_adapter} adapter "
          f"params in {n_leaves} leaves ({len(paths)} qkv/w layers, rank 8); "
          f"upload {runner.upload_bytes:.0f} B priced; set-up + pretrain "
          f"{time.perf_counter() - t0:.2f} s, pretrained acc "
          f"{runner.evaluate():.4f}")
    assert n_params == 2_678_218 and n_leaves == 12 and len(paths) == 6
    totals = {k: 0 for k in ops.launches}
    ops.reset_launches()
    left = None
    for strat, rounds in ((FedAvg, 2), (FedExLoRA, 2), (FedAuto, 2),
                          (FedProx, 1), (Scaffold, 1), (FedLAW, 1),
                          (FedAWE, 1), (CentralizedPublic, 1)):
        runner.base_params = tree_map(lambda t: t, base0)
        runner.global_params = g0
        runner.rng = np.random.default_rng(42)
        before = dict(ops.launches)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        stamps = [time.perf_counter()]

        def log(rnd, acc):
            sync(device)
            stamps.append(time.perf_counter())

        hist = runner.run(strat(), rounds, log=log)
        walls = np.diff(stamps)
        delta = {k: ops.launches[k] - before[k] for k in ops.launches}
        for k in totals:
            totals[k] += delta[k]
        parts = runner.loop.participants_per_round
        busy = sum(1 for n in parts if n > 0)
        expect = dict.fromkeys(ops.launches, 0)
        if cuda and strat.streaming:
            expect["float_fedagg"] = n_leaves * (len(parts) + busy)
        elif cuda and strat is not CentralizedPublic:
            expect["fedagg"] = n_leaves * busy
        print(f"[lora-rounds] {strat.name}: round_wall_s="
              f"{[round(float(w), 4) for w in walls]} participants={parts} "
              f"acc={hist} peak_mem_bytes="
              f"{torch.cuda.max_memory_allocated() if cuda else 'not measured'} "
              f"launches={delta}")
        assert delta == expect, (strat.name, delta, expect)
        assert (not cuda or strat is CentralizedPublic
                or sum(delta.values()) > 0), strat.name
        changed = sorted(p for p, leaf in _iter_paths(runner.base_params)
                         if not torch.equal(leaf, _get(base0, p)))
        folds = strat is FedExLoRA and max(parts) >= 2
        assert changed == (paths if folds else []), (strat.name, changed)
        for leaf in tree_leaves(runner.global_params) + tree_leaves(
                runner.base_params):
            assert bool(torch.isfinite(leaf).all()), f"{strat.name}: non-finite"
        assert all(0.0 <= a <= 1.0 for a in hist) and len(hist) == rounds
        print(f"[lora-rounds] {strat.name}: base leaves changed: "
              f"{changed or 'none'}")
        if strat is FedAuto:
            left = runner.base_params, runner.global_params
    runner.base_params, runner.global_params = left
    if cuda:

        def fedauto_round():
            runner.base_params = tree_map(lambda t: t, base0)
            runner.global_params = g0
            runner.rng = np.random.default_rng(42)
            runner.run(FedAuto(), 1)

        profile_kernels(fedauto_round, "lora-rounds: one fedauto round",
                        {"float_fedagg": "coef_reduce_kernel"}, host_ops=True)
        runner.base_params, runner.global_params = left
    return runner, totals


def phase_lora_entry(runner, device="cuda"):
    """``fl.lora.lora_matmul(x, W, ab, cfg)`` on each ``qkv/w`` layer the
    rounds left (base and FedAuto's adapters) for x of 544 x 192 (one ViT
    batch of 32 x 17 tokens), against ``x @ W_eff`` of the merged layer
    within the fp32 tolerance.  Returns the launches and the largest
    error."""
    from repro_torch.fl.lora import _get, apply_lora, lora_matmul
    from repro_torch.kernels import ops
    cuda = torch.device(device).type == "cuda"
    cfg = runner.lora_cfg
    merged = apply_lora(runner.base_params, runner.global_params, cfg)
    g = torch.Generator(device=device).manual_seed(14)
    worst = None
    ops.reset_launches()
    for path, ab in sorted(runner.global_params.items()):
        w = _get(runner.base_params, path)
        x = torch.randn((32 * 17, w.shape[0]), generator=g, device=device)
        e = lora_error(lora_matmul(x, w, ab, cfg), x @ _get(merged, path))
        print(f"[lora-entry] {path}: x {tuple(x.shape)} W {tuple(w.shape)} "
              f"r={ab['a'].shape[1]} max_abs_err={e['max_abs_err']:.3e} "
              f"err/mean={e['err_over_mean']:.3e} {'ok' if e['ok'] else 'FAIL'}")
        assert e["ok"], path
        worst = e if worst is None or e["max_abs_err"] > worst["max_abs_err"] else worst
    launches = dict(ops.launches)
    expect = dict.fromkeys(launches, 0)
    expect["lora_matmul"] = len(runner.global_params) if cuda else 0
    print(f"[lora-entry] launches={launches}")
    assert launches == expect and len(runner.global_params) == 6, launches
    return launches["lora_matmul"], worst


def lora_agreement(image_size=8):
    """A small LoRA run, the registered ViT at ``image_size`` with rank-4
    adapters, FedEx-LoRA and FedAuto 2 rounds each, on the card and on the
    CPU from the same base, adapters and minibatch indices: the kernels and
    cuBLAS (TF32 off) against the plain versions.  Returns the largest
    adapter and base differences after asserting them within 1e-4 and the
    accuracies within one test sample."""
    from repro_torch.core.strategies import FedAuto, FedExLoRA
    from repro_torch.data.synthetic import fft_split, make_dataset, train_test_split
    from repro_torch.fl.lora import LoRAConfig, lora_init
    from repro_torch.fl.partition import partition
    from repro_torch.fl.runtime import FFTConfig, FFTRunner
    from repro_torch.models.vision import make_model
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = make_dataset(600, n_classes=10, image_size=image_size, channels=1, seed=0)
    train, test = train_test_split(ds, 120, seed=1)
    public, private = fft_split(train, public_per_class=5, seed=0)
    parts, _ = partition("group_classes", private.y, n_clients=6,
                         n_classes=10, classes_per_group=2, seed=0)
    cfg = dict(n_clients=6, k_selected=6, local_steps=2, batch_size=8, lr=0.05,
               failure_mode="mixed", tx_delay_s=0.01, model_bytes=1e5, seed=0,
               eval_every=1)
    lcfg = LoRAConfig(rank=4, match=lambda p: "qkv/w" in p)
    init_cpu, apply_fn = make_model("vit", 10, image_size, 1, device="cpu")
    p0 = init_cpu(0)
    ad0 = lora_init(torch.Generator().manual_seed(1), p0, lcfg)
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(5)

        def batch_indices(n, E, bs):
            return torch.as_tensor(rng.integers(0, n, (E, bs)), device=dev)

        r = FFTRunner(FFTConfig(**cfg), lambda seed: tree_map(lambda t: t.to(dev), p0),
                      apply_fn, public, parts, private, test, lora_cfg=lcfg,
                      device=dev, batch_indices=batch_indices)
        r.global_params = tree_map(lambda t: t.to(dev), ad0)
        r.pretrain(4)
        g0 = r.global_params
        for strat in (FedExLoRA, FedAuto):
            r.base_params = tree_map(lambda t: t.to(dev), p0)
            r.global_params = g0
            r.rng = np.random.default_rng(42)
            hist = r.run(strat(), 2)
            out[(dev, strat.name)] = (
                hist, [t.cpu() for t in tree_leaves(r.global_params)],
                [t.cpu() for t in tree_leaves(r.base_params)],
                list(r.loop.participants_per_round))
    res = {}
    for name in ("fedex_lora", "fedauto"):
        (hc, ac, bc, pc), (hp, ap, bp, pp) = out[("cuda", name)], out[("cpu", name)]
        d_ad = max(float((a - b).abs().max()) for a, b in zip(ac, ap))
        d_base = max(float((a - b).abs().max()) for a, b in zip(bc, bp))
        d_acc = max(abs(a - b) for a, b in zip(hc, hp))
        res[name] = dict(adapters=d_ad, base=d_base, acc=d_acc, hist=(hc, hp),
                         participants=pc)
        assert pc == pp, (pc, pp)
        assert d_ad < 1e-4 and d_base < 1e-4, (name, d_ad, d_base)
        assert d_acc <= 1 / 120 + 1e-12, (name, hc, hp)
    return res


def phase_lora_agreement():
    for name, r in lora_agreement().items():
        print(f"[agree-lora] vit image 8 rank 4 {name} 2 rounds: acc "
              f"cuda={r['hist'][0]} cpu={r['hist'][1]} participants="
              f"{r['participants']} max |adapter diff|={r['adapters']:.3e} "
              f"max |base diff|={r['base']:.3e}")


# ---------------------------------------------------------------------------
# the Mamba2 hybrid path
# ---------------------------------------------------------------------------
# (B, S, H, dh, n): tests/test_kernels.py's cases (ragged S, odd dh and n),
# one zamba2-1.2b layer at B=4 x S=4096 (the forward phase's shape), then
# the kernel's tiling edges (Q = 32-step chunks; 128 head-dim rows per block
# for n <= 64, 64 above): S in {1, Q-1, Q, Q+1, 2Q+1, 4095} and around 2Q
# and 4Q, dh not a multiple of the row tile, n in {1, 7, 65, 128}
# (n % 4 != 0 takes 4-byte copies), H = 1
SCAN_LAYER = (4, 4096, 32, 128, 64)
SCAN_EDGES = [(2, 1, 3, 128, 64), (1, 63, 2, 128, 64), (1, 64, 2, 128, 64),
              (2, 65, 2, 128, 64), (1, 129, 2, 128, 64), (1, 4095, 4, 128, 64),
              (1, 200, 2, 33, 64), (1, 200, 2, 72, 64), (1, 200, 2, 96, 64),
              (1, 200, 2, 64, 1), (1, 200, 2, 64, 7), (1, 200, 2, 64, 65),
              (1, 200, 2, 128, 128), (2, 300, 1, 128, 64), (1, 31, 2, 128, 64),
              (1, 32, 2, 128, 64), (2, 33, 2, 128, 64)]
SCAN_CHECKS = [(2, 64, 4, 8, 16), (1, 100, 2, 32, 64), (2, 128, 3, 16, 24),
               SCAN_LAYER] + SCAN_EDGES
# decay regimes at B=1, S=4096, H=8, dh=128, n=64 (``scan_regime_check``):
# no decay (the state grows over all 4096 steps) and a_log 30x the recipe's
# (the exponentials underflow)
SCAN_REGIMES = [("none", (1, 4096, 8, 128, 64)), ("underflow", (1, 4096, 8, 128, 64))]
SCAN_TOL = 2e-4          # |got - want| <= 2e-4 (1 + |want|): the JAX test's
# zamba2-1.2b's shared attention: (B, Sq, Sk, H, KV, hd, causal, window, dtype)
# at the forward's shape, and (B, S, H, KV, hd, n_valid, dtype) at the serve
# run's last step
SSM_FLASH_CHECKS = [(4, 4096, 4096, 32, 32, 64, True, None, torch.bfloat16),
                    (1, 1000, 1000, 32, 32, 64, True, None, torch.float32)]
SSM_DECODE_CHECKS = [(4, 256, 32, 32, 64, 96, torch.bfloat16),
                     (4, 256, 32, 32, 64, 96, torch.float32)]


def scan_inputs(B, S, H, dh, n, seed, device="cuda", decay="recipe"):
    """The JAX test's recipe: xdt, B, C ~ N(0, 1), a_log = -softplus(N(0, 1));
    ``decay="none"`` sets a_log = 0, ``"underflow"`` multiplies it by 30."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    xdt = randn(B, S, H, dh)
    a_log = -torch.nn.functional.softplus(randn(B, S, H))
    a_log = {"recipe": a_log, "none": torch.zeros_like(a_log),
             "underflow": 30.0 * a_log}[decay]
    return xdt, a_log, randn(B, S, n), randn(B, S, n)


def scan_error(got, want):
    """{"max_abs_err", "share_of_limit" (the largest |got - want| over
    2e-4 (1 + |want|)), "ok"}."""
    err = (got - want).abs()
    share = float((err / (SCAN_TOL * (1 + want.abs()))).max())
    return {"max_abs_err": float(err.max()), "share_of_limit": share,
            "ok": (got.dtype == want.dtype and got.shape == want.shape
                   and share <= 1.0 and bool(torch.isfinite(got).all()))}


def scan_check(B, S, H, dh, n, seed):
    """One ``ops.selective_scan`` launch against the sequential plain version
    on the same inputs; returns ``scan_error``'s dict."""
    from repro_torch.kernels import ops, ref
    xdt, a_log, Bm, Cm = scan_inputs(B, S, H, dh, n, seed)
    got = ops.selective_scan(xdt, a_log, Bm, Cm)
    torch.cuda.synchronize()
    want, _ = ref.selective_scan(xdt, a_log, Bm, Cm,
                                 torch.zeros((B, H, dh, n), device="cuda"))
    return scan_error(got, want)


def scan_regime_check(decay, B, S, H, dh, n, seed):
    """One ``ops.selective_scan`` launch in a decay regime of ``scan_inputs``
    against the exact recurrence (the sequential plain version in fp64 on
    the card): ``scan_error``'s dict, plus "seq_share", the fp32 sequential
    plain version's own share of the limit.  Where that version holds the
    limit the kernel must too; where it does not (no decay: the state grows
    to ~300 and y cancels to near 0 on a few elements, which no fp32
    computation holds to 2e-4 (1 + |y|), tests/test_torch_ssm.py), the
    kernel must come no further from the exact recurrence than it."""
    from repro_torch.kernels import ops, ref
    xdt, a_log, Bm, Cm = scan_inputs(B, S, H, dh, n, seed, decay=decay)
    got = ops.selective_scan(xdt, a_log, Bm, Cm)
    torch.cuda.synchronize()
    h0 = torch.zeros((B, H, dh, n), device="cuda")
    seq, _ = ref.selective_scan(xdt, a_log, Bm, Cm, h0)
    want, _ = ref.selective_scan(*(t.double() for t in (xdt, a_log, Bm, Cm)),
                                 h0.double())
    e = scan_error(got.double(), want)
    e["seq_share"] = scan_error(seq.double(), want)["share_of_limit"]
    e["ok"] = (got.dtype == torch.float32 and bool(torch.isfinite(got).all())
               and e["share_of_limit"] <= max(1.0, e["seq_share"]))
    return e


def scan_bound(B, S, H, dh, n):
    """bytes: xdt and y (B,S,H,dh), a_log (B,S,H), B and C (B,S,n) in fp32,
    each once; operations: the recurrence's 4·dh·n flops per step per
    (b, h) on the TF32 tensor cores, three times over (the 3xTF32 split
    that keeps fp32 accuracy)."""
    nbytes = 4 * (2 * B * S * H * dh + B * S * H + 2 * B * S * n)
    flops = 3 * 4.0 * B * S * H * dh * n
    t_ops, t_bytes = flops / TF32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_chunked_flops(B, S, H, dh, n, q=32):
    """The flops the kernel's chunked algorithm does: G = C.B^T once per
    (b, chunk) in fp32 (2 q^2 n), and per (b, h, chunk) the tensor-core
    products three times over (the 3xTF32 split): W.X on every (t, s) pair
    (one wgmma covers all t of a k-step; W is zero above the diagonal),
    2 q^2 dh, and the carried term C.H^T and the state update, 2 q n dh
    each."""
    chunks = -(-S // q)
    gram = B * chunks * 2.0 * q * q * n
    products = 2.0 * dh * q * q + 4.0 * q * n * dh
    return gram + 3 * B * H * chunks * products


def phase_ssm():
    """``ops.selective_scan`` against the sequential plain version at every
    shape of ``SCAN_CHECKS``, then timed at the zamba2-1.2b layer against
    the chunked plain version (chunk 128, the wrapper's default) and its
    bound; then flash_attention and decode_attention at zamba2's heads
    against their plain versions, and timed."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    errs = {}
    for i, (B, S, H, dh, n) in enumerate(SCAN_CHECKS):
        e = scan_check(B, S, H, dh, n, seed=400 + i)
        errs[(B, S, H, dh, n)] = e
        print(f"[ssm] selective_scan B={B} S={S} H={H} dh={dh} n={n} "
              f"max_abs_err={e['max_abs_err']:.3e} "
              f"share_of_limit={e['share_of_limit']:.4f} "
              f"{'ok' if e['ok'] else 'FAIL'}")
        if not e["ok"]:
            raise AssertionError(f"selective_scan B={B} S={S} H={H} dh={dh} "
                                 f"n={n} disagrees with its plain version")
        torch.cuda.empty_cache()
    for i, (decay, (B, S, H, dh, n)) in enumerate(SCAN_REGIMES):
        e = scan_regime_check(decay, B, S, H, dh, n, seed=450 + i)
        print(f"[ssm] selective_scan decay={decay} B={B} S={S} H={H} dh={dh} "
              f"n={n} against the fp64 recurrence: max_abs_err="
              f"{e['max_abs_err']:.3e} share_of_limit={e['share_of_limit']:.4f} "
              f"(fp32 sequential plain version: {e['seq_share']:.4f}) "
              f"{'ok' if e['ok'] else 'FAIL'}")
        if not e["ok"]:
            raise AssertionError(f"selective_scan decay={decay} disagrees with "
                                 "the exact recurrence")
        torch.cuda.empty_cache()

    B, S, H, dh, n = SCAN_LAYER
    xdt, a_log, Bm, Cm = scan_inputs(B, S, H, dh, n, seed=9)
    h0 = torch.zeros((B, H, dh, n), device="cuda")
    k_ms = cuda_ms(lambda: ops.selective_scan(xdt, a_log, Bm, Cm), 20)
    p_ms = cuda_ms(lambda: ref.ssd_chunked(xdt, a_log, Bm, Cm, h0, 128), 3)
    b_ms, b_by = scan_bound(B, S, H, dh, n)
    chunked = scan_chunked_flops(B, S, H, dh, n)
    scan_timing = timing(k_ms, p_ms, b_ms, b_by, None)
    print(f"[ssm-time] selective_scan B={B} S={S} H={H} dh={dh} n={n} fp32: "
          f"kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / k_ms:.4f} plain_ms(chunked, Q=128)={p_ms:.4f} "
          f"library_ms=null (no single PyTorch call computes the scan) "
          f"kernel_TFLOP/s(recurrence)={4.0 * B * S * H * dh * n / k_ms / 1e9:.2f} "
          f"kernel_TFLOP/s(chunked 3xTF32, {chunked / 1e9:.1f} GFLOP)="
          f"{chunked / k_ms / 1e9:.2f}")
    del xdt, a_log, Bm, Cm, h0
    torch.cuda.empty_cache()

    for i, (B, Sq, Sk, H, KV, hd, causal, window, dt) in enumerate(SSM_FLASH_CHECKS):
        q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=500 + i)
        check("flash_attention", ops.flash_attention(q, k, v, causal=causal),
              ref.flash_attention(q, k, v, causal=causal),
              f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
              f"{str(dt)[6:]}")
        if i == 0:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            k_ms, l_ms = cuda_times([   # in turns: kernel, SDPA, SDPA, kernel
                lambda: ops.flash_attention(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True)], 10)
            b_ms, b_by = flash_bound(B, Sq, Sk, H, KV, hd, causal, window, dt)
            print(f"[ssm-time] flash_attention B={B} S={Sq} H={H} KV={KV} "
                  f"hd={hd} causal bf16: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} "
                  f"({b_by}) share_of_bound={b_ms / k_ms:.4f} "
                  f"library_ms(sdpa)={l_ms:.4f} kernel_TFLOP/s="
                  f"{4.0 * B * H * hd * flash_pairs(Sq, Sk, True, None) / k_ms / 1e9:.2f}")
            del qt, kt, vt
        del q, k, v
        torch.cuda.empty_cache()
    for i, (B, S, H, KV, hd, nv, dt) in enumerate(SSM_DECODE_CHECKS):
        q, k, v = attn_inputs(B, 1, S, H, KV, hd, dt, seed=600 + i)
        valid = torch.arange(S, device="cuda") < nv
        scale = 1.0 / hd ** 0.5
        check("decode_attention", ops.decode_attention(q, k, v, valid, scale=scale),
              ref.decode_attention(q, k, v, valid, scale=scale),
              f"B={B} S={S} H={H} KV={KV} hd={hd} n_valid={nv} {str(dt)[6:]}")
        del q, k, v
    decode_timing(*SSM_DECODE_CHECKS[0], label="ssm-time")
    return errs, scan_timing


def hybrid_param_count(cfg):
    """The parameters ``init_params`` gives a Mamba2/shared-attention stack:
    tied embedding, final norm, each Mamba2 block and one shared block."""
    from repro_torch.configs.base import MAMBA2, SHARED_ATTN
    d, hd = cfg.d_model, cfg.resolved_head_dim
    d_in, H, n = cfg.ssm_expand * d, cfg.ssm_num_heads, cfg.ssm_state_size
    mamba = (d + d * (2 * d_in + 2 * n + H) + cfg.ssm_conv_width * d_in
             + 3 * H + d_in + d_in * d)
    shared = (2 * d + 2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
              + 3 * d * cfg.d_ff)
    kinds = cfg.layer_kinds()
    return (cfg.vocab_size * d + d + kinds.count(MAMBA2) * mamba
            + (SHARED_ATTN in kinds) * shared)


def phase_ssm_forward(device="cuda", smoke=False, S=4096):
    """``forward`` (prefill / score) on full-width zamba2-1.2b, B=4, S=4096,
    under ``torch.no_grad()``.  The CPU rehearsal passes ``device="cpu",
    smoke=True`` and a short S (a multiple of the Mamba2 chunk, 256)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import MAMBA2, SHARED_ATTN
    from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("zamba2-1.2b")
    kinds = cfg.layer_kinds()
    n_mamba, n_attn = kinds.count(MAMBA2), kinds.count(SHARED_ATTN)
    B = 4
    t0 = time.perf_counter()
    params = T.init_params(cfg, 2, device)
    sync(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[ssm-forward] {cfg.name}: {n_params} params ({cfg.dtype}), "
          f"{cfg.num_layers} layers ({n_mamba} Mamba2, {n_attn} shared "
          f"attention), init {time.perf_counter() - t0:.2f} s")
    assert n_params == hybrid_param_count(cfg), n_params     # full width and depth
    assert smoke or (n_params == 949_167_104 and (n_mamba, n_attn) == (32, 6))
    stream = make_bigram_stream(8 * S, cfg.vocab_size, domain=0, n_domains=1, seed=0)
    toks, labels = next(batches_from_stream(stream, B, S, seed=0))
    batch = {"tokens": torch.from_numpy(toks).long().to(device),
             "labels": torch.from_numpy(labels).long().to(device)}
    with torch.no_grad():
        T.forward(params, cfg, {k: v[:, :256] for k, v in batch.items()})  # warm-up
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, metrics = T.forward(params, cfg, batch)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        ln_v = float(np.log(cfg.vocab_size))
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        print(f"[ssm-forward] {cfg.name} B={B} S={S}: loss={float(loss):.4f} "
              f"(ln V = {ln_v:.4f}) tokens={int(metrics['target_tokens'])} "
              f"wall_s={wall:.4f} tok/s={B * S / wall:.1f} "
              f"peak_mem_bytes={peak} launches={launches}")
        expect = dict.fromkeys(launches, 0)
        if cuda:
            expect.update(selective_scan=n_mamba, flash_attention=n_attn)
        assert launches == expect, (launches, expect)
        assert bool(torch.isfinite(loss)) and abs(float(loss) - ln_v) < 1.0, float(loss)
        if cuda:
            profile_kernels(lambda: T.forward(params, cfg, batch),
                            f"ssm-forward: {cfg.name} B={B} S={S}",
                            {"selective_scan": "selective_scan",
                             "flash_attention": "flash_attention"})
    return launches


def phase_ssm_serve(device="cuda", smoke=False):
    """``generate`` on full-width zamba2-1.2b, as ``python -m
    repro_torch.launch.serve --arch zamba2-1.2b --smoke-scale=false`` runs
    it: each step runs the 32 Mamba2 blocks' one-step recurrence (plain
    PyTorch) and the shared block's decode_attention at 6 positions, each
    with its own cache.  The CPU rehearsal passes ``device="cpu",
    smoke=True``."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import SHARED_ATTN
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("zamba2-1.2b")
    n_attn = cfg.layer_kinds().count(SHARED_ATTN)
    B, P, steps, cache_len = 4, 64, 32, 256
    params = T.init_params(cfg, 0, device)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=device,
                            generator=torch.Generator(device=device).manual_seed(0))
    generate(params, cfg, prompts[:, :2], 1, cache_len)         # warm-up
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = generate(params, cfg, prompts, steps, cache_len)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    print(f"[ssm-serve] arch={cfg.name} B={B} prefill({P} tok)={res['prefill_s']:.4f}s "
          f"decode={steps} steps {res['decode_s']:.4f}s -> {res['tok_s']:.1f} tok/s "
          f"({res['decode_s'] / steps * 1e3:.3f} ms/step) peak_mem_bytes={peak} "
          f"launches={launches}")
    expect = dict.fromkeys(launches, 0)
    if cuda:
        expect["decode_attention"] = (P + steps) * n_attn
    assert launches == expect, (launches, expect)
    assert not cuda or smoke or expect["decode_attention"] == 576
    toks = res["tokens"]
    assert toks.shape == (B, steps + 1) and int(toks.min()) >= 0 \
        and int(toks.max()) < cfg.vocab_size
    assert res["logits"].shape == (B, cfg.vocab_size) and \
        bool(torch.isfinite(res["logits"]).all())
    print(f"[ssm-serve] sample: {toks[0][:16].tolist()}")
    if not cuda:
        return launches

    state = T.init_decode_state(params, cfg, B, cache_len)
    for t in range(8):
        _, state = T.decode_step(params, cfg, state, prompts[:, t:t + 1])

    def four_steps():
        nonlocal state
        for _ in range(4):
            _, state = T.decode_step(params, cfg, state, prompts[:, :1])

    profile_kernels(four_steps, f"ssm-serve: 4 decode steps of {cfg.name} B={B}",
                    {"decode_attention": "decode_attention"})
    return launches


def ssm_agreement():
    """zamba2-1.2b-smoke in fp32, the same params and tokens on the card and
    on the CPU: hidden states and forward loss (B=2, S=64), then ``generate``
    (prompt 8, 16 greedy steps, a 12-slot ring that wraps).  The kernels and
    cuBLAS (TF32 off) against the plain versions.  Returns {"loss": {dev:
    loss}, "loss_diff", "hidden_diff", "tokens": {dev: tokens}, "launches":
    {dev: counts}} after asserting the launch counts, agreement within 1e-4
    and identical tokens."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), dtype="float32")
    p_cpu = T.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    loss, hidden, tokens, launches = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        batch = {"tokens": toks.to(dev), "labels": toks.roll(-1, 1).to(dev)}
        ops.reset_launches()
        hidden[dev] = T.hidden_states(p, cfg, batch)[0].cpu()
        loss[dev] = float(T.forward(p, cfg, batch, loss_chunk=16)[0])
        tokens[dev] = generate(p, cfg, batch["tokens"][:, :8], 16, 12)["tokens"].cpu()
        launches[dev] = dict(ops.launches)
    d_loss = abs(loss["cuda"] - loss["cpu"])
    d_hidden = float((hidden["cuda"] - hidden["cpu"]).abs().max())
    expect = dict.fromkeys(launches["cpu"], 0)
    assert launches["cpu"] == expect, launches
    expect.update(selective_scan=4, flash_attention=2, decode_attention=24)
    assert launches["cuda"] == expect, launches
    assert d_loss <= 1e-4 * (1 + abs(loss["cpu"])), d_loss
    assert d_hidden <= 1e-4, d_hidden
    assert torch.equal(tokens["cuda"], tokens["cpu"]), tokens
    return {"loss": loss, "loss_diff": d_loss, "hidden_diff": d_hidden,
            "tokens": tokens, "launches": launches}


def phase_ssm_agreement():
    r = ssm_agreement()
    print(f"[agree-ssm] zamba2-1.2b-smoke fp32: loss cuda={r['loss']['cuda']:.6f} "
          f"cpu={r['loss']['cpu']:.6f} |diff|={r['loss_diff']:.3e}; max |hidden "
          f"diff|={r['hidden_diff']:.3e}; 17 greedy tokens identical: "
          f"{r['tokens']['cuda'][0].tolist()}; cuda launches={r['launches']['cuda']}")


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the LLM training path: the flash backward, launch/train.py, the parallel
# FFT round and the LoRA-LLM FedAuto rounds
# ---------------------------------------------------------------------------
SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
SCAN_BWD_TRAIN = (8, 256, 32, 128, 64)   # zamba2-1.2b's train step, a layer
# (B, S, H, dh, n): the train shape, the forward's row-7 shape, n of 16
# and 128 (two 64-column slices a head), S off the 32-step chunk, dh off
# the kernel's 128-row tile, the JAX test's shapes, a single step; then dh
# 192 (two row tiles, the second half empty) at H = 1, B H = 2 blocks a
# slice, far below the card's 132 SMs
SCAN_BWD_CHECKS = [SCAN_BWD_TRAIN, SCAN_LAYER, (2, 256, 4, 128, 16),
                   (2, 256, 4, 128, 128), (2, 100, 3, 128, 64),
                   (1, 4095, 2, 72, 64), (2, 33, 2, 33, 7),
                   (2, 64, 4, 8, 16), (1, 100, 2, 32, 64), (2, 128, 3, 16, 24),
                   (1, 1, 1, 1, 1), (2, 300, 1, 192, 64)]


def scan_bwd_inputs(B, S, H, dh, n, seed, device="cuda", decay="recipe"):
    """``scan_inputs`` and dy ~ N(0, 1): the backward's five inputs."""
    xdt, a_log, Bm, Cm = scan_inputs(B, S, H, dh, n, seed, device, decay)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn(xdt.shape, generator=g, device=device)
    return xdt, a_log, Bm, Cm, dy


def scan_bwd_error(got, want):
    """``scan_error`` over the four gradients (dxdt, da_log, dB, dC): the
    largest error and share of the limit, and each one's share."""
    es = [scan_error(g, w) for g, w in zip(got, want)]
    return {"max_abs_err": max(e["max_abs_err"] for e in es),
            "share_of_limit": max(e["share_of_limit"] for e in es),
            "shares": [round(e["share_of_limit"], 4) for e in es],
            "ok": all(e["ok"] for e in es)}


def scan_train_path(ins):
    """The main path's calls, as its autograd Function makes them: the
    forward with its states (``ops.selective_scan_fwd(..., with_states=
    True)``), then ``ops.selective_scan_bwd`` given them; returns (y,
    states, the four gradients)."""
    from repro_torch.kernels import ops
    y, states = ops.selective_scan_fwd(*ins[:4], with_states=True)
    return y, states, ops.selective_scan_bwd(*ins, states)


def scan_bwd_check(B, S, H, dh, n, seed, device="cuda"):
    """The main path's forward with states and its backward given them
    (``scan_train_path``): y against the sequential plain forward, the
    gradients against the chunked plain backward, each within 2e-4 (1 +
    |want|), then a second backward that must equal the first bit for bit;
    ``scan_bwd_error``'s dict with "y_share" and "bitwise"."""
    from repro_torch.kernels import ops, ref
    ins = scan_bwd_inputs(B, S, H, dh, n, seed, device)
    y, states, got = scan_train_path(ins)
    again = ops.selective_scan_bwd(*ins, states)
    sync(device)
    ey = scan_error(y, ref.selective_scan(
        *ins[:4], torch.zeros((B, H, dh, n), device=device))[0])
    e = scan_bwd_error(got, ref.selective_scan_bwd(*ins, chunk=32))
    e["y_share"] = ey["share_of_limit"]
    e["bitwise"] = all(torch.equal(a, b) for a, b in zip(got, again))
    e["ok"] = e["ok"] and ey["ok"] and e["bitwise"]
    return e


# With no decay the state grows over all 4096 steps and the gradients sum
# terms that cancel: no fp32 computation holds 2e-4 (1 + |want|) there,
# and the largest error over the limit is a max of rounding noise (the
# FMA kernel's over the fp32 plain backward's read 0.50-1.36 over six seeds
# at (1, 4096, 8, 128, 64), H100).  Its RMS over each gradient is stable:
# the kernel's RMS error against the fp64 result read 0.89-1.001x the fp32
# plain backward's (and 2.4e-7-3.0e-7 of the gradient's RMS) on the same
# seeds, the 3xTF32 kernel's 0.62-1.00x over seeds 0-5, 9 and 750.  A
# gradient that misses the limit must keep its RMS error within
# ``SCAN_BWD_REGIME_RATIO`` times the fp32 plain backward's.
SCAN_BWD_REGIME_RATIO = 1.1


def _rms(x):
    return float(x.double().pow(2).mean().sqrt()) if x.numel() else 0.0


def scan_bwd_regime_check(decay, B, S, H, dh, n, seed, device="cuda"):
    """The backward kernel in a decay regime of ``scan_inputs`` against the
    plain backward in fp64 on the same device: ``scan_bwd_error``'s dict,
    "plain_share" (the fp32 plain backward's own share) and "rms_ratio"
    (per gradient, the kernel's RMS error over the fp32 plain backward's);
    the kernel must hold the limit, or keep every gradient's RMS ratio
    within ``SCAN_BWD_REGIME_RATIO``.  The kernel runs as on the main path,
    given the forward's states (``scan_train_path``)."""
    from repro_torch.kernels import ref
    ins = scan_bwd_inputs(B, S, H, dh, n, seed, device, decay=decay)
    got = scan_train_path(ins)[2]
    sync(device)
    want = ref.selective_scan_bwd(*(t.double() for t in ins), chunk=32)
    plain = ref.selective_scan_bwd(*ins, chunk=32)
    e = scan_bwd_error([g.double() for g in got], want)
    e["plain_share"] = scan_bwd_error([p.double() for p in plain],
                                      want)["share_of_limit"]
    e["rms_ratio"] = [round(_rms(g.double() - w) / max(_rms(p.double() - w),
                                                       1e-300), 4)
                      for g, p, w in zip(got, plain, want)]
    e["ok"] = (all(bool(torch.isfinite(g).all()) for g in got) and
               (e["share_of_limit"] <= 1.0 or
                max(e["rms_ratio"]) <= SCAN_BWD_REGIME_RATIO))
    return e


def scan_bwd_flops(B, S, H, dh, n):
    """The sequential backward's flops: per step and (b, h), the state h_t
    again, the adjoint g_t, and dxdt, dB and dC from them, 2 dh n each."""
    return 10.0 * B * S * H * dh * n


def scan_bwd_bound(B, S, H, dh, n):
    """bytes: xdt and dy read and dxdt written (B,S,H,dh), a_log and
    da_log (B,S,H), B, C, dB and dC (B,S,n), fp32, each once; operations:
    ``scan_bwd_flops`` on the TF32 tensor cores three times over (the
    3xTF32 split that keeps fp32 accuracy), as ``scan_bound`` counts the
    forward."""
    nbytes = 4 * (3 * B * S * H * dh + 2 * B * S * H + 4 * B * S * n)
    t_ops = 3 * scan_bwd_flops(B, S, H, dh, n) / TF32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_bwd_timing(B, S, H, dh, n, iters=10):
    """The main path's scan calls in turns (``cuda_times``): the backward
    given the forward's states, the plain backward, the forward with its
    states and without them (the forward a no-grad call runs); the device
    elapsed time of one backward call, and the bound.  Returns
    (``timing``'s dict for the backward, line)."""
    from repro_torch.kernels import ops, ref
    ins = scan_bwd_inputs(B, S, H, dh, n, seed=11)
    _, states = ops.selective_scan_fwd(*ins[:4], with_states=True)
    fns = [lambda: ops.selective_scan_bwd(*ins, states),
           lambda: ref.selective_scan_bwd(*ins, chunk=32),
           lambda: ops.selective_scan_fwd(*ins[:4], with_states=True),
           lambda: ops.selective_scan_fwd(*ins[:4])]
    k_ms, p_ms, fs_ms, f_ms = cuda_times(fns, iters)
    el = device_elapsed(fns[0], calls=6)
    b_ms, b_by = scan_bwd_bound(B, S, H, dh, n)
    line = (f"selective_scan_bwd B={B} S={S} H={H} dh={dh} n={n} fp32: "
            f"kernel_ms(given the forward's states)={k_ms:.4f} elapsed_ms="
            f"{el:.4f} bound_ms={b_ms:.4f} ({b_by}) share_of_bound="
            f"{b_ms / k_ms:.4f} forward_ms with states={fs_ms:.4f} without="
            f"{f_ms:.4f} plain_ms(chunked, Q=32)={p_ms:.4f} library_ms=null "
            f"(no PyTorch call computes the scan's gradient) "
            f"kernel_GFLOP/s(sequential)="
            f"{scan_bwd_flops(B, S, H, dh, n) / k_ms / 1e6:.1f}")
    out = timing(k_ms, p_ms, b_ms, b_by, None)
    out.update(elapsed_ms=float(el))
    del ins, states
    torch.cuda.empty_cache()
    return out, line


def phase_scan_bwd(device="cuda", checks=SCAN_BWD_CHECKS,
                   regimes=SCAN_REGIMES):
    """``[scan-bwd]``: the main path's forward with states and
    ``ops.selective_scan_bwd`` given them (``scan_bwd_check``) against the
    plain versions at every shape of ``checks`` within 2e-4 (1 + |want|) on
    y and each gradient, each backward repeated bit for bit, and in the
    decay ``regimes`` against the fp64 plain backward; then, on the card,
    timed at
    zamba2-1.2b's train shape and at the forward's row-7 shape
    (``scan_bwd_timing``).  On the CPU (a rehearsal) the wrapper is the
    plain backward.  Returns (errs, {"train": timing, "layer": timing})."""
    errs = {}
    for i, shape in enumerate(checks):
        e = scan_bwd_check(*shape, seed=700 + i, device=device)
        errs[shape] = e
        print(f"[scan-bwd] B,S,H,dh,n={shape} max_abs_err={e['max_abs_err']:.3e} "
              f"share_of_limit={e['share_of_limit']:.4f} (dxdt, da_log, dB, "
              f"dC: {e['shares']}; the forward's y: {e['y_share']:.4f}) "
              f"bitwise repeat={e['bitwise']} "
              f"{'ok' if e['ok'] else 'FAIL'}")
        if not e["ok"]:
            raise AssertionError(f"selective_scan_bwd {shape} disagrees with "
                                 "its plain version or does not repeat")
        gc.collect()
    for i, (decay, shape) in enumerate(regimes):
        e = scan_bwd_regime_check(decay, *shape, seed=750 + i, device=device)
        print(f"[scan-bwd] decay={decay} B,S,H,dh,n={shape} against the fp64 "
              f"plain backward: max_abs_err={e['max_abs_err']:.3e} "
              f"share_of_limit={e['share_of_limit']:.4f} ({e['shares']}; fp32 "
              f"plain backward: {e['plain_share']:.4f}) RMS error over the "
              f"fp32 plain backward's={e['rms_ratio']} "
              f"{'ok' if e['ok'] else 'FAIL'}")
        if not e["ok"]:
            raise AssertionError(f"selective_scan_bwd decay={decay} disagrees "
                                 "with the exact backward")
        gc.collect()
    times = {}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        for key, shape, iters in (("train", SCAN_BWD_TRAIN, 20),
                                  ("layer", SCAN_LAYER, 3)):
            times[key], line = scan_bwd_timing(*shape, iters=iters)
            print(f"[scan-bwd-time] {line}")
    return errs, times


FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/attention_bwd.cu"
# (B, Sq, Sk, H, KV, hd, causal, window, dtype): launch/train.py's shape
# (B=8, S=256, 28 calls a step; the timed one), qwen3-1.7b's forward shape,
# a window across tile edges, an odd S, g = 1 at hd 64 (zamba2's heads),
# Sq < Sk, rows with no valid key (Sq > Sk + window - 1), and fp32 at hd 32;
# then bf16 at hd 32, bf16 rows with no valid key, and `[fft-lora-llm]`'s
# shape (S=64, under one tile); then hd 256 (gemma-7b) in both dtypes,
# causal and windowed, with GQA and rows with no valid key, and gemma's
# `[fft-lora-llm-dense]` shape; then padded head dims (8, 24, 48, 200) in
# both dtypes, causal or windowed, and hd 136, whose fourth 64-column box
# lies wholly past hd (loaded as zeros, dropped by the stores)
FLASH_BWD_CHECKS = [
    (8, 256, 256, 16, 8, 128, True, None, torch.bfloat16),
    (4, 4096, 4096, 16, 8, 128, True, None, torch.bfloat16),
    (2, 1000, 1000, 16, 8, 128, True, 100, torch.bfloat16),
    (2, 777, 777, 16, 8, 128, True, None, torch.bfloat16),
    (2, 1024, 1024, 32, 32, 64, True, None, torch.bfloat16),
    (2, 100, 300, 8, 4, 128, True, None, torch.bfloat16),
    (1, 300, 100, 8, 2, 64, False, 32, torch.float32),
    (2, 300, 300, 8, 2, 32, True, None, torch.float32),
    (2, 300, 300, 8, 2, 32, True, None, torch.bfloat16),
    (1, 300, 100, 8, 2, 64, False, 32, torch.bfloat16),
    (4, 64, 64, 16, 8, 128, True, None, torch.bfloat16),
    (2, 1000, 1000, 16, 8, 256, True, None, torch.bfloat16),
    (2, 777, 777, 16, 4, 256, True, 100, torch.bfloat16),
    (1, 300, 100, 8, 2, 256, False, 32, torch.bfloat16),
    (2, 300, 300, 8, 2, 256, True, None, torch.float32),
    (1, 300, 100, 8, 2, 256, False, 32, torch.float32),
    (2, 500, 500, 8, 4, 256, True, 100, torch.float32),
    (4, 64, 64, 16, 16, 256, True, None, torch.bfloat16),
    (2, 300, 300, 8, 2, 8, True, None, torch.bfloat16),
    (2, 300, 300, 8, 2, 8, True, None, torch.float32),
    (2, 500, 500, 12, 4, 24, True, 100, torch.bfloat16),
    (2, 500, 500, 12, 4, 24, True, 100, torch.float32),
    (2, 777, 777, 16, 16, 48, True, None, torch.bfloat16),
    (2, 777, 777, 16, 16, 48, True, None, torch.float32),
    (1, 300, 100, 8, 2, 200, False, 32, torch.bfloat16),
    (2, 300, 300, 8, 2, 200, True, 64, torch.float32),
    (2, 500, 500, 4, 2, 136, True, None, torch.bfloat16),
    # the LoRA-LLM shapes of codeqwen1.5-7b (g = 1) and starcoder2-7b (g = 9,
    # its window) that ``[fft-lora-llm-dense]`` trains
    (4, 64, 64, 32, 32, 128, True, None, torch.bfloat16),
    (4, 64, 64, 36, 4, 128, True, 4096, torch.bfloat16),
]
# gemma-7b's hd 256 backward timed as row 5d of PERF.md: qwen3's forward
# shape with gemma's heads (B=4, S=4096, 16/16, causal)
FLASH_BWD_GEMMA = (4, 4096, 4096, 16, 16, 256, True, None, torch.bfloat16)
# lse: the kernels' exp2/log2 of log2e-scaled scores (bf16) or expf/logf
# (fp32) against the plain logsumexp, both fp32: a few ulp of |lse|
LSE_TOL = 1e-5
# The gradients: ``ATTN_TOL``'s rules (each bf16 gradient is rounded once
# from fp32, as the forward's output is), and in bf16 a floor of 1e-3 of
# the tensor's RMS: a row whose terms cancel (query 0 under the causal
# mask sees only key 0, so its dS = P (dP - D) is 0 in exact arithmetic)
# keeps the fp32 summation-order error of terms of the tensor's scale,
# which the row's own RMS does not bound.
GRAD_TOL = {torch.float32: ATTN_TOL[torch.float32],
            torch.bfloat16: dict(ATTN_TOL[torch.bfloat16], tensor=1e-3)}


def flash_bwd_bound(B, Sq, Sk, H, KV, hd, causal, window, dtype):
    """The backward's least time: 10 hd flops per unmasked (query, key)
    pair (S, dP, dV, dK, dQ at 2 hd each) at the dtype's peak, or q, k, v,
    o, dO, dq, dk, dv, lse and D read or written once."""
    isz = torch.empty((), dtype=dtype).element_size()
    flops = 10.0 * B * H * hd * flash_pairs(Sq, Sk, causal, window)
    nbytes = (4 * B * Sq * H * hd + 4 * B * Sk * KV * hd) * isz + 8 * B * H * Sq
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bwd_check(B, Sq, Sk, H, KV, hd, causal, window, dt, seed):
    """The backward kernels against the plain backward on the same inputs
    (q, k, v, dO and the forward kernel's out and lse), under
    ``attention_error`` per gradient under ``GRAD_TOL``; the forward
    kernel's lse against the plain
    one; and a second call bitwise the first.  Returns {"max_abs_err",
    "lse_err", "bitwise", "ok"}."""
    from repro_torch.kernels import ops, ref
    q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed)
    do = attn_inputs(B, Sq, 1, H, 1, hd, dt, seed + 1)[0]
    kw = dict(causal=causal, window=window, scale=hd ** -0.5)
    out, lse = ops.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    lse_err = float(((lse - ref.flash_attention_lse(q, k, v, **kw)[1]).abs()
                     / (1 + lse.abs())).max())
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = ref.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    errs = [attention_error(g, w, GRAD_TOL) for g, w in zip(got, want)]
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    label = (f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
             f"window={window} {str(dt)[6:]}")
    ok = all(e["ok"] for e in errs) and bitwise and lse_err <= LSE_TOL
    print(f"[flash-bwd] {label} " + " ".join(
        f"{n}: max_abs_err={e['max_abs_err']:.3e} share_of_limit="
        f"{e['share_of_limit']:.3f}" for n, e in zip(("dq", "dk", "dv"), errs))
        + f" lse_rel_err={lse_err:.2e} bitwise_repeat={bitwise} "
        f"{'ok' if ok else 'FAIL'}")
    return {"max_abs_err": max(e["max_abs_err"] for e in errs),
            "lse_err": lse_err, "bitwise": bitwise, "ok": ok}


def parent_flash_bwd(src_dir):
    """Another commit's ``flash_attention_bwd_bf16`` as a ctypes function,
    to time it in turns with this tree's: ``src_dir`` holds that commit's
    ``attention_bwd.cu`` and the headers it includes (written there by
    ``git show <commit>:src/repro_torch/kernels/csrc/<file>``), compiled
    here into a library of its own."""
    import ctypes
    from repro_torch.kernels import build
    so = os.path.join(src_dir, "libparent_bwd.so")
    cmd = [build.find_nvcc(), *build.COMPILE_FLAGS, "-shared", "-o", so,
           os.path.join(src_dir, "attention_bwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{res.stderr}")
    fn = ctypes.CDLL(so).flash_attention_bwd_bf16
    fn.argtypes = build.ENTRIES["flash_attention_bwd_bf16"]
    fn.restype = ctypes.c_int
    return fn


def flash_bwd_timing(B, Sq, Sk, H, KV, hd, causal, window, dt, iters,
                     parent=None):
    """The backward kernels timed against the plain backward, their bound
    and SDPA's backward on the same inputs (``autograd.grad`` of its saved
    forward: one call of the library computing the same function) and, when
    ``parent`` (``parent_flash_bwd``) is given, an older commit's backward,
    in turns; then forward + backward, ours against SDPA's, in turns; the
    device time of one call with the host excluded (``device_elapsed``) of
    each, and the profiler's device time per call with its split over our
    three kernels.  Returns the ``kernels`` entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=11)
    do = attn_inputs(B, Sq, 1, H, 1, hd, dt, seed=12)[0]
    kw = dict(causal=causal, window=window, scale=hd ** -0.5)
    out, lse = ops.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def ours():
        return ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)

    def sdpa_bwd():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    def parent_bwd():
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        work = torch.empty(2 * B * H * -(-Sq // 128) * 128,
                           dtype=torch.float32, device="cuda")
        err = parent(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), work.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk,
                     H, KV, hd, int(causal), int(window or 0), kw["scale"],
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's backward failed: CUDA error {err}")
        return dq, dk, dv

    def ours_fwd_bwd():
        o = ops.flash_attention(qg, kg, vg, causal=causal, window=window)
        return torch.autograd.grad(o, (qg, kg, vg), do)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    fns = [ours, sdpa_bwd] + ([parent_bwd] if parent is not None else [])
    k_ms, l_ms, *par_ms = cuda_times(fns, iters)
    f_ms, lf_ms = cuda_times([ours_fwd_bwd, sdpa_fwd_bwd], iters)
    p_ms = cuda_ms(lambda: ref.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                   1)
    k_el, l_el, *par_el = (device_elapsed(fn) for fn in fns)
    k_dev, split = device_profile(ours, 5)
    l_dev = device_ms(sdpa_bwd, 5)
    split = {name: ms for name, (_, ms) in split.items()}
    b_ms, b_by = flash_bwd_bound(B, Sq, Sk, H, KV, hd, causal, window, dt)
    flops = 10.0 * B * H * hd * flash_pairs(Sq, Sk, causal, window)
    parent_txt = (f" parent_ms(in turns)={par_ms[0]:.4f} "
                  f"parent_elapsed_ms={par_el[0]:.4f}" if par_ms else "")
    print(f"[flash-bwd-time] B={B} S={Sq} H={H} KV={KV} hd={hd} causal "
          f"{str(dt)[6:]}: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms(sdpa backward, in turns)={l_ms:.4f}{parent_txt} "
          f"elapsed_ms: kernel={k_el:.4f} sdpa={l_el:.4f} "
          f"fwd+bwd_ms={f_ms:.4f} library_fwd+bwd_ms(sdpa, in turns)="
          f"{lf_ms:.4f} kernel_TFLOP/s={flops / k_ms / 1e9:.2f} "
          f"device_ms(profiler): kernel={k_dev} sdpa={l_dev} split={split}")
    del q, k, v, do, out, lse, qt, kt, vt, ot, dot, qg, kg, vg
    torch.cuda.empty_cache()
    entry = dict(timing(k_ms, p_ms, b_ms, b_by, l_ms), device_ms=k_dev,
                 library_device_ms=l_dev, elapsed_ms=float(k_el),
                 library_elapsed_ms=float(l_el), kernel_device_ms=split,
                 fwd_bwd_ms=float(f_ms), fwd_bwd_ms_q1=f_ms.q1,
                 fwd_bwd_ms_q3=f_ms.q3, library_fwd_bwd_ms=float(lf_ms),
                 library_fwd_bwd_ms_q1=lf_ms.q1, library_fwd_bwd_ms_q3=lf_ms.q3)
    if par_ms:
        entry.update(parent_ms=float(par_ms[0]), parent_ms_q1=par_ms[0].q1,
                     parent_ms_q3=par_ms[0].q3, parent_elapsed_ms=float(par_el[0]))
    return entry


def phase_flash_bwd():
    """``[flash-bwd]``: every ``FLASH_BWD_CHECKS`` case, then the backward
    timed at the train shape, at qwen3's forward shape, at gemma-7b's hd
    256 (``FLASH_BWD_GEMMA``) and at gemma's LoRA-LLM shape.  Returns
    ({"hd<=128" | "hd256": {dtype: max_abs_err}}, {same keys: the
    ``kernels`` timing of the train shape, of ``FLASH_BWD_GEMMA``})."""
    errs = {"hd<=128": {}, "hd256": {}}
    for i, case in enumerate(FLASH_BWD_CHECKS):
        r = flash_bwd_check(*case, seed=300 + 2 * i)
        if not r["ok"]:
            raise AssertionError(f"flash_attention_bwd disagrees with its "
                                 f"plain version or does not repeat: {case}")
        e = errs["hd256" if case[5] > 128 else "hd<=128"]
        e[case[-1]] = max(e.get(case[-1], 0.0), r["max_abs_err"])
        torch.cuda.empty_cache()
    t = flash_bwd_timing(*FLASH_BWD_CHECKS[0], iters=20)
    flash_bwd_timing(*FLASH_BWD_CHECKS[1], iters=2)
    t256 = flash_bwd_timing(*FLASH_BWD_GEMMA, iters=2)
    flash_bwd_timing(4, 64, 64, 16, 16, 256, True, None, torch.bfloat16,
                     iters=20)
    return errs, {"hd<=128": t, "hd256": t256}


def token_batches(cfg, B, S, seed, n_tokens=200_000):
    from repro_torch.data.tokens import batches_from_stream, make_bigram_stream
    stream = make_bigram_stream(n_tokens, cfg.vocab_size, domain=0,
                                n_domains=1, seed=seed)
    return batches_from_stream(stream, B, S, seed=seed)


def phase_train(device="cuda", smoke=False, steps=30, B=8, S=256):
    """``[train]``: ``python -m repro_torch.launch.train --arch qwen3-1.7b
    --smoke-scale=false --batch 8 --seq 256 --steps 30`` (warmup 20, the
    loss must fall), with exactly 28 x 2 flash_attention launches (each
    layer is recomputed in the backward) and 28 flash_attention_bwd
    launches a step, and its checkpoint loaded back bitwise; then step
    wall, tok/s and peak memory with remat on and, for one step, off; one
    step profiled (kernel time, launches, busy share), and once more with
    each layer's leaves selected per layer instead of unbound once (the
    launches that change saves); the model-flops share 6 N tokens / wall /
    989 TFLOP/s.  Returns the launch counts of the ``main`` run."""
    from repro_torch.checkpoint import load
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("qwen3-1.7b")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "train.ckpt")
        ops.reset_launches()
        r = train.main(["--arch", "qwen3-1.7b", f"--smoke-scale={smoke}",
                        "--batch", str(B), "--seq", str(S), "--steps",
                        str(steps), "--device", device, "--checkpoint", path])
        launches = dict(ops.launches)
        params, opt_state, losses = r["params"], r["opt_state"], r["losses"]
        t0 = time.perf_counter()
        back = params_from_jax(load(path)["params"], device=device)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                   zip(tree_leaves(back), tree_leaves(params)))
        size = os.path.getsize(path)
        load_s = time.perf_counter() - t0
        del back
    n_params = sum(t.numel() for t in tree_leaves(params))
    L = cfg.num_layers
    print(f"[train] {cfg.name} ({n_params} params) B={B} S={S} {steps} steps: "
          f"loss first={losses[0]:.4f} last10={np.mean(losses[-10:]):.4f} "
          f"main wall_s={r['wall_s']:.2f} launches={launches}; checkpoint "
          f"{size} bytes loaded back in {load_s:.2f} s, bitwise={same}")
    assert np.mean(losses[-10:]) < losses[0] and same
    expect = (2 * L * steps, L * steps) if cuda else (0, 0)
    assert (launches["flash_attention"], launches["flash_attention_bwd"]) \
        == expect, launches
    assert not cuda or smoke or expect == (1680, 840)

    batches = token_batches(cfg, B, S, seed=5)

    def batch():
        toks, labels = next(batches)
        return torch.from_numpy(toks).to(device), torch.from_numpy(labels).to(device)

    def timed_steps(remat, n):
        step = train.make_train_step(cfg, remat=remat)
        walls, peak = [], "not measured"
        for _ in range(n):
            toks, labels = batch()
            sync(device)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(params, opt_state, toks, labels, 1e-4)
            sync(device)
            walls.append(time.perf_counter() - t0)
            if cuda:
                peak = torch.cuda.max_memory_allocated()
        return walls, peak

    def grad_peak(remat):
        """Peak memory of the forward and backward alone (no optimizer):
        the params, the gradients, the layers' saved tensors and the loss
        chunks' fp32 logits."""
        toks, labels = batch()
        sync(device)
        if not cuda:
            return "not measured"
        torch.cuda.reset_peak_memory_stats()
        train.value_and_grad(cfg, params, toks, labels,
                             loss_chunk=train.LOSS_CHUNK, remat=remat)
        sync(device)
        return torch.cuda.max_memory_allocated()

    flops_per_step = 6.0 * n_params * B * S
    for remat, n in ((True, 4), (False, 2)):
        walls, peak = timed_steps(remat, n)
        wall = float(np.median(walls[1:] if n > 1 else walls))
        mfs = f"{flops_per_step / wall / BF16_FLOP_PER_S:.4f}" if cuda \
            else "not measured"
        print(f"[train] remat={remat}: step wall_s={wall:.4f} (each: "
              f"{', '.join(f'{w:.4f}' for w in walls)}) tok/s={B * S / wall:.1f} "
              f"peak_mem_bytes={peak} (forward + backward alone: "
              f"{grad_peak(remat)}) model_flops_share(6 N tokens / wall / "
              f"989 TFLOP/s)={mfs}")
    if not cuda:
        return launches
    step = train.make_train_step(cfg)
    toks, labels = batch()
    profile_kernels(lambda: step(params, opt_state, toks, labels, 1e-4),
                    f"train: one step of {cfg.name} B={B} S={S}",
                    {"flash_attention_fwd": "flash_attention",
                     "flash_attention_bwd": "flash_bwd"})
    unstack = T._unstack
    T._unstack = lambda stacked, n: [T._layer(stacked, i) for i in range(n)]
    try:
        profile_kernels(lambda: step(params, opt_state, toks, labels, 1e-4),
                        f"train: one step, each layer's leaves selected t[i] "
                        f"(before the unbind)", {"flash_attention_bwd": "flash_bwd"})
    finally:
        T._unstack = unstack
    return launches


def phase_fft_round(device="cuda", smoke=False, K=4, b=2, S=256):
    """``[fft-round]``: ``fl/parallel.py``'s round on full-width qwen3-1.7b,
    K clients of b sequences, one β at 0; changing that client's tokens
    leaves the new global params and the loss bitwise the same.  Wall and
    peak memory of the first round."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.fl.parallel import make_fft_round_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("qwen3-1.7b")
    params = T.init_params(cfg, 1, device)
    toks, labels = (torch.from_numpy(x).reshape(K, b, S).to(device)
                    for x in next(token_batches(cfg, K * b, S, seed=6)))
    beta = torch.tensor([0.4, 0.0, 0.35, 0.25], device=device)[:K]
    fft_round = make_fft_round_step(cfg, lr=1e-3, loss_chunk=S)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    new, loss = fft_round(params, toks, labels, beta)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    other = toks.clone()
    other[1] = (other[1] * 7 + 1) % cfg.vocab_size
    t0 = time.perf_counter()
    new2, loss2 = fft_round(params, other, labels, beta)
    sync(device)
    wall2 = time.perf_counter() - t0
    same = float(loss2) == float(loss) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(new), tree_leaves(new2)))
    moved = max(float((x.float() - p.float()).abs().max())
                for x, p in zip(tree_leaves(new), tree_leaves(params)))
    print(f"[fft-round] {cfg.name} K={K} b={b} S={S} beta={beta.tolist()}: "
          f"weighted loss={float(loss):.4f} wall_s={wall:.4f}, {wall2:.4f} "
          f"peak_mem_bytes={peak} launches={launches} max |new - global|="
          f"{moved:.3e}; the beta=0 client's tokens changed: bitwise the "
          f"same={same}")
    L = cfg.num_layers
    assert same and moved > 0 and bool(torch.isfinite(loss))
    assert launches["flash_attention_bwd"] == (K * L if cuda else 0), launches
    return launches


def phase_fft_lora_llm(device="cuda", smoke=False, rounds=3):
    """``[fft-lora-llm]``: ``launch/fft_lora_llm.py`` on full-width
    qwen3-1.7b for 3 rounds (4 clients, 4 local steps, B=4 x S=64, rank-4
    adapters on wq/w and wv/w), with exactly 4 fedagg launches a round
    (one per adapter leaf) and the frozen base bitwise unchanged; the round
    walls."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import fft_lora_llm
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("qwen3-1.7b")
    base = T.init_params(cfg, 0, device)
    before = [t.clone() for t in tree_leaves(base)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = fft_lora_llm.run(cfg, rounds=rounds, device=device, base=base)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    frozen = all(torch.equal(a, c) for a, c in zip(tree_leaves(base), before))
    n_ad = len(tree_leaves(out["adapters"]))
    finite = all(bool(torch.isfinite(a).all()) for a in tree_leaves(out["adapters"]))
    print(f"[fft-lora-llm] {cfg.name} {rounds} rounds: round wall_s="
          f"{', '.join(f'{w:.4f}' for w in out['round_s'])} connected="
          f"{[int(u.sum()) for u in out['connected']]} server_loss="
          f"{[round(x, 4) for x in out['server_loss']]} {n_ad} adapter leaves, "
          f"peak_mem_bytes={peak} launches={launches} base bitwise "
          f"unchanged={frozen}")
    assert frozen and finite and n_ad == 4
    assert launches["fedagg"] == (n_ad * rounds if cuda else 0), launches
    return launches


FFT_DENSE_ARCHS = ("codeqwen1.5-7b", "starcoder2-7b", "gemma-7b")


def phase_fft_lora_llm_dense(device="cuda", smoke=False, rounds=2):
    """``[fft-lora-llm-dense]``: ``launch/fft_lora_llm.py`` on each of
    ``FFT_DENSE_ARCHS`` at full width (bf16, 4 clients, 4 local steps, B=4
    x S=64, rank-4 adapters on wq/w and wv/w), ``rounds`` rounds, one model
    at a time, with exactly 4 fedagg launches a round (one per adapter
    leaf), one flash_attention_bwd launch per layer, local step and model
    trained (the server's and each connected client's; gemma-7b's on the
    hd 256 kernel) and two flash_attention launches (remat recomputes each
    layer), the adapters finite and the frozen base bitwise unchanged: held
    against a second init from the same seed, drawn after the run, so the
    check adds no copy to the run's peak.  The round walls and the peak
    memory.  Returns {arch: launches}."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import fft_lora_llm
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    res = {}
    for arch in FFT_DENSE_ARCHS:
        cfg = (get_smoke_config if smoke else get_config)(arch)
        base = T.init_params(cfg, 0, device)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fft_lora_llm.run(cfg, rounds=rounds, device=device, base=base)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
        ads = tree_leaves(out["adapters"])
        finite = all(bool(torch.isfinite(a).all()) for a in ads)
        models = sum(1 + int(u.sum()) for u in out["connected"])
        round_s, losses = out["round_s"], out["server_loss"]
        del out
        again = T.init_params(cfg, 0, device)
        frozen = all(torch.equal(a, b) for a, b in
                     zip(tree_leaves(base), tree_leaves(again)))
        del again, base
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        n_bwd = cfg.num_layers * 4 * models
        print(f"[fft-lora-llm-dense] {cfg.name} (hd {cfg.resolved_head_dim}) "
              f"{rounds} rounds, {models} models trained: round wall_s="
              f"{', '.join(f'{w:.4f}' for w in round_s)} (run {wall:.2f} s) "
              f"server_loss={[round(x, 4) for x in losses]} peak_mem_bytes="
              f"{peak} launches={launches} base bitwise unchanged={frozen}")
        assert frozen and finite and len(ads) == 4
        assert launches["fedagg"] == (4 * rounds if cuda else 0), launches
        assert launches["flash_attention_bwd"] == (n_bwd if cuda else 0), launches
        assert launches["flash_attention"] == (2 * n_bwd if cuda else 0), launches
        res[arch] = launches
    return res


def phase_xlstm(device="cuda", smoke=False, steps=4, B=8, S=256,
                serve_B=4, prompt=64, decode=32, score_B=4, score_S=1024):
    """``[xlstm]``: xlstm-125m (12 blocks, mLSTM and sLSTM in turn, d_model
    768; no attention, so no kernel of the port: its time loops are plain
    PyTorch) at full width in bf16.  train: ``steps`` AdamW steps of
    ``launch.train``'s step at B x S (each block recomputed in the
    backward), the loss finite and the params changed, step walls, tok/s
    and peak memory; the peak of the forward and backward alone with and
    without the per-block remat at S/4; one step at S=8 and S=16
    profiled (kernel launches, busy share: the launches grow linearly with
    S).  serve: ``serve.generate`` at B=``serve_B``, a ``prompt``-token
    prompt and ``decode`` greedy steps: prefill s, ms a step, peak.  score:
    ``forward`` under no_grad at ``score_B`` x ``score_S``: wall, tok/s,
    peak, the loss finite and within ``DENSE_LOSS_TOL`` of
    ``init_loss_prediction``.  Returns the kernels' launch counts over the
    three runs (all 0)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("xlstm-125m")
    params = T.init_params(cfg, 0, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    first = [t.clone() for t in tree_leaves(params)]
    opt = adamw_init(params)
    step = train.make_train_step(cfg)
    batches = token_batches(cfg, B, S, seed=7)
    peak = lambda: torch.cuda.max_memory_allocated() if cuda else "not measured"

    def batch(it=batches):
        toks, labels = next(it)
        return (torch.from_numpy(toks).to(device),
                torch.from_numpy(labels).to(device))

    ops.reset_launches()
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(steps):
        toks, labels = batch()
        sync(device)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks, labels, 3e-4)
        sync(device)
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    train_peak = peak()
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(params), first))
    del first
    wall = float(np.median(walls[1:]))
    print(f"[xlstm] train {cfg.name} ({n_params} params) B={B} S={S} {steps} "
          f"AdamW steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, step wall_s="
          f"{wall:.4f} (each: {', '.join(f'{w:.4f}' for w in walls)}) tok/s="
          f"{B * S / wall:.1f} peak_mem_bytes={train_peak} max |param moved|="
          f"{moved:.3e}")
    assert all(np.isfinite(losses)) and moved > 0

    small = token_batches(cfg, B, S // 4, seed=8)
    for remat in (True, False):
        toks, labels = batch(small)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        train.value_and_grad(cfg, params, toks, labels,
                             loss_chunk=train.LOSS_CHUNK, remat=remat)
        sync(device)
        print(f"[xlstm] forward + backward B={B} S={S // 4} remat={remat}: "
              f"peak_mem_bytes={peak()}")
    if cuda:
        for s_prof in (8, 16):
            toks, labels = batch(token_batches(cfg, B, s_prof, seed=9))
            profile_kernels(lambda: step(params, opt, toks, labels, 3e-4),
                            f"xlstm: one train step B={B} S={s_prof}", {})

    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (serve_B, prompt),
                            generator=gen, device=device)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    r = serve.generate(params, cfg, prompts, decode, 256)
    print(f"[xlstm] serve B={serve_B} prompt {prompt} + {decode} greedy steps: "
          f"prefill_s={r['prefill_s']:.4f} decode ms/step="
          f"{r['decode_s'] / decode * 1e3:.3f} tok/s={r['tok_s']:.1f} "
          f"peak_mem_bytes={peak()}")
    assert r["tokens"].shape == (serve_B, decode + 1)

    toks, labels = next(token_batches(cfg, score_B, score_S, seed=10))
    sb = {"tokens": torch.from_numpy(toks).long().to(device),
          "labels": torch.from_numpy(labels).long().to(device)}
    with torch.no_grad():
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = T.forward(params, cfg, sb, loss_chunk=512)
        sync(device)
        s_wall = time.perf_counter() - t0
        s_peak = peak()
        h, _ = T.hidden_states(params, cfg, sb)
        pred = init_loss_prediction(h, T.lm_head_w(params, cfg),
                                    sb["tokens"], sb["labels"])
        del h
    print(f"[xlstm] score B={score_B} S={score_S}: loss={float(loss):.4f} "
          f"(predicted from the hidden states {pred:.4f}) wall_s={s_wall:.4f} "
          f"tok/s={score_B * score_S / s_wall:.1f} peak_mem_bytes={s_peak}")
    assert bool(torch.isfinite(loss)) and abs(float(loss) - pred) <= DENSE_LOSS_TOL
    launches = dict(ops.launches)
    assert not any(launches.values()), launches
    return launches


ZOO_TRAIN_DEEPSEEK_LAYERS = 2     # its dense layer and 1 MoE layer
ZOO_TRAIN_PROFILE_KEYS = {"selective_scan_bwd": "scan_bwd_",
                          "selective_scan": "selective_scan_",
                          "flash_attention": "flash_attention_"}


def _timed_steps(step, args_of, n, device):
    """``n`` calls ``step(*args_of(i))``, each timed on the host clock to a
    synchronise; returns (the last result, walls)."""
    out, walls = None, []
    for i in range(n):
        args = args_of(i)
        sync(device)
        t0 = time.perf_counter()
        out = step(*args)
        sync(device)
        walls.append(time.perf_counter() - t0)
    return out, walls


def zoo_train_zamba2(device="cuda", smoke=False, steps=4, B=8, S=256):
    """``launch.train.train`` (AdamW, warmup-cosine, the bigram stream) on
    zamba2-1.2b (38 layers: 32 Mamba2 blocks, the shared attention block
    at 6) for ``steps`` steps: the loss finite, exactly 64 selective_scan
    and 32 selective_scan_bwd launches a step (each Mamba2 block's forward
    runs again in the backward), 12 flash_attention and 6
    flash_attention_bwd; then 2 more steps of ``make_train_step`` timed
    one by one (wall, tok/s, peak memory) and one profiled."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import MAMBA2, SHARED_ATTN
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    cuda = torch.device(device).type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)("zamba2-1.2b")
    kinds = cfg.layer_kinds()
    n_scan, n_attn = kinds.count(MAMBA2), kinds.count(SHARED_ATTN)
    params = T.init_params(cfg, 0, device)
    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params, opt, losses, wall = train.train(cfg, params, steps=steps, batch=B,
                                            seq=S, lr=3e-4, log_every=steps)
    launches = dict(ops.launches)
    per_step = {"selective_scan": 2 * n_scan, "selective_scan_bwd": n_scan,
                "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    assert all(np.isfinite(losses)), losses
    for k, n in per_step.items():
        assert launches[k] == (n * steps if cuda else 0), (k, launches)
    step = train.make_train_step(cfg)
    batches = token_batches(cfg, B, S, seed=21)
    data = [tuple(torch.from_numpy(a).to(device) for a in next(batches))
            for _ in range(2)]
    (params, opt, _), walls = _timed_steps(
        step, lambda i: (params, opt, *data[i], 3e-4), 2, device)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    w = min(walls)
    print(f"[zoo-train] zamba2-1.2b ({len(kinds)} layers: {n_scan} Mamba2, "
          f"{n_attn} shared attention) B={B} S={S}, train.train {steps} AdamW "
          f"steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} ({wall:.2f} s); "
          f"2 steps timed: wall_s={', '.join(f'{x:.4f}' for x in walls)} "
          f"tok/s={B * S / w:.1f} peak_mem_bytes={peak} launches a step="
          f"{ {k: launches[k] // steps for k in per_step} }")
    if cuda:
        profile_kernels(lambda: step(params, opt, *data[0], 3e-4),
                        f"zamba2-1.2b one train step B={B} S={S}",
                        ZOO_TRAIN_PROFILE_KEYS, wall_ms=w * 1e3)
    return {"launches": launches, "step_s": walls, "peak": peak}


def zoo_train_seamless(device="cuda", smoke=False, steps=3, B=8, S=256):
    """seamless-m4t-large-v2 as published: ``steps`` AdamW steps of
    ``make_train_step`` with ``extra={"encoder_embeds": ...}`` (S N(0, 1)
    frames, B x S tokens), the loss finite; a step's flash_attention
    launches 2 per encoder and decoder layer (remat) and
    flash_attention_bwd one each, the encoder's at causal=0; walls, peak."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cuda = torch.device(device).type == "cuda"
    cfg = zoo_config("seamless-m4t-large-v2", smoke)
    params = T.init_params(cfg, 0, device)
    opt = adamw_init(params)
    step = train.make_train_step(cfg)
    data = []
    for i in range(steps):
        b, _ = zoo_inputs(cfg, B, S, device, seed=30 + i)
        data.append((b["tokens"], b["labels"],
                     {"encoder_embeds": b["encoder_embeds"]}))
    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses = []

    def one(i):
        nonlocal params, opt
        params, opt, loss = step(params, opt, data[i][0], data[i][1], 3e-4,
                                 data[i][2])
        losses.append(float(loss))

    _, walls = _timed_steps(one, lambda i: (i,), steps, device)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    n_layers = cfg.num_layers + cfg.num_encoder_layers
    print(f"[zoo-train] seamless-m4t-large-v2 ({cfg.num_encoder_layers} + "
          f"{cfg.num_layers} layers) B={B} S={S} + {S} encoder frames, "
          f"{steps} AdamW steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"step wall_s={', '.join(f'{x:.4f}' for x in walls)} tok/s="
          f"{B * S / min(walls):.1f} peak_mem_bytes={peak} launches={launches}")
    assert all(np.isfinite(losses)), losses
    assert launches["flash_attention"] == (2 * n_layers * steps if cuda else 0)
    assert launches["flash_attention_bwd"] == (n_layers * steps if cuda else 0)
    return {"launches": launches, "step_s": walls, "peak": peak}


def zoo_train_deepseek(device="cuda", smoke=False, B=4, S=256):
    """deepseek-v2-236b at published width and expert count, cut to its
    dense layer and 1 MoE layer: one ``value_and_grad`` (remat) and the JAX
    smoke test's SGD step p - 0.01 g, leaf by leaf in place; the gradients
    finite, 2 MoE read-backs (the forward and its recompute), no flash
    launch (MLA is the plain ``sdpa``); the loss on the same batch before
    and after the step; fwd + bwd wall and peak memory."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = zoo_config("deepseek-v2-236b", True) if smoke else dataclasses.replace(
        zoo_config("deepseek-v2-236b"), num_layers=ZOO_TRAIN_DEEPSEEK_LAYERS)
    q_chunk = min(ZOO_Q_CHUNK["deepseek-v2-236b"], S)
    params = T.init_params(cfg, 0, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch, _ = zoo_inputs(cfg, B, S, device, seed=40)
    sync(device)
    ops.reset_launches()
    moe.reset_readbacks()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads = train.value_and_grad(cfg, params, batch["tokens"],
                                       batch["labels"],
                                       loss_chunk=train.LOSS_CHUNK,
                                       q_chunk=q_chunk)
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    reads, launches = dict(moe.readbacks), dict(ops.launches)
    finite = True
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            finite &= bool(torch.isfinite(g).all())
            p.sub_(0.01 * g.to(p.dtype))
        del grads
        after, _ = T.forward(params, cfg, batch, loss_chunk=train.LOSS_CHUNK,
                             q_chunk=q_chunk)
    n_moe = cfg.num_layers - cfg.first_k_dense
    print(f"[zoo-train] deepseek-v2-236b ({cfg.num_layers} layers: "
          f"{cfg.first_k_dense} dense + {n_moe} MoE of {cfg.num_experts} "
          f"experts; {n_params} params) B={B} S={S}: value_and_grad wall_s="
          f"{wall:.4f} peak_mem_bytes={peak} grads finite={finite} "
          f"read-backs={reads['moe_group_sizes']} loss before the SGD step="
          f"{float(loss):.4f} after={float(after):.4f} launches={launches}")
    assert finite and bool(torch.isfinite(after))
    assert reads["moe_group_sizes"] == 2 * n_moe, reads
    assert launches["flash_attention"] == launches["flash_attention_bwd"] == 0
    return {"wall_s": wall, "peak": peak, "loss": (float(loss), float(after))}


def fingerprint(t, chunk=1 << 26):
    """(the sum of ``t``'s bytes, the sum of each byte times its position
    mod 65,521, plus one), in int64 over chunks of ``chunk`` bytes: a check
    that a tensor too large to copy was not written."""
    b = t.detach().reshape(-1).view(torch.uint8)
    total, weighted = 0, 0
    for i in range(0, b.numel(), chunk):
        c = b[i:i + chunk].to(torch.int64)
        pos = (torch.arange(i, i + c.numel(), device=c.device) % 65521) + 1
        total += int(c.sum())
        weighted += int((c * pos).sum())
    return total, weighted


def zoo_train_lora(arch, device="cuda", smoke=False, rounds=2):
    """``launch/fft_lora_llm.py``'s rounds on ``arch`` (mixtral-8x22b at
    ``ZOO_LAYERS``, llava-next-mistral-7b as published; FedAuto, rank-4
    adapters on wq/w and wv/w, 4 clients, 4 local steps, B=4 x S=64, on
    text): exactly 4 fedagg launches a round, one flash_attention_bwd
    launch per layer, local step and model trained (two flash_attention),
    2 MoE read-backs per MoE layer and local step; the adapters finite, the
    base unchanged (each leaf's ``fingerprint`` equal before and after:
    mixtral's 41 GB leave no room for a second copy); round walls, peak."""
    from repro_torch.kernels import ops
    from repro_torch.launch import fft_lora_llm
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cuda = torch.device(device).type == "cuda"
    cfg = zoo_config(arch, smoke)
    base = T.init_params(cfg, 0, device)
    before = [fingerprint(t) for t in tree_leaves(base)]
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    moe.reset_readbacks()
    out = fft_lora_llm.run(cfg, rounds=rounds, device=device, base=base)
    launches, reads = dict(ops.launches), moe.readbacks["moe_group_sizes"]
    peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    ads = tree_leaves(out["adapters"])
    finite = all(bool(torch.isfinite(a).all()) for a in ads)
    models = sum(1 + int(u.sum()) for u in out["connected"])
    round_s, losses = out["round_s"], out["server_loss"]
    del out
    frozen = before == [fingerprint(t) for t in tree_leaves(base)]
    del base
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_fwd = zoo_launches(cfg)[0]
    n_bwd = n_fwd * 4 * models
    n_moe = (cfg.num_layers - cfg.first_k_dense) if cfg.moe else 0
    print(f"[zoo-train] {cfg.name} ({cfg.num_layers} layers) LoRA-LLM "
          f"{rounds} rounds, {models} models trained: round wall_s="
          f"{', '.join(f'{w:.4f}' for w in round_s)} server_loss="
          f"{[round(x, 4) for x in losses]} peak_mem_bytes={peak} "
          f"read-backs={reads} launches={launches} base unchanged (byte "
          f"fingerprints)={frozen}")
    assert frozen and finite and len(ads) == 4
    assert launches["fedagg"] == (4 * rounds if cuda else 0), launches
    assert launches["flash_attention_bwd"] == (n_bwd if cuda else 0), launches
    assert launches["flash_attention"] == (2 * n_bwd if cuda else 0), launches
    assert reads == 2 * n_moe * 4 * models, reads
    return {"launches": launches, "round_s": round_s, "peak": peak}


def phase_zoo_train(device="cuda", smoke=False, zamba2=None, seamless=None,
                    deepseek=None, lora_rounds=None):
    """``[zoo-train]``: the five archs that train since this slice, bf16,
    seed 0, one at a time (``zoo_train_*``; the keyword dicts override
    their shapes): zamba2-1.2b, seamless-m4t-large-v2, deepseek-v2-236b
    (2 layers), mixtral-8x22b (``ZOO_LAYERS``) and llava-next-mistral-7b
    LoRA-LLM rounds.  Returns {name: result}."""
    res = {"zamba2-1.2b": zoo_train_zamba2(device, smoke, **(zamba2 or {}))}
    for name, fn, kw in (("seamless-m4t-large-v2", zoo_train_seamless, seamless),
                         ("deepseek-v2-236b", zoo_train_deepseek, deepseek)):
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        res[name] = fn(device, smoke, **(kw or {}))
    for arch in ("mixtral-8x22b", "llava-next-mistral-7b"):
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        res[arch] = zoo_train_lora(arch, device, smoke,
                                   **({"rounds": lora_rounds} if lora_rounds
                                      else {}))
    return res


TRAIN_AGREE_ARCHS = ("qwen3-1.7b", "gemma-7b", "starcoder2-7b", "xlstm-125m",
                     "zamba2-1.2b", "mixtral-8x22b", "deepseek-v2-236b",
                     "seamless-m4t-large-v2", "llava-next-mistral-7b")
# AdamW's first update of an element is lr g / (|g| + eps), eps = 1e-8, whose
# slope in g is lr eps / (|g| + eps)^2: up to lr / eps where g is near 0.
# xlstm-125m-smoke has gradient elements of about 1e-9 at init (fp32 noise
# of about 5e-10 on terms that cancel), which that slope turns into moves
# of up to 0.05 lr.  An element whose gradient is nonzero and under
# ``ADAMW_NEAR_EPS`` at some step, on either device, has no determined step
# and is left out of every arch's params check (past it the slope is under
# 1/121 of lr / eps; a gradient of exactly 0, an embedding row no token of
# the batch reads, steps alike on both); the rest hold within 1e-4.  At
# most ``ADAMW_NEAR_EPS_SHARE`` of the elements may be left out.  CPU
# against CPU (``adamw_cpu_spread``: 1 thread against 8), held | all
# elements: xlstm (seeds 0-4) 1.6e-6-1.3e-5 | 1.5e-5-5.5e-5 with 0.28-0.29 %
# left out; starcoder2-7b (seeds 0-2; an embedding element of g = 4.6e-8 at
# one step) 3.2e-7-1.9e-6 | 7.2e-7-4.7e-5, 0.05-0.06 %; qwen3 and gemma-7b
# 1.2e-7-4.2e-7 | 1.2e-7-4.2e-7, 0.05-0.06 %.
ADAMW_NEAR_EPS = 10 * 1e-8
ADAMW_NEAR_EPS_SHARE = 0.01


def adamw_steps(cfg, p0, data, dev, near_eps, trace=None):
    """``launch.train``'s step (lr 1e-3) over ``data`` ((tokens, labels,
    extra) of numpy arrays) on ``dev`` from a copy of ``p0``, marking in
    ``near_eps`` (bool, one per leaf) the elements whose gradient, taken
    again at each step's params, is nonzero and under ``ADAMW_NEAR_EPS``.
    A ``trace`` list gets, after each step, the params and this run's own
    marks so far, on the CPU.  Returns (params, losses, the steps'
    launches)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    params = tree_map(lambda t: t.to(dev), p0)
    opt = adamw_init(params)
    step = train.make_train_step(cfg)
    losses, counted = [], collections.Counter()
    own = [torch.zeros_like(m) for m in near_eps]
    for toks, labels, extra in data:
        toks = torch.from_numpy(toks).to(dev)
        labels = torch.from_numpy(labels).to(dev)
        extra = {k: torch.from_numpy(v).to(dev) for k, v in extra.items()}
        grads = train.value_and_grad(cfg, params, toks, labels,
                                     loss_chunk=train.LOSS_CHUNK,
                                     extra=extra)[1]
        for m, o, g in zip(near_eps, own, tree_leaves(grads)):
            o |= ((g != 0) & (g.abs() < ADAMW_NEAR_EPS)).cpu()
            m |= o
        del grads
        ops.reset_launches()
        params, opt, loss = step(params, opt, toks, labels, 1e-3, extra)
        counted.update(ops.launches)
        losses.append(float(loss))
        if trace is not None:
            trace.append(([t.cpu().clone() for t in tree_leaves(params)],
                          [o.clone() for o in own]))
    return params, losses, counted


def free_run_curve(ta, tb):
    """Per step of two ``adamw_steps`` traces, ``params_diff``'s (held,
    all) under the union of both runs' marks so far."""
    return [params_diff(dict(enumerate(a)), dict(enumerate(b)),
                        [x | y for x, y in zip(ma, mb)])[:2]
            for (a, ma), (b, mb) in zip(ta, tb)]


ULP_SEEDS = range(4)


def ulp_spread(cfg, p0, data, base):
    """The CPU against itself: ``free_run_curve`` of ``base`` (the CPU's
    trace from ``p0``) against a run from ``p0`` with every element moved
    by one ulp, up or down by a coin of each of ``ULP_SEEDS``."""
    from repro_torch.tree import tree_map
    curves = []
    for seed in ULP_SEEDS:
        g = torch.Generator().manual_seed(seed)
        p = tree_map(lambda t: t * (1 + 2.0 ** -23 * (
            2 * torch.randint(0, 2, t.shape, generator=g) - 1)), p0)
        trace = []
        adamw_steps(cfg, p, data, "cpu", [torch.zeros_like(m) for m in
                                          base[0][1]], trace)
        curves.append(free_run_curve(base, trace))
    return curves


def params_diff(a, b, near_eps):
    """(max |a - b| over the elements not in ``near_eps``, over all, the
    share of elements in ``near_eps``)."""
    from repro_torch.tree import tree_leaves
    pairs = list(zip(tree_leaves(a), tree_leaves(b), near_eps))
    return (max(float(((x.cpu() - y.cpu()).abs() * ~m).max()) for x, y, m in pairs),
            max(float((x.cpu() - y.cpu()).abs().max()) for x, y, _ in pairs),
            sum(int(m.sum()) for m in near_eps) / sum(m.numel() for m in near_eps))


def agreement_problem(arch, seed, steps):
    """``arch``'s smoke config in fp32, its params from ``seed`` on the CPU,
    ``steps`` bigram batches of B=4 x S=64 (with N(0, 1) image embeddings,
    labels -1 over them, for a VLM, and 32 encoder frames for an
    encoder-decoder), and an all-False mask a leaf."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p0 = T.init_params(cfg, seed, device="cpu")
    data = []
    for s in range(steps):
        toks, labels = next(token_batches(cfg, 4, 64, seed=s, n_tokens=20_000))
        rng, extra = np.random.default_rng(100 + s), {}
        if cfg.vision_frontend:
            n_img = cfg.num_image_tokens
            extra["image_embeds"] = rng.normal(
                size=(4, n_img, cfg.d_model)).astype(np.float32)
            labels = np.concatenate([np.full((4, n_img), -1, labels.dtype),
                                     labels], 1)
        if cfg.encoder_decoder:
            extra["encoder_embeds"] = rng.normal(
                size=(4, 32, cfg.d_model)).astype(np.float32)
        data.append((toks, labels, extra))
    return cfg, p0, data, [torch.zeros_like(t, dtype=torch.bool)
                           for t in tree_leaves(p0)]


@contextlib.contextmanager
def route_recorder():
    """The router's input and weight at every ``moe._route`` call, in call
    order, as fp32 CPU tensors."""
    from repro_torch.models import moe
    recs, route = [], moe._route

    def wrap(p, cfg, x2d):
        recs.append((x2d.detach().float().cpu(),
                     p["router"]["w"].detach().float().cpu()))
        return route(p, cfg, x2d)

    moe._route = wrap
    try:
        yield recs
    finally:
        moe._route = route


def route_margin_ratio(recs_a, recs_b, k):
    """The smallest ratio, over the calls and their tokens, of the token's
    top-k margin (the k-th largest router probability over the (k+1)-th,
    in ``recs_b``'s probabilities) to twice the largest difference between
    the two runs' probabilities of that token (each from its own input and
    weight, in fp64), and whether every call picks the same expert sets.
    Above 1, no expert choice can differ by the rounding between the runs
    (``tests/test_torch_zoo_configs.py::route_margins``)."""
    assert len(recs_a) == len(recs_b) > 0
    ratio, same = float("inf"), True
    for (xa, wa), (xb, wb) in zip(recs_a, recs_b):
        pa = torch.softmax(xa.double() @ wa.double(), -1)
        pb = torch.softmax(xb.double() @ wb.double(), -1)
        top = torch.sort(pb, -1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        delta = (pa - pb).abs().max(-1).values
        ratio = min(ratio, float((gap / (2 * delta).clamp_min(1e-30)).min()))
        sets = [torch.sort(torch.sort(p, dim=-1, descending=True, stable=True)
                           .indices[:, :k], -1).values for p in (pa, pb)]
        same &= torch.equal(*sets)
    return ratio, same


def adamw_cpu_spread(arch, seeds=range(3), steps=5, threads=8):
    """The readings beside ``ADAMW_NEAR_EPS``: ``train_agreement``'s AdamW
    steps on the CPU at 1 thread and at ``threads`` (another summation
    order), from each seed's params; prints the params diff held (under
    the eps rule), over all elements and the share left out.  Runs without
    a card: ``python -c "import chip_smoke as c;
    c.adamw_cpu_spread('xlstm-125m', range(5))"`` with ``src`` on the path."""
    before = torch.get_num_threads()
    try:
        for seed in seeds:
            cfg, p0, data, near_eps = agreement_problem(arch, seed, steps)
            out = []
            for n in (1, threads):
                torch.set_num_threads(n)
                out.append(adamw_steps(cfg, p0, data, "cpu", near_eps)[0])
            held, every, share = params_diff(*out, near_eps)
            print(f"[adamw spread] {arch}-smoke seed {seed}: 1 thread vs "
                  f"{threads}, {steps} steps: held={held:.3e} all={every:.3e} "
                  f"left out={share:.4%}", flush=True)
    finally:
        torch.set_num_threads(before)


# zamba2-1.2b-smoke's free-running AdamW trajectory is chaotic at the 1e-4
# level.  An element whose gradient lies under ADAMW_NEAR_EPS takes an
# update of up to the learning rate that follows rounding noise; the next
# step's gradients then move with it, so the held distance of any two runs
# that round differently jumps from ~1e-6 after one step to ~5e-4 after two
# (``free_run_curve``).  The CPU against itself from a start moved by one
# ulp (``ulp_spread``) reads 1.5e-3 to 2.4e-3 after 5 steps (seeds 0-3), the
# card against the CPU 8.6e-4, while one step from the same state agrees
# to ~5e-6.  Its agreement is therefore held step by step: each step taken
# on the card from the CPU run's params and AdamW state before it
# (``adamw_forced_steps``); the free-running distance must stay inside the
# CPU's own one-ulp spread.
TRAIN_AGREE_FORCED = ("zamba2-1.2b",)


def adamw_forced_steps(cfg, p0, data, dev):
    """The CPU's ``adamw_steps`` run, and at each step the same step taken
    on ``dev`` from the CPU's params and AdamW state before it, the two
    results compared under the near-eps rule of that step's gradients
    (either device's).  Returns (the largest held diff, over all elements,
    the largest share left out, {"cpu", dev: losses}, ``dev``'s launches)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    params = tree_map(lambda t: t.clone(), p0)
    opt = adamw_init(params)
    step = train.make_train_step(cfg)
    held, every, share = 0.0, 0.0, 0.0
    losses, counted = {"cpu": [], dev: []}, collections.Counter()
    for toks, labels, extra in data:
        near = [torch.zeros_like(t, dtype=torch.bool) for t in tree_leaves(p0)]
        moved = {}
        for d in ("cpu", dev):
            to = lambda t: t.to(d)
            args = (tree_map(to, params), tree_map(to, opt),
                    torch.from_numpy(toks).to(d), torch.from_numpy(labels).to(d))
            ex = {k: torch.from_numpy(v).to(d) for k, v in extra.items()}
            grads = train.value_and_grad(cfg, args[0], args[2], args[3],
                                         loss_chunk=train.LOSS_CHUNK,
                                         extra=ex)[1]
            for m, g in zip(near, tree_leaves(grads)):
                m |= ((g != 0) & (g.abs() < ADAMW_NEAR_EPS)).cpu()
            del grads
            ops.reset_launches()
            moved[d] = step(*args, 1e-3, ex)
            if d == dev:
                counted.update(ops.launches)
            losses[d].append(float(moved[d][2]))
        h, e, sh = params_diff(moved[dev][0], moved["cpu"][0], near)
        held, every, share = max(held, h), max(every, e), max(share, sh)
        params, opt = moved["cpu"][0], moved["cpu"][1]
    return held, every, share, losses, counted


def train_agreement(arch="qwen3-1.7b", steps=5, rounds=2,
                    devices=("cuda", "cpu")):
    """``arch``'s smoke config in fp32, the same params and batches on the
    card and on the CPU: ``steps`` AdamW steps of ``launch.train``'s step
    and ``rounds`` LoRA-LLM rounds (none for deepseek's MLA, which has no
    wq/w or wv/w to adapt, or seamless, whose encoder frames the rounds'
    streams lack), every leaf within 1e-4: the adapters all, the params
    where no step's gradient was nonzero and under ``ADAMW_NEAR_EPS``
    (``adamw_steps``).  The flash kernels forward and backward
    (gemma-7b-smoke's hd 48 and starcoder2-7b-smoke's windowed hd 24 on the
    padded instantiations; seamless's encoder at causal=0; xlstm-125m-smoke
    and deepseek's MLA have none), zamba2's scan forward and backward, and
    cuBLAS (TF32 off) against the plain versions; an MoE config's every
    routing decision holds its margin (``route_margin_ratio``).  An arch of
    ``TRAIN_AGREE_FORCED`` holds its params step by step
    (``adamw_forced_steps``); its free-running distance ("free_running",
    per step "free_curve") must lie within the CPU's own distance from a
    start moved by one ulp after as many steps (per step "ulp_curves",
    ``ulp_spread``).  ``devices=("cpu", "cpu")`` rehearses it without a
    card.  Returns {"params_diff" (held), "params_diff_all",
    "near_eps_share", "adapters_diff", "route_margin", "free_running",
    "loss", "launches"} after asserting them."""
    from repro_torch.configs.base import MAMBA2
    from repro_torch.fl.lora import lora_init
    from repro_torch.kernels import ops
    from repro_torch.launch import fft_lora_llm
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p_cpu, data, near_eps = agreement_problem(arch, 0, steps)
    lora = not (cfg.mla or cfg.encoder_decoder)
    rounds = rounds if lora else 0
    ad_cpu = lora_init(torch.Generator().manual_seed(1), p_cpu,
                       fft_lora_llm.LORA) if lora else None
    res, launches, losses, routes = {}, {}, {}, {}
    traces = {dev: [] if arch in TRAIN_AGREE_FORCED else None
              for dev in devices}
    models = 0
    for dev in dict.fromkeys(devices):
        with route_recorder() as routes[dev]:
            params, losses[dev], counted = adamw_steps(
                cfg, p_cpu, data, dev, near_eps, traces[dev])
        launches[dev] = dict(counted)
        adapters = None
        if lora:
            ops.reset_launches()
            out = fft_lora_llm.run(cfg, rounds=rounds, local_steps=2,
                                   device=dev, base=tree_map(
                                       lambda t: t.to(dev), p_cpu),
                                   adapters=tree_map(lambda t: t.to(dev), ad_cpu))
            launches[dev]["lora"] = dict(ops.launches)
            adapters = out["adapters"]
            models = sum(1 + int(u.sum()) for u in out["connected"])
        res[dev] = (params, adapters)
    a, b = devices
    held, every, share = params_diff(res[a][0], res[b][0], near_eps)
    r = {"params_diff": held, "params_diff_all": every, "near_eps_share": share,
         "adapters_diff": max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
                              zip(tree_leaves(res[a][1]),
                                  tree_leaves(res[b][1]))) if lora else 0.0,
         "route_margin": None, "free_running": None, "loss": losses,
         "launches": launches}
    if arch in TRAIN_AGREE_FORCED:
        r["free_running"] = (held, every, share)
        r["free_curve"] = free_run_curve(traces[a], traces[b])
        r["ulp_curves"] = ulp_spread(cfg, p_cpu, data, traces["cpu"])
        spread = max(c[-1][0] for c in r["ulp_curves"])
        assert held <= spread, (held, r["ulp_curves"])
        held, every, share, forced_losses, forced = adamw_forced_steps(
            cfg, p_cpu, data, a)
        r.update(params_diff=held, params_diff_all=every, near_eps_share=share,
                 forced_loss=forced_losses)
        assert dict(forced) == {k: v for k, v in launches[a].items()
                                if k != "lora"}, (forced, launches)
    # a flash backward per attention layer (and encoder layer) and train
    # step, a scan backward per Mamba2 block and step; in the LoRA rounds one
    # per attention layer and local step of every model (the server's and
    # each connected client's, 2 local steps)
    n_attn = zoo_launches(cfg)[0]
    n_scan = cfg.layer_kinds().count(MAMBA2)
    on = int(torch.device(a).type == "cuda")
    got = launches[a]
    assert launches[b].get("flash_attention_bwd", 0) == 0, launches
    assert got.get("flash_attention_bwd", 0) == on * n_attn * steps, launches
    assert got.get("selective_scan_bwd", 0) == on * n_scan * steps, launches
    assert got.get("selective_scan", 0) == on * 2 * n_scan * steps, launches
    if lora:
        assert got["lora"]["fedagg"] == on * 4 * rounds, launches
        assert got["lora"]["flash_attention_bwd"] == \
            on * n_attn * 2 * models, launches
        assert r["adapters_diff"] <= 1e-4, r
    if cfg.moe:
        r["route_margin"], same = route_margin_ratio(
            routes[a], routes[b], cfg.num_experts_per_tok)
        assert same and r["route_margin"] > 1.0, r
    assert r["params_diff"] <= 1e-4, r
    assert r["near_eps_share"] <= ADAMW_NEAR_EPS_SHARE, r
    return r


def phase_train_agreement():
    for arch in TRAIN_AGREE_ARCHS:
        r = train_agreement(arch)
        lora = (f"2 LoRA-LLM rounds: max |adapter diff|={r['adapters_diff']:.3e}"
                if "lora" in r["launches"]["cuda"] else "no LoRA-LLM rounds")
        margin = ("" if r["route_margin"] is None else
                  f"; routing margin ratio (>1 holds)={r['route_margin']:.3f}")
        if r["free_running"] is not None:
            curve = lambda c: "[" + ", ".join(f"{h:.2e}/{e:.2e}"
                                              for h, e in c) + "]"
            margin += (f"; held step by step (each step from the CPU's state);"
                       f" free-running 5 steps: {r['free_running'][0]:.3e} "
                       f"held, {r['free_running'][1]:.3e} all; per step "
                       f"held/all cuda vs cpu {curve(r['free_curve'])}, cpu "
                       f"vs cpu from a start moved by 1 ulp (seeds "
                       f"{list(ULP_SEEDS)}) " + " ".join(
                           curve(c) for c in r["ulp_curves"]))
        print(f"[train agreement] {arch}-smoke fp32, 5 AdamW steps: max |param "
              f"diff| cuda vs cpu={r['params_diff']:.3e} held, over the "
              f"{1 - r['near_eps_share']:.4%} of elements whose |g| was never "
              f"in (0, {ADAMW_NEAR_EPS:.0e}) (all elements: "
              f"{r['params_diff_all']:.3e}); "
              f"losses cuda={[round(x, 6) for x in r['loss']['cuda']]} cpu="
              f"{[round(x, 6) for x in r['loss']['cpu']]}; {lora}{margin}; "
              f"cuda launches={r['launches']['cuda']}")


# ---------------------------------------------------------------------------
# [dist]: the mesh paths on the card (models/dist.py, launch/mesh.py)
# ---------------------------------------------------------------------------
DIST_MOE_SHAPE = (4, 512)           # x: B x S at mixtral-8x22b's d_model
DIST_MOE_TOL = 2e-4                 # out: the JAX test's rtol = atol
DIST_AUX_RTOL = 5e-2                # aux: a per-shard-mean estimator
DIST_DECODE = dict(arch="starcoder2-7b", layers=2, B=4, cache_len=4096,
                   length=6000, steps=16, model=8)
DIST_DECODE_TOL = 2e-3              # logits, as the JAX test's decode check
PARTIAL_SOURCE = ATTN_SOURCE
# (B, S_loc, H, KV, hd, n_valid): [dist]'s decode slice (starcoder2-7b, 4,096
# slots over 8 ranks) and qwen3-1.7b's 32,768 slots split 16 ways
PARTIAL_CHECKS = [(4, 512, 36, 4, 128, 512), (4, 2048, 16, 8, 128, 2048),
                  (4, 2048, 16, 8, 128, 1000), (4, 512, 36, 4, 128, 0)]
PARTIAL_TOL = 1e-5                  # m and l, relative to 1 + |want|


def moe_layer_config(E, smoke=False):
    """One MoE layer of mixtral-8x22b (d 6144, d_ff 16384, top-2) in fp32
    with ``E`` experts (E = 2 takes the virtual-expert body on 4 ranks, as
    the JAX package's own test replaces E); ``smoke``: the smoke config."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if smoke else get_config)("mixtral-8x22b")
    return dataclasses.replace(cfg, num_experts=E, num_experts_per_tok=2,
                               dtype="float32")


def moe_layer_params(cfg, device, experts=None, seed=0):
    """The layer's router and expert stacks, each expert drawn from its own
    generator (so a rank draws only its experts and every rank draws the
    same ones): ``experts`` the ids to draw (all by default), stacked in
    that order."""
    d, f = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    ids = range(E) if experts is None else experts

    def draw(e, j, shape, fan_in):
        g = torch.Generator(device=device).manual_seed(seed * 1000 + 10 * e + j)
        return torch.randn(shape, generator=g, device=device) / fan_in ** 0.5

    g = torch.Generator(device=device).manual_seed(seed * 1000 + 999)
    return {"router": {"w": torch.randn((d, E), generator=g, device=device)
                       / d ** 0.5},
            "w_gate": torch.stack([draw(e, 0, (d, f), d) for e in ids]),
            "w_up": torch.stack([draw(e, 1, (d, f), d) for e in ids]),
            "w_down": torch.stack([draw(e, 2, (f, d), f) for e in ids])}


def dist_moe_rank(rank, world, spec):
    """One rank of ``[dist]``'s MoE checks (also run by the tests on gloo
    CPU ranks): on a ``spec["mesh"]`` ("data", "model") mesh, for each
    expert count E of ``spec["experts"]``, ``moe_forward`` under the mesh
    context on this rank's batch shard and its own experts (drawn by
    ``moe_layer_params``, or sliced by ``launch/sharding.shard_params``
    from the whole arrays ``spec["params"][E]``); rank 0 also runs the
    local path on the whole batch without the context.  Returns per E the
    output, aux, dropped pairs, read-backs, collectives and walls."""
    import dataclasses
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import mesh as lm, sharding
    from repro_torch.models import dist, moe
    device = spec["device"]
    mesh = lm.make_device_mesh(spec["mesh"], ("data", "model"), device)
    ctx = dist.MeshContext(mesh, lm.batch_axes(mesh), lm.model_axis(mesh))
    m, b = (mesh.get_local_rank(mesh_dim=a) for a in ("model", "data"))
    out = {}
    for E in spec["experts"]:
        cfg = moe_layer_config(E, spec.get("smoke", False))
        if spec.get("overrides"):
            cfg = dataclasses.replace(cfg, **spec["overrides"])
        given = spec.get("params", {}).get(E)
        if given is not None:
            whole = params_from_jax(given["p"], device=device)
            x = torch.from_numpy(given["x"]).to(device)
        else:
            gen = torch.Generator(device=device).manual_seed(7)
            x = torch.randn((*spec["x_shape"], cfg.d_model), generator=gen,
                            device=device)
            whole = None
        ms = spec["mesh"][1]
        if whole is not None:
            tree = {"moe": whole}            # the layer's path in a model
            mine = sharding.shard_params(
                tree, sharding.execution_pspecs(tree, cfg, mesh), mesh)["moe"]
        elif E % ms == 0:
            per = E // ms
            mine = moe_layer_params(cfg, device, range(m * per, (m + 1) * per))
        else:
            within = ms // E
            mine = moe_layer_params(cfg, device, [m // within])
            mine.update({n: moe.virtual_expert_slice(
                mine[n], n, within, m % within) for n in
                ("w_gate", "w_up", "w_down")})
        B_loc = dist.local_batch(ctx, x.shape[0])
        x_loc = x[b * B_loc:(b + 1) * B_loc] if B_loc < x.shape[0] else x
        moe.reset_readbacks()
        dist.reset_collectives()
        with torch.no_grad(), dist.mesh_context(ctx):
            sync(device)
            t0 = time.perf_counter()
            got, aux = moe.moe_forward(mine, cfg, x_loc)
            sync(device)
            wall = time.perf_counter() - t0
        rec = {"out": got.cpu(), "aux": float(aux), "wall_s": wall,
               "dropped": moe.dropped["moe_pairs"],
               "readbacks": moe.readbacks["moe_group_sizes"],
               "collectives": {k: dict(v) for k, v in
                               dist.collectives.items()},
               "batch_rows": (b * B_loc, b * B_loc + x_loc.shape[0]),
               "backend": torch.distributed.get_backend()}
        del mine
        if rank == 0 and spec.get("local", True):
            full = whole if whole is not None else moe_layer_params(cfg, device)
            with torch.no_grad(), dist.mesh_context(None):
                sync(device)
                t0 = time.perf_counter()
                want, want_aux = moe.moe_forward(full, cfg, x)
                sync(device)
                rec["local_wall_s"] = time.perf_counter() - t0
            rec["local_out"], rec["local_aux"] = want.cpu(), float(want_aux)
            del full
        out[E] = rec
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def check_moe_ranks(res, label, tol=DIST_MOE_TOL, aux_rtol=DIST_AUX_RTOL):
    """Rank 0's local path against every rank's sharded rows: within ``tol``
    (|d| <= tol + tol |want|), aux within ``aux_rtol``, no pair dropped.
    Returns {E: max_abs_err}; prints a line per E."""
    errs = {}
    for E in res[0]:
        want, want_aux = res[0][E]["local_out"], res[0][E]["local_aux"]
        err, bitwise = 0.0, True
        for r in res:
            rec = r[E]
            lo, hi = rec["batch_rows"]
            d = (rec["out"] - want[lo:hi]).abs()
            err = max(err, float(d.max()))
            bitwise &= torch.equal(rec["out"], want[lo:hi])
            assert bool((d <= tol + tol * want[lo:hi].abs()).all()), \
                f"{label} E={E}: out off the local path by {float(d.max())}"
            assert abs(rec["aux"] - want_aux) <= aux_rtol * abs(want_aux), \
                f"{label} E={E}: aux {rec['aux']} against {want_aux}"
            assert rec["dropped"] == 0, f"{label} E={E}: {rec['dropped']} dropped"
            assert rec["readbacks"] == 1, rec["readbacks"]
        from repro_torch.launch import roofline
        r0 = res[0][E]
        print(f"[dist] {label} E={E} ({len(res)} ranks, {r0['backend']}): "
              f"max_abs_err={err:.3e} bitwise={bitwise} aux={r0['aux']:.6f} "
              f"(local {want_aux:.6f}) dropped=0 sharded_wall_s="
              f"{max(r[E]['wall_s'] for r in res):.4f} local_wall_s="
              f"{r0['local_wall_s']:.4f} collectives="
              f"{roofline.collective_bytes(r0['collectives'])}")
        errs[E] = err
    return errs


def dist_decode_config(spec):
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if spec.get("smoke") else get_config)(spec["arch"])
    over = dict(dtype="float32", num_layers=spec["layers"])
    over.update(spec.get("overrides", {}))
    return dataclasses.replace(cfg, **over)


def dist_decode_rank(rank, world, spec):
    """One rank of the sequence-sharded decode (``[dist]`` and the tests):
    params from ``spec["seed"]`` (every rank the same) or carried across
    from ``spec["params"]``, tokens seeded or ``spec["tokens"]`` (steps, B,
    1), a ("data", "model")
    mesh of ``spec["mesh"]``, a ring of ``cache_len`` slots, either empty
    (``length`` 0) or filled on every layer from a seeded generator and
    advanced to ``length`` as ``[serve-long]`` fills its cache; then
    ``steps`` ``decode_step``s of seeded tokens under the mesh context, each
    rank holding its slice of the ring.  Rank 0 also decodes the same
    tokens from the whole ring without the context.  Returns the logits of
    every step (both runs on rank 0), the launches and the collectives."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lm
    from repro_torch.models import dist
    from repro_torch.models import transformer as T
    device = spec["device"]
    cfg = dist_decode_config(spec)
    B, S, length, steps = spec["B"], spec["cache_len"], spec["length"], \
        spec["steps"]
    mesh = lm.make_device_mesh(spec["mesh"], ("data", "model"), device)
    ctx = dist.MeshContext(mesh, lm.batch_axes(mesh), lm.model_axis(mesh))
    if spec.get("params") is not None:        # a JAX tree, as numpy
        from repro_torch.convert import params_from_jax
        params = params_from_jax(spec["params"], device=device)
    else:
        params = T.init_params(cfg, spec["seed"], device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"] + 1)
    toks = torch.randint(0, cfg.vocab_size, (steps, B, 1), device=device,
                         generator=gen)
    if spec.get("tokens") is not None:
        toks = torch.from_numpy(spec["tokens"]).to(device)
    ring = T.init_decode_state(params, cfg, B, S)["layers"]
    if length:
        for i in range(cfg.num_layers):
            ring.k[i].normal_(generator=gen)
            ring.v[i].normal_(generator=gen)
    ring = ring._replace(length=length)

    def decode(state):
        logits = []
        with torch.no_grad():
            for t in range(steps):
                lg, state = T.decode_step(params, cfg, state, toks[t])
                logits.append(lg)
        sync(device)
        return torch.stack(logits).cpu(), state

    with dist.mesh_context(ctx):
        local = T.init_decode_state(params, cfg, B, S)["layers"]
        assert local.shard is not None, "the seq-sharded path is not taken"
        lo = local.shard.start
        n = local.k.shape[2]
        local.k.copy_(ring.k[:, :, lo:lo + n])
        local.v.copy_(ring.v[:, :, lo:lo + n])
        state = {"layers": local._replace(length=length)}
        ops.reset_launches()
        dist.reset_collectives()
        sync(device)
        t0 = time.perf_counter()
        got, state = decode(state)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    out = {"logits": got, "launches": launches, "wall_s": wall,
           "collectives": {k: dict(v) for k, v in dist.collectives.items()},
           "shard": tuple(local.shard), "slots": n,
           "backend": torch.distributed.get_backend(),
           "length": state["layers"].length}
    with dist.mesh_context(ctx):
        out["psum_bf16"] = psum_bf16_check(rank, world, device)
    if rank == 0:
        whole = {"layers": ring._replace(k=ring.k.clone(), v=ring.v.clone())}
        ops.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        out["replicated_logits"], _ = decode(whole)
        out["replicated_wall_s"] = time.perf_counter() - t0
        out["replicated_launches"] = dict(ops.launches)
    return out


def psum_bf16_check(rank, world, device):
    """``dist.psum`` of a bf16 tensor over the model axis, reduced in its own
    dtype as JAX's bodies reduce: rank r holds (r + 1) * [1, 2^-1, ..., 2^-7],
    whose sums over the ranks bf16 holds exactly."""
    from repro_torch.models import dist
    base = torch.exp2(-torch.arange(8.0, device=device))
    x = ((rank + 1) * base).to(torch.bfloat16)
    y = dist.psum(x, dist.get_mesh_context().model_axis)
    want = (world * (world + 1) // 2 * base).to(torch.bfloat16)
    return {"dtype": str(y.dtype), "exact": bool(torch.equal(y, want))}


def check_decode_ranks(res, spec, tol=DIST_DECODE_TOL):
    """Every rank's sharded logits against rank 0's replicated run, within
    ``tol`` (|d| <= tol + tol |want|) at every step; on the card exactly
    steps x layers ``decode_attention_partial`` launches on every rank."""
    want = res[0]["replicated_logits"]
    cuda = torch.device(spec["device"]).type == "cuda"
    err = 0.0
    for r in res:
        d = (r["logits"] - want).abs()
        err = max(err, float(d.max()))
        assert bool((d <= tol + tol * want.abs()).all()), \
            f"seq-sharded decode off the replicated one by {float(d.max())}"
        n = spec["steps"] * spec["layers"] if cuda else 0
        assert r["launches"]["decode_attention_partial"] == n, r["launches"]
        assert r["launches"]["decode_attention"] == 0, r["launches"]
        assert r["length"] == spec["length"] + spec["steps"]
        assert r["psum_bf16"] == {"dtype": "torch.bfloat16", "exact": True}, \
            r["psum_bf16"]
    return err


def partial_bound(B, S, H, KV, hd, n_valid, dtype):
    """The K/V rows of the valid slots, q, the mask and the fp32 (m, l, o)
    out, each read or written once; 4 flops a (head, dim, valid key)."""
    isz = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * n_valid * KV * hd + B * H * hd) * isz + S + \
        4 * B * H * (hd + 2)
    flops = 4.0 * B * H * hd * n_valid
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def partial_inputs(B, S, H, KV, hd, n_valid, dt, seed):
    q, k, v = attn_inputs(B, 1, S, H, KV, hd, dt, seed)
    # the valid slots of a wrapped ring's slice: a run that starts mid-slice
    valid = torch.zeros(S, dtype=torch.bool, device="cuda")
    start = (S - n_valid) // 3
    valid[start:start + n_valid] = True
    return q, k, v, valid


def partial_check(B, S, H, KV, hd, n_valid, dt):
    """The kernel's (m, l, o) against the plain version's: m and l within
    ``PARTIAL_TOL`` (1 + |want|), o / l under ``attention_error``'s fp32
    tolerance (the empty slice: m = -1e30, l = o = 0 exactly)."""
    from repro_torch.kernels import ops, ref
    q, k, v, valid = partial_inputs(B, S, H, KV, hd, n_valid, dt, seed=11)
    scale = 1.0 / hd ** 0.5
    before = ops.launches["decode_attention_partial"]
    got = ops.decode_attention_partial(q, k, v, valid, scale=scale)
    assert ops.launches["decode_attention_partial"] == before + 1
    want = ref.decode_attention_partial(q, k, v, valid, scale=scale)
    torch.cuda.synchronize()
    label = (f"B={B} S_loc={S} H={H} KV={KV} hd={hd} valid={n_valid} "
             f"{str(dt)[6:]}")
    if n_valid == 0:
        ok = bool((got[0] == -1e30).all()) and not got[1].any() and \
            not got[2].any()
        print(f"[dist] decode_attention_partial {label}: empty slice "
              f"m=-1e30 l=0 o=0 {'ok' if ok else 'FAIL'}")
        assert ok, label
        return 0.0
    e_ml = max(float(((g - w).abs() / (1 + w.abs())).max())
               for g, w in zip(got[:2], want[:2]))
    e = attention_error(got[2] / got[1][..., None], want[2] / want[1][..., None])
    print(f"[dist] decode_attention_partial {label}: m,l rel_err={e_ml:.3e} "
          f"(limit {PARTIAL_TOL}) o/l max_abs_err={e['max_abs_err']:.3e} "
          f"share_of_limit={e['share_of_limit']:.3f} "
          f"{'ok' if e['ok'] and e_ml <= PARTIAL_TOL else 'FAIL'}")
    assert e["ok"] and e_ml <= PARTIAL_TOL, label
    return max(e["max_abs_err"], e_ml)


def partial_timing(B, S, H, KV, hd, n_valid, dt):
    """The kernel, its plain version and ATen's memory-efficient attention
    with its log-sum-exp (the same information: o and lse, over K/V expanded
    to every query head, a -inf bias on the masked slots) in turns; the
    bound; one line and the ``kernels`` entry."""
    from repro_torch.kernels import ops, ref
    q, k, v, valid = partial_inputs(B, S, H, KV, hd, n_valid, dt, seed=12)
    scale = 1.0 / hd ** 0.5
    g = H // KV
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    bias = torch.where(valid, 0.0, float("-inf")).to(dt).expand(
        B, H, 1, S).contiguous()

    def kernel():
        return ops.decode_attention_partial(q, k, v, valid, scale=scale)

    def plain():
        return ref.decode_attention_partial(q, k, v, valid, scale=scale)

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True, scale=scale)

    fns, why = [kernel, plain, library], None
    try:                      # a yardstick only: the port never calls it
        library()
    except RuntimeError as e:
        fns, why = fns[:2], f"{type(e).__name__}: {str(e)[:120]}"
    times = cuda_times(fns, 50)
    b_ms, b_by = partial_bound(B, S, H, KV, hd, n_valid, dt)
    lib = times[2] if len(times) > 2 else None
    k_el = device_elapsed(kernel)
    l_el = device_elapsed(library) if lib is not None else None
    print(f"[dist-time] decode_attention_partial B={B} S_loc={S} "
          f"n_valid={n_valid} H={H} KV={KV} hd={hd} {str(dt)[6:]}: "
          f"kernel_ms={times[0]:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / times[0]:.4f} plain_ms={times[1]:.4f} "
          f"library_ms(_scaled_dot_product_efficient_attention, in turns)="
          f"{'null (' + why + ')' if lib is None else format(lib, '.4f')} "
          f"elapsed_ms (device, host excluded): kernel={k_el:.4f} library="
          f"{'null' if l_el is None else format(l_el, '.4f')}")
    return dict(timing(times[0], times[1], b_ms, b_by, lib),
                elapsed_ms=float(k_el),
                library_elapsed_ms=None if l_el is None else float(l_el))


def phase_dist(device="cuda", smoke=False):
    """``[dist]``: the port's mesh paths, every rank a process.  The kernel
    library is built here, before any rank starts.
      1. ``decode_attention_partial`` against its plain version
         (``PARTIAL_CHECKS``, fp32 and bf16), then timed in turns;
      2. mixtral-8x22b's MoE layer (d 6144, d_ff 16384, top-2, fp32, x 4 x
         512) on a (1, 4) mesh of gloo ranks sharing the card: 8 experts
         (expert-parallel, 2 a rank) and 2 (virtual experts, within 2),
         each against the local path on rank 0;
      3. starcoder2-7b's attention (36 heads, 4 KV heads, hd 128, window
         4,096) at 2 layers, fp32, on a (1, 8) mesh: 16 decode steps from a
         4,096-slot ring filled and advanced to 6,000, seq-sharded (512
         slots a rank) against the replicated decode on rank 0, with 16 x 2
         ``decode_attention_partial`` launches on every rank;
      4. the MoE layer of 2 (8 experts) on a (1, 1) mesh under NCCL.
    ``device="cpu", smoke=True`` rehearses 2-4 at the smoke configs on
    gloo CPU ranks (no kernel)."""
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as lm
    cuda = torch.device(device).type == "cuda"
    out = {"errs": {}, "walls": {}}
    if cuda:
        build.load()
        t0 = time.perf_counter()
        errs = [partial_check(*c, dt) for c in PARTIAL_CHECKS
                for dt in (torch.float32, torch.bfloat16)]
        out["max_abs_err"] = max(errs)
        out["timing"] = partial_timing(*PARTIAL_CHECKS[0], torch.float32)
        out["timing_qwen3"] = partial_timing(*PARTIAL_CHECKS[1], torch.bfloat16)
        out["walls"]["kernel"] = time.perf_counter() - t0
    x_shape = (4, 16) if smoke else DIST_MOE_SHAPE
    spec = dict(device=device, mesh=(1, 4), experts=(8, 2), smoke=smoke,
                x_shape=x_shape)
    t0 = time.perf_counter()
    res = lm.run_ranks(dist_moe_rank, 4, device=device, args=(spec,),
                       timeout_s=600)
    out["errs"]["moe"] = check_moe_ranks(res, "moe (1, 4)")
    out["walls"]["moe"] = time.perf_counter() - t0
    del res
    dspec = dict(DIST_DECODE, device=device, mesh=(1, DIST_DECODE["model"]),
                 seed=0)
    if smoke:
        dspec.update(cache_len=32, length=48, steps=4, model=4, mesh=(1, 4),
                     smoke=True, overrides=dict(sliding_window=32))
    t0 = time.perf_counter()
    res = lm.run_ranks(dist_decode_rank, dspec["mesh"][1], device=device,
                       args=(dspec,), timeout_s=600)
    out["errs"]["decode"] = check_decode_ranks(res, dspec)
    from repro_torch.launch import roofline
    r0 = res[0]
    out["launches"] = sum(r["launches"]["decode_attention_partial"]
                          for r in res)
    print(f"[dist] seq-sharded decode {dspec['arch']} {dspec['layers']} "
          f"layers B={dspec['B']} ring={dspec['cache_len']} over "
          f"{len(res)} ranks ({r0['slots']} slots a rank, {r0['backend']}) "
          f"from length {dspec['length']}: {dspec['steps']} steps, logits "
          f"max_abs_err={out['errs']['decode']:.3e} (limit "
          f"{DIST_DECODE_TOL}) sharded {r0['wall_s'] / dspec['steps'] * 1e3:.3f}"
          f" ms/step replicated "
          f"{r0['replicated_wall_s'] / dspec['steps'] * 1e3:.3f} ms/step "
          f"decode_attention_partial launches a rank="
          f"{r0['launches']['decode_attention_partial']} "
          f"collectives a rank={roofline.collective_bytes(r0['collectives'])}"
          f"; a bf16 psum over the {len(res)} ranks: {r0['psum_bf16']}")
    out["walls"]["decode"] = time.perf_counter() - t0
    del res
    if cuda:
        t0 = time.perf_counter()
        res = lm.run_ranks(dist_moe_rank, 1, device=device, args=(dict(
            spec, mesh=(1, 1), experts=(8,)),), timeout_s=600)
        assert res[0][8]["backend"] == "nccl", res[0][8]["backend"]
        out["errs"]["nccl"] = check_moe_ranks(res, "moe (1, 1)")
        out["walls"]["nccl"] = time.perf_counter() - t0
    print(f"[dist] walls (s): {out['walls']}")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import ops

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("card", phase_card)
    timed("build", phase_build)
    errs, timings = timed("kernels", phase_kernels)
    topk_err, topk_times = timed("topk kernel", phase_topk)
    attn_errs, attn_timings = timed("attention", phase_attention)
    launches, runner, g0, rebuild = timed("main path", phase_main_path)
    timed("profile", phase_profile, runner, g0)
    ops.reset_launches()
    strat_launches = timed("strategies", phase_strategies, runner, g0, rebuild)
    ops.reset_launches()
    codec_launches = timed("codecs", phase_codecs, g0, rebuild)
    launches = {k: n + strat_launches[k] + codec_launches[k]
                for k, n in launches.items()}
    timed("broadcast", phase_broadcast, g0)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        trace_path = os.path.join(tmp, "async.ndjson")
        ops.reset_launches()
        async_launches, deadline, live = timed("async", phase_async, g0,
                                               rebuild, "cuda", trace_path)
        ops.reset_launches()
        adaptive_launches = timed("adaptive", phase_adaptive, g0, rebuild,
                                  deadline)
        ops.reset_launches()
        replay_launches = timed("replay", phase_replay, g0, rebuild, deadline,
                                live, trace_path)
        ops.reset_launches()
        telemetry_launches = timed("telemetry", phase_telemetry, g0, rebuild,
                                   deadline, tmp)
    timed("population", phase_population)
    launches = {k: n + async_launches[k] + adaptive_launches[k]
                + replay_launches[k] + telemetry_launches[k]
                for k, n in launches.items()}
    del g0, rebuild, live
    torch.cuda.empty_cache()
    timed("agreement", phase_agreement)
    serve_launches = timed("serve", phase_serve)
    torch.cuda.empty_cache()
    timed("serve long", phase_serve_long)
    torch.cuda.empty_cache()
    forward_launches = timed("forward", phase_forward)
    torch.cuda.empty_cache()
    dense = timed("dense", phase_dense)
    torch.cuda.empty_cache()
    timed("zoo", phase_zoo)
    torch.cuda.empty_cache()
    timed("llm agreement", phase_llm_agreement)
    bwd_errs, bwd_timing = timed("flash backward", phase_flash_bwd)
    train_launches = timed("train", phase_train)
    torch.cuda.empty_cache()
    timed("fft round", phase_fft_round)
    torch.cuda.empty_cache()
    timed("fft lora llm", phase_fft_lora_llm)
    torch.cuda.empty_cache()
    lora_dense = timed("fft lora llm dense", phase_fft_lora_llm_dense)
    torch.cuda.empty_cache()
    timed("xlstm", phase_xlstm)
    gc.collect()
    torch.cuda.empty_cache()
    scan_bwd_errs, scan_bwd_timing = timed("scan backward", phase_scan_bwd)
    zoo_train = timed("zoo train", phase_zoo_train)
    gc.collect()
    torch.cuda.empty_cache()
    timed("train agreement", phase_train_agreement)
    lora_errs, lora_timings = timed("lora kernel", phase_lora_kernel)
    runner, _ = timed("lora rounds", phase_lora_rounds)
    lora_launches, _ = timed("lora entry point", phase_lora_entry, runner)
    del runner
    torch.cuda.empty_cache()
    timed("lora agreement", phase_lora_agreement)
    scan_errs, scan_timing = timed("ssm", phase_ssm)
    ssm_launches = timed("ssm forward", phase_ssm_forward)
    torch.cuda.empty_cache()
    timed("ssm serve", phase_ssm_serve)
    torch.cuda.empty_cache()
    timed("ssm agreement", phase_ssm_agreement)
    gc.collect()
    torch.cuda.empty_cache()
    dist_out = timed("dist", phase_dist)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, dt in MAIN_DTYPE.items():
        replaces = next(c[3] for c in CASES if c[0] == name)
        t = timings[(name, dt, P_TIMED[0])]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[(name, dt)], **t})
    gemma = dense["gemma-7b"]
    for name, replaces, n, shape in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:82",
             forward_launches["flash_attention"],
             "qwen3-1.7b forward B=4 S=4096 H=16 KV=8 hd 128 causal"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:51",
             serve_launches["decode_attention"],
             "qwen3-1.7b serve B=4 S=256 (96 valid) H=16 KV=8 hd 128"),
            ("flash_attention@hd256", "src/repro/kernels/flash_attention.py:82",
             gemma["score"]["launches"]["flash_attention"],
             "gemma-7b forward B=4 S=4096 H=KV=16 hd 256 causal"),
            ("decode_attention@hd256", "src/repro/kernels/decode_attention.py:51",
             gemma["serve_launches"]["decode_attention"],
             "gemma-7b serve B=4 S=256 (96 valid) H=KV=16 hd 256")):
        kernels.append({"name": name, "route": "cuda", "source": ATTN_SOURCE,
                        "replaces": replaces, "launches": n, "shape": shape,
                        "max_abs_err": attn_errs[name][torch.bfloat16],
                        **attn_timings[name]})
    kernels.append({"name": "flash_attention_bwd", "route": "cuda",
                    "source": FLASH_BWD_SOURCE,
                    "replaces": "the gradient of "
                                "src/repro/kernels/flash_attention.py:82",
                    "launches": train_launches["flash_attention_bwd"],
                    "shape": "qwen3-1.7b train B=8 S=256 H=16 KV=8 hd 128 "
                             "causal",
                    "max_abs_err": bwd_errs["hd<=128"][torch.bfloat16],
                    **bwd_timing["hd<=128"]})
    kernels.append({"name": "flash_attention_bwd@hd256", "route": "cuda",
                    "source": FLASH_BWD_SOURCE,
                    "replaces": "the gradient of "
                                "src/repro/kernels/flash_attention.py:82",
                    "launches": lora_dense["gemma-7b"]["flash_attention_bwd"],
                    "shape": "B=4 S=4096 H=KV=16 hd 256 causal (gemma-7b's "
                             "heads); launches: gemma-7b [fft-lora-llm-dense]",
                    "max_abs_err": bwd_errs["hd256"][torch.bfloat16],
                    **bwd_timing["hd256"]})
    kernels.append({"name": "lora_matmul", "route": "cuda",
                    "source": LORA_SOURCE,
                    "replaces": "src/repro/kernels/lora_matmul.py:43",
                    "launches": lora_launches,
                    "max_abs_err": lora_errs[LORA_JSON_CASE]["max_abs_err"],
                    **lora_timings[LORA_JSON_CASE]})
    kernels.append({"name": "selective_scan", "route": "cuda",
                    "source": SCAN_SOURCE,
                    "replaces": "src/repro/kernels/selective_scan.py:51",
                    "launches": ssm_launches["selective_scan"],
                    "max_abs_err": scan_errs[SCAN_LAYER]["max_abs_err"],
                    **scan_timing})
    kernels.append({"name": "selective_scan_bwd", "route": "cuda",
                    "source": SCAN_BWD_SOURCE,
                    "replaces": "the gradient of "
                                "src/repro/kernels/selective_scan.py:51",
                    "launches": zoo_train["zamba2-1.2b"]["launches"][
                        "selective_scan_bwd"],
                    "shape": "zamba2-1.2b train B=8 S=256 H=32 dh=128 n=64; "
                             "launches: [zoo-train]'s 4 train.train steps",
                    "max_abs_err": scan_bwd_errs[SCAN_BWD_TRAIN]["max_abs_err"],
                    **scan_bwd_timing["train"]})
    kernels.append({"name": "topk_fedagg", "route": "cuda",
                    "source": TOPK_SOURCE,
                    "replaces": "src/repro/kernels/ref.py:55",
                    "launches": launches["topk_fedagg"],
                    "max_abs_err": topk_err, **topk_times})
    kernels.append({"name": "decode_attention_partial", "route": "cuda",
                    "source": PARTIAL_SOURCE,
                    "replaces": "src/repro/models/attention.py:219-229 (the "
                                "seq-sharded decode's local einsums; no "
                                "Pallas kernel)",
                    "launches": dist_out["launches"],
                    "shape": "starcoder2-7b's slice B=4 S_loc=512 H=36 KV=4 "
                             "hd 128 fp32; launches: [dist]'s 16 steps x 2 "
                             "layers on each of 8 ranks",
                    "max_abs_err": dist_out["max_abs_err"],
                    **dist_out["timing"]})
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
