"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit, TF32 switched off for matmul and cuDNN;
2. build: nvcc for sm_90a, one compile per source started together, with
   the ptxas register/shared-memory/spill lines, then the same sources in
   one nvcc call for comparison;
3. kernels: every aggregation kernel against its plain PyTorch version on
   the card, over M in {1, 3, 22, 64} and P in {1, 100, 4097, 2359296,
   11223140}, then timed at M=22 against its plain version, its bytes bound
   and (where one PyTorch call computes the same function) that call;
4. attention kernels: flash_attention and decode_attention against their
   plain versions on the card (qwen3-1.7b's heads at S up to 32768, a
   windowed, an odd-S and an fp32 case; ``attention_error`` gives the
   tolerance), then timed against their plain versions, their bounds and
   ``F.scaled_dot_product_attention``;
5. federated round: the synchronous FedAuto round on full-width
   ResNet-18-GN (CIFAR-100 shapes, 20 clients, mixed failures): FedAvg 2
   rounds, FedAuto 2 rounds (fp32 streaming), FedAuto 1 round with int8
   uploads and FedAuto 1 round with the materializing path, with the launch
   counters of every kernel read around the runs, then one FedAuto round
   timed and profiled (kernel time, busy share, top kernels);
6. agreement: one small FedAuto run on the card against the same run on the
   CPU (plain versions), params within 1e-4;
7. serve: ``launch/serve.py``'s ``generate`` on full-width qwen3-1.7b (28
   layers, random init from a seed), B=4, prompt 64, decode 32, cache 256,
   with exactly 96 x 28 decode_attention launches, then a few decode steps
   profiled;
8. forward: ``models/transformer.py``'s ``forward`` on full-width
   qwen3-1.7b at B=4, S=4096 on ``data/tokens.py`` batches, with exactly 28
   flash_attention launches and a loss near ln(151936) at init, then
   profiled;
9. LLM agreement: qwen3-1.7b-smoke in fp32 on the card against the CPU
   (forward loss and decode logits within 1e-4; ``llm_agreement``, which
   ``tests/test_torch_kernels_gpu.py`` runs too).

The last two lines are a JSON object with one entry per kernel and the JSON
result line ``{"ok": true, "device": {...}}``.  Exits non-zero (and prints
no result) without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
FP32_FLOP_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
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


def call(ops_or_ref, name, x, scales, betas):
    if name == "dequant_fedagg":
        return ops_or_ref.dequant_fedagg(x, scales, betas)
    return getattr(ops_or_ref, name)(x, betas)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    # the same sources and flags in one nvcc call: what the parallel build saves
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run([build.find_nvcc(), *build.COMPILE_FLAGS, "-shared", "-o",
                        os.path.join(tmp, "one_call.so"),
                        *map(str, build.sources())], check=True, capture_output=True)
        one = time.perf_counter() - t0
    print(f"[build] one nvcc call over the same {len(info.ptxas)} sources: "
          f"{one:.2f} s (parallel compiles + link: {info.seconds:.2f} s)")


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
            b_ms, b_by = bound(name, dt, odt, M_TIMED, P)
            timings[(name, dt, P)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                          bound_by=b_by, library_ms=lib_ms)
            lib = f"{lib_ms:.4f}" if lib_ms is not None else "null"
            print(f"[time] {name:14s} {str(dt)[6:]:8s} M={M_TIMED} P={P:9d} "
                  f"kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"share_of_bound={b_ms / k_ms:.3f} plain_ms={p_ms:.4f} "
                  f"library_ms={lib}")
            del x
    torch.cuda.empty_cache()
    return errs, timings


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
    base = dict(n_clients=20, k_selected=20, local_steps=5, batch_size=32,
                lr=0.05, failure_mode="mixed", seed=0, eval_every=1)
    t0 = time.perf_counter()
    runner = FFTRunner(FFTConfig(**base), init_fn, apply_fn, public, parts,
                       private, test, pretrain_steps=10, device=device)
    sync(device)
    g0 = runner.global_params
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
            r = FFTRunner(FFTConfig(**base, **over), lambda seed: g0, apply_fn,
                          public, parts, private, test, device=device)
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
    return totals, runner, g0


def phase_profile(runner, g0):
    """One FedAuto fp32 round timed on the host clock, then the same round
    under torch.profiler for the kernels that take the device time.  The
    busy share is the profiled kernel time over the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.strategies import FedAuto

    def one_round():
        runner.global_params = g0
        runner.rng = np.random.default_rng(42)
        t0 = time.perf_counter()
        runner.run(FedAuto(), 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = one_round()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_round()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    if not kernels:
        print(f"[profile] wall_ms={wall_ms:.1f} device time: not measured "
              "(the profiler recorded no device events)")
        return
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = sum(e.self_device_time_total for e in kernels
               if "coef_reduce_kernel" in e.key) / 1e3
    print(f"[profile] fedauto fp32 round: wall_ms={wall_ms:.1f} "
          f"kernel_ms={dev_ms:.1f} busy_share={dev_ms / wall_ms:.3f} "
          f"aggregation_kernels_ms={ours:.3f} "
          f"kernel_launches={sum(e.count for e in kernels)}")
    for e in kernels[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d}x {e.key[:100]}")


def phase_agreement():
    """One small FedAuto run, fp32 streaming, on the card and on the CPU
    from the same init and minibatch indices: the CUDA kernels and cuDNN
    (TF32 off) against the plain versions."""
    from repro_torch.core.strategies import FedAuto
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
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(5)

        def batch_indices(n, E, bs):
            return torch.as_tensor(rng.integers(0, n, (E, bs)), device=dev)

        r = FFTRunner(FFTConfig(**cfg),
                      lambda seed: tree_map(lambda t: t.to(dev), p0), apply_fn,
                      public, parts, private, test, pretrain_steps=4,
                      device=dev, batch_indices=batch_indices)
        hist = r.run(FedAuto(), 2)
        out[dev] = (hist, [l.cpu() for l in tree_leaves(r.global_params)])
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["cuda"][1], out["cpu"][1]))
    print(f"[agree] cnn FedAuto 2 rounds: acc cuda={out['cuda'][0]} "
          f"cpu={out['cpu'][0]} max |param diff|={diff:.3e}")
    assert diff < 1e-4, diff
    assert max(abs(a - b) for a, b in zip(out["cuda"][0], out["cpu"][0])) <= 1 / 120


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


def attention_error(got, want):
    """{"max_abs_err", "max_err_over_row_rms" (|got - want| over the RMS of
    its output row), "share_of_limit" (the largest |got - want| over its
    ``ATTN_TOL`` limit), "ok" (right dtype, shape, finite, within the
    limit everywhere)}."""
    tol = ATTN_TOL[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    limit = tol["atol"] + tol["rtol"] * w.abs() + tol["row"] * rms
    share = float((err / limit.clamp_min(1e-30)).max())
    return {"max_abs_err": float(err.max()),
            "max_err_over_row_rms": float((err / rms.clamp_min(1e-30)).max()),
            "share_of_limit": share,
            "ok": (got.dtype == want.dtype and got.shape == want.shape
                   and share <= 1.0 and bool(torch.isfinite(g).all()))}


# (B, Sq, Sk, H, KV, hd, causal, window, dtype); the first is qwen3-1.7b's
# prefill at train_4k's length, the shape the forward phase gives the kernel
FLASH_CHECKS = [
    (4, 4096, 4096, 16, 8, 128, True, None, torch.bfloat16),
    (2, 2048, 2048, 16, 8, 128, True, 512, torch.bfloat16),
    (2, 1027, 1027, 16, 8, 128, True, None, torch.bfloat16),
    (1, 1500, 1500, 16, 8, 128, False, None, torch.bfloat16),
    (2, 777, 777, 16, 8, 128, True, None, torch.float32),
    (2, 300, 1000, 8, 2, 64, True, 128, torch.bfloat16),
]
# (B, S, H, KV, hd, n_valid, dtype): qwen3-1.7b's group (g=2, hd=128); the
# first is the serve phase's cache at its last step
DECODE_CHECKS = [
    (4, 256, 16, 8, 128, 96, torch.bfloat16),
    (4, 4096, 16, 8, 128, 3001, torch.bfloat16),
    (4, 32768, 16, 8, 128, 30000, torch.bfloat16),
    (4, 32768, 16, 8, 128, 32768, torch.bfloat16),
    (4, 4096, 16, 8, 128, 4000, torch.float32),
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


def phase_attention():
    """Each attention kernel against its plain version on the card, then
    timed by CUDA events at the main paths' shapes (and longer caches)
    against the plain version, the bound and SDPA (a yardstick only: the
    port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    errs = {"flash_attention": {}, "decode_attention": {}}
    for i, (B, Sq, Sk, H, KV, hd, causal, window, dt) in enumerate(FLASH_CHECKS):
        q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=100 + i)
        kw = dict(causal=causal, window=window)
        e = check("flash_attention", ops.flash_attention(q, k, v, **kw),
                  ref.flash_attention(q, k, v, **kw),
                  f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
                  f"window={window} {str(dt)[6:]}")
        errs["flash_attention"][dt] = max(errs["flash_attention"].get(dt, 0.0), e)
        del q, k, v
        torch.cuda.empty_cache()
    for i, (B, S, H, KV, hd, nv, dt) in enumerate(DECODE_CHECKS):
        q, k, v = attn_inputs(B, 1, S, H, KV, hd, dt, seed=200 + i)
        valid = torch.arange(S, device="cuda") < nv
        if nv < S:                 # a ring buffer: the valid run wraps around
            valid = valid.roll(S // 3)
        scale = 1.0 / hd ** 0.5
        e = check("decode_attention", ops.decode_attention(q, k, v, valid, scale=scale),
                  ref.decode_attention(q, k, v, valid, scale=scale),
                  f"B={B} S={S} H={H} KV={KV} hd={hd} n_valid={nv} {str(dt)[6:]}")
        errs["decode_attention"][dt] = max(errs["decode_attention"].get(dt, 0.0), e)
    torch.cuda.empty_cache()

    timings = {}
    B, Sq, Sk, H, KV, hd, causal, window, dt = FLASH_CHECKS[0]
    q, k, v = attn_inputs(B, Sq, Sk, H, KV, hd, dt, seed=7)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True), 10)
    p_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, causal=True), 3)
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    b_ms, b_by = flash_bound(B, Sq, Sk, H, KV, hd, causal, window, dt)
    timings["flash_attention"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                      bound_by=b_by, library_ms=l_ms)
    print(f"[attn-time] flash_attention B={B} S={Sq} H={H} KV={KV} hd={hd} "
          f"causal bf16: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / k_ms:.4f} plain_ms={p_ms:.4f} "
          f"library_ms(sdpa)={l_ms:.4f} "
          f"kernel_TFLOP/s={4.0 * B * H * hd * flash_pairs(Sq, Sk, True, None) / k_ms / 1e9:.2f}")
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
    for i, (B, S, H, KV, hd, nv, dt) in enumerate(DECODE_CHECKS[:4]):
        q, k, v = attn_inputs(B, 1, S, H, KV, hd, dt, seed=8)
        valid = torch.arange(S, device="cuda") < nv
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = valid[None, None, None, :]
        scale = 1.0 / hd ** 0.5
        k_ms = cuda_ms(lambda: ops.decode_attention(q, k, v, valid, scale=scale), 50)
        p_ms = cuda_ms(lambda: ref.decode_attention(q, k, v, valid, scale=scale), 20)
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True), 50)
        b_ms, b_by = decode_bound(B, S, H, KV, hd, nv, dt)
        if i == 0:                         # the serve phase's shape
            timings["decode_attention"] = dict(ms=k_ms, plain_ms=p_ms,
                                               bound_ms=b_ms, bound_by=b_by,
                                               library_ms=l_ms)
        print(f"[attn-time] decode_attention B={B} S={S} n_valid={nv} H={H} "
              f"KV={KV} hd={hd} bf16: kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}) share_of_bound={b_ms / k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms(sdpa)={l_ms:.4f}")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return errs, timings


# ---------------------------------------------------------------------------
# the LLM serving path
# ---------------------------------------------------------------------------
def profile_kernels(fn, label, ours):
    """``fn`` timed on the host clock, then run again under torch.profiler:
    device kernel time, busy share (kernel time over the unprofiled wall),
    launches, the time of the kernels named in ``ours`` and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
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
    for e in kernels[:10]:
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


def llm_agreement():
    """qwen3-1.7b-smoke in fp32, the same params and tokens on the card and
    on the CPU: the forward loss and 40 decode steps' logits (the 32-slot
    ring wraps).  The attention kernels and cuBLAS (TF32 off) against the
    plain versions.  Returns {"loss": {dev: loss}, "loss_diff",
    "logit_diff", "launches": {dev: counts}} after asserting the launch
    counts and agreement within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), dtype="float32")
    p_cpu = T.init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    loss, logits, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        batch = {"tokens": toks.to(dev), "labels": toks.roll(-1, 1).to(dev)}
        ops.reset_launches()
        loss[dev] = float(T.forward(p, cfg, batch, loss_chunk=16)[0])
        state = T.init_decode_state(p, cfg, 2, 32)
        steps = []
        for t in range(40):
            lg, state = T.decode_step(p, cfg, state, batch["tokens"][:, t:t + 1])
            steps.append(lg.cpu())
        logits[dev] = torch.stack(steps)
        launches[dev] = dict(ops.launches)
    d_loss = abs(loss["cuda"] - loss["cpu"])
    d_logit = float((logits["cuda"] - logits["cpu"]).abs().max())
    assert launches["cuda"]["flash_attention"] == cfg.num_layers, launches
    assert launches["cuda"]["decode_attention"] == 40 * cfg.num_layers, launches
    assert launches["cpu"]["flash_attention"] == 0, launches
    assert launches["cpu"]["decode_attention"] == 0, launches
    assert d_loss <= 1e-4 * (1 + abs(loss["cpu"])), d_loss
    assert d_logit <= 1e-4, d_logit
    return {"loss": loss, "loss_diff": d_loss, "logit_diff": d_logit,
            "launches": launches}


def phase_llm_agreement():
    r = llm_agreement()
    print(f"[agree-llm] qwen3-1.7b-smoke fp32: loss cuda={r['loss']['cuda']:.6f} "
          f"cpu={r['loss']['cpu']:.6f} |diff|={r['loss_diff']:.3e}; 40 decode "
          f"steps max |logit diff|={r['logit_diff']:.3e}; cuda launches="
          f"{r['launches']['cuda']}")


# ---------------------------------------------------------------------------
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    phase_card()
    phase_build()
    errs, timings = phase_kernels()
    attn_errs, attn_timings = phase_attention()
    launches, runner, g0 = phase_main_path()
    phase_profile(runner, g0)
    del runner, g0
    torch.cuda.empty_cache()
    phase_agreement()
    serve_launches = phase_serve()
    torch.cuda.empty_cache()
    forward_launches = phase_forward()
    torch.cuda.empty_cache()
    phase_llm_agreement()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, dt in MAIN_DTYPE.items():
        replaces = next(c[3] for c in CASES if c[0] == name)
        t = timings[(name, dt, P_TIMED[0])]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[(name, dt)], **t})
    for name, replaces, n in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:82",
             forward_launches["flash_attention"]),
            ("decode_attention", "src/repro/kernels/decode_attention.py:51",
             serve_launches["decode_attention"])):
        kernels.append({"name": name, "route": "cuda", "source": ATTN_SOURCE,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": attn_errs[name][torch.bfloat16],
                        **attn_timings[name]})
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
