"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. card: name and power limit, TF32 switched off for matmul and cuDNN;
2. build: nvcc for sm_90a, with the ptxas register/shared-memory/spill lines;
3. kernels: every CUDA kernel against its plain PyTorch version on the card,
   over M in {1, 3, 22, 64} and P in {1, 100, 4097, 2359296, 11223140},
   then timed at M=22 against its plain version, its bytes bound and (where
   one PyTorch call computes the same function) that call;
4. main path: the synchronous FedAuto round on full-width ResNet-18-GN
   (CIFAR-100 shapes, 20 clients, mixed failures): FedAvg 2 rounds, FedAuto
   3 rounds (fp32 streaming), FedAuto 1 round with int8 uploads and FedAuto
   1 round with the materializing path, with the launch counters of every
   kernel read around the runs, then one FedAuto round timed and profiled
   (kernel time, busy share, top kernels);
5. agreement: one small FedAuto run on the card against the same run on the
   CPU (plain versions), params within 1e-4.

The last two lines are a JSON object with one entry per kernel and the JSON
result line ``{"ok": true, "device": {...}}``.  Exits non-zero (and prints
no result) without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/fedagg.cu"
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
FP32_FLOP_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
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
    print(f"[build] nvcc {' '.join(build.ARCH_FLAGS)}: {info.seconds:.2f} s "
          f"-> {os.path.relpath(info.path, ROOT)}")
    for line in info.ptxas.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
            print(f"[build] {line.strip()}")


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
            ("fedauto fp32 streaming", FedAuto, {}, 3, "float_fedagg", 2),
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
    launches, runner, g0 = phase_main_path()
    phase_profile(runner, g0)
    del runner, g0
    phase_agreement()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, dt in MAIN_DTYPE.items():
        replaces = next(c[3] for c in CASES if c[0] == name)
        t = timings[(name, dt, P_TIMED[0])]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[(name, dt)], **t})
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
