"""The port's CUDA kernels against their plain PyTorch versions on the card:
the aggregation reductions (``csrc/fedagg.cu``), the top-k scatter
(``csrc/topk_fedagg.cu``, bitwise), the attention kernels
(``csrc/attention.cu``) and the flash backward (``csrc/attention_bwd.cu``),
the fused LoRA matmul (``csrc/lora_matmul.cu``) and the Mamba2 selective
scan (``csrc/selective_scan.cu``) and its backward
(``csrc/selective_scan_bwd.cu``), the smoke transformer (serving and
training) and the smoke zamba2, and the async and buffered server's rounds
on the toy cnn on the card against the same models on the CPU.

Marked ``gpu``: each test skips with a reason where there is no CUDA device.
The file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The attention, LoRA and scan tolerances and the smoke-model comparisons are
``chip_smoke.py``'s own (``attention_error``, ``lora_check``,
``scan_check``, ``llm_agreement``, ``ssm_agreement``), so the smoke run and
these tests hold the kernels to one standard.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

SHAPES = [(3, 100), (22, 4096), (7, 13000), (1, 257), (64, 2_359_296),
          (22, 11_223_140)]


def _inputs(case, m, p, seed, device):
    """(x, scales, betas) drawn on the card: x in the case's dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    if case == "dequant_int8":
        x = torch.randint(-127, 128, (m, p), generator=g, device=device,
                          dtype=torch.int8)
    else:
        dt = {"fp32": torch.float32, "fp16": torch.float16,
              "bf16": torch.bfloat16}[case.split("_")[1]]
        x = torch.randn((m, p), generator=g, device=device).to(dt)
    w = torch.rand((m,), generator=g, device=device) + 0.1
    scales = torch.rand((m,), generator=g, device=device) * 9e-3 + 1e-3
    return x, scales, w / w.sum()


# ---------------------------------------------------------------------------
@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", SHAPES)
@pytest.mark.parametrize("case", ["float_fp32", "float_fp16", "dequant_int8",
                                  "fedagg_fp32", "fedagg_bf16"])
def test_cuda_kernel_matches_plain_version(cuda_device, case, m, p):
    x, s, b = _inputs(case, m, p, seed=m + p, device=cuda_device)
    key = {"float": "float_fedagg", "dequant": "dequant_fedagg",
           "fedagg": "fedagg"}[case.split("_")[0]]
    before = dict(ops.launches)
    if key == "dequant_fedagg":
        got, want = ops.dequant_fedagg(x, s, b), ref.dequant_fedagg(x, s, b)
    else:
        got, want = getattr(ops, key)(x, b), getattr(ref, key)(x, b)
    torch.cuda.synchronize()
    assert ops.launches[key] == before[key] + 1
    assert got.dtype == want.dtype and got.device.type == "cuda"
    assert got.shape == (p,)
    # fp32 out: fold vs FMA chain; bf16 out: one bf16 rounding of the sum
    tol = (dict(rtol=2e-2, atol=2e-2) if case.endswith("bf16")
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,m", chip_smoke.STRATEGY_INPUTS)
@pytest.mark.parametrize("name", ["fedagg", "float_fedagg"])
def test_cuda_reductions_hold_the_strategies_inputs(cuda_device, name, kind, m):
    """fp32 reductions on what the baselines send them: TF-Aggregation's
    unnormalised weights (Σβ > 1, β from 1e-3 to 5) and SCAFFOLD's signed
    1e-3 deltas, at ResNet-18's widest leaf, within rtol 1e-5 and
    atol 1e-6·Σ|β|·max|x| of the plain version."""
    x, b = chip_smoke.strategy_inputs(kind, m, chip_smoke.STRATEGY_P,
                                      seed=m, device=cuda_device)
    rtol, atol = chip_smoke.strategy_tolerance(x, b)
    before = ops.launches[name]
    got, want = getattr(ops, name)(x, b), getattr(ref, name)(x, b)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    assert got.dtype == torch.float32 and got.shape == (chip_smoke.STRATEGY_P,)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind,m", chip_smoke.STRATEGY_INPUTS)
def test_strategy_inputs_span_the_strategies_ranges(kind, m):
    """The inputs of the test above, drawn on the CPU at a small width:
    unnormalised weights between 1e-3 and 5 that sum to between 1 and 20,
    or uniform weights over signed rows of scale 1e-3."""
    x, b = chip_smoke.strategy_inputs(kind, m, 4096, seed=m, device="cpu")
    assert x.shape == (m, 4096) and b.shape == (m,)
    assert x.dtype == b.dtype == torch.float32
    if kind == "tf_weights":
        assert 1.0 < float(b.sum()) < 20.0
        assert abs(float(b.min()) - 1e-3) < 1e-9 and abs(float(b.max()) - 5.0) < 1e-6
    else:
        assert torch.allclose(b, torch.full((m,), 1.0 / m))
        assert 1e-4 < float(x.abs().mean()) < 1e-2
        assert bool((x < 0).any()) and bool((x > 0).any())
    rtol, atol = chip_smoke.strategy_tolerance(x, b)
    assert rtol == 1e-5 and atol > 0


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", [(22, 2_359_296), (3, 100)])
def test_dequant_fedagg_is_one_kernel_with_the_coefficients_folded(
        cuda_device, m, p):
    """One ``ops.dequant_fedagg`` call records exactly one CUDA kernel, and
    its result is bit for bit the one of folding c_m = β_m·s_m first and
    running the fp32 reduction's FMA chain over the int8 rows as floats."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, s, b = _inputs("dequant_int8", m, p, seed=m + p, device=cuda_device)
    ops.dequant_fedagg(q, s, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = ops.dequant_fedagg(q, s, b)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "coef_reduce_kernel" in kernels[0], kernels
    assert torch.equal(got, ops.float_fedagg(q.float(), b * s))


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((3, 8), device=cuda_device)
    b = torch.full((3,), 1 / 3, device=cuda_device)
    with pytest.raises(TypeError):
        ops.fedagg(x.to(torch.float16), b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.float_fedagg(torch.zeros((8, 3), device=cuda_device).t(), b)
    with pytest.raises(ValueError, match="coefficient"):
        ops.float_fedagg(x, b[:2])
    with pytest.raises(ValueError, match="different devices"):
        ops.float_fedagg(x, b.cpu())


# ---------------------------------------------------------------------------
# topk_fedagg
# ---------------------------------------------------------------------------
TOPK_CASES = [("row-8 shape", *chip_smoke.TOPK_SHAPE, "sorted")] + chip_smoke.TOPK_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("label,m,k,n,kind", TOPK_CASES,
                         ids=[c[0] for c in TOPK_CASES])
def test_topk_fedagg_kernel_is_bitwise_its_plain_version(cuda_device, label,
                                                        m, k, n, kind):
    """One launch per call, the same bits as the plain fold on the card
    (entries outside [0, n) dropped by both), on sorted rows, a k = n
    cohort, an unsorted row and indices out of range."""
    idx, vals, b = chip_smoke.topk_inputs(m, k, n, seed=m + k + n, kind=kind)
    before = ops.launches["topk_fedagg"]
    got = ops.topk_fedagg(idx, vals, b, n)
    torch.cuda.synchronize()
    assert ops.launches["topk_fedagg"] == before + 1
    want = chip_smoke.topk_plain(idx, vals, b, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), label


@pytest.mark.gpu
@pytest.mark.parametrize("label,m,k,n,kind", TOPK_CASES,
                         ids=[c[0] for c in TOPK_CASES])
def test_topk_fedagg_into_is_bitwise_its_plain_version(cuda_device, label, m,
                                                       k, n, kind):
    """The flush entry on each case as a one-leaf flush into a non-zero
    accumulator, the rows read where they lie (views of one draw)."""
    idx, vals, b = chip_smoke.topk_inputs(m, k, n, seed=m + k + n, kind=kind)
    chip_smoke.topk_flush_check(label, [n], [[idx[i]] for i in range(m)],
                                [[vals[i]] for i in range(m)], b, seed=k)


TOPK_FLUSHES = [("M=5", 5, {}), ("M=20", 20, {}),
                ("faults", 5, {3: "unsorted", 40: "out_of_range"})]


@pytest.mark.gpu
@pytest.mark.parametrize("label,m,faults", TOPK_FLUSHES,
                         ids=[c[0] for c in TOPK_FLUSHES])
def test_topk_fedagg_into_resnet18_leaves(cuda_device, label, m, faults):
    """ResNet-18-GN's 76 leaf sizes at 10%: M = 5 and 20, and a flush with an
    unsorted row in leaf 3 and indices outside [0, n) in leaf 40 (only those
    rows take the whole-row scan, every leaf stays bitwise)."""
    ns = [l.numel() for l in chip_smoke._leaves(
        chip_smoke.resnet18_template("cuda"))]
    assert len(ns) == 76 and sum(ns) == 11_223_140
    chip_smoke.topk_flush_check(
        label, ns, *chip_smoke.topk_flush_inputs(ns, m, seed=80 + m,
                                                 faults=faults), seed=m)


@pytest.mark.gpu
def test_topk_fedagg_into_spans_row_chunks(cuda_device):
    """M = 300: the fold kernel plans rows 32 at a time."""
    ns = chip_smoke.TOPK_CHUNKED
    chip_smoke.topk_flush_check("M=300", ns, *chip_smoke.topk_flush_inputs(
        ns, 300, seed=90), seed=91)


@pytest.mark.gpu
def test_topk_fedagg_into_counts_one_launch_per_flush(cuda_device):
    """One launch count per flush, whatever the leaf count; a second flush
    on the same plan (its flags under a new epoch) adds into the first's
    result."""
    ns = (64, 100, 1728, 2048, 2049, 36864)
    idx_rows, val_rows, b = chip_smoke.topk_flush_inputs(ns, 7, seed=95)
    accs = [torch.zeros(n, device=cuda_device) for n in ns]
    want = chip_smoke.topk_flush_plain(accs, idx_rows, val_rows, b)
    want = chip_smoke.topk_flush_plain(want, idx_rows, val_rows, b)
    before, plan = ops.launches["topk_fedagg"], ops.TopkPlan()
    for _ in range(2):
        ops.topk_fedagg_into(accs, idx_rows, val_rows, b, plan=plan)
    torch.cuda.synchronize()
    assert ops.launches["topk_fedagg"] == before + 2
    for a, w in zip(accs, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
def test_topk_fedagg_streams_a_topk_cohort_bitwise(cuda_device):
    """The StreamAccumulator's top-k family on the card: 20 ``topk:0.1``
    payloads of a multi-leaf tree (a ResNet-18 conv leaf, GroupNorm
    scales, a head and its bias) after a dense ``add_tree`` term give the
    CPU's bits, in one launch count."""
    from repro_torch.fl.comm import StreamAccumulator, make_codec
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = {"w": (3, 3, 256, 256), "gn": (64,), "fc": (512, 100),
              "b": (100,), "stem": (3, 3, 3, 64)}
    tmpl = {k: torch.zeros(s, device=cuda_device) for k, s in shapes.items()}
    codec = make_codec("topk:0.1")
    pays = [codec.encode({k: torch.randn(s, generator=g, device=cuda_device)
                          for k, s in shapes.items()}) for _ in range(20)]
    anchor = {k: torch.randn(s, generator=g, device=cuda_device)
              for k, s in shapes.items()}
    betas = torch.rand(20, generator=g, device=cuda_device).tolist()
    out = {}
    for dev in ("cuda", "cpu"):
        acc = StreamAccumulator({k: v.to(dev) for k, v in tmpl.items()})
        acc.add_tree({k: v.to(dev) for k, v in anchor.items()}, 0.25)
        before = ops.launches["topk_fedagg"]
        for p, bm in zip(pays, betas):
            if dev == "cpu":
                for el in p.leaves:
                    el.data = {k: v.cpu() for k, v in el.data.items()}
            acc.add(p, bm)
        out[dev] = {k: v.cpu() for k, v in acc.total().items()}
        assert ops.launches["topk_fedagg"] == before + (dev == "cuda")
    for k in shapes:
        assert torch.equal(out["cuda"][k].view(torch.int32),
                           out["cpu"][k].view(torch.int32)), k


@pytest.mark.gpu
def test_topk_fedagg_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    vals = torch.zeros((2, 3), device=cuda_device)
    b = torch.ones(2, device=cuda_device)
    with pytest.raises(TypeError):
        ops.topk_fedagg(idx.long(), vals, b, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_fedagg(idx.t().contiguous().t(), vals.t().contiguous().t(),
                        torch.ones(2, device=cuda_device), 4)
    with pytest.raises(ValueError, match="different devices"):
        ops.topk_fedagg(idx, vals, b.cpu(), 4)
    acc = [torch.zeros(4, device=cuda_device)]
    rows = [[idx[0]], [idx[1]]]
    with pytest.raises(TypeError):
        ops.topk_fedagg_into(acc, [[r[0].long()] for r in rows],
                             [[vals[0]], [vals[1]]], b)
    with pytest.raises(ValueError, match="same k"):
        ops.topk_fedagg_into(acc, [[idx[0]], [idx[1][:2]]],
                             [[vals[0]], [vals[1][:2]]], b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_fedagg_into(acc, [[idx[0]], [idx[1]]],
                             [[vals[0]], [torch.zeros((3, 2), device=cuda_device).t()[0]]],
                             b)
    with pytest.raises(ValueError, match="different devices"):
        ops.topk_fedagg_into(acc, rows, [[vals[0]], [vals[1].cpu()]], b)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # tests/test_kernels.py's cases
    dict(B=1, Sq=128, Sk=128, H=4, KV=4, hd=64, causal=True, window=None),
    dict(B=2, Sq=256, Sk=256, H=8, KV=2, hd=64, causal=True, window=None),
    dict(B=1, Sq=256, Sk=256, H=4, KV=4, hd=128, causal=True, window=64),
    dict(B=1, Sq=192, Sk=192, H=4, KV=1, hd=32, causal=True, window=None),
    dict(B=1, Sq=128, Sk=128, H=4, KV=4, hd=64, causal=False, window=None),
    # ragged tiles, Sq != Sk, rows with no valid key, qwen3-1.7b's heads
    dict(B=2, Sq=77, Sk=77, H=4, KV=2, hd=128, causal=True, window=None),
    dict(B=1, Sq=80, Sk=48, H=4, KV=2, hd=32, causal=True, window=None),
    dict(B=2, Sq=200, Sk=16, H=4, KV=2, hd=64, causal=False, window=8),
    dict(B=1, Sq=16, Sk=300, H=2, KV=1, hd=64, causal=True, window=5),
    dict(B=2, Sq=1, Sk=33, H=4, KV=2, hd=32, causal=False, window=None),
    dict(B=2, Sq=1024, Sk=1024, H=16, KV=8, hd=128, causal=True, window=None),
    # the bf16 kernel's tiling edges (128-row q and key tiles): S of 129,
    # 255 and 1000, Sk under one key tile, g = H/KV of 1, 2 and 4, a window
    # of 100 across tile edges, hd 32, 64 and 128; then zamba2-1.2b's
    # shared attention at its forward's shape
    dict(B=2, Sq=129, Sk=129, H=8, KV=8, hd=64, causal=True, window=None),
    dict(B=2, Sq=255, Sk=255, H=8, KV=2, hd=32, causal=True, window=None),
    dict(B=1, Sq=1000, Sk=1000, H=8, KV=4, hd=128, causal=True, window=100),
    dict(B=2, Sq=1000, Sk=255, H=4, KV=1, hd=64, causal=False, window=None),
    dict(B=2, Sq=300, Sk=100, H=8, KV=2, hd=128, causal=True, window=None),
    dict(B=3, Sq=255, Sk=40, H=4, KV=4, hd=32, causal=False, window=100),
    dict(B=2, Sq=129, Sk=1000, H=8, KV=2, hd=128, causal=False, window=100),
    dict(B=4, Sq=4096, Sk=4096, H=32, KV=32, hd=64, causal=True, window=None),
    # head dims past 128 and between the kernels' 32, 64, 128, 256: gemma-7b
    # (hd 256, 16/16 heads) and hd 256 with a window, ragged tiles, Sq !=
    # Sk and rows with no valid key; the smoke configs' hd 24 (starcoder2,
    # windowed) and 48 (gemma); hd 96; hd 136 (a 64-column box wholly past
    # hd); hd 8 and 16 (a 16- and 32-byte row under HD 32's 64-byte box)
    dict(B=1, Sq=2048, Sk=2048, H=16, KV=16, hd=256, causal=True, window=None),
    dict(B=2, Sq=1000, Sk=1000, H=8, KV=8, hd=256, causal=True, window=100),
    dict(B=2, Sq=300, Sk=700, H=8, KV=2, hd=256, causal=True, window=None),
    dict(B=2, Sq=200, Sk=40, H=4, KV=4, hd=256, causal=False, window=8),
    dict(B=2, Sq=255, Sk=255, H=6, KV=2, hd=24, causal=True, window=64),
    dict(B=2, Sq=300, Sk=300, H=4, KV=4, hd=48, causal=True, window=None),
    dict(B=2, Sq=1000, Sk=1000, H=8, KV=2, hd=96, causal=True, window=None),
    dict(B=2, Sq=500, Sk=500, H=4, KV=2, hd=136, causal=True, window=None),
    dict(B=2, Sq=300, Sk=300, H=4, KV=2, hd=8, causal=True, window=None),
    dict(B=1, Sq=500, Sk=500, H=4, KV=4, hd=16, causal=False, window=64),
]
DECODE_CASES = [
    dict(B=2, S=512, H=8, KV=2, hd=64, valid="prefix:300"),
    dict(B=1, S=1024, H=4, KV=4, hd=128, valid="prefix:1024"),
    dict(B=3, S=200, H=6, KV=1, hd=32, valid="prefix:7"),
    dict(B=2, S=40, H=4, KV=2, hd=64, valid="ring"),
    dict(B=2, S=100, H=4, KV=2, hd=64, valid="none"),
    dict(B=4, S=4096, H=16, KV=8, hd=128, valid="prefix:2500"),
    dict(B=1, S=70, H=32, KV=2, hd=128, valid="prefix:69"),   # g*hd = 2048
    # the split kernel: qwen3-1.7b's longest cache, a ring hole over whole
    # splits, no valid slot (every split visited), zamba2-1.2b's serve
    # shape, one slot, S off the 32-key tile, a group of 34 heads (g*hd
    # 2176: 17 blocks of 2 heads)
    dict(B=4, S=32768, H=16, KV=8, hd=128, valid="prefix:32768"),
    dict(B=4, S=4096, H=16, KV=8, hd=128, valid="ring"),
    dict(B=4, S=4096, H=16, KV=8, hd=128, valid="none"),
    dict(B=4, S=256, H=32, KV=32, hd=64, valid="prefix:96"),
    dict(B=2, S=1, H=4, KV=2, hd=64, valid="prefix:1"),
    dict(B=3, S=1001, H=16, KV=8, hd=128, valid="ring"),
    dict(B=1, S=300, H=34, KV=1, hd=64, valid="prefix:250"),
    # gemma-7b's hd 256, starcoder2-7b's group of 9 over a full ring, the
    # smoke configs' hd 24 and 48, hd 96 and 136, hd 8 and 16
    dict(B=4, S=256, H=16, KV=16, hd=256, valid="prefix:96"),
    dict(B=2, S=4096, H=16, KV=16, hd=256, valid="ring"),
    dict(B=4, S=4096, H=36, KV=4, hd=128, valid="prefix:4096"),
    dict(B=2, S=64, H=6, KV=2, hd=24, valid="ring"),
    dict(B=2, S=256, H=4, KV=4, hd=48, valid="prefix:96"),
    dict(B=4, S=1000, H=8, KV=2, hd=96, valid="prefix:700"),
    dict(B=2, S=500, H=4, KV=2, hd=136, valid="none"),
    dict(B=2, S=300, H=4, KV=2, hd=8, valid="ring"),
    dict(B=2, S=256, H=4, KV=4, hd=16, valid="prefix:96"),
]


def _randn(shape, gen, device, dtype):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _valid(spec, S, device):
    kind, _, n = spec.partition(":")
    if kind == "prefix":
        return torch.arange(S, device=device) < int(n)
    if kind == "ring":                      # a hole in the middle
        k = torch.arange(S, device=device)
        return (k < S // 4) | (k >= 3 * S // 4)
    return torch.zeros(S, dtype=torch.bool, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda_device, case, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(case["Sq"] + case["Sk"])
    B, H, KV, hd = case["B"], case["H"], case["KV"], case["hd"]
    q = _randn((B, case["Sq"], H, hd), g, cuda_device, dtype)
    k = _randn((B, case["Sk"], KV, hd), g, cuda_device, dtype)
    v = _randn((B, case["Sk"], KV, hd), g, cuda_device, dtype)
    kw = dict(causal=case["causal"], window=case["window"])
    before = ops.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    err = chip_smoke.attention_error(got, want)
    assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain_version(cuda_device, case, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(case["S"])
    B, S, H, KV, hd = case["B"], case["S"], case["H"], case["KV"], case["hd"]
    q = _randn((B, 1, H, hd), g, cuda_device, dtype)
    k = _randn((B, S, KV, hd), g, cuda_device, dtype)
    v = _randn((B, S, KV, hd), g, cuda_device, dtype)
    valid = _valid(case["valid"], S, cuda_device)
    scale = 1.0 / np.sqrt(hd)
    before = ops.launches["decode_attention"]
    got = ops.decode_attention(q, k, v, valid, scale=scale)
    torch.cuda.synchronize()
    assert ops.launches["decode_attention"] == before + 1
    want = ref.decode_attention(q, k, v, valid, scale=scale)
    assert got.dtype == dtype and got.shape == q.shape
    err = chip_smoke.attention_error(got, want)
    assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.PARTIAL_CHECKS,
                         ids=lambda c: "B{}-S{}-H{}-KV{}-hd{}-valid{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_partial_kernel_matches_plain_version(cuda_device,
                                                               case, dtype):
    """The sequence-sharded decode's slice kernel: (m, l, o) against the
    plain version, an empty slice exactly (-1e30, 0, 0)."""
    chip_smoke.partial_check(*case, dtype)


@pytest.mark.gpu
def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((1, 8, 4, 64), device=cuda_device)
    k = torch.zeros((1, 8, 2, 64), device=cuda_device)
    valid = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q[:, :1].clone().requires_grad_(), k, k, valid,
                             scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2))
    for hd in (20, 264):      # not a multiple of 8; past 256
        qh, kh = torch.zeros((1, 8, 4, hd), device=cuda_device), \
            torch.zeros((1, 8, 2, hd), device=cuda_device)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(qh, kh, kh)
        with pytest.raises(ValueError, match="head dim"):
            ops.decode_attention(qh[:, :1], kh, kh, valid, scale=1.0)
    off = torch.zeros(1 + 8 * 4 * 64, device=cuda_device)[1:].view(1, 8, 4, 64)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(off, k, k)
    with pytest.raises(ValueError, match="different devices"):
        ops.decode_attention(q[:, :1], k, k, valid.cpu(), scale=1.0)


# ---------------------------------------------------------------------------
# the flash backward (csrc/attention_bwd.cu) and training
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.FLASH_BWD_CHECKS,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_bwd_kernels_match_plain_version(cuda_device, case):
    """dq, dk, dv under ``attention_error``, the forward kernel's lse
    against the plain one, and a second call bitwise the first."""
    before = ops.launches["flash_attention_bwd"]
    r = chip_smoke.flash_bwd_check(*case, seed=5)
    assert r["ok"], r
    assert ops.launches["flash_attention_bwd"] == before + 2


def test_flash_bwd_checks_cover_the_bf16_kernels_edges():
    """``FLASH_BWD_CHECKS`` hold the bf16 backward at every instantiation
    (32, 64, 128, 256) and at padded head dims (8, 24, 48, 136, 200), causal
    and not, with a window, Sq < Sk, rows with no valid key (Sq > Sk +
    window - 1), S off the 128-row tiles, and g = 1, 2 and >= 4; and hd 256
    and the padded head dims in fp32 too."""
    bf16 = [c for c in chip_smoke.FLASH_BWD_CHECKS if c[-1] == torch.bfloat16]
    f32 = [c for c in chip_smoke.FLASH_BWD_CHECKS if c[-1] == torch.float32]
    assert {c[5] for c in bf16} >= {8, 24, 32, 48, 64, 128, 136, 200, 256}
    assert {c[5] for c in f32} >= {8, 24, 48, 200, 256}
    assert any(c[5] == 256 and c[7] for c in bf16)
    assert any(c[5] == 256 and c[3] > c[4] for c in bf16)
    assert {c[6] for c in bf16} == {True, False}
    assert any(c[7] for c in bf16)
    assert any(c[1] < c[2] for c in bf16)
    assert any(c[7] and c[1] > c[2] + c[7] - 1 for c in bf16)
    assert any(c[1] % 128 or c[2] % 128 for c in bf16)
    groups = {c[3] // c[4] for c in bf16}
    assert {1, 2} <= groups and max(groups) >= 4


def test_flash_bwd_checks_hold_every_lora_llm_dense_shape():
    """Each attention shape that ``[fft-lora-llm-dense]`` trains (B=4 x
    S=64, the config's heads, head dim and window, bf16) is one of
    ``FLASH_BWD_CHECKS``: codeqwen1.5-7b at g = 1, starcoder2-7b at g = 9
    with its window, gemma-7b at hd 256."""
    from repro_torch.configs import get_config
    for arch in chip_smoke.FFT_DENSE_ARCHS:
        cfg = get_config(arch)
        shape = (4, 64, 64, cfg.num_heads, cfg.num_kv_heads,
                 cfg.resolved_head_dim, True, cfg.sliding_window,
                 torch.bfloat16)
        assert shape in chip_smoke.FLASH_BWD_CHECKS, (arch, shape)


@pytest.mark.parametrize("shape,bound,by", [
    ((8, 256, 256, 16, 8, 128), 0.0151, "bytes"),
    ((4, 4096, 4096, 16, 8, 128), 0.6950, "operations"),
    ((4, 4096, 4096, 16, 16, 256), 1.3900, "operations")])
def test_flash_bwd_bound_is_pinned(shape, bound, by):
    """The backward's yardstick at the train shape, qwen3-1.7b's forward
    shape and gemma-7b's heads at that shape (causal, bf16): q, k, v, o,
    dO, dq, dk, dv, lse and D once over 3.35 TB/s, or 10 hd flops per
    unmasked pair over 989 TFLOP/s."""
    ms, got_by = chip_smoke.flash_bwd_bound(*shape, True, None, torch.bfloat16)
    assert got_by == by and ms == pytest.approx(bound, abs=5e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_runs_the_kernels(cuda_device, dtype):
    """Under autograd the wrapper runs the forward kernel with lse and the
    backward kernels, one launch count each, and its gradients are the
    plain backward's on the kernel's own output and lse."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q = _randn((2, 200, 8, 64), g, cuda_device, dtype).requires_grad_()
    k = _randn((2, 200, 4, 64), g, cuda_device, dtype).requires_grad_()
    v = _randn((2, 200, 4, 64), g, cuda_device, dtype).requires_grad_()
    do = _randn((2, 200, 8, 64), g, cuda_device, dtype)
    before = dict(ops.launches)
    out = ops.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    assert ops.launches["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o2, lse = ops.flash_attention_fwd(qd, kd, vd, causal=True, window=None,
                                      scale=64 ** -0.5, with_lse=True)
    assert torch.equal(o2, out.detach())
    want = ref.flash_attention_bwd(qd, kd, vd, o2, lse, do, causal=True,
                                   window=None, scale=64 ** -0.5)
    for got, w in zip((dq, dk, dv), want):
        err = chip_smoke.attention_error(got, w, chip_smoke.GRAD_TOL)
        assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("arch", chip_smoke.TRAIN_AGREE_ARCHS)
def test_training_on_the_card_matches_the_cpu(cuda_device, arch):
    """The smoke configs of qwen3-1.7b, gemma-7b (hd 48), starcoder2-7b (hd
    24, windowed), xlstm-125m, zamba2-1.2b (the scan's backward kernel),
    mixtral-8x22b, deepseek-v2-236b, seamless-m4t-large-v2 and
    llava-next-mistral-7b in fp32: 5 AdamW steps of ``launch.train`` and 2
    LoRA-LLM rounds (none for deepseek and seamless) on both devices, every
    leaf within 1e-4 (the params where no step's gradient was nonzero and
    under ``chip_smoke.ADAMW_NEAR_EPS``, at most ``ADAMW_NEAR_EPS_SHARE``
    of them left out), the MoE routing margins held, with the kernels'
    launch counts (the check asserts them itself)."""
    r = chip_smoke.train_agreement(arch)
    assert r["adapters_diff"] <= 1e-4 and r["params_diff"] <= 1e-4
    assert r["near_eps_share"] <= chip_smoke.ADAMW_NEAR_EPS_SHARE


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_at_head_dim_256_matches_plain_version(
        cuda_device, dtype):
    """A gradient through gemma-7b's hd 256 (GQA, causal) runs the backward
    kernels, one launch, and agrees with the plain backward on the
    kernel's own output and lse under ``GRAD_TOL``."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q = _randn((2, 300, 8, 256), g, cuda_device, dtype).requires_grad_()
    k = _randn((2, 300, 4, 256), g, cuda_device, dtype).requires_grad_()
    v = _randn((2, 300, 4, 256), g, cuda_device, dtype).requires_grad_()
    do = _randn((2, 300, 8, 256), g, cuda_device, dtype)
    before = ops.launches["flash_attention_bwd"]
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_bwd"] == before + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o2, lse = ops.flash_attention_fwd(qd, kd, vd, causal=True, window=None,
                                      scale=256 ** -0.5, with_lse=True)
    want = ref.flash_attention_bwd(qd, kd, vd, o2, lse, do, causal=True,
                                   window=None, scale=256 ** -0.5)
    for got, w in zip(grads, want):
        err = chip_smoke.attention_error(got, w, chip_smoke.GRAD_TOL)
        assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("arch", chip_smoke.LLM_ARCHS)
def test_smoke_transformer_on_the_card_matches_the_cpu(cuda_device, arch):
    """Each arch's smoke config in fp32 (qwen3, zamba2, the dense configs at
    hd 24, 32, 48 and 64, and the MoE, MLA, enc-dec and VLM configs), the
    same params and tokens on both devices: forward loss and 40 decode
    steps' logits within 1e-4, with the kernels' launch counts (the check
    asserts them itself: deepseek's MLA launches no attention kernel)."""
    r = chip_smoke.llm_agreement(arch)
    assert r["logit_diff"] <= 1e-4
    assert r["launches"]["cuda"]["decode_attention"] == \
        r["expected"]["decode_attention"]


# ---------------------------------------------------------------------------
# fused LoRA matmul
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize(
    "t,d,o,r,dtype,x_offset,label", chip_smoke.LORA_CHECKS,
    ids=[f"{c[6]}-{c[0]}x{c[1]}x{c[2]}-r{c[3]}-{str(c[4])[6:]}"
         for c in chip_smoke.LORA_CHECKS])
def test_lora_matmul_kernel_matches_plain_version(cuda_device, t, d, o, r,
                                                 dtype, x_offset, label):
    """``chip_smoke.LORA_CHECKS``: ``tests/test_kernels.py``'s shapes in fp32
    and bf16, the ViT and qwen3 shapes and the bf16 kernel's edges (rank 64
    and 5, T = 16383, d = 300 and x at a base 2 bytes off 16, o short of a
    tile), one launch each, against the plain version in fp32
    (``chip_smoke.LORA_TOL``: 1e-4 of mean |want| for fp32, one bf16
    rounding for bf16)."""
    before = ops.launches["lora_matmul"]
    err = chip_smoke.lora_check(t, d, o, r, dtype, seed=t + d,
                                x_offset=x_offset)
    assert ops.launches["lora_matmul"] == before + 1
    assert err["ok"], err


@pytest.mark.gpu
def test_lora_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, w, a, b = chip_smoke.lora_inputs(16, 32, 24, 4, torch.float32, seed=0)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.lora_matmul(x, w, a.requires_grad_(), b, 2.0)
    a = a.detach()
    with pytest.raises(TypeError):
        ops.lora_matmul(x, w.to(torch.bfloat16), a, b, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lora_matmul(x, w.t().contiguous().t(), a, b, 2.0)
    wide = torch.zeros((32, ops.MAX_LORA_RANK + 1), device=cuda_device)
    with pytest.raises(ValueError, match="rank"):
        ops.lora_matmul(x, w, wide, torch.zeros((wide.shape[1], 24),
                                                device=cuda_device), 2.0)
    with pytest.raises(ValueError, match="different devices"):
        ops.lora_matmul(x, w, a, b.cpu(), 2.0)


# ---------------------------------------------------------------------------
# Mamba2 selective scan
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,dh,n", [
    (2, 64, 4, 8, 16), (1, 100, 2, 32, 64), (2, 128, 3, 16, 24),   # test_kernels
    (1, 1, 1, 1, 1), (2, 65, 2, 33, 7), (1, 300, 2, 128, 128), (3, 63, 5, 40, 64),
] + chip_smoke.SCAN_EDGES)
def test_selective_scan_kernel_matches_plain_version(cuda_device, B, S, H, dh, n):
    """One launch against the sequential plain version within
    2e-4 (1 + |want|) (``chip_smoke.scan_check``): the test cases, a single
    step, ragged chunks, dh past one row tile, the largest state and the
    kernel's tiling edges (``chip_smoke.SCAN_EDGES``)."""
    before = ops.launches["selective_scan"]
    err = chip_smoke.scan_check(B, S, H, dh, n, seed=S + n)
    assert ops.launches["selective_scan"] == before + 1
    assert err["ok"], err


@pytest.mark.gpu
@pytest.mark.parametrize("decay,shape", chip_smoke.SCAN_REGIMES)
def test_selective_scan_kernel_holds_the_decay_regimes(cuda_device, decay, shape):
    """No decay (the state grows over 4096 steps) and underflowing decays,
    against the exact recurrence (``chip_smoke.scan_regime_check``)."""
    err = chip_smoke.scan_regime_check(decay, *shape, seed=7)
    assert err["ok"], err


@pytest.mark.gpu
def test_selective_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    xdt, a_log, Bm, Cm = chip_smoke.scan_inputs(1, 8, 2, 4, 3, seed=0)
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(xdt, a_log, Bm.double(), Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(xdt.transpose(1, 2).contiguous().transpose(1, 2),
                           a_log, Bm, Cm)
    wide = torch.zeros((1, 8, ops.MAX_SCAN_STATE + 1), device=cuda_device)
    with pytest.raises(ValueError, match="state size"):
        ops.selective_scan(xdt, a_log, wide, wide)
    with pytest.raises(ValueError, match="different devices"):
        ops.selective_scan(xdt, a_log, Bm, Cm.cpu())
    empty = ops.selective_scan(xdt[:, :0], a_log[:, :0], Bm[:, :0], Cm[:, :0])
    assert empty.shape == (1, 0, 2, 4)


@pytest.mark.gpu
def test_selective_scan_gradient_on_the_card_is_the_backward_kernel(cuda_device):
    """A gradient through ``ops.selective_scan`` on the card runs the
    backward kernels (one launch count) and agrees with the plain backward
    on the same inputs within 2e-4 (1 + |want|)."""
    xdt, a_log, Bm, Cm, dy = chip_smoke.scan_bwd_inputs(2, 100, 3, 40, 24,
                                                        seed=5)
    leaves = [t.clone().requires_grad_() for t in (xdt, a_log, Bm, Cm)]
    before = dict(ops.launches)
    ops.selective_scan(*leaves).backward(dy)
    assert ops.launches["selective_scan"] == before["selective_scan"] + 1
    assert ops.launches["selective_scan_bwd"] == before["selective_scan_bwd"] + 1
    want = ref.selective_scan_bwd(xdt, a_log, Bm, Cm, dy)
    err = chip_smoke.scan_bwd_error([t.grad for t in leaves], want)
    assert err["ok"], err


@pytest.mark.gpu
def test_selective_scan_bwd_takes_the_forwards_states(cuda_device):
    """The forward writes the states beside y (``with_states``, as the
    autograd Function saves them) without changing y bit for bit; the
    backward given them repeats bit for bit, one launch count a call, and
    refuses to run without them or with states of another shape."""
    ins = chip_smoke.scan_bwd_inputs(2, 100, 3, 40, 24, seed=6)
    y, states = ops.selective_scan_fwd(*ins[:4], with_states=True)
    assert states.shape == (2, 3, 3, 40, 24) and states.dtype == torch.float32
    assert torch.equal(y, ops.selective_scan_fwd(*ins[:4]))
    before = ops.launches["selective_scan_bwd"]
    got = ops.selective_scan_bwd(*ins, states)
    again = ops.selective_scan_bwd(*ins, states)
    assert ops.launches["selective_scan_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for bad in (None, states[:, :, :2].contiguous()):
        with pytest.raises(ValueError, match="states"):
            ops.selective_scan_bwd(*ins, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", chip_smoke.SCAN_BWD_CHECKS)
def test_selective_scan_bwd_kernel_matches_plain_version(cuda_device, shape):
    """``chip_smoke.scan_bwd_check``: the backward kernel against the
    chunked plain backward within 2e-4 (1 + |want|) on each gradient, and
    a second launch bitwise equal to the first, at ``[scan-bwd]``'s
    shapes (zamba2-1.2b's train shape, B=4 x S=4096, n 16 and 128, S and
    dh off the kernel's tiles, the JAX test's shapes, a single step)."""
    before = ops.launches["selective_scan_bwd"]
    err = chip_smoke.scan_bwd_check(*shape, seed=sum(shape))
    assert ops.launches["selective_scan_bwd"] == before + 2
    assert err["ok"] and err["bitwise"], err


@pytest.mark.gpu
@pytest.mark.parametrize("decay,shape", chip_smoke.SCAN_REGIMES)
def test_selective_scan_bwd_kernel_holds_the_decay_regimes(cuda_device, decay,
                                                          shape):
    """No decay and underflowing decays against the fp64 plain backward
    (``chip_smoke.scan_bwd_regime_check``: the limit, or with no decay each
    gradient's RMS error within ``SCAN_BWD_REGIME_RATIO`` of the fp32 plain
    backward's)."""
    err = chip_smoke.scan_bwd_regime_check(decay, *shape, seed=9)
    assert err["ok"], err


@pytest.mark.gpu
def test_smoke_zamba2_on_the_card_matches_the_cpu(cuda_device):
    """zamba2-1.2b-smoke in fp32 on both devices: hidden states and loss
    within 1e-4 and the same greedy tokens, with the kernels' launch counts
    (the check asserts them itself)."""
    r = chip_smoke.ssm_agreement()
    assert r["hidden_diff"] <= 1e-4 and r["launches"]["cuda"]["selective_scan"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode,name", [("async", "fedauto_async"),
                                       ("buffered", "fedauto_async"),
                                       ("async", "fedbuff"),
                                       ("async", "fedasync")])
def test_async_runner_on_the_card_matches_the_cpu(cuda_device, mode, name):
    """The async server (stale uploads through ``float_fedagg`` and, where
    a step holds none, ``fedagg``) 4 rounds on the toy cnn: every leaf
    within 1e-4 of the CPU run, participants, staleness and clock equal
    (``chip_smoke.async_toy_agreement`` asserts those)."""
    assert chip_smoke.async_toy_agreement(mode, name) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("mode,name,codec", chip_smoke.TELEMETRY_AGREE)
def test_telemetry_on_the_card_matches_the_cpu(cuda_device, mode, name,
                                              codec):
    """The toy cnn with ``telemetry="full"``, 3 rounds on the card and on
    the CPU: both flight records reconcile; outcomes, resolutions, rungs,
    bytes, participants and counters equal, β within 1e-5, distortions
    within 1e-3·|d| + 1e-6 (``chip_smoke.telemetry_toy_agreement``)."""
    res = chip_smoke.telemetry_toy_agreement(mode, name, codec)
    if codec == "fp32":
        assert res["params"] <= 1e-4, res


@pytest.mark.gpu
def test_telemetry_round_on_the_card_is_the_round_without_it(cuda_device):
    """One sync FedAuto round of the toy cnn on the card, telemetry off and
    full, each from the same init and minibatch stream, under
    ``cudnn.deterministic``: the params bitwise equal, the same launches,
    and the full run's record reconciles with every phase inside its
    round's wall."""
    from repro_torch.core.strategies import FedAuto
    from repro_torch.fl.runtime import FFTConfig
    from repro_torch.fl.toy import make_toy_runner
    from repro_torch.models.vision import make_model
    from repro_torch.obs import reconcile
    from repro_torch.tree import tree_leaves, tree_map
    p0 = make_model("cnn", 4, 8, 1, device="cpu")[0](0)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for tel in (False, "full"):
            rng = np.random.default_rng(5)
            r = make_toy_runner(
                FFTConfig(n_clients=6, k_selected=6, local_steps=2,
                          batch_size=8, lr=0.05, seed=0, eval_every=1,
                          telemetry=tel, **chip_smoke.AGREE_ASYNC),
                n_samples=600, public_per_class=10, pretrain_steps=0,
                init_fn=lambda seed: tree_map(lambda x: x.to("cuda"), p0),
                batch_indices=lambda n, E, bs: torch.as_tensor(
                    rng.integers(0, n, (E, bs)), device="cuda"))
            ops.reset_launches()
            r.run(FedAuto(), 1)
            out[tel] = ([l.cpu() for l in tree_leaves(r.global_params)],
                        dict(ops.launches), r)
    finally:
        torch.backends.cudnn.deterministic = saved
    (p_off, l_off, _), (p_on, l_on, r_on) = out[False], out["full"]
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))
    assert l_off == l_on and l_on["float_fedagg"] > 0
    reconcile(r_on.report, r_on)
    chip_smoke.phase_rows(r_on.report)


@pytest.mark.parametrize("arch", chip_smoke.TRAIN_AGREE_ARCHS)
def test_adamw_near_eps_rule_leaves_out_few_elements(arch, one_torch_thread):
    """``train_agreement``'s AdamW steps (2 of its 5) on the CPU: the
    elements whose gradient was nonzero and under ``ADAMW_NEAR_EPS`` at
    some step (left out of the params check) are at most
    ``ADAMW_NEAR_EPS_SHARE`` of the params: exactly zero gradients
    (starcoder2-7b-smoke's embedding rows that no token of a batch reads,
    17 % of its params) are not among them.  Torch runs on one thread, as
    the runner test files do, beside the test suite's other workers."""
    cfg, p0, data, near_eps = chip_smoke.agreement_problem(arch, 0, 2)
    _, losses, launches = chip_smoke.adamw_steps(cfg, p0, data, "cpu",
                                                 near_eps)
    share = (sum(int(m.sum()) for m in near_eps)
             / sum(m.numel() for m in near_eps))
    assert 0 < share <= chip_smoke.ADAMW_NEAR_EPS_SHARE
    assert len(losses) == 2 and not any(launches.values())
