"""Device dispatch for the port's kernels.

A tensor on the CPU goes to the plain version in ``kernels.ref``; a tensor
on a CUDA device goes to the hand-written kernel (``csrc/fedagg.cu``,
``csrc/attention.cu``, ``csrc/attention_bwd.cu``, ``csrc/lora_matmul.cu``,
``csrc/selective_scan.cu``, ``csrc/selective_scan_bwd.cu``,
``csrc/topk_fedagg.cu``), or the wrapper raises.
There is no mode switch and no fallback: a kernel that fails to build or
launch is an error.

``launches[name]`` counts the kernel launches of each wrapper (CPU calls
are not counted), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import contextlib
import math
import operator
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref as _ref

launches: Dict[str, int] = {"float_fedagg": 0, "dequant_fedagg": 0,
                            "fedagg": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0, "decode_attention": 0,
                            "decode_attention_partial": 0,
                            "lora_matmul": 0, "selective_scan": 0,
                            "selective_scan_bwd": 0, "topk_fedagg": 0}

MAX_M = 12288          # the coefficients live in 48 KB of shared memory


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _device(x: torch.Tensor, *others: torch.Tensor) -> torch.device:
    devs = {x.device} | {o.device for o in others}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    return x.device


def _on_cpu(x: torch.Tensor, *others: torch.Tensor) -> bool:
    dev = _device(x, *others)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(name: str, x: torch.Tensor, dtypes: Tuple[torch.dtype, ...],
           *vectors: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a (M, P) matrix, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: x dtype {x.dtype} not in {dtypes}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    M = x.shape[0]
    if not 1 <= M <= MAX_M:
        raise ValueError(f"{name}: M={M} outside [1, {MAX_M}]")
    for v in vectors:
        if v.shape != (M,):
            raise ValueError(f"{name}: expected a ({M},) coefficient vector, "
                             f"got {tuple(v.shape)}")


def _run_kernel(entry: str, name: str, x: torch.Tensor, *args) -> None:
    """Launch C entry ``entry`` of the kernel library on ``x``'s device and
    current stream, raise on a launch error, and count the launch.  The
    device guard is entered only when ``x`` lies on another device than the
    current one."""
    from repro_torch.kernels.build import load
    here = x.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(load(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel {entry} launch failed with CUDA "
                           f"error {err}")
    launches[name] += 1


def _launch(entry: str, x: torch.Tensor, coef: torch.Tensor,
            out: torch.Tensor, name: str) -> torch.Tensor:
    M, P = x.shape
    if P == 0:
        return out
    coef = coef.to(torch.float32).contiguous()
    _run_kernel(entry, name, x, x.data_ptr(), coef.data_ptr(), out.data_ptr(),
                M, P)
    return out


def float_fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp16/fp32; betas: (M,) -> (P,) fp32 = Σ_m β_m x[m]."""
    if _on_cpu(stacked, betas):
        return _ref.float_fedagg(stacked, betas)
    _check("float_fedagg", stacked, (torch.float32, torch.float16), betas)
    out = torch.empty(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    entry = ("coef_reduce_f32" if stacked.dtype == torch.float32
             else "coef_reduce_f16")
    return _launch(entry, stacked, betas, out, "float_fedagg")


def dequant_fedagg(q: torch.Tensor, scales: torch.Tensor,
                   betas: torch.Tensor) -> torch.Tensor:
    """q: (M, P) int8; scales, betas: (M,) -> (P,) fp32
    = Σ_m (β_m·s_m)·q[m].  On the card one kernel folds c_m = β_m·s_m (one
    fp32 product) as it loads its coefficients; scales and betas are
    converted only where they are not fp32 and contiguous already."""
    if _on_cpu(q, scales, betas):
        return _ref.dequant_fedagg(q, scales, betas)
    _check("dequant_fedagg", q, (torch.int8,), scales, betas)
    M, P = q.shape
    out = torch.empty(P, dtype=torch.float32, device=q.device)
    if P == 0:
        return out
    scales = scales.to(torch.float32).contiguous()
    betas = betas.to(torch.float32).contiguous()
    _run_kernel("dequant_fedagg_i8", "dequant_fedagg", q, q.data_ptr(),
                scales.data_ptr(), betas.data_ptr(), out.data_ptr(), M, P)
    return out


def fedagg(stacked: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """stacked: (M, P) fp32/bf16; betas: (M,) -> (P,) in stacked's dtype
    = Σ_m β_m stacked[m], accumulated in fp32 (Eq. 7)."""
    if _on_cpu(stacked, betas):
        return _ref.fedagg(stacked, betas)
    _check("fedagg", stacked, (torch.float32, torch.bfloat16), betas)
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype,
                      device=stacked.device)
    entry = "fedagg_f32" if stacked.dtype == torch.float32 else "fedagg_bf16"
    return _launch(entry, stacked, betas, out, "fedagg")


def topk_fedagg(idx: torch.Tensor, vals: torch.Tensor, betas: torch.Tensor,
                n: int) -> torch.Tensor:
    """idx: (M, k) int32, indices unique within a row; vals: (M, k) fp32;
    betas: (M,) -> (n,) fp32 = Σ_m β_m·scatter(idx[m], vals[m]), folded
    over m in order (bit for bit the plain version's).  On the card the
    one-leaf case of ``topk_fedagg_into``'s kernels, which read the rows of
    the two matrices in place (no row table to build and copy) and write
    the fold into a fresh output: one launch count.  Rows sorted ascending (as
    ``TopKCodec`` sends them) take the fast path; an unsorted row is summed
    right by a whole-row scan; an index outside [0, n) is dropped on the
    card (the plain version raises)."""
    if idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"topk_fedagg: expected (M, k) idx and vals, got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    M, k = idx.shape
    if idx.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"topk_fedagg: idx {idx.dtype} / vals {vals.dtype}; "
                        "expected int32 / float32")
    if not idx.is_contiguous() or not vals.is_contiguous():
        raise ValueError("topk_fedagg: idx and vals must be contiguous")
    if not 1 <= M <= MAX_M:
        raise ValueError(f"topk_fedagg: M={M} outside [1, {MAX_M}]")
    if betas.shape != (M,):
        raise ValueError(f"topk_fedagg: expected a ({M},) coefficient "
                         f"vector, got {tuple(betas.shape)}")
    n = int(n)
    if not 1 <= n < 2 ** 31 or not 1 <= k < 2 ** 31:
        raise ValueError(f"topk_fedagg: n={n}, k={k} outside [1, 2^31)")
    if _on_cpu(idx, vals, betas):
        return _ref.topk_fedagg(idx, vals, betas, n)
    out = torch.empty(n, dtype=torch.float32, device=idx.device)
    betas = betas.to(torch.float32).contiguous()
    _topk_launch(_ONE_LEAF, out, (n,), (k,), M, None, betas.data_ptr(),
                 (idx.data_ptr(), vals.data_ptr(), out.data_ptr()),
                 accumulate=False)
    return out


def topk_fedagg_into(accs: Sequence[torch.Tensor],
                     idx_rows: Sequence[Sequence[torch.Tensor]],
                     val_rows: Sequence[Sequence[torch.Tensor]],
                     betas, plan: Optional["TopkPlan"] = None) -> None:
    """One flush of sparse top-k payloads into every leaf of an fp32
    accumulator, in place: ``accs[l] += Σ_m β_m·scatter(idx_rows[m][l],
    val_rows[m][l])``, the sum folded over m in order from zeros and then
    added (bit for bit ``accs[l].add_(topk_fedagg(stack(idx_rows[:][l]),
    ...))``, leaf by leaf, which is what the CPU runs).  ``idx_rows[m][l]``
    and ``val_rows[m][l]`` are payload m's leaf l: k_l int32 indices
    (unique) and k_l fp32 values, contiguous, the same k_l for every m.
    ``betas``: an (M,) tensor on the rows' device, or M floats.  ``plan``:
    a ``TopkPlan`` that the caller keeps between flushes of one set of
    leaves (a ``StreamAccumulator`` holds one); without it the call makes
    its own.

    On the card: one launch count for the whole flush, two kernels over
    every leaf and row, which read each row where it lies through a table
    of row pointers (``topk_row_table``: one non-blocking copy from a fresh
    pinned buffer, β with it when given as floats) and add the fold into
    ``accs`` themselves: no stack, no partial leaf, no ``add_``."""
    L, M = len(accs), len(idx_rows)
    if L == 0:
        raise ValueError("topk_fedagg_into: no accumulator leaves")
    if not 1 <= M <= MAX_M:
        raise ValueError(f"topk_fedagg_into: M={M} outside [1, {MAX_M}]")
    if len(val_rows) != M or any(len(r) != L for r in idx_rows) or any(
            len(r) != L for r in val_rows):
        raise ValueError(f"topk_fedagg_into: expected {M} x {L} index and "
                         "value rows")
    on_host = not isinstance(betas, torch.Tensor)
    if on_host:
        betas = np.asarray(betas, dtype=np.float32)
    if tuple(betas.shape) != (M,):
        raise ValueError(f"topk_fedagg_into: expected a ({M},) coefficient "
                         f"vector, got {tuple(betas.shape)}")
    flat_i = [t for r in idx_rows for t in r]
    flat_v = [t for r in val_rows for t in r]
    tensors = flat_i + flat_v + list(accs)
    devs = set(map(_DEVICE, tensors))
    if not on_host:
        devs.add(betas.device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    if set(map(_DTYPE, flat_i)) != {torch.int32} or set(
            map(_DTYPE, flat_v)) != {torch.float32} or set(
            map(_DTYPE, accs)) != {torch.float32}:
        raise TypeError("topk_fedagg_into: expected int32 indices, float32 "
                        "values and float32 accumulator leaves")
    if not all(map(torch.Tensor.is_contiguous, tensors)):
        raise ValueError("topk_fedagg_into: rows and accumulator leaves must "
                         "be contiguous")
    ks = np.fromiter(map(torch.Tensor.numel, flat_i), np.int64, M * L)
    kv = np.fromiter(map(torch.Tensor.numel, flat_v), np.int64, M * L)
    ks, kv = ks.reshape(M, L), kv.reshape(M, L)
    if (ks != ks[0]).any() or (kv != ks).any():
        raise ValueError("topk_fedagg_into: every row of a leaf needs the "
                         "same k, in its indices and its values")
    ns = tuple(int(a.numel()) for a in accs)
    k0 = tuple(int(k) for k in ks[0])
    if not all(1 <= n < 2 ** 31 for n in ns) or not all(
            1 <= k < 2 ** 31 for k in k0):
        raise ValueError(f"topk_fedagg_into: leaf sizes {ns} or k {k0} "
                         "outside [1, 2^31)")
    if _on_cpu(accs[0]):
        b = torch.from_numpy(betas) if on_host else betas
        for l, (acc, n) in enumerate(zip(accs, ns)):
            part = _ref.topk_fedagg(
                torch.stack([r[l].reshape(-1) for r in idx_rows]),
                torch.stack([r[l].reshape(-1) for r in val_rows]), b, n)
            acc.add_(part.view(acc.shape))
        return
    ptrs = np.fromiter(map(torch.Tensor.data_ptr, tensors), np.int64,
                       len(tensors))
    if not on_host:
        betas = betas.to(torch.float32).contiguous()
    _topk_launch(plan or TopkPlan(), accs[0], ns, k0, M, ptrs,
                 betas if on_host else betas.data_ptr(), None, accumulate=True)


_DEVICE = operator.attrgetter("device")
_DTYPE = operator.attrgetter("dtype")
_TOPK_GEOMETRY: Dict[int, int] = {}


def topk_geometry() -> Tuple[int, int]:
    """(outputs per tile, positions per check unit) of
    ``csrc/topk_fedagg.cu``, asked from the C side once."""
    if not _TOPK_GEOMETRY:
        from repro_torch.kernels.build import load
        for which in range(2):
            _TOPK_GEOMETRY[which] = int(load().topk_fedagg_geometry(which))
    return _TOPK_GEOMETRY[0], _TOPK_GEOMETRY[1]


class TopkPlan:
    """What a top-k flush needs on the card beyond its rows, kept between
    flushes: the int32 leaf table (n, k, first tile, first tile offset,
    first check unit of each leaf, then each tile's and each check unit's
    leaf), a device buffer for the row table, and the workspace (a flag per
    row, then each row's tile offsets), zeroed when allocated.  Each flush
    stamps faulty rows with a new epoch, so the flags are never cleared.
    Built at the first flush and again when the device, the stream or the
    leaf sizes change: its buffers are reused in one stream's order only."""

    def __init__(self):
        self.key = None

    def prepare(self, device: torch.device, stream: int,
                ns: Tuple[int, ...], ks: Tuple[int, ...], M: int) -> int:
        """Ready the plan for a flush of M rows a leaf; returns its epoch."""
        key = (device, stream, ns, ks)
        if self.key != key:
            tile, check = topk_geometry()
            n, k = np.asarray(ns, np.int64), np.asarray(ks, np.int64)
            tiles = -(-n // tile)
            units = -(-(k + 3) // check)  # a row may start 3 int32s past 16 bytes
            base = lambda c: np.concatenate([[0], np.cumsum(c)[:-1]])
            L = len(ns)
            self.L, self.T = L, int(tiles.sum())
            self.C, self.S = int(units.sum()), int((tiles + 1).sum())
            table = np.concatenate([n, k, base(tiles), base(tiles + 1),
                                    base(units), np.repeat(np.arange(L), tiles),
                                    np.repeat(np.arange(L), units)])
            self.table = torch.from_numpy(table.astype(np.int32)).to(device)
            self.rows: Optional[torch.Tensor] = None
            self.work = torch.empty(0, dtype=torch.int32, device=device)
            self.epoch, self.key = 0, key
        need = self.L * M + M * self.S
        if self.work.numel() < need or self.epoch >= 2 ** 31 - 1:
            self.work = torch.zeros(need, dtype=torch.int32, device=device)
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_ONE_LEAF = TopkPlan()     # ``topk_fedagg``'s


def topk_row_table(device: torch.device, ptrs: np.ndarray,
                   betas: Optional[np.ndarray] = None,
                   dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int64 row table on ``device``: ``ptrs``, then the fp32 ``betas``
    packed two to a slot, into a fresh pinned buffer (the host allocator
    keeps it until the copy has run, so a later flush never writes into a
    copy in flight), then one non-blocking copy into ``dst``, or into a new
    tensor where ``dst`` is too small."""
    nb = 0 if betas is None else (len(betas) + 1) // 2
    size = len(ptrs) + nb
    host = torch.empty(size, dtype=torch.int64, pin_memory=True)
    view = host.numpy()
    view[:len(ptrs)] = ptrs
    if nb:
        view[len(ptrs):].view(np.float32)[:len(betas)] = betas
    if dst is None or dst.numel() < size:
        dst = torch.empty(size, dtype=torch.int64, device=device)
    dst[:size].copy_(host, non_blocking=True)
    return dst


def _topk_launch(plan: TopkPlan, x: torch.Tensor, ns: Tuple[int, ...],
                 ks: Tuple[int, ...], M: int, ptrs: Optional[np.ndarray],
                 betas, mats, *, accumulate: bool) -> None:
    """Launch the flush's two kernels on ``x``'s device and current stream
    through ``plan``.  The rows come from the row table (``ptrs``: M·L index
    rows, M·L value rows, L outputs) or, for one leaf, from ``mats``: the
    (M, k) index and value matrices and the output.  ``betas`` is a device
    pointer, or host floats sent with the row table."""
    dev = x.device
    epoch = plan.prepare(dev, torch.cuda.current_stream(dev).cuda_stream, ns,
                         ks, M)
    rows, mats = 0, mats or (0, 0, 0)
    if ptrs is not None:
        host_betas = isinstance(betas, np.ndarray)
        plan.rows = topk_row_table(dev, ptrs, betas if host_betas else None,
                                   plan.rows)
        rows = plan.rows.data_ptr()
        if host_betas:
            betas = rows + 8 * len(ptrs)
    _run_kernel("topk_fedagg_flush", "topk_fedagg", x, plan.table.data_ptr(),
                rows, betas, plan.work.data_ptr(), *mats, plan.L, M, plan.T,
                plan.C, plan.S, plan.work.numel(), epoch, int(accumulate))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
ATTN_DTYPES = (torch.float32, torch.bfloat16)
# The forward, backward and decode kernels' head dims: multiples of 8 in
# [8, 256], each run on the next of 32, 64, 128, 256 up with its columns
# past hd zero-filled inside the kernel.
HEAD_DIM_RULE = "a multiple of 8 in [8, 256]"
# decode: the kernel's number of cache splits per (device, dtype, shape)
_DECODE_SPLITS: Dict[tuple, int] = {}


def _check_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, sq: Optional[int] = None) -> None:
    """Shapes and dtypes every device must agree on: q (B,Sq,H,hd),
    k/v (B,Sk,KV,hd) of one dtype, H a multiple of KV."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected 4-d q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "differ")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    KV = k.shape[2]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{name}: {H} query heads are not a multiple of "
                         f"{KV} KV heads")
    if sq is not None and Sq != sq:
        raise ValueError(f"{name}: expected {sq} query token(s), got {Sq}")
    if q.dtype not in ATTN_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; expected one of {ATTN_DTYPES} for all")


def _check_launchable(name: str, *ts: torch.Tensor) -> None:
    hd = ts[0].shape[-1]
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"{name}: head dim {hd} is not {HEAD_DIM_RULE}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) fp32/bf16 -> (B,Sq,H,hd) in q's
    dtype: causal and/or sliding-window GQA attention.  Differentiable: the
    forward keeps the row log-sum-exp, and the backward runs
    ``flash_attention_bwd`` (the plain version on the CPU, the kernels of
    ``csrc/attention_bwd.cu`` on the card)."""
    _check_attention("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), window,
                                     float(scale))
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=float(scale), with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    """Saves q, k, v, the output and lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, scale = ctx.attrs
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q, k, v, *, causal: bool, window: Optional[int],
                        scale: float, with_lse: bool):
    """(out, lse or None): the forward kernel, which writes the (B, H, Sq)
    fp32 row log-sum-exp (natural log) when ``with_lse``, or its plain
    version on the CPU."""
    if _on_cpu(q, k, v):
        if with_lse:
            return _ref.flash_attention_lse(q, k, v, causal=causal,
                                            window=window, scale=scale)
        return _ref.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale), None
    _check_launchable("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Sk == 0:
        raise ValueError("flash_attention: no keys")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if Sq == 0:
        return out, lse
    entry = ("flash_attention_f32" if q.dtype == torch.float32
             else "flash_attention_bf16")
    _run_kernel(entry, "flash_attention", q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                0 if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, hd,
                int(bool(causal)), int(window or 0), float(scale))
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                        window: Optional[int], scale: float):
    """(dq, dk, dv) in the inputs' dtypes from the forward's saved output
    and lse.  On the card three kernels (``csrc/attention_bwd.cu``: the row
    dot D = rowsum(dO ∘ O), with lse·log2e in bf16, into a workspace the
    wrapper allocates, then dK and dV per key tile with each GQA group
    summed in the block, then dQ per query tile; in bf16 every product on
    ``wgmma``; no atomics, so the result repeats bit for bit), one launch
    count under ``flash_attention_bwd``.  Head dims as the forward's
    (``HEAD_DIM_RULE``)."""
    if _on_cpu(q, k, v, out, lse, dout):
        return _ref.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                        window=window, scale=scale)
    dout, lse = dout.contiguous(), lse.contiguous()
    if dout.dtype != q.dtype or dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)} "
                         f"{dout.dtype} and out {tuple(out.shape)} must match "
                         f"q {tuple(q.shape)} {q.dtype}")
    _check_launchable("flash_attention_bwd", q, k, v, out, dout)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    # D and lse·log2e per (b, h) row, rows padded to a multiple of 128
    work = torch.empty(2 * B * H * -(-Sq // 128) * 128, dtype=torch.float32,
                       device=q.device)
    entry = ("flash_attention_bwd_f32" if q.dtype == torch.float32
             else "flash_attention_bwd_bf16")
    _run_kernel(entry, "flash_attention_bwd", q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, hd,
                int(bool(causal)), int(window or 0), float(scale))
    return dq, dk, dv


def decode_splits(q: torch.Tensor, k: torch.Tensor) -> int:
    """The decode kernel's number of cache splits for q (B,1,H,hd) against
    k (B,S,KV,hd) on their CUDA device: the C side's rule (as many blocks
    as the card holds at once), asked once per (device, dtype, shape)."""
    (B, _, H, hd), S, KV = q.shape, k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    key = (q.device, bf16, B, S, H, KV, hd)
    if key not in _DECODE_SPLITS:
        from repro_torch.kernels.build import load
        with torch.cuda.device(q.device):
            n = load().decode_attention_splits(B, S, H, KV, hd, int(bf16))
        if n <= 0:
            raise RuntimeError(f"decode_attention: no split count for B={B} "
                               f"S={S} H={H} KV={KV} hd={hd} (CUDA error {-n})")
        _DECODE_SPLITS[key] = n
    return _DECODE_SPLITS[key]


def _check_decode(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, valid: torch.Tensor) -> bool:
    """The decode wrappers' checks; True where the inputs lie on the CPU."""
    if _device(q, k, v, valid).type != "cpu" and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(f"{name}: the kernel has no backward; "
                           "call it on tensors that do not require grad")
    _check_attention(name, q, k, v, sq=1)
    S = k.shape[1]
    if valid.shape != (S,) or valid.dtype != torch.bool:
        raise ValueError(f"{name}: expected a ({S},) bool validity "
                         f"vector, got {tuple(valid.shape)} {valid.dtype}")
    if _on_cpu(q, k, v, valid):
        return True
    _check_launchable(name, q, k, v)
    if S == 0:
        raise ValueError(f"{name}: empty cache")
    return False


def _decode_work(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """(n_split, the split kernel's workspace of partial results)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    n_split = decode_splits(q, k)
    return n_split, torch.empty(B * KV * n_split * (H // KV) * (hd + 2),
                                dtype=torch.float32, device=q.device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q: (B,1,H,hd), k/v: (B,S,KV,hd) fp32/bf16, valid: (S,) bool shared by
    the batch -> (B,1,H,hd) in q's dtype, forward only.  On the card the
    kernel splits S over blocks: the wrapper asks it for the number of
    splits (once per shape), allocates the partial results' workspace,
    B*KV*n_split*(H/KV)*(hd+2) floats, and counts one launch for the split
    and combine kernels."""
    if _check_decode("decode_attention", q, k, v, valid):
        return _ref.decode_attention(q, k, v, valid, scale=scale)
    B, S, KV, hd = k.shape
    valid = valid.contiguous()
    n_split, work = _decode_work(q, k)
    out = torch.empty_like(q)
    entry = ("decode_attention_f32" if q.dtype == torch.float32
             else "decode_attention_bf16")
    _run_kernel(entry, "decode_attention", q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), valid.data_ptr(), work.data_ptr(),
                out.data_ptr(), B, S, q.shape[2], KV, hd, n_split,
                float(scale))
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             scale: float):
    """One rank's part of the sequence-sharded decode: q (B,1,H,hd) against
    its slice k/v (B,S_loc,KV,hd) of the cache, valid (S_loc,) bool ->
    (m (B,KV,g), l (B,KV,g), o (B,KV,g,hd)), fp32, g = H/KV: the scaled,
    masked scores' max m, l = sum exp(s - m) and the unnormalised
    o = sum exp(s - m) v over the slice's valid keys; a slice with no valid
    key gives m = -1e30, l = 0, o = 0.  The caller combines the ranks'
    triples (``models/attention.py``).  On the card ``decode_attention``'s
    split kernel and its combine in its partial mode, which writes the
    triple in place of o / l; one launch count."""
    if _check_decode("decode_attention_partial", q, k, v, valid):
        return _ref.decode_attention_partial(q, k, v, valid, scale=scale)
    B, S, KV, hd = k.shape
    g = q.shape[2] // KV
    valid = valid.contiguous()
    n_split, work = _decode_work(q, k)
    m, l = (torch.empty((B, KV, g), dtype=torch.float32, device=q.device)
            for _ in range(2))
    o = torch.empty((B, KV, g, hd), dtype=torch.float32, device=q.device)
    entry = ("decode_attention_partial_f32" if q.dtype == torch.float32
             else "decode_attention_partial_bf16")
    _run_kernel(entry, "decode_attention_partial", q, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                work.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
                B, S, q.shape[2], KV, hd, n_split, float(scale))
    return m, l, o


# ---------------------------------------------------------------------------
# fused LoRA matmul
# ---------------------------------------------------------------------------
LORA_DTYPES = (torch.float32, torch.bfloat16)
MAX_LORA_RANK = 64     # the kernel's side product lives in registers


def lora_route(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> str:
    """The bf16 kernel's route for these operands: "tma" where TMA can map
    x, W and B (d and o multiples of 8, 16-byte aligned bases; the output
    and the Aᵀ workspace come from ``torch.empty``, aligned), else
    "cp.async" (the same kernel with a producer that copies by hand)."""
    D, O = x.shape[1], w.shape[1]
    ok = D > 0 and D % 8 == 0 and O % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, w, b))
    return "tma" if ok else "cp.async"


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scaling: float) -> torch.Tensor:
    """x: (T, d), w: (d, o), a: (d, r), b: (r, o), one dtype (fp32/bf16)
    -> (T, o) in x's dtype = x @ w + scaling * (x @ a) @ b, accumulated in
    fp32, forward only.  In bf16 on the card the wrapper allocates the
    kernel's Aᵀ workspace (r rows of d rounded up to 8) and picks its route
    (``lora_route``); one launch count covers the transpose and the
    product."""
    if _device(x, w, a, b).type != "cpu" and any(
            t.requires_grad for t in (x, w, a, b)):
        raise RuntimeError("lora_matmul: the kernel has no backward; call it "
                           "on tensors that do not require grad")
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"lora_matmul: expected 2-d x, w, a, b, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    (T, D), O, R = x.shape, w.shape[1], a.shape[1]
    if w.shape[0] != D or a.shape[0] != D or b.shape != (R, O):
        raise ValueError(f"lora_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not chain")
    if _on_cpu(x, w, a, b):
        return _ref.lora_matmul(x, w, a, b, scaling)
    if x.dtype not in LORA_DTYPES or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError(f"lora_matmul: dtypes {x.dtype}, {w.dtype}, {a.dtype}, "
                        f"{b.dtype}; expected one of {LORA_DTYPES} for all")
    if not 1 <= R <= MAX_LORA_RANK:
        raise ValueError(f"lora_matmul: rank {R} outside [1, {MAX_LORA_RANK}]")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("lora_matmul: inputs must be contiguous")
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    if T == 0 or O == 0:
        return out
    if x.dtype == torch.float32:
        _run_kernel("lora_matmul_f32", "lora_matmul", x, x.data_ptr(),
                    w.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    T, D, O, R, float(scaling))
        return out
    at = torch.empty(R * -(-D // 8) * 8, dtype=x.dtype, device=x.device)
    _run_kernel("lora_matmul_bf16", "lora_matmul", x, x.data_ptr(),
                w.data_ptr(), a.data_ptr(), b.data_ptr(), at.data_ptr(),
                out.data_ptr(), T, D, O, R, float(scaling),
                int(lora_route(x, w, b) == "tma"))
    return out


# ---------------------------------------------------------------------------
# Mamba2 selective scan (SSD)
# ---------------------------------------------------------------------------
MAX_SCAN_STATE = 128   # the kernel keeps a (rows, n) state tile per block
SCAN_KERNEL_CHUNK = 32  # kQ of csrc/selective_scan.cu


def selective_scan(xdt: torch.Tensor, a_log: torch.Tensor, B_mat: torch.Tensor,
                   C_mat: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """xdt: (B,S,H,dh) dt-scaled input, a_log: (B,S,H) = log a_t,
    B_mat/C_mat: (B,S,n), shared by the heads of a batch row -> y
    (B,S,H,dh) fp32 of h_t = a_t·h_{t-1} + xdt_t ⊗ B_t, y_t = C_t·h_t from
    a zero state.  ``chunk`` is the plain versions' chunk; the kernels tile
    S with their own (a tile choice: the function is the same).
    Differentiable: the forward keeps its inputs (on the card also the
    state at every chunk's start, which its kernel writes beside y), and
    the backward runs ``selective_scan_bwd`` (the plain version on the CPU,
    the kernels of ``csrc/selective_scan_bwd.cu`` on the card)."""
    if xdt.dim() != 4:
        raise ValueError(f"selective_scan: expected a 4-d xdt, got "
                         f"{tuple(xdt.shape)}")
    Bsz, S, H, dh = xdt.shape
    n = B_mat.shape[-1] if B_mat.dim() == 3 else -1
    if (a_log.shape != (Bsz, S, H) or B_mat.shape != (Bsz, S, n)
            or C_mat.shape != B_mat.shape):
        raise ValueError(f"selective_scan: xdt {tuple(xdt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, B {tuple(B_mat.shape)}, C "
                         f"{tuple(C_mat.shape)} do not match")
    if chunk < 1:
        raise ValueError(f"selective_scan: chunk {chunk} < 1")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, a_log, B_mat, C_mat)):
        return _SelectiveScan.apply(xdt, a_log, B_mat, C_mat, int(chunk))
    return selective_scan_fwd(xdt, a_log, B_mat, C_mat, chunk=chunk)


class _SelectiveScan(torch.autograd.Function):
    """Saves the inputs for the backward and, on the card, the states at
    the chunks' starts (under remat, those of the recomputed forward, held
    until its backward)."""

    @staticmethod
    def forward(ctx, xdt, a_log, B_mat, C_mat, chunk):
        ctx.chunk = chunk
        y, states = selective_scan_fwd(xdt, a_log, B_mat, C_mat, chunk=chunk,
                                       with_states=True)
        ctx.save_for_backward(xdt, a_log, B_mat, C_mat, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ins, states = ctx.saved_tensors
        grads = selective_scan_bwd(*ins, dy, states, chunk=ctx.chunk)
        return (*grads, None)


def _check_scan_launchable(name: str, n: int, *ts: torch.Tensor) -> None:
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name}: dtypes {', '.join(str(t.dtype) for t in ts)}"
                        "; expected float32 for all")
    if not 1 <= n <= MAX_SCAN_STATE:
        raise ValueError(f"{name}: state size {n} outside "
                         f"[1, {MAX_SCAN_STATE}]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")


def _scan_gram_floats(Bsz: int, S: int, n: int) -> int:
    """The Gram kernel's workspace: per (batch row, chunk of
    ``SCAN_KERNEL_CHUNK`` steps) C·Bᵀ and the TF32 parts of C and Bᵀ over n
    rounded up to 64 or 128 columns."""
    Q, n_pad = SCAN_KERNEL_CHUNK, 64 if n <= 64 else 128
    return Bsz * -(-S // Q) * Q * (Q + 4 * n_pad)


def selective_scan_fwd(xdt, a_log, B_mat, C_mat, *, chunk: int = 128,
                       with_states: bool = False):
    """``selective_scan``'s forward: the chunked plain version on the CPU;
    on the card the kernel, whose workspace (``_scan_gram_floats``) the
    wrapper allocates; one launch count for its two kernels.
    ``with_states`` returns (y, states) for ``selective_scan_bwd``: on the
    card the state at the start of every chunk of ``SCAN_KERNEL_CHUNK``
    steps but the first, (B, H, ceil(S / 32) - 1, dh, n), written by the
    same launch; on the CPU None (the plain backward recomputes them)."""
    Bsz, S, H, dh = xdt.shape
    n = B_mat.shape[-1]
    if _on_cpu(xdt, a_log, B_mat, C_mat):
        h0 = torch.zeros((Bsz, H, dh, n), dtype=xdt.dtype)
        y = _ref.ssd_chunked(xdt, a_log, B_mat, C_mat, h0, chunk)[0]
        return (y, None) if with_states else y
    _check_scan_launchable("selective_scan", n, xdt, a_log, B_mat, C_mat)
    out = torch.empty_like(xdt)
    states = torch.empty((Bsz, H, max(-(-S // SCAN_KERNEL_CHUNK) - 1, 0), dh, n)
                         if with_states else 0, dtype=torch.float32,
                         device=xdt.device)
    if out.numel() > 0:
        work = torch.empty(_scan_gram_floats(Bsz, S, n), dtype=torch.float32,
                           device=xdt.device)
        _run_kernel("selective_scan_f32", "selective_scan", xdt,
                    xdt.data_ptr(), a_log.data_ptr(), B_mat.data_ptr(),
                    C_mat.data_ptr(), work.data_ptr(), out.data_ptr(),
                    states.data_ptr() if states.numel() else None, Bsz, S, H,
                    dh, n, work.numel())
    return (out, states) if with_states else out


def selective_scan_bwd(xdt, a_log, B_mat, C_mat, dy, states, *,
                       chunk: int = SCAN_KERNEL_CHUNK):
    """(dxdt, da_log, dB, dC) in fp32 from the forward's inputs, the
    states ``selective_scan_fwd(..., with_states=True)`` returned with y,
    and dy; dB and dC summed over the heads.  The plain version
    (``ref.selective_scan_bwd``, by chunks of ``chunk``, which recomputes
    the states) on the CPU.  On the card the kernels of
    ``csrc/selective_scan_bwd.cu`` (the forward's Gram kernel with B and C
    swapped, the reverse walk over the chunks on the tensor cores, the sums
    over heads in a fixed order; no atomics, so the result repeats bit for
    bit); one launch count under ``selective_scan_bwd``.  Its workspace
    (``scan_bwd_work_floats``) the wrapper allocates."""
    if _on_cpu(xdt, a_log, B_mat, C_mat, dy):
        return _ref.selective_scan_bwd(xdt, a_log, B_mat, C_mat, dy,
                                       chunk=chunk)
    Bsz, S, H, dh = xdt.shape
    n = B_mat.shape[-1]
    dy = dy.contiguous()
    if dy.shape != xdt.shape:
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} must "
                         f"match xdt {tuple(xdt.shape)}")
    _check_scan_launchable("selective_scan_bwd", n, xdt, a_log, B_mat, C_mat,
                           dy)
    dxdt, da_log = torch.empty_like(xdt), torch.empty_like(a_log)
    dB, dC = torch.empty_like(B_mat), torch.empty_like(C_mat)
    if xdt.numel() == 0:
        return dxdt.zero_(), da_log.zero_(), dB.zero_(), dC.zero_()
    nc = -(-S // SCAN_KERNEL_CHUNK)
    if states is None or (
            states.shape != (Bsz, H, nc - 1, dh, n) or
            states.dtype != torch.float32 or not states.is_contiguous() or
            states.device != xdt.device):
        got = None if states is None else (tuple(states.shape), states.dtype)
        raise ValueError(f"selective_scan_bwd: states {got} are not the "
                         f"forward's {(Bsz, H, nc - 1, dh, n)} float32")
    work = torch.empty(scan_bwd_work_floats(Bsz, S, H, dh, n),
                       dtype=torch.float32, device=xdt.device)
    _run_kernel("selective_scan_bwd_f32", "selective_scan_bwd", xdt,
                xdt.data_ptr(), a_log.data_ptr(), B_mat.data_ptr(),
                C_mat.data_ptr(), dy.data_ptr(),
                states.data_ptr() if states.numel() else None,
                work.data_ptr(), dxdt.data_ptr(), da_log.data_ptr(),
                dB.data_ptr(), dC.data_ptr(), Bsz, S, H, dh, n, work.numel())
    return dxdt, da_log, dB, dC


def scan_bwd_work_floats(Bsz: int, S: int, H: int, dh: int, n: int) -> int:
    """The backward kernels' workspace in floats: the Gram kernel's; dB and
    dC per (head, 128 head-dim rows); da_log per (128 rows, 64 state
    columns) and dxdt per 64 columns where there are several."""
    tiles, slices = -(-dh // 128), -(-n // 64)
    parts = tiles * slices
    nda = Bsz * S * H * parts if parts > 1 else 0
    ndx = Bsz * S * H * dh * slices if slices > 1 else 0
    return (_scan_gram_floats(Bsz, S, n) + 2 * Bsz * S * H * tiles * n
            + nda + ndx)
