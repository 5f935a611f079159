"""Times this tree's Mamba2 scan kernels in turns with another version's on
one card.

The other versions are built from their sources into libraries of their
own in a temporary directory:

* ``--parent DIR``: the ``selective_scan.cu``, ``selective_scan_bwd.cu``
  and ``hopper.cuh`` of a version before the forward wrote its states
  (``selective_scan_f32`` without a states argument, a backward that
  computes its own states), as ``git show <commit>:src/repro_torch/
  kernels/csrc/<file>`` prints them;
* ``--other DIR`` (optional): the same files, and ``selective_scan.cuh``,
  of a version with this tree's interface.

At zamba2-1.2b's train shape and at B=4 x S=4096 it prints, each in turns
(``chip_smoke.cuda_times``): the forward without and with its states, and
the backward given this tree's forward's states, against the parent's
forward and backward (and the other's forward), with how far each
version's results lie from this tree's.  ``--phases`` also times the
backward's chunk kernel with one phase at a time left out
(``SCAN_BWD_SKIPS``: throwaway builds whose results are wrong, only their
time counts; the anchors fit this version of ``selective_scan_bwd.cu``,
and the script raises where one no longer does).

    mkdir -p build/parent && for f in selective_scan.cu selective_scan_bwd.cu hopper.cuh; do
      git show <commit>:src/repro_torch/kernels/csrc/$f > build/parent/$f; done
    PYTHONPATH=src python tools/scan_turns.py --parent build/parent [--phases]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int64


def _nvcc(out, name, srcs, include):
    """Starts nvcc on ``srcs`` into ``out/name.so``; returns (so, process)."""
    so = os.path.join(out, f"{name}.so")
    proc = subprocess.Popen([build.find_nvcc(), *build.COMPILE_FLAGS, "-shared",
                             "-I", include, "-o", so, *srcs],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return so, proc


def _finish(name, so, proc):
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{err}")
    for line in (out + err).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[scan-turns] {name}: {line.strip()}")
    return ctypes.CDLL(so)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def parent_fns(lib):
    """fwd(xdt, a_log, B, C) -> y and bwd(xdt, a_log, B, C, dy) -> the four
    gradients, under the interface before the forward wrote its states."""
    fwd, bwd = lib.selective_scan_f32, lib.selective_scan_bwd_f32
    fwd.argtypes, fwd.restype = [P] * 6 + [I] * 6 + [P], ctypes.c_int
    bwd.argtypes, bwd.restype = [P] * 10 + [I] * 6 + [P], ctypes.c_int

    def run_fwd(xdt, a_log, Bm, Cm):
        Bsz, S, H, dh = xdt.shape
        n = Bm.shape[-1]
        y = torch.empty_like(xdt)
        work = torch.empty(ops._scan_gram_floats(Bsz, S, n), device=xdt.device)
        err = fwd(*(t.data_ptr() for t in (xdt, a_log, Bm, Cm, work, y)),
                  Bsz, S, H, dh, n, work.numel(), _stream())
        if err:
            raise RuntimeError(f"the parent's scan forward: CUDA error {err}")
        return y

    def run_bwd(xdt, a_log, Bm, Cm, dy):
        Bsz, S, H, dh = xdt.shape
        n = Bm.shape[-1]
        nc, tiles = -(-S // 32), -(-dh // 64)
        work = torch.empty(Bsz * H * tiles * ((nc - 1) * 64 * n + S * (2 * n + 1)),
                           device=xdt.device)
        outs = [torch.empty_like(t) for t in (xdt, a_log, Bm, Cm)]
        err = bwd(*(t.data_ptr() for t in (xdt, a_log, Bm, Cm, dy, work, *outs)),
                  Bsz, S, H, dh, n, work.numel(), _stream())
        if err:
            raise RuntimeError(f"the parent's scan backward: CUDA error {err}")
        return outs
    return run_fwd, run_bwd


def other_fwd(lib):
    """fwd(xdt, a_log, B, C) -> y under this tree's interface (no states)."""
    fwd = lib.selective_scan_f32
    fwd.argtypes, fwd.restype = build.ENTRIES["selective_scan_f32"], ctypes.c_int

    def run(xdt, a_log, Bm, Cm):
        Bsz, S, H, dh = xdt.shape
        n = Bm.shape[-1]
        y = torch.empty_like(xdt)
        work = torch.empty(ops._scan_gram_floats(Bsz, S, n), device=xdt.device)
        err = fwd(*(t.data_ptr() for t in (xdt, a_log, Bm, Cm, work, y)), None,
                  Bsz, S, H, dh, n, work.numel(), _stream())
        if err:
            raise RuntimeError(f"the other scan forward: CUDA error {err}")
        return y
    return run


def turns(shape, iters, parent, other):
    """One shape: every call in turns, and the agreements."""
    ins = c.scan_bwd_inputs(*shape, seed=11)
    p_fwd, p_bwd = parent
    y, states = ops.selective_scan_fwd(*ins[:4], with_states=True)
    grads = ops.selective_scan_bwd(*ins, states)
    ey = c.scan_error(p_fwd(*ins[:4]), y)
    eg = c.scan_bwd_error(p_bwd(*ins), grads)
    y0 = ops.selective_scan_fwd(*ins[:4])
    print(f"[scan-turns] {shape}: this tree's y without states bitwise the y "
          f"with them: {torch.equal(y0, y)}; the parent's against this tree's: "
          f"y share_of_limit={ey['share_of_limit']:.4f}, gradients "
          f"{eg['shares']}")
    names = ["forward", "forward with states", "backward given the states",
             "parent forward", "parent backward"]
    fns = [lambda: ops.selective_scan_fwd(*ins[:4]),
           lambda: ops.selective_scan_fwd(*ins[:4], with_states=True),
           lambda: ops.selective_scan_bwd(*ins, states),
           lambda: p_fwd(*ins[:4]), lambda: p_bwd(*ins)]
    if other is not None:
        eo = c.scan_error(other(*ins[:4]), y)
        print(f"[scan-turns] {shape}: the other's y against this tree's: "
              f"share_of_limit={eo['share_of_limit']:.4f}")
        names.append("other forward")
        fns.append(lambda: other(*ins[:4]))
    ms = dict(zip(names, c.cuda_times(fns, iters)))
    print(f"[scan-turns] {shape} fp32, ms (median [q1, q3] in turns): "
          + "; ".join(f"{k} {float(m):.4f} [{m.q1:.4f}, {m.q3:.4f}]"
                      for k, m in ms.items()))
    print(f"[scan-turns] {shape}: backward {float(ms['parent backward']) / float(ms['backward given the states']):.2f}x "
          f"the parent's; forward with states + backward "
          f"{float(ms['forward with states']) + float(ms['backward given the states']):.4f} "
          f"against the parent's forward + backward "
          f"{float(ms['parent forward']) + float(ms['parent backward']):.4f}; "
          f"forward over the parent's "
          f"{float(ms['forward']) / float(ms['parent forward']):.4f}")
    del ins, y, states, grads
    torch.cuda.empty_cache()


# Throwaway builds of csrc/selective_scan_bwd.cu that each leave one phase
# of the chunk kernel out: (name, [(text of the source, its replacement),
# ...]).  Each text must occur once in the source.
SCAN_BWD_SKIPS = [
    ("wgmma (dX, G)", [
        ("if (ks == 0) {        // dY^T.W", "if (false) {        // dY^T.W"),
        ("    {\n      // G.B^T:", "    if (false) {\n      // G.B^T:"),
        ("    {\n      uint32_t eh[kQ / 8][4], el[kQ / 8][4];",
         "    if (false) {\n      uint32_t eh[kQ / 8][4], el[kQ / 8][4];")]),
    ("M", [("for (int kk = 0; kk < kRows / 8; ++kk) {\n        const int d = "
            "8 * kk + cid;\n        uint32_t ah[4], al[4], bh0",
            "for (int kk = 0; kk < 0; ++kk) {\n        const int d = "
            "8 * kk + cid;\n        uint32_t ah[4], al[4], bh0")]),
    ("dB, dC products", [("      for (int kk = 0; kk < kRows / 8; ++kk) {\n"
                          "        const int d = 8 * kk + cid;\n"
                          "        uint32_t ah[4], al[4];\n",
                          "      for (int kk = 0; kk < 0; ++kk) {\n"
                          "        const int d = 8 * kk + cid;\n"
                          "        uint32_t ah[4], al[4];\n")]),
    ("dB, dC partial stores", [("          if (gr < a.S && kcol + k < a.n) {",
                                "          if (false) {")]),
    ("dX stores", [("        if (t < q) {\n          if (da < a.dh)",
                    "        if (false) {\n          if (da < a.dh)"),
                   ("        if (t + 1 < q) {\n          if (da < a.dh)",
                    "        if (false) {\n          if (da < a.dh)")]),
    ("the producers' loads", [
        ("                                           int ks, int pt) {\n",
         "                                           int ks, int pt) {\n"
         "  return;\n"),
        ("                                        int pt) {\n  if (c == 0) {",
         "                                        int pt) {\n  return;\n"
         "  if (c == 0) {")]),
]
SCAN_BWD_SKIPS.append(("all products", [e for name, edits in SCAN_BWD_SKIPS[:3]
                                        for e in edits]))


def phase_costs(out, shapes):
    """The chunk kernel's time with each phase of ``SCAN_BWD_SKIPS`` left
    out, in turns with the full kernel, given this tree's forward's states:
    what each phase costs.  One line per shape."""
    csrc = str(build.CSRC)
    src = open(os.path.join(csrc, "selective_scan_bwd.cu")).read()
    variants = [("full", [])] + SCAN_BWD_SKIPS
    procs = []
    for i, (name, edits) in enumerate(variants):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"phase_costs: {name}: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out, f"skip{i}.cu")
        open(cu, "w").write(text)
        procs.append((name, *_nvcc(out, f"skip{i}", [cu], csrc)))
    fns = []
    for name, so, proc in procs:
        fn = _finish(f"without {name}", so, proc).selective_scan_bwd_f32
        fn.argtypes, fn.restype = build.ENTRIES["selective_scan_bwd_f32"], ctypes.c_int
        fns.append(fn)
    for shape in shapes:
        B, S, H, dh, n = shape
        ins = c.scan_bwd_inputs(*shape, seed=11)
        _, states = ops.selective_scan_fwd(*ins[:4], with_states=True)
        work = torch.empty(ops.scan_bwd_work_floats(B, S, H, dh, n), device="cuda")
        outs = [torch.empty_like(t) for t in ins[:4]]

        def call(fn):
            def run():
                err = fn(*(t.data_ptr() for t in ins), states.data_ptr(),
                         work.data_ptr(), *(t.data_ptr() for t in outs), B, S,
                         H, dh, n, work.numel(), _stream())
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            return run
        ms = c.cuda_times([call(f) for f in fns], 10 if S < 1000 else 2)
        print(f"[scan-turns] phases {shape}: full {float(ms[0]):.4f} ms; "
              + "; ".join(f"without {name} {float(m):.4f} (-{float(ms[0]) - float(m):.4f})"
                          for (name, _), m in zip(variants[1:], ms[1:])))
        del ins, states, work, outs
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--other")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("scan_turns: no CUDA device")
    print("[scan-turns] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory(prefix="scan_turns_") as out:
        p_dir = os.path.abspath(args.parent)
        jobs = [("parent", *_nvcc(out, "parent", [
            os.path.join(p_dir, f) for f in ("selective_scan.cu",
                                             "selective_scan_bwd.cu")], p_dir))]
        if args.other:
            o_dir = os.path.abspath(args.other)
            jobs.append(("other", *_nvcc(out, "other", [
                os.path.join(o_dir, "selective_scan.cu")], o_dir)))
        info = build.build()          # this tree's kernels, meanwhile
        for name in ("selective_scan.cu", "selective_scan_bwd.cu"):
            for line in info.ptxas.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[scan-turns] this tree's {name}: {line.strip()}")
        libs = {name: _finish(name, so, proc) for name, so, proc in jobs}
        parent = parent_fns(libs["parent"])
        other = other_fwd(libs["other"]) if args.other else None
        for shape, iters in ((c.SCAN_BWD_TRAIN, 20), (c.SCAN_LAYER, 3)):
            turns(shape, iters, parent, other)
        if args.phases:
            phase_costs(out, (c.SCAN_BWD_TRAIN, c.SCAN_LAYER))


if __name__ == "__main__":
    main()
