"""Build and load the port's CUDA kernels.

Every ``*.cu`` source under ``kernels/csrc/`` has a plain C interface (the
``*.cuh`` headers there hold device helpers they share).  At
first use each is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object file, all sources at once in parallel, and the objects are linked
into one shared library under ``build/repro_torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``), loaded with ``ctypes``.  No PyTorch
headers are involved, so a build takes seconds.  The library's file name
carries a hash of every source and the flags, so a later process reuses a
library built from the same sources and rebuilds after any change.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_REDUCE = [_P, _P, _P, _I, _I, _P]                      # x, coef, out, M, P, stream
_DEQUANT = [_P] * 4 + [_I, _I, _P]                      # q, scales, betas, out, M,
#                                                         P, stream
_FLASH = [_P] * 5 + [_I] * 8 + [_F, _P]                # q, k, v, out, lse, B, Sq,
#                                                         Sk, H, KV, hd, causal,
#                                                         window, scale, stream
_FLASH_BWD = [_P] * 10 + [_I] * 8 + [_F, _P]           # q, k, v, out, dout, lse,
#                                                         work, dq, dk, dv, B,
#                                                         Sq, Sk, H, KV, hd,
#                                                         causal, window, scale,
#                                                         stream
_DECODE = [_P] * 6 + [_I] * 6 + [_F, _P]               # q, k, v, valid, work, out,
#                                                         B, S, H, KV, hd, n_split,
#                                                         scale, stream
_DECODE_PARTIAL = [_P] * 8 + [_I] * 6 + [_F, _P]       # q, k, v, valid, work, m,
#                                                         l, o, B, S, H, KV, hd,
#                                                         n_split, scale, stream
_SPLITS = [_I] * 6                                      # B, S, H, KV, hd, bf16
_LORA = [_P] * 5 + [_I] * 4 + [_F, _P]                  # x, w, a, b, out, T, d, o,
#                                                         r, scaling, stream
_LORA_BF16 = [_P] * 6 + [_I] * 4 + [_F, _I, _P]        # x, w, a, b, at, out, T, d,
#                                                         o, r, scaling, tma, stream
_SCAN = [_P] * 7 + [_I] * 6 + [_P]                      # xdt, a_log, B, C, work,
#                                                         y, states, B, S, H,
#                                                         dh, n, work floats,
#                                                         stream
_SCAN_BWD = [_P] * 11 + [_I] * 6 + [_P]                # xdt, a_log, B, C, dy,
#                                                         states, work, dxdt,
#                                                         da_log, dB, dC, B, S,
#                                                         H, dh, n, work floats,
#                                                         stream
_TOPK = [_P] * 7 + [_I] * 8 + [_P]                      # table, rows, betas, work,
#                                                         idx, vals, out (one
#                                                         leaf), L, M, T, C, S,
#                                                         work ints, epoch,
#                                                         accumulate, stream
ENTRIES = {
    "coef_reduce_f32": _REDUCE, "coef_reduce_f16": _REDUCE,
    "dequant_fedagg_i8": _DEQUANT, "fedagg_f32": _REDUCE,
    "fedagg_bf16": _REDUCE,
    "flash_attention_f32": _FLASH, "flash_attention_bf16": _FLASH,
    "flash_attention_bwd_f32": _FLASH_BWD,
    "flash_attention_bwd_bf16": _FLASH_BWD,
    "decode_attention_f32": _DECODE, "decode_attention_bf16": _DECODE,
    "decode_attention_partial_f32": _DECODE_PARTIAL,
    "decode_attention_partial_bf16": _DECODE_PARTIAL,
    "decode_attention_splits": _SPLITS,
    "lora_matmul_f32": _LORA, "lora_matmul_bf16": _LORA_BF16,
    "selective_scan_f32": _SCAN,
    "selective_scan_bwd_f32": _SCAN_BWD,
    "topk_fedagg_flush": _TOPK, "topk_fedagg_geometry": [_I],
}


class BuildInfo:
    """What a build did: the library path, the wall seconds of the parallel
    ``nvcc`` compiles and the link (0.0 when an existing library was
    reused) and, per source, the ``-Xptxas -v`` report (registers, shared
    memory, spills)."""

    def __init__(self, path: Path, seconds: float, ptxas: Dict[str, str]):
        self.path = path
        self.seconds = seconds
        self.ptxas = ptxas


_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return nvcc


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:12]}.so"


def build(force: bool = False) -> BuildInfo:
    """Compile the kernels unless a library from the same sources exists."""
    path = _library_path()
    if path.is_file() and not force:
        return BuildInfo(path, 0.0, {})
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((src, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        ptxas, failed = {}, []
        for src, cmd, proc in procs:
            out, err = proc.communicate()
            ptxas[src.name] = out + err
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmpdir, path.name)
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp_lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp_lib, path)   # atomic: concurrent builders never see half
    return BuildInfo(path, seconds, ptxas)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
