"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface.  At first use
they are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), and loaded with ``ctypes``.  No PyTorch headers are
involved, so a build takes seconds.  The library's file name carries a hash
of the source and the flags, so a later process reuses a library built from
the same source and rebuilds after any change.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fedagg.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]
ENTRIES = ("coef_reduce_f32", "coef_reduce_f16", "coef_reduce_i8",
           "fedagg_f32", "fedagg_bf16")


class BuildInfo:
    """What a build did: the library path, the seconds ``nvcc`` took (0.0
    when an existing library was reused) and the ``-Xptxas -v`` report
    (registers, shared memory, spills)."""

    def __init__(self, path: Path, seconds: float, ptxas: str):
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


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfedagg_{h.hexdigest()[:12]}.so"


def build(force: bool = False) -> BuildInfo:
    """Compile the kernels unless a library from the same source exists."""
    path = _library_path()
    if path.is_file() and not force:
        return BuildInfo(path, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)        # atomic: concurrent builders never see half
    return BuildInfo(path, seconds, res.stdout + res.stderr)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
