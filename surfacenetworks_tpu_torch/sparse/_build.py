"""Build and load the hand-written CUDA kernels (``csrc/spmm.cu``).

One ``nvcc`` call compiles the source for ``sm_90a`` into a shared library
with a plain C interface, which ``ctypes`` loads.  No PyTorch headers are
included, so the build takes seconds.  The library goes into
``surfacenetworks_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, and is built at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
]

_lib: ctypes.CDLL | None = None
# what the last build did: seconds, nvcc's report, the library's path
build_info: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile ``spmm.cu`` unless a library of the same source and flags
    exists; return the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsnx_spmm_{digest}.so"
    if lib.exists():
        build_info.setdefault("path", str(lib))
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib)
    build_info.update(seconds=seconds, log=res.stderr + res.stdout, path=str(lib))
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.snx_ell_spmm.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib.snx_ell_spmm.restype = i32
        lib.snx_bsr_spmm.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.snx_bsr_spmm.restype = i32
        lib.snx_sddmm.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib.snx_sddmm.restype = i32
        _lib = lib
    return _lib
