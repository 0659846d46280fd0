"""ctypes bindings for the native host runtime (``csrc/snx_native.cc``),
counterpart of ``surfacenetworks_tpu/native``.

The library assembles mesh operators from (V, F) straight into the padded
ELL layout (forward and stored transpose), packs a CSR into both ELL
directions in one pass, and builds the structured Dirac coefficients and
the vertex normals: the host side of data loading.  ``csrc/snx_native.cc``
is a verbatim copy of the JAX package's source, so both packages compute
the same bits; on a CSR with sorted rows every entry point gives the bits
of its NumPy counterpart (``geometry.mesh_ops``, ``sparse.ell``).  The
forward ELL packers keep a CSR's slot order, where ``ell_from_scipy``
sorts each row.

The library is built at first use with one ``g++`` call (the JAX
package's flags) into ``surfacenetworks_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the flags and the
compiler's target (``-march=native`` code runs only on a CPU like the one
that built it).  A failed build raises with the compiler's message.
``SNX_NO_NATIVE`` set in the environment is the one way to take the NumPy
route: ``available()`` is then False, the packers return None and
``laplacian_ell_operator``, ``dirac_coeffs`` and ``vertex_normals`` compute
with NumPy, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "snx_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib = None
# what the last build did: seconds, the compiler's output, the library's path
build_info: dict = {}

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _target_key() -> bytes:
    """The compiler's predefined macros under ``-march=native``: its
    version and the host's instruction set, which the library bakes in."""
    cmd = [_cxx(), "-march=native", "-E", "-dM", "-x", "c++", os.devnull]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(f"native runtime: cannot run the compiler {cmd[0]!r}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native runtime: {' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}")
    return res.stdout.encode()


def build() -> Path:
    """Compile ``snx_native.cc`` unless a library of the same source, flags
    and target exists; return the library's path.  Raises with the
    compiler's message when the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _target_key()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsnx_native_{digest}.so"
    if lib.exists():
        build_info.setdefault("path", str(lib))
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native runtime: cannot run the compiler {cmd[0]!r}: {e}") from e
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime: build failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders each write their own temporary file
    build_info.update(seconds=seconds, log=res.stderr + res.stdout, path=str(lib))
    return lib


def _load():
    """The loaded library, built at first use; None under ``SNX_NO_NATIVE``."""
    global _lib
    if os.environ.get("SNX_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.snx_abi_version.restype = ctypes.c_int32
        if lib.snx_abi_version() != 1:
            raise RuntimeError(f"native runtime: ABI version {lib.snx_abi_version()}, expected 1")
        lib.snx_igl_laplacian_ell.restype = ctypes.c_int32
        lib.snx_igl_laplacian_ell.argtypes = [
            _f64p, ctypes.c_int64, _i32p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i32p, _f32p, _i32p, _f32p,
        ]
        lib.snx_mesh_laplacian_ell.restype = ctypes.c_int32
        lib.snx_mesh_laplacian_ell.argtypes = [
            _f64p, ctypes.c_int64, _i32p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i32p, _f32p, _i32p, _f32p,
        ]
        lib.snx_dirac_coeffs.restype = ctypes.c_int32
        lib.snx_dirac_coeffs.argtypes = [
            _f64p, ctypes.c_int64, _i32p, ctypes.c_int64, ctypes.c_int32,
            _f32p, _i32p, _i32p, _f32p, _f32p, _f32p,
        ]
        lib.snx_csr_to_ell.restype = ctypes.c_int32
        lib.snx_csr_to_ell.argtypes = [
            _i64p, _i32p, _f32p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, _i32p, _f32p,
        ]
        lib.snx_csr_to_ell_both.restype = ctypes.c_int32
        lib.snx_csr_to_ell_both.argtypes = [
            _i64p, _i32p, _f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i32p, _f32p, _i32p, _f32p,
        ]
        lib.snx_vertex_normals.restype = None
        lib.snx_vertex_normals.argtypes = [_f64p, ctypes.c_int64, _i32p, ctypes.c_int64, _f32p]
        _lib = lib
        return _lib


def available() -> bool:
    """True unless ``SNX_NO_NATIVE`` is set (builds the library on first
    call, and raises if that fails)."""
    return _load() is not None


def _prep(V: np.ndarray, F: np.ndarray):
    V = np.ascontiguousarray(V, dtype=np.float64)
    F = np.ascontiguousarray(F, dtype=np.int32)
    return V, F


def _check_rows(n: int, n_rows: int) -> None:
    # the library writes rows [0, n) of buffers of n_rows rows
    if n > n_rows:
        raise ValueError(f"padded shape smaller than matrix shape: {n} rows into {n_rows}")


def _ell_pair(V, F, n_rows: int, k: int, k_t: int | None):
    k_t = k if k_t is None else k_t
    _check_rows(V.shape[0], n_rows)
    return k_t, (np.empty((n_rows, k), np.int32), np.empty((n_rows, k), np.float32),
                 np.empty((n_rows, k_t), np.int32), np.empty((n_rows, k_t), np.float32))


def igl_laplacian_ell_arrays(V: np.ndarray, F: np.ndarray, n_rows: int, k: int, k_t: int | None = None,
                             hack: float | None = 1.0):
    """igl-convention Laplacian as padded-ELL (fwd + transpose) arrays
    ``(fwd_cols, fwd_vals, bwd_cols, bwd_vals)``, or None under
    ``SNX_NO_NATIVE``.  Raises ``ValueError`` when ``k``/``k_t`` is smaller
    than the largest row degree."""
    lib = _load()
    if lib is None:
        return None
    V, F = _prep(V, F)
    k_t, out = _ell_pair(V, F, n_rows, k, k_t)
    rc = lib.snx_igl_laplacian_ell(
        V, V.shape[0], F, F.shape[0],
        0.0 if hack is None else float(hack), 0 if hack is None else 1,
        n_rows, k, k_t, *out,
    )
    if rc:
        raise ValueError(f"ELL k too small: need {rc}")
    return out


def mesh_laplacian_ell_arrays(V: np.ndarray, F: np.ndarray, n_rows: int, k: int, k_t: int | None = None):
    """mesh.py-convention Laplacian as padded-ELL (fwd + transpose) arrays,
    or None under ``SNX_NO_NATIVE``."""
    lib = _load()
    if lib is None:
        return None
    V, F = _prep(V, F)
    k_t, out = _ell_pair(V, F, n_rows, k, k_t)
    rc = lib.snx_mesh_laplacian_ell(V, V.shape[0], F, F.shape[0], n_rows, k, k_t, *out)
    if rc:
        raise ValueError(f"ELL k too small: need {rc}")
    return out


def _ell_matrix(cols: np.ndarray, vals: np.ndarray, n_cols: int):
    import torch

    from surfacenetworks_tpu_torch.sparse.ell import EllMatrix, _ell_window

    return EllMatrix(cols=torch.from_numpy(cols), vals=torch.from_numpy(vals), n_cols=n_cols,
                     window=_ell_window(cols, vals, n_cols))


def laplacian_ell_operator(V: np.ndarray, F: np.ndarray, n_rows: int, k: int, k_t: int | None = None,
                           convention: str = "igl", hack: float | None = 1.0):
    """An ``EllOperator`` straight from (V, F): natively, or through scipy
    and ``operator_from_scipy`` under ``SNX_NO_NATIVE``."""
    from surfacenetworks_tpu_torch.sparse.ell import EllOperator

    k_t = k if k_t is None else k_t
    if convention == "igl":
        arrays = igl_laplacian_ell_arrays(V, F, n_rows, k, k_t, hack=hack)
    elif convention == "mesh":
        arrays = mesh_laplacian_ell_arrays(V, F, n_rows, k, k_t)
    else:
        raise ValueError(f"unknown convention {convention!r}")
    if arrays is not None:
        fc, fv, bc, bv = arrays
        return EllOperator(fwd=_ell_matrix(fc, fv, n_rows), bwd=_ell_matrix(bc, bv, n_rows))
    from surfacenetworks_tpu_torch.geometry import mesh_ops
    from surfacenetworks_tpu_torch.sparse.ell import operator_from_scipy

    if convention == "igl":
        L = mesh_ops.igl_style_laplacian(V, F, hack=hack)
    else:
        L = mesh_ops.mesh_laplacian(V, F)
    return operator_from_scipy(L.tocsr(), k=k, n_rows=n_rows, n_cols=n_rows)


def dirac_coeffs(V: np.ndarray, F: np.ndarray, max_valence: int | None = None):
    """The structured Dirac coefficients (``geometry.DiracCoeffs``),
    natively, or with ``mesh_ops.dirac_coeffs`` under ``SNX_NO_NATIVE``."""
    from surfacenetworks_tpu_torch.geometry import mesh_ops

    lib = _load()
    if lib is None:
        return mesh_ops.dirac_coeffs(V, F, max_valence=max_valence)
    V, F = _prep(V, F)
    n, m = V.shape[0], F.shape[0]
    if max_valence is None:
        Kv = int(np.bincount(F.reshape(-1), minlength=n).max()) if m else 1
    else:
        Kv = max_valence
    q_fv = np.empty((m, 3, 4), np.float32)
    vf_face = np.empty((n, Kv), np.int32)
    vf_corner = np.empty((n, Kv), np.int32)
    q_vf = np.empty((n, Kv, 4), np.float32)
    q_bwd_v = np.empty((n, Kv, 4), np.float32)
    q_bwd_f = np.empty((m, 3, 4), np.float32)
    lib.snx_dirac_coeffs(V, n, F, m, Kv, q_fv, vf_face, vf_corner, q_vf, q_bwd_v, q_bwd_f)
    return mesh_ops.DiracCoeffs(
        F=F, q_fv=q_fv, vf_face=vf_face, vf_corner=vf_corner, q_vf=q_vf,
        q_bwd_v=q_bwd_v, q_bwd_f=q_bwd_f, n_vertices=n, n_faces=m,
    )


def _csr_arrays(csr):
    return (np.ascontiguousarray(csr.indptr, dtype=np.int64), np.ascontiguousarray(csr.indices, dtype=np.int32),
            np.ascontiguousarray(csr.data, dtype=np.float32))


def csr_to_ell_arrays(csr, n_rows: int, k: int):
    """A scipy CSR packed into ELL ``(cols, vals)`` in its own slot order,
    or None under ``SNX_NO_NATIVE``."""
    lib = _load()
    if lib is None:
        return None
    _check_rows(csr.shape[0], n_rows)
    cols = np.empty((n_rows, k), np.int32)
    vals = np.empty((n_rows, k), np.float32)
    rc = lib.snx_csr_to_ell(*_csr_arrays(csr), csr.shape[0], n_rows, k, cols, vals)
    if rc:
        raise ValueError(f"ELL k too small: need {rc}")
    return cols, vals


def ell_operator_from_csr(csr, n_rows: int, k: int, k_t: int):
    """A scipy CSR as an ``EllOperator`` (forward in the CSR's slot order,
    stored transpose in ascending row order) in one pass, or None under
    ``SNX_NO_NATIVE``."""
    lib = _load()
    if lib is None:
        return None
    from surfacenetworks_tpu_torch.sparse.ell import EllOperator

    _check_rows(max(csr.shape), n_rows)
    cols = np.empty((n_rows, k), np.int32)
    vals = np.empty((n_rows, k), np.float32)
    t_cols = np.empty((n_rows, k_t), np.int32)
    t_vals = np.empty((n_rows, k_t), np.float32)
    rc = lib.snx_csr_to_ell_both(*_csr_arrays(csr), csr.shape[0], csr.shape[1], n_rows, k, k_t,
                                 cols, vals, t_cols, t_vals)
    if rc:
        raise ValueError(f"ELL k too small: need {rc}")
    return EllOperator(fwd=_ell_matrix(cols, vals, n_rows), bwd=_ell_matrix(t_cols, t_vals, n_rows))


def vertex_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, float32: natively, or with NumPy under
    ``SNX_NO_NATIVE``."""
    lib = _load()
    if lib is None:
        from surfacenetworks_tpu_torch.geometry import mesh_ops

        return mesh_ops.vertex_normals(V, F).astype(np.float32)
    V, F = _prep(V, F)
    out = np.empty((V.shape[0], 3), np.float32)
    lib.snx_vertex_normals(V, V.shape[0], F, F.shape[0], out)
    return out
