"""Spectral geometry: Laplacian eigendecomposition, WKS and HKS
descriptors, norm-scaled Laplacians (NumPy/SciPy).

Counterpart of ``surfacenetworks_tpu/geometry/spectral.py``, a verbatim copy
(the reference's ``utils/geom_utils.py``: laplacian_eigendecomp (:16),
normalized_laplacian (:168), compute_wks (:407)); scipy's ``eigsh`` is
called as the JAX package calls it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from surfacenetworks_tpu_torch.geometry import mesh_ops


def cot_and_mass(V: np.ndarray, F: np.ndarray):
    """(Lc, mass): igl-convention cot stiffness (negative diagonal) and
    barycentric vertex mass vector."""
    n = V.shape[0]
    l2 = mesh_ops.edge_lengths(V, F) ** 2
    areas = mesh_ops.face_areas(V, F)
    rows, cols, vals = [], [], []
    for c in range(3):
        a, b = (c + 1) % 3, (c + 2) % 3
        w = (l2[:, a] + l2[:, b] - l2[:, c]) / (8.0 * areas)
        rows += [F[:, a], F[:, b], F[:, a], F[:, b]]
        cols += [F[:, b], F[:, a], F[:, a], F[:, b]]
        vals += [w, w, -w, -w]
    Lc = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    ).tocsr()
    mass = np.zeros(n)
    for c in range(3):
        np.add.at(mass, F[:, c], areas / 3.0)
    return Lc, mass


def laplacian_eigendecomp(V: np.ndarray, F: np.ndarray, k: int = 30):
    """Smallest-k generalized eigenpairs of (-Lc, M) — geom_utils.py:16-31
    (igl cotmatrix is negative semidefinite; eigsh near sigma=0)."""
    Lc, mass = cot_and_mass(V, F)
    M = sp.diags(np.maximum(mass, 1e-12))
    vals, vecs = spla.eigsh((-Lc).tocsc(), M=M.tocsc(), k=k, sigma=-1e-8, which="LM")
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def normalized_laplacian(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix | None:
    """M^-1 Lc scaled by its Frobenius norm (geom_utils.py:168-182); returns
    None when any vertex has zero mass."""
    Lc, mass = cot_and_mass(V, F)
    if np.any(mass == 0):
        return None
    L = sp.diags(1.0 / mass) @ Lc
    L = (L / spla.norm(L)).tocsr().astype(np.float32)
    return L


def compute_wks(V: np.ndarray, F: np.ndarray, n_descriptors: int = 100, k: int = 300):
    """Wave-kernel signatures (geom_utils.py:407-440): band-pass filters of
    the squared eigenfunctions over log eigenvalue energies."""
    Lc, mass = cot_and_mass(V, F)
    Am = np.clip(mass, 1e-8, np.inf)
    Am = Am / Am.sum()
    k = min(k, V.shape[0] - 2)
    E, phi = spla.eigsh(-Lc.tocsc(), M=sp.diags(Am).tocsc(), sigma=-1e-5, k=k)
    E = np.abs(np.real(E))
    phi = np.real(phi)
    order = np.argsort(E)
    E, phi = E[order], phi[:, order]
    logE = np.log(np.clip(E, 1e-6, np.inf)).T
    ee = np.linspace(logE[1], np.max(logE) / 1.02, n_descriptors)
    sigma = (ee[1] - ee[0]) * 6
    num_v = V.shape[0]
    C = np.zeros(n_descriptors)
    WKS = np.zeros((num_v, n_descriptors))
    for i in range(n_descriptors):
        band = np.exp(-((ee[i] - logE) ** 2) / (2 * sigma**2))
        C[i] = band.sum()
        WKS[:, i] = (phi**2) @ band
    return WKS / np.tile(C.T, (num_v, 1))


def heat_kernel_signature(V: np.ndarray, F: np.ndarray, times=None, k: int = 100):
    """HKS companion descriptor (same spectral machinery; not in the
    reference but standard alongside WKS)."""
    Lc, mass = cot_and_mass(V, F)
    Am = np.clip(mass, 1e-8, np.inf)
    k = min(k, V.shape[0] - 2)
    E, phi = spla.eigsh(-Lc.tocsc(), M=sp.diags(Am).tocsc(), sigma=-1e-5, k=k)
    E = np.abs(np.real(E))
    phi = np.real(phi)
    if times is None:
        tmin = 4 * np.log(10) / max(E.max(), 1e-6)
        tmax = 4 * np.log(10) / max(E[E > 1e-10].min() if (E > 1e-10).any() else 1e-6, 1e-6)
        times = np.geomspace(tmin, tmax, 16)
    return np.stack([(phi**2 * np.exp(-E * t)).sum(axis=1) for t in times], axis=1)
