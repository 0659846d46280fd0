"""Host-side mesh operators (NumPy/SciPy), copied from the JAX package.

Counterpart of ``surfacenetworks_tpu/geometry/mesh_ops.py``.  The functions
below are verbatim copies of the ones the normal-prediction serving path
needs, so the port builds identical operators without importing the JAX
package (whose ``__init__`` imports jax and flax).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def edge_lengths(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Per-face edge lengths ``l[:, c] = |V[F[:, (c+1)%3]] - V[F[:, (c+2)%3]]|``
    (edge opposite corner ``c``)."""
    V = np.asarray(V, dtype=np.float64)
    e0 = V[F[:, 1]] - V[F[:, 2]]
    e1 = V[F[:, 2]] - V[F[:, 0]]
    e2 = V[F[:, 0]] - V[F[:, 1]]
    return np.stack(
        [np.linalg.norm(e0, axis=1), np.linalg.norm(e1, axis=1), np.linalg.norm(e2, axis=1)],
        axis=1,
    )


def face_areas(V: np.ndarray, F: np.ndarray, degenerate_floor: float = 1e-6) -> np.ndarray:
    """Heron's-formula face areas with the reference's degenerate floor.

    Parity: utils/mesh.py:67-80 (``area``) — if the Heron product is <= 0 the
    area is set to ``1e-6``.
    """
    l = edge_lengths(V, F)
    s = l.sum(axis=1) / 2.0
    prod = s * (s - l[:, 0]) * (s - l[:, 1]) * (s - l[:, 2])
    areas = np.where(prod > 0, np.sqrt(np.maximum(prod, 0.0)), degenerate_floor)
    return areas


def cotangent_weights(
    V: np.ndarray, F: np.ndarray, areas: np.ndarray | None = None
) -> tuple[sp.csr_matrix, sp.dia_matrix]:
    """Cotangent weight matrix W and inverse-mass diagonal A^{-1}.

    Parity: utils/mesh.py:102-112 — per ordered permutation (i, j, k) of each
    face, ``W[i,j] += (-l_ij^2 + l_jk^2 + l_ki^2) / (8 a_f + 1e-6)`` and
    ``A[i] += a_f / 12`` (each vertex leads two of the six permutations, so a
    face contributes ``a_f/6`` per vertex).  Returns ``(W, diag(1/(A+1e-9)))``.
    """
    n = V.shape[0]
    l = edge_lengths(V, F)
    if areas is None:
        areas = face_areas(V, F)
    l2 = l**2  # l2[:, c] = squared length of edge opposite corner c
    denom = 8.0 * areas + 1e-6

    rows, cols, vals = [], [], []
    # ordered pair (corner a, corner b), opposite corner c: cot contribution
    for a, b, c in [(0, 1, 2), (1, 0, 2), (1, 2, 0), (2, 1, 0), (2, 0, 1), (0, 2, 1)]:
        rows.append(F[:, a])
        cols.append(F[:, b])
        # -l_ij^2 + l_jk^2 + l_ki^2 where l_ij is opposite c, l_jk opposite a,
        # l_ki opposite b
        vals.append((-l2[:, c] + l2[:, a] + l2[:, b]) / denom)
    W = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    ).tocsr()

    # each of the 3 face vertices receives a_f/6 (two leading permutations
    # x a_f/12 each)
    A = np.zeros(n)
    np.add.at(A, F[:, 0], areas / 6.0)
    np.add.at(A, F[:, 1], areas / 6.0)
    np.add.at(A, F[:, 2], areas / 6.0)
    A_inv = sp.diags(1.0 / (A + 1e-9), 0)
    return W, A_inv


def laplacian(W: sp.spmatrix, A_inv: sp.spmatrix) -> sp.csr_matrix:
    """Mass-normalized (non-symmetric) Laplacian ``L = A^{-1} (D - W)`` with
    ``D = diag(colsum W)`` (parity: utils/mesh.py:114-125)."""
    d = np.asarray(W.sum(axis=0)).ravel()
    D = sp.diags(d, 0)
    L = (A_inv @ (D - W)).tocsr()
    return L


def hackit(Op: sp.spmatrix, hack: float) -> sp.spmatrix:
    """Clamp non-finite and huge operator entries to ``hack``.

    Parity: normal_predict/sampler.py:42-46 and geom_utils.py:209-211 — the
    reference's defence against degenerate meshes.
    """
    data = Op.data
    data[~np.isfinite(data)] = hack
    data[data > 1e10] = hack
    data[data < -1e10] = hack
    return Op


def igl_style_laplacian(
    V: np.ndarray, F: np.ndarray, hack: float | None = 1.0
) -> sp.csr_matrix:
    """igl-convention mass-normalized cot Laplacian, with "hack" clamping.

    Parity: utils/geom_utils.py:200-212 (hacky_compute_laplacian): igl
    ``cotmatrix`` builds Lc with off-diagonal w_ij = (cot alpha + cot beta)/2
    and negative diagonal -sum_j w_ij; barycentric mass M = diag(sum_f a_f/3);
    L = M^{-1} Lc.  Degenerate faces produce inf/nan cotangents which the hack
    clamps (pass ``hack=None`` to skip clamping).
    """
    n = V.shape[0]
    l2 = edge_lengths(V, F) ** 2
    # true Heron area WITHOUT floor (degenerates -> 0 -> inf cot, then clamped)
    l = np.sqrt(l2)
    s = l.sum(axis=1) / 2.0
    prod = s * (s - l[:, 0]) * (s - l[:, 1]) * (s - l[:, 2])
    with np.errstate(invalid="ignore"):
        areas = np.sqrt(prod)  # nan for slivers with negative round-off
    with np.errstate(divide="ignore", invalid="ignore"):
        # cot of angle at corner c = (l_a^2 + l_b^2 - l_c^2) / (4 area)
        cot = np.empty_like(l2)
        for c in range(3):
            a, b = (c + 1) % 3, (c + 2) % 3
            cot[:, c] = (l2[:, a] + l2[:, b] - l2[:, c]) / (4.0 * areas)

    rows, cols, vals = [], [], []
    for c in range(3):
        a, b = (c + 1) % 3, (c + 2) % 3
        w = cot[:, c] / 2.0
        rows += [F[:, a], F[:, b], F[:, a], F[:, b]]
        cols += [F[:, b], F[:, a], F[:, a], F[:, b]]
        vals += [w, w, -w, -w]
    Lc = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    ).tocsr()

    mass = np.zeros(n)
    bary = face_areas(V, F, degenerate_floor=0.0) / 3.0
    for c in range(3):
        np.add.at(mass, F[:, c], bary)
    with np.errstate(divide="ignore"):
        Minv = sp.diags(np.where(mass > 0, 1.0 / mass, np.inf), 0)
    L = (Minv @ Lc).tocsr().astype(np.float32)
    if hack is not None:
        L = hackit(L, hack)
    return L.tocsr()


def vertex_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (equivalent of geom_utils.compute_normals
    / igl per_vertex_normals with area weighting)."""
    V = np.asarray(V, dtype=np.float64)
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])  # 2*area-weighted
    N = np.zeros_like(V)
    for c in range(3):
        np.add.at(N, F[:, c], fn)
    norm = np.linalg.norm(N, axis=1, keepdims=True)
    return N / np.maximum(norm, 1e-30)


def uniform_mesh_scale(V: np.ndarray) -> np.ndarray:
    """The normal trainer's ``--uniform-mesh`` scaling: shift to the origin
    corner, divide by the largest coordinate."""
    V = V - np.min(V, axis=0)
    return V / np.max(V)


def invert_permutation(p: np.ndarray) -> np.ndarray:
    s = np.empty(p.size, p.dtype)
    s[p] = np.arange(p.size)
    return s
