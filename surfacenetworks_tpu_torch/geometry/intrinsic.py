"""Intrinsic Delaunay cotangent Laplacian (NumPy/SciPy), copied from the
JAX package.

Counterpart of ``surfacenetworks_tpu/geometry/intrinsic.py``, verbatim but
for its imports (the port's own ``mesh_ops.edge_lengths`` and
``graph_ops.triangle_triangle_adjacency``): the FAUST trainer's
``--intrinsic``.  Edges are flipped intrinsically (lengths only; a new
diagonal's length comes from unfolding its two triangles into the plane)
until every interior edge satisfies ``cot(alpha) + cot(beta) >= 0``, then
the cotangent stiffness matrix is assembled from the final lengths (igl
sign convention, off-diagonal ``w_ij = (cot a + cot b) / 2``).

Conventions: ``L[f, c]`` is the length of the edge opposite corner c;
TT/TTi use the igl first-corner edge slots (edge e = F[f,e] -> F[f,e+1]),
so edge slot e has length ``L[f, (e+2)%3]`` and apex corner ``(e+2)%3``.
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.sparse as sp

from surfacenetworks_tpu_torch.geometry import graph_ops, mesh_ops


def _area4_sq(l2a, l2b, l2c):
    """(4*area)^2 from squared side lengths."""
    return max(2 * (l2a * l2b + l2b * l2c + l2c * l2a) - (l2a**2 + l2b**2 + l2c**2), 1e-300)


def _cot_at(l2_adj1, l2_adj2, l2_opp, area4):
    return (l2_adj1 + l2_adj2 - l2_opp) / area4


def _unfold_diagonal(lab, l_u0v0, l_u1v0, l_u0v1, l_u1v1):
    """|v0 v1| after unfolding the quad (u0, u1 shared; v0 above, v1 below)."""
    x0 = (l_u0v0**2 - l_u1v0**2 + lab**2) / (2 * lab)
    y0 = np.sqrt(max(l_u0v0**2 - x0**2, 0.0))
    x1 = (l_u0v1**2 - l_u1v1**2 + lab**2) / (2 * lab)
    y1 = -np.sqrt(max(l_u0v1**2 - x1**2, 0.0))
    return float(np.hypot(x0 - x1, y0 - y1))


def intrinsic_delaunay(
    V: np.ndarray, F: np.ndarray, max_flips: int | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Flip to the intrinsic Delaunay triangulation.

    Returns (F_idt [M,3] int64, lengths [M,3] (opposite-corner), n_flips).
    """
    F = np.asarray(F, dtype=np.int64).copy()
    L = mesh_ops.edge_lengths(V, F).copy()
    TT, TTi = graph_ops.triangle_triangle_adjacency(F)
    m = F.shape[0]
    if max_flips is None:
        max_flips = 50 * m

    def edge_cots(f0, e0):
        """cot at the two apices across edge slot e0 of f0 (None if boundary)."""
        f1 = int(TT[f0, e0])
        if f1 == -1:
            return None
        e1 = int(TTi[f0, e0])
        l2_0 = L[f0] ** 2
        l2_1 = L[f1] ** 2
        a0 = (e0 + 2) % 3  # apex corner in f0
        a1 = (e1 + 2) % 3
        cot0 = _cot_at(
            l2_0[(a0 + 1) % 3], l2_0[(a0 + 2) % 3], l2_0[a0], np.sqrt(_area4_sq(*l2_0))
        )
        cot1 = _cot_at(
            l2_1[(a1 + 1) % 3], l2_1[(a1 + 2) % 3], l2_1[a1], np.sqrt(_area4_sq(*l2_1))
        )
        return cot0 + cot1

    queue = collections.deque((f, e) for f in range(m) for e in range(3))
    flips = 0
    while queue and flips < max_flips:
        f0, e0 = queue.popleft()
        s = edge_cots(f0, e0)
        if s is None or s >= -1e-12:
            continue
        f1 = int(TT[f0, e0])
        e1 = int(TTi[f0, e0])
        e01, e02 = (e0 + 1) % 3, (e0 + 2) % 3
        e11, e12 = (e1 + 1) % 3, (e1 + 2) % 3
        # quad: shared edge (u0, u1); apices v0 (in f0), v1 (in f1)
        #   u0 = F[f0,e0] = F[f1,e11]; u1 = F[f0,e01] = F[f1,e1]
        #   v0 = F[f0,e02]; v1 = F[f1,e12]
        lab = L[f0, e02]  # |u0 u1|
        l_u0v0 = L[f0, e01]  # opposite e01 connects (e02, e0) = |v0 u0|
        l_u1v0 = L[f0, e0]  # opposite e0 connects (e01, e02) = |u1 v0|
        l_u0v1 = L[f1, e1]  # opposite e1 connects (e11, e12) = |u0 v1|
        l_u1v1 = L[f1, e11]  # opposite e11 connects (e12, e1) = |v1 u1|
        l_new = _unfold_diagonal(lab, l_u0v0, l_u1v0, l_u0v1, l_u1v1)

        f01, f11 = int(TT[f0, e01]), int(TT[f1, e11])
        # combinatorial flip (reference update pattern, geom_utils.py:139-158)
        F[f0, e01] = F[f1, e12]  # f0 -> (u0, v1, v0)
        F[f1, e11] = F[f0, e02]  # f1 -> (u1, v0, v1)
        TT[f0, e0] = f11
        TT[f0, e01] = f1
        TT[f1, e1] = f01
        TT[f1, e11] = f0
        if f11 != -1:
            TT[f11, TTi[f1, e11]] = f0
        if f01 != -1:
            TT[f01, TTi[f0, e01]] = f1
        TTi[f0, e0], TTi[f1, e1] = TTi[f1, e11], TTi[f0, e01]
        TTi[f0, e01], TTi[f1, e11] = e11, e01
        if f11 != -1:
            TTi[f11, TTi[f0, e0]] = e0
        if f01 != -1:
            TTi[f01, TTi[f1, e1]] = e1
        # new lengths: f0' = (u0, v1, v0), f1' = (u1, v0, v1)
        # f0' edges: opp e0 connects (e01=v1, e02=v0) -> |v1 v0| = l_new
        #            opp e01 connects (e02=v0, e0=u0) -> |v0 u0| = l_u0v0
        #            opp e02 connects (e0=u0, e01=v1) -> |u0 v1| = l_u0v1
        L[f0, e0] = l_new
        L[f0, e01] = l_u0v0
        L[f0, e02] = l_u0v1
        # f1' edges: opp e1 connects (e11=v0, e12=v1) -> l_new
        #            opp e11 connects (e12=v1, e1=u1) -> |v1 u1| = l_u1v1
        #            opp e12 connects (e1=u1, e11=v0) -> |u1 v0| = l_u1v0
        L[f1, e1] = l_new
        L[f1, e11] = l_u1v1
        L[f1, e12] = l_u1v0
        queue.extend([(f0, 0), (f0, 1), (f0, 2), (f1, 0), (f1, 1), (f1, 2)])
        flips += 1
    return F, L, flips


def cot_matrix_from_lengths(F: np.ndarray, L: np.ndarray, n: int) -> sp.csr_matrix:
    """igl-convention cot stiffness from connectivity + intrinsic lengths."""
    l2 = L**2
    area4 = np.sqrt(
        np.maximum(
            2 * (l2[:, 0] * l2[:, 1] + l2[:, 1] * l2[:, 2] + l2[:, 2] * l2[:, 0])
            - (l2[:, 0] ** 2 + l2[:, 1] ** 2 + l2[:, 2] ** 2),
            1e-300,
        )
    )
    rows, cols, vals = [], [], []
    for c in range(3):
        a, b = (c + 1) % 3, (c + 2) % 3
        w = (l2[:, a] + l2[:, b] - l2[:, c]) / (2.0 * area4)  # cot/2
        rows += [F[:, a], F[:, b], F[:, a], F[:, b]]
        cols += [F[:, b], F[:, a], F[:, a], F[:, b]]
        vals += [w, w, -w, -w]
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    ).tocsr()


def intrinsic_laplacian(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Intrinsic Delaunay cot stiffness matrix (reference
    ``mesh.intrinsic_laplacian`` contract: returned raw, float32 CSR)."""
    F_idt, L, _ = intrinsic_delaunay(V, F)
    return cot_matrix_from_lengths(F_idt, L, np.asarray(V).shape[0]).astype(np.float32)
