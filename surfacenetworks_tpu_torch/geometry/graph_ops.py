"""Graph Laplacians, face-derived adjacency and the amp pyramid
(NumPy/SciPy), copied from the JAX package.

Counterpart of ``surfacenetworks_tpu/geometry/graph_ops.py``, verbatim: the
two functions the edge-flip augmentation needs (``repair.constrained_edge_flip``,
the normal trainer's ``--flip-variants``) and the intrinsic Laplacian
(``geometry.intrinsic``), ``graph_laplacian`` and ``uniform_weights`` (the
cascade's pyramid, ``geometry.coarsening``), and ``amp_pyramid`` (the FAUST
trainer's amp trunk).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def graph_laplacian(
    W: sp.spmatrix, normalized: bool = True, symmetric: bool = True
) -> sp.csr_matrix:
    """Graph Laplacian of a weight matrix.

    Parity: utils/graph.py:40-66: unnormalized ``D - W``; normalized symmetric
    ``I - D^-1/2 W D^-1/2``; normalized non-symmetric (random-walk)
    ``I - D^-1 W``.
    """
    d = np.asarray(W.sum(axis=0)).ravel()
    if not normalized:
        L = sp.diags(d, 0) - W
    else:
        d = d + np.spacing(np.array(0, W.dtype))
        if symmetric:
            dh = 1.0 / np.sqrt(d)
            D = sp.diags(dh, 0)
            L = sp.identity(d.size, dtype=W.dtype) - D @ W @ D
        else:
            D = sp.diags(1.0 / d, 0)
            L = sp.identity(d.size, dtype=W.dtype) - D @ W
    return L.tocsr()


def uniform_weights(dist: sp.csr_matrix) -> sp.csr_matrix:
    """1/d weights with zeroed diagonal (utils/mesh.py:82-90)."""
    with np.errstate(divide="ignore"):
        W = sp.csr_matrix((1.0 / dist.data, dist.indices, dist.indptr), shape=dist.shape)
    W.setdiag(0)
    W.eliminate_zeros()
    # zero-distance off-diagonal pairs (degenerate) would be inf; drop them
    W.data[~np.isfinite(W.data)] = 0.0
    W.eliminate_zeros()
    return W


def vertex_adjacency(F: np.ndarray, num_vertices: int | None = None) -> sp.csr_matrix:
    """0/1 vertex adjacency from triangles (equivalent of igl's
    ``adjacency_matrix``)."""
    if num_vertices is None:
        num_vertices = int(F.max()) + 1
    rows = np.concatenate([F[:, 0], F[:, 1], F[:, 1], F[:, 2], F[:, 2], F[:, 0]])
    cols = np.concatenate([F[:, 1], F[:, 0], F[:, 2], F[:, 1], F[:, 0], F[:, 2]])
    A = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(num_vertices, num_vertices)
    ).tocsr()
    A.data[:] = 1.0
    return A


def triangle_triangle_adjacency(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """TT / TTi in the igl convention: edge slot e of face f is the directed
    edge ``F[f, e] -> F[f, (e+1)%3]``; ``TT[f, e]`` is the face across it and
    ``TTi[f, e]`` that face's slot for the same edge (-1 on boundary)."""
    m = F.shape[0]
    TT = -np.ones((m, 3), dtype=np.int64)
    TTi = -np.ones((m, 3), dtype=np.int64)
    edges = {}
    for f in range(m):
        for e in range(3):
            a, b = int(F[f, e]), int(F[f, (e + 1) % 3])
            key = (min(a, b), max(a, b))
            if key in edges:
                f2, e2 = edges[key]
                TT[f, e] = f2
                TTi[f, e] = e2
                TT[f2, e2] = f
                TTi[f2, e2] = e
            else:
                edges[key] = (f, e)
    return TT, TTi


def amp_pyramid(L: sp.spmatrix, levels: int = 3) -> list[sp.csr_matrix]:
    """Degree-renormalized squared-Laplacian pyramid for the FAUST 'amp'
    trunk (dense_correspondence/main.py:73-84): Dsq = diag(1/sqrt(deg - 1))
    with deg the stored-nnz row count, L_0 = Dsq L Dsq, then repeatedly
    renormalize and square.  All levels share the vertex set (operator powers
    widen the receptive field; no coarsening)."""
    L = L.tocsr().astype(np.float32)
    idp = L.indptr
    with np.errstate(divide="ignore"):
        d = 1.0 / np.sqrt(np.maximum(idp[1:] - idp[:-1] - 1, 0))
    d[~np.isfinite(d)] = 0.0
    Dsq = sp.diags(d).astype(np.float32)
    out = []
    L = (Dsq @ L @ Dsq).astype(np.float32)
    out.append(L.tocsr())
    for _ in range(levels - 1):
        L = (Dsq @ L @ Dsq).astype(np.float32)
        L = (L @ L).tocsr()
        out.append(L)
    return out
