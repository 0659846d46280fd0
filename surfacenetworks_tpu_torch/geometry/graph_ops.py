"""Face-derived adjacency (NumPy/SciPy), copied from the JAX package.

Counterpart of ``surfacenetworks_tpu/geometry/graph_ops.py``: the two
functions the edge-flip augmentation needs (``repair.constrained_edge_flip``,
the normal trainer's ``--flip-variants``), verbatim.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
