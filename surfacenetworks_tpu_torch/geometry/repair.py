"""Edge flips for data augmentation (NumPy), copied from the JAX package.

Counterpart of ``surfacenetworks_tpu/geometry/repair.py``: ``flip_edge`` and
``constrained_edge_flip``, verbatim, so that the same
``np.random.default_rng`` seed flips the same edges in both packages.
"""

from __future__ import annotations

import numpy as np

from surfacenetworks_tpu_torch.geometry import graph_ops


def flip_edge(F, TT, TTi, f0: int, e0: int, adj) -> bool:
    """In-place flip of edge slot e0 of face f0: rejects boundary edges and
    flips that would duplicate an existing edge.  Updates F/TT/TTi/adjacency
    in place."""
    f1 = int(TT[f0, e0])
    if f1 == -1:
        return False
    e1 = int(TTi[f0, e0])
    e01, e02 = (e0 + 1) % 3, (e0 + 2) % 3
    e11, e12 = (e1 + 1) % 3, (e1 + 2) % 3
    f01, f11 = int(TT[f0, e01]), int(TT[f1, e11])

    u1 = F[f0, e01]
    u0 = F[f1, e11]
    v0 = F[f0, e02]
    v1 = F[f1, e12]
    if adj[v0, v1] != 0:
        return False

    adj[v0, v1] = adj[v1, v0] = 1
    adj[u0, u1] = adj[u1, u0] = 0

    F[f0, e01] = F[f1, e12]
    F[f1, e11] = F[f0, e02]
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
    return True


def constrained_edge_flip(
    V: np.ndarray,
    F: np.ndarray,
    num_flipped_edges: int,
    rng: np.random.Generator | None = None,
    min_degree: int = 5,
    max_degree: int = 7,
    angle_threshold: float = 0.5,
):
    """Random constrained edge flips as data augmentation: a flip is
    rejected on boundaries, duplicate edges, valence bounds, near-zero new
    areas, or if the dihedral normal changes by more than ~60 deg.  Returns
    (V, F): F a flipped copy, int32."""
    rng = rng or np.random.default_rng()
    F = np.asarray(F, dtype=np.int64).copy()
    TT, TTi = graph_ops.triangle_triangle_adjacency(F)
    adj = graph_ops.vertex_adjacency(F, V.shape[0]).tolil()
    vdeg = np.asarray(adj.sum(axis=1)).ravel().astype(np.int64)

    def normal_area(a, b, c):
        return np.cross(V[b] - V[a], V[c] - V[a]) / 2.0

    flips = 0
    for f0, e0 in zip(
        rng.integers(0, F.shape[0], size=num_flipped_edges),
        rng.integers(0, 3, size=num_flipped_edges),
    ):
        f0, e0 = int(f0), int(e0)
        f1 = int(TT[f0, e0])
        if f1 == -1:
            continue
        e1 = int(TTi[f0, e0])
        u1 = F[f0, (e0 + 1) % 3]
        u0 = F[f1, (e1 + 1) % 3]
        v0 = F[f0, (e0 + 2) % 3]
        v1 = F[f1, (e1 + 2) % 3]
        if adj[v0, v1] != 0:
            continue
        if vdeg[u0] < min_degree or vdeg[u1] < min_degree:
            continue
        if vdeg[v0] > max_degree or vdeg[v1] > max_degree:
            continue
        n_before = normal_area(u1, u0, v0) + normal_area(u1, v1, u0)
        n_after = normal_area(u1, v1, v0) + normal_area(v1, u0, v0)
        if np.linalg.norm(n_after) < 1e-10:
            continue
        cosang = np.dot(
            n_before / max(np.linalg.norm(n_before), 1e-30),
            n_after / max(np.linalg.norm(n_after), 1e-30),
        )
        if cosang < angle_threshold:
            continue
        if flip_edge(F, TT, TTi, f0, e0, adj):
            vdeg[u0] -= 1
            vdeg[u1] -= 1
            vdeg[v0] += 1
            vdeg[v1] += 1
            flips += 1
    return V, F.astype(np.int32)
