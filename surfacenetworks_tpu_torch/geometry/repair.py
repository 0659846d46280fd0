"""Mesh repair: degenerate-face fixing, largest-component extraction and
the constrained edge flips of data augmentation (NumPy).

Counterpart of ``surfacenetworks_tpu/geometry/repair.py``, a verbatim copy:
``normal_predict/fix_degenerate.py`` (collapse short edges and flip the
longest edge of zero-area faces until the mesh is clean) and
``dense_correspondence/largest_component.py`` (keep the largest facet
component, drop unreferenced vertices), and the normal trainer's
``--flip-variants`` flips, so that the same ``np.random.default_rng`` seed
flips the same edges in both packages.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from surfacenetworks_tpu_torch.geometry import graph_ops, mesh_ops


def degenerate_faces(V: np.ndarray, F: np.ndarray, area_eps: float = 1e-12) -> np.ndarray:
    """Indices of (near-)zero-area faces."""
    areas = mesh_ops.face_areas(V, F, degenerate_floor=0.0)
    return np.nonzero(~(areas > area_eps))[0]


def zero_mass_vertices(V: np.ndarray, F: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Vertices whose barycentric mass is (near) zero."""
    mass = np.zeros(V.shape[0])
    bary = mesh_ops.face_areas(V, F, degenerate_floor=0.0) / 3.0
    for c in range(3):
        np.add.at(mass, F[:, c], bary)
    return np.nonzero(mass <= eps)[0]


def collapse_edge(V: np.ndarray, F: np.ndarray, vi: int, vj: int):
    """Collapse vj into vi (midpoint placement); drops faces containing both."""
    V = V.copy()
    V[vi] = (V[vi] + V[vj]) / 2.0
    F = F.copy()
    F[F == vj] = vi
    keep = ~(
        (F[:, 0] == F[:, 1]) | (F[:, 1] == F[:, 2]) | (F[:, 2] == F[:, 0])
    )
    return V, F[keep]


def remove_unreferenced(V: np.ndarray, F: np.ndarray):
    """Drop unreferenced vertices and reindex faces (igl equivalent)."""
    used = np.zeros(V.shape[0], dtype=bool)
    used[F.reshape(-1)] = True
    remap = -np.ones(V.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.sum())
    return V[used], remap[F].astype(F.dtype), np.nonzero(used)[0]


def fix_degenerate(
    V: np.ndarray,
    F: np.ndarray,
    short_edge_ratio: float = 1e-3,
    max_iters: int = 100,
):
    """Iteratively clean a mesh (fix_degenerate.py:29-74 semantics):

    1. collapse edges shorter than ``short_edge_ratio`` x mean edge length;
    2. flip the longest edge of each remaining zero-area (cap) face;
    3. repeat until no degenerate faces remain or ``max_iters``.

    Returns (V, F, ok).
    """
    V = np.asarray(V, dtype=np.float64).copy()
    F = np.asarray(F, dtype=np.int64).copy()
    for _ in range(max_iters):
        if F.size == 0:
            return V, F.astype(np.int32), False
        l = mesh_ops.edge_lengths(V, F)
        mean_l = l.mean()
        # 1) collapse one short edge at a time (indices shift after collapse)
        short = np.argwhere(l < short_edge_ratio * mean_l)
        if len(short):
            f, c = short[0]
            vi, vj = F[f, (c + 1) % 3], F[f, (c + 2) % 3]
            V, F = collapse_edge(V, F, int(vi), int(vj))
            continue
        deg = degenerate_faces(V, F)
        if len(deg) == 0:
            V2, F2, _ = remove_unreferenced(V, F)
            return V2, F2.astype(np.int32), True
        # 2) flip the longest edge of the first degenerate face
        TT, TTi = graph_ops.triangle_triangle_adjacency(F)
        f = int(deg[0])
        # edge_lengths[:, c] is opposite corner c; the igl edge slot for the
        # edge connecting corners (c+1, c+2) is (c+1)
        c = int(np.argmax(mesh_ops.edge_lengths(V, F[f : f + 1])[0]))
        e = (c + 1) % 3
        A = graph_ops.vertex_adjacency(F, V.shape[0]).tolil()
        flipped = flip_edge(F, TT, TTi, f, e, A)
        if not flipped:
            # fall back: collapse the shortest edge of the degenerate face
            ls = mesh_ops.edge_lengths(V, F[f : f + 1])[0]
            c = int(np.argmin(ls))
            vi, vj = F[f, (c + 1) % 3], F[f, (c + 2) % 3]
            V, F = collapse_edge(V, F, int(vi), int(vj))
    V2, F2, _ = remove_unreferenced(V, F)
    return V2, F2.astype(np.int32), len(degenerate_faces(V2, F2)) == 0


def flip_edge(F, TT, TTi, f0: int, e0: int, adj) -> bool:
    """In-place flip of edge slot e0 of face f0 (geom_utils.edge_flip
    semantics): rejects boundary edges and flips that would duplicate an
    existing edge.  Updates F/TT/TTi/adjacency in place."""
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
    """Random constrained edge flips as data augmentation
    (geom_utils.constrained_edge_flip / edge_flip_with_deg_geom:39-108):
    a flip is rejected on boundaries, duplicate edges, valence bounds, near-
    zero new areas, or if the dihedral normal changes by more than ~60 deg.

    Returns (V, F) with F modified in place semantics preserved (copy made).
    """
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


def largest_component(V: np.ndarray, F: np.ndarray):
    """Keep only the largest face-connected component and drop unreferenced
    vertices (largest_component.py:29-48 semantics)."""
    A = graph_ops.dual_adjacency(F)
    n_comp, labels = sp.csgraph.connected_components(A, directed=False)
    if n_comp <= 1:
        keepF = F
    else:
        counts = np.bincount(labels)
        keepF = F[labels == np.argmax(counts)]
    V2, F2, kept = remove_unreferenced(np.asarray(V), np.asarray(keepF))
    return V2, F2, kept
