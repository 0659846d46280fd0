"""Graclus-style graph coarsening for the multiresolution cascade models,
copied from the JAX package (counterpart of
``surfacenetworks_tpu/geometry/coarsening.py``, verbatim).

The reference's ``EfficientCascade`` ("efficient pooling in Deff2017",
normal_predict/models.py:413-609) consumes a precomputed Laplacian pyramid
``Laps[0..k-1]`` (coarsest..finest) over a vertex ordering in which each
coarse vertex's two children sit at consecutive fine positions ``2c, 2c+1``
— so pooling is ``MaxPool1d(2)`` and unpooling is nearest-neighbour
upsampling.  The pyramid-construction code is absent from the reference
repo; this module supplies it with the standard greedy-matching (Graclus)
scheme from the cnn_graph lineage:

* pair each unmatched vertex with its unmatched neighbour maximizing
  ``w_ij (1/d_i + 1/d_j)``; leftovers become singletons (paired with a fake
  zero-degree slot);
* coarse weights ``W_c = S W S^T``;
* fine-level vertices reordered so cluster members are adjacent.

All levels are padded to static bucket sizes (fine bucket divisible by
``2**(levels-1)``), fake slots carry mask 0 and zero operator rows.

Known fault, kept so that both packages drop the same vertices: the
coarsest level's order covers only ``n_bucket / 2**(levels-1)`` slots, so
where singleton clusters push a coarse level's real count above that, the
clusters past it are skipped and their fine vertices get mask 0 (at 4
levels a 7,000-vertex synthetic mesh in a 7,000-row bucket keeps 6,139).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from surfacenetworks_tpu_torch.geometry import graph_ops, mesh_ops


@dataclasses.dataclass
class PyramidLevel:
    L: sp.csr_matrix  # operator at this level (padded, ordered)
    n_real: int  # number of real (non-fake) vertices


@dataclasses.dataclass
class LaplacianPyramid:
    levels: list[PyramidLevel]  # [coarsest ... finest], reference Laps order
    perm: np.ndarray  # fine-level vertex ordering: position -> original index (fakes = -1)

    @property
    def finest(self) -> PyramidLevel:
        return self.levels[-1]


def _greedy_match(W: sp.csr_matrix) -> list[list[int]]:
    """Pair vertices greedily by normalized edge weight; returns clusters of
    size 1 or 2 covering all vertices."""
    n = W.shape[0]
    W = W.tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel() + 1e-12
    order = np.argsort(-deg)  # heavy vertices first
    matched = np.zeros(n, dtype=bool)
    clusters: list[list[int]] = []
    for i in order:
        if matched[i]:
            continue
        matched[i] = True
        best_j, best_w = -1, -np.inf
        start, end = W.indptr[i], W.indptr[i + 1]
        for j, w in zip(W.indices[start:end], W.data[start:end]):
            if matched[j] or j == i:
                continue
            score = w * (1.0 / deg[i] + 1.0 / deg[j])
            if score > best_w:
                best_w, best_j = score, j
        if best_j >= 0:
            matched[best_j] = True
            clusters.append([int(i), int(best_j)])
        else:
            clusters.append([int(i)])
    return clusters


def build_pyramid(
    V: np.ndarray,
    F: np.ndarray,
    levels: int,
    n_bucket: int | None = None,
    laplacian_kind: str = "rw",
) -> LaplacianPyramid:
    """Coarsen the mesh graph ``levels-1`` times and return the Laplacian
    pyramid in reference order (coarsest first).

    ``laplacian_kind``: 'rw' = random-walk normalized graph Laplacian
    (I - D^-1 W); 'cot' uses the cotangent Laplacian at the finest level and
    random-walk Laplacians of the coarsened weight graphs above it.
    """
    n = V.shape[0]
    unit = 2 ** (levels - 1)
    if n_bucket is None:
        n_bucket = (n + unit - 1) // unit * unit
    assert n_bucket % unit == 0 and n_bucket >= n

    W = mesh_ops.dist_matrix(V, F)
    W = graph_ops.uniform_weights(W)

    # per level: clusters over current REAL vertices
    perms: list[np.ndarray] = []  # mapping position -> current-level index (-1 fake)
    Ws = [W]
    n_real = [n]
    for lvl in range(levels - 1):
        clusters = _greedy_match(Ws[-1])
        n_c = len(clusters)
        # fine ordering: cluster c members at 2c, 2c+1 (fake = -1)
        fine_pos = -np.ones(2 * n_c, dtype=np.int64)
        rows, cols = [], []
        for c, members in enumerate(clusters):
            for s, m in enumerate(members):
                fine_pos[2 * c + s] = m
                rows.append(m)
                cols.append(c)
        S = sp.coo_matrix(
            (np.ones(len(rows)), (rows, cols)), shape=(Ws[-1].shape[0], n_c)
        ).tocsr()
        Wc = (S.T @ Ws[-1] @ S).tocsr()
        Wc.setdiag(0)
        Wc.eliminate_zeros()
        perms.append(fine_pos)
        Ws.append(Wc)
        n_real.append(n_c)

    # compose orderings: position at finest level -> original vertex
    # build from coarsest down: coarse level ordering is identity (c -> c)
    sizes = [n_bucket // (2**i) for i in range(levels)]  # finest..coarsest buckets
    sizes = sizes[::-1]  # coarsest..finest

    # order at each level as arrays position->current-level index
    orders: list[np.ndarray] = [None] * levels  # coarsest..finest
    orders[0] = np.arange(sizes[0])
    orders[0][n_real[levels - 1] :] = -1  # fake coarse slots
    for i in range(1, levels):
        coarse_order = orders[i - 1]
        fine_pos = perms[levels - 1 - i]  # clusters at this coarsening step
        order = -np.ones(sizes[i], dtype=np.int64)
        for pos_c, c in enumerate(coarse_order):
            if c < 0 or 2 * c + 1 >= len(fine_pos):
                continue
            order[2 * pos_c] = fine_pos[2 * c]
            order[2 * pos_c + 1] = fine_pos[2 * c + 1]
        orders[i] = order

    # build padded, ordered operators per level
    lvls: list[PyramidLevel] = []
    for i in range(levels):
        Wl = Ws[levels - 1 - i]
        if i == levels - 1 and laplacian_kind == "cot":
            Ll = mesh_ops.mesh_laplacian(V, F)
        else:
            Ll = graph_ops.graph_laplacian(Wl, normalized=True, symmetric=False)
        order = orders[i]
        npad = sizes[i]
        # scatter rows/cols of Ll into ordered padded matrix
        src = order[order >= 0]
        dst = np.nonzero(order >= 0)[0]
        pos_of = -np.ones(Ll.shape[0], dtype=np.int64)
        pos_of[src] = dst
        coo = Ll.tocoo()
        keep = (pos_of[coo.row] >= 0) & (pos_of[coo.col] >= 0)
        Lp = sp.coo_matrix(
            (coo.data[keep], (pos_of[coo.row[keep]], pos_of[coo.col[keep]])),
            shape=(npad, npad),
        ).tocsr()
        lvls.append(PyramidLevel(L=Lp.astype(np.float32), n_real=int((order >= 0).sum())))
    return LaplacianPyramid(levels=lvls, perm=orders[-1])


def pyramid_mask(pyramid: LaplacianPyramid) -> np.ndarray:
    """Finest-level [N, 1] mask (1 on real slots)."""
    order = pyramid.perm
    return (order >= 0).astype(np.float32)[:, None]


def reorder_fine_data(pyramid: LaplacianPyramid, arr: np.ndarray) -> np.ndarray:
    """Gather per-vertex data into the pyramid's finest-level ordering
    (fake slots zero-filled)."""
    order = pyramid.perm
    out = np.zeros((len(order),) + arr.shape[1:], dtype=arr.dtype)
    valid = order >= 0
    out[valid] = arr[order[valid]]
    return out
