"""Host-side mesh operators (NumPy/SciPy), copied from the JAX package.

Counterpart of ``surfacenetworks_tpu/geometry/mesh_ops.py``.  The functions
below are verbatim copies of the ones the port's Laplacian and Dirac paths
need, so the port builds identical operators without importing the JAX
package (whose ``__init__`` imports jax and flax).
"""

from __future__ import annotations

import dataclasses

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


def dist_matrix(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Sparse symmetric matrix of pairwise vertex distances within each face
    (parity: utils/mesh.py:17-26 ``dist``; includes the zero diagonal pattern)."""
    V = np.asarray(V, dtype=np.float64)
    M = F.shape[0]
    # all ordered pairs (i, j) within each face, including i == j
    idx_a = np.repeat(F, 3, axis=1).reshape(-1)  # i i i j j j k k k per face
    idx_b = np.tile(F, (1, 3)).reshape(-1)  # i j k i j k i j k per face
    d = np.linalg.norm(V[idx_a] - V[idx_b], axis=1)
    n = V.shape[0]
    # duplicate (i, j) pairs (shared edges) all carry the same distance, so
    # COO's summing semantics would be wrong — keep one entry per unique pair
    # (the reference assigns into a dense matrix, last write wins).
    pairs = np.stack([idx_a, idx_b], axis=1)
    uniq, first = np.unique(pairs, axis=0, return_index=True)
    W = sp.coo_matrix((d[first], (uniq[:, 0], uniq[:, 1])), shape=(n, n))
    return W.tocsr()


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


def mesh_laplacian(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Cotan ``L = A^{-1}(D - W)`` straight from ``(V, F)``: the offline
    operator of the ARAP sequences."""
    W, A_inv = cotangent_weights(V, F)
    return laplacian(W, A_inv)


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


def quaternion_matrix(q: np.ndarray) -> np.ndarray:
    """Left-multiplication matrix L(q) with L(q) x = q (x) quaternion product.

    Parity: utils/mesh.py:28-33. Supports batched input [..., 4] -> [..., 4, 4].
    """
    q = np.asarray(q)
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        np.stack([a, -b, -c, -d], axis=-1),
        np.stack([b, a, -d, c], axis=-1),
        np.stack([c, d, a, -b], axis=-1),
        np.stack([d, -c, b, a], axis=-1),
    ]
    return np.stack(rows, axis=-2)


@dataclasses.dataclass
class DiracCoeffs:
    """Structured quaternion-coefficient form of the Dirac operator pair.

    The structured applies (``sparse/ops.py``) consume this directly instead
    of a generic sparse matrix:

    * ``Di v``  (faces <- vertices): ``out[i] = sum_c q_fv[i, c] (x) v[F[i, c]]``
      where ``q_fv[i, c] = -e_{i,c} / (2 A_f[i])`` is a pure quaternion built
      from the opposite edge ``e_{i,c} = V[F[i,(c+1)%3]] - V[F[i,(c+2)%3]]``.
    * ``DiA f`` (vertices <- faces): the adjoint blocks are
      ``(q_fv block)^T * A_f / A_v = L(e_{i,c}) / (2 A_v[j])`` — represented via
      a per-vertex incidence table of up to ``max_valence`` (face, corner)
      pairs with quaternion coefficient ``q_vf[j, s] = e_{i,c} / (2 A_v[j])``.

    (Uses L(e)^T = L(-e) for pure quaternions e.)
    Parity: utils/mesh.py:35-64 (``dirac``).
    """

    F: np.ndarray  # [M, 3] int32 — face vertex indices
    q_fv: np.ndarray  # [M, 3, 4] float32 — Di quaternion coeffs per corner
    vf_face: np.ndarray  # [N, Kv] int32 — incident face index (0-padded)
    vf_corner: np.ndarray  # [N, Kv] int32 — corner of this vertex in that face
    q_vf: np.ndarray  # [N, Kv, 4] float32 — DiA quaternion coeffs (0-padded)
    # adjoint coefficient tables for the applies' backwards (the counterpart
    # of the reference's stored-transpose backward, sparse_bmm_func.py:53-72);
    # uses L(q)^T = L(conj q) and conj(pure e) = -e:
    q_bwd_v: np.ndarray  # [N, Kv, 4] — VJP of Di  (vertices <- faces): -q_fv at (vf_face, vf_corner)
    q_bwd_f: np.ndarray  # [M, 3, 4]  — VJP of DiA (faces <- vertices): -q_vf at matching slots
    n_vertices: int
    n_faces: int


def dirac_coeffs(V: np.ndarray, F: np.ndarray, max_valence: int | None = None) -> DiracCoeffs:
    """Build the structured Dirac coefficients from (V, F)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int32)
    n, m = V.shape[0], F.shape[0]
    Af = face_areas(V, F)
    Av = np.zeros(n)
    for c in range(3):
        np.add.at(Av, F[:, c], Af / 3.0)

    # edge opposite corner c: e = V[F[:, (c+1)%3]] - V[F[:, (c+2)%3]]
    e = np.stack([V[F[:, (c + 1) % 3]] - V[F[:, (c + 2) % 3]] for c in range(3)], axis=1)
    q_fv = np.zeros((m, 3, 4))
    q_fv[:, :, 1:] = -e / (2.0 * Af)[:, None, None]

    # per-vertex incidence (face, corner) lists
    counts = np.zeros(n, dtype=np.int64)
    np.add.at(counts, F.reshape(-1), 1)
    Kv = int(counts.max()) if max_valence is None else max_valence
    vf_face = np.zeros((n, Kv), dtype=np.int32)
    vf_corner = np.zeros((n, Kv), dtype=np.int32)
    q_vf = np.zeros((n, Kv, 4))
    # sort-based fill to stay vectorizable for large meshes
    flat_v = F.reshape(-1)
    order = np.argsort(flat_v, kind="stable")
    faces_sorted = (np.repeat(np.arange(m), 3))[order]
    corners_sorted = (np.tile(np.arange(3), m))[order]
    verts_sorted = flat_v[order]
    slot = np.arange(len(verts_sorted)) - np.searchsorted(verts_sorted, verts_sorted)
    keep = slot < Kv
    vf_face[verts_sorted[keep], slot[keep]] = faces_sorted[keep]
    vf_corner[verts_sorted[keep], slot[keep]] = corners_sorted[keep]
    # DiA coeff: +e_{i,c} / (2 A_v[j])
    ecoef = e[faces_sorted[keep], corners_sorted[keep]] / (2.0 * Av[verts_sorted[keep]])[:, None]
    q_vf[verts_sorted[keep], slot[keep], 1:] = ecoef

    q_bwd_v = np.zeros((n, Kv, 4))
    q_bwd_v[verts_sorted[keep], slot[keep]] = -q_fv[faces_sorted[keep], corners_sorted[keep]]
    q_bwd_f = np.zeros((m, 3, 4))
    q_bwd_f[faces_sorted[keep], corners_sorted[keep]] = -q_vf[verts_sorted[keep], slot[keep]]
    return DiracCoeffs(
        F=F,
        q_fv=q_fv.astype(np.float32),
        vf_face=vf_face,
        vf_corner=vf_corner,
        q_vf=q_vf.astype(np.float32),
        q_bwd_v=q_bwd_v.astype(np.float32),
        q_bwd_f=q_bwd_f.astype(np.float32),
        n_vertices=n,
        n_faces=m,
    )


def dirac(V: np.ndarray, F: np.ndarray) -> tuple[sp.csr_matrix, sp.csr_matrix]:
    """Scipy-CSR Dirac operator pair (D [4M x 4N], DA [4N x 4M]).

    Vectorized parity with utils/mesh.py:35-64: D block (face i, vertex j=F[i,c])
    is ``-L(e_{i,c}) / (2 A_f[i])``; DA block is its transpose times
    ``A_f[i]/A_v[j]``.
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int32)
    n, m = V.shape[0], F.shape[0]
    coeffs = dirac_coeffs(V, F)
    Af = face_areas(V, F)
    Av = np.zeros(n)
    for c in range(3):
        np.add.at(Av, F[:, c], Af / 3.0)

    blocks = quaternion_matrix(coeffs.q_fv.astype(np.float64))  # [M, 3, 4, 4]

    # D: rows 4i..4i+3, cols 4j..4j+3
    fi = np.repeat(np.arange(m), 3)
    vj = F.reshape(-1)
    b = blocks.reshape(-1, 4, 4)  # [3M, 4, 4]
    rr = (4 * fi[:, None, None] + np.arange(4)[None, :, None]).repeat(4, axis=2)
    cc = (4 * vj[:, None, None] + np.arange(4)[None, None, :]).repeat(4, axis=1)
    D = sp.coo_matrix((b.ravel(), (rr.ravel(), cc.ravel())), shape=(4 * m, 4 * n)).tocsr()

    bt = np.swapaxes(b, 1, 2) * (Af[np.repeat(np.arange(m), 3)] / Av[vj])[:, None, None]
    rr2 = (4 * vj[:, None, None] + np.arange(4)[None, :, None]).repeat(4, axis=2)
    cc2 = (4 * fi[:, None, None] + np.arange(4)[None, None, :]).repeat(4, axis=1)
    DA = sp.coo_matrix((bt.ravel(), (rr2.ravel(), cc2.ravel())), shape=(4 * n, 4 * m)).tocsr()
    return D, DA


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
