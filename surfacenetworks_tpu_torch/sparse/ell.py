"""Padded ELL operators and the structured Dirac operator (counterpart of
``surfacenetworks_tpu/sparse/ell.py``).

Mesh operators have bounded row degree, so each row keeps a fixed number
``K`` of (column, value) slots; padding slots are (column 0, value 0) and add
nothing.  The packing is done on the host with NumPy exactly as in the JAX
package, then held as tensors; ``.to(device)`` copies an operator to the card
once per request.  A leading batch axis on ``cols``/``vals`` is a
block-diagonal batch of operators.  The Dirac pair (Di, DiA) is held as
quaternion coefficient tables with their adjoint tables (DiA is not Di^T:
it is area-rescaled).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from surfacenetworks_tpu_torch.geometry.mesh_ops import DiracCoeffs


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def check_columns(cols: torch.Tensor, limit: int, what: str) -> None:
    """Raise unless every stored column lies in ``[0, limit)``.

    The operators call this in ``.to(device)``, on the host, before they
    reach the card: the CUDA kernels skip an out-of-range slot (a guard
    against reading out of bounds, not a contract) where the plain versions
    raise, so a packing fault is caught here on either path.
    """
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= limit):
        raise ValueError(
            f"{what} outside [0, {limit}): min {int(cols.min())}, max {int(cols.max())}"
        )


@dataclasses.dataclass
class EllMatrix:
    """Padded ELL sparse matrix of logical shape ``(n_rows, n_cols)``.

    ``window`` is the banded bound the JAX package's Pallas kernel needs; it
    is kept so tests can hand the same matrix to that kernel.  The CUDA
    kernel gathers rows directly and does not read it.
    """

    cols: torch.Tensor  # int32 [..., R, K]
    vals: torch.Tensor  # float32 [..., R, K]
    n_cols: int
    window: int = 0

    @property
    def n_rows(self) -> int:
        return self.cols.shape[-2]

    @property
    def k(self) -> int:
        return self.cols.shape[-1]

    def to(self, device, non_blocking: bool = False) -> "EllMatrix":
        check_columns(self.cols, self.n_cols, "ELL column")
        return dataclasses.replace(self, cols=self.cols.to(device, non_blocking=non_blocking),
                                   vals=self.vals.to(device, non_blocking=non_blocking))


@dataclasses.dataclass
class EllOperator:
    """A linear operator with its stored transpose (for the training slice's
    backward), and, once ``transpose_map`` has built it on the host,
    ``fwd``'s pattern transposed as slot references (``transpose_slot_map``:
    ``(t_slots, t_cols)``), through which the SDDMM's backward sums ``db``
    with ``ell_matmul`` in a fixed order.  Only SDDMM operators need it, so
    it is built on request and then travels with the operator."""

    fwd: EllMatrix
    bwd: EllMatrix  # ELL of the transpose
    fwd_t: tuple[torch.Tensor, torch.Tensor] | None = None  # int32 [..., n_cols, K_t] each

    def to(self, device, non_blocking: bool = False) -> "EllOperator":
        fwd_t = None if self.fwd_t is None else tuple(t.to(device, non_blocking=non_blocking) for t in self.fwd_t)
        return EllOperator(fwd=self.fwd.to(device, non_blocking), bwd=self.bwd.to(device, non_blocking), fwd_t=fwd_t)

    def transpose_map(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``fwd``'s ``(t_slots, t_cols)``, built once, on the host."""
        if self.fwd_t is None:
            m = self.fwd
            cols, vals = m.cols.cpu().numpy(), m.vals.cpu().numpy()
            lead = cols.shape[:-2]
            maps = [tuple(map(torch.from_numpy, transpose_slot_map(c, v, m.n_cols)))
                    for c, v in zip(cols.reshape(-1, *cols.shape[-2:]), vals.reshape(-1, *vals.shape[-2:]))]
            self.fwd_t = tuple(t.reshape(lead + t.shape[1:]).to(m.cols.device)
                               for t in _stack_maps(maps, m.n_rows * m.k))
        return self.fwd_t


def _ell_window(cols: np.ndarray, vals: np.ndarray, n_cols: int, tr: int = 128) -> int:
    """Banded-window bound of the JAX package's Pallas ELL kernel.

    For each aligned ``tr``-row tile, the window is measured from the tile's
    smallest nonzero column rounded down to a multiple of 8; the returned
    value (rounded up to a multiple of 128, capped at ``n_cols``) covers
    every tile.
    """
    R, K = cols.shape
    if R == 0 or K == 0:
        return 128
    T = -(-R // tr)
    pad = T * tr - R
    c = np.pad(cols, ((0, pad), (0, 0))).reshape(T, tr * K)
    nz = np.pad(vals, ((0, pad), (0, 0))).reshape(T, tr * K) != 0
    if not nz.any():
        return 128
    mins = np.where(nz, c, np.iinfo(np.int32).max).min(axis=1)
    maxs = np.where(nz, c, -1).max(axis=1)
    has = nz.any(axis=1)
    spans = np.where(has, maxs - (mins // 8) * 8 + 1, 1)
    return int(min(_round_up(int(spans.max()), 128), n_cols))


def transpose_slot_map(cols: np.ndarray, vals: np.ndarray, n_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """The transpose of an ELL pattern ``cols, vals [R, K]`` as slot
    references: ``t_slots, t_cols`` int32 ``[n_cols, K_t]``.

    Row ``j`` lists the live slots (value nonzero) whose column is ``j``, in
    ascending flat slot ``r*K + k`` (so ascending ``r``): ``t_slots[j, t]``
    is that flat slot and ``t_cols[j, t] = r``.  ``K_t`` is the largest
    column count (at least 1).  Padding entries hold slot ``R*K``, which
    points at a zero appended to the flattened values, and column 0.  So for
    per-slot weights ``w [R, K]``, ``ell_matmul(t_cols, w_pad[t_slots], a)``
    is ``sum over (r, k) with cols[r, k] == j of w[r, k] a[r]`` summed in
    that fixed order: the SDDMM's ``db`` without a scatter.
    """
    R, K = cols.shape
    slots = np.flatnonzero(vals.reshape(-1) != 0)  # ascending
    col = cols.reshape(-1)[slots].astype(np.int64)
    if col.size and (col.min() < 0 or col.max() >= n_cols):
        raise ValueError(f"ELL column outside [0, {n_cols}): min {col.min()}, max {col.max()}")
    order = np.argsort(col, kind="stable")  # by column, ascending slot within one
    col_sorted, slot_sorted = col[order], slots[order]
    counts = np.bincount(col, minlength=n_cols)
    k_t = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(col.size) - starts[col_sorted]
    t_slots = np.full((n_cols, k_t), R * K, np.int32)
    t_cols = np.zeros((n_cols, k_t), np.int32)
    t_slots[col_sorted, pos] = slot_sorted
    t_cols[col_sorted, pos] = slot_sorted // K
    return t_slots, t_cols


def _stack_maps(maps: list[tuple[torch.Tensor, torch.Tensor]], pad_slot: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stack ``(t_slots, t_cols)`` pairs, padding each to the largest
    ``K_t`` with slot ``pad_slot`` and column 0."""
    k_t = max(s.shape[-1] for s, _ in maps)
    pad = lambda a, v: torch.nn.functional.pad(a, (0, k_t - a.shape[-1]), value=v)
    return torch.stack([pad(s, pad_slot) for s, _ in maps]), torch.stack([pad(c, 0) for _, c in maps])


def ell_from_scipy(
    M: sp.spmatrix,
    k: int | None = None,
    n_rows: int | None = None,
    n_cols: int | None = None,
    k_multiple: int = 1,
) -> EllMatrix:
    """Pack a scipy sparse matrix into padded ELL.

    ``n_rows`` / ``n_cols`` optionally pad the logical shape (bucketing);
    ``k`` fixes the slot count (defaults to the max row degree, rounded up to
    ``k_multiple``).  Raises if ``k`` is too small.
    """
    csr = M.tocsr()
    csr.sum_duplicates()
    deg = np.diff(csr.indptr)
    kmax = int(deg.max()) if deg.size else 0
    if k is None:
        k = max(_round_up(max(kmax, 1), k_multiple), 1)
    elif kmax > k:
        raise ValueError(f"ELL k={k} smaller than max row degree {kmax}")
    R = n_rows if n_rows is not None else M.shape[0]
    C = n_cols if n_cols is not None else M.shape[1]
    if R < M.shape[0] or C < M.shape[1]:
        raise ValueError("padded shape smaller than matrix shape")
    cols = np.zeros((R, k), dtype=np.int32)
    vals = np.zeros((R, k), dtype=np.float32)
    nnz = csr.indptr[-1]
    row_of = np.repeat(np.arange(M.shape[0]), deg)
    slot = np.arange(nnz) - np.repeat(csr.indptr[:-1], deg)
    cols[row_of, slot] = csr.indices
    vals[row_of, slot] = csr.data
    return EllMatrix(
        cols=torch.from_numpy(cols),
        vals=torch.from_numpy(vals),
        n_cols=C,
        window=_ell_window(cols, vals, C),
    )


def operator_from_scipy(
    M: sp.spmatrix,
    k: int | None = None,
    n_rows: int | None = None,
    n_cols: int | None = None,
    k_multiple: int = 1,
) -> EllOperator:
    """Build an ``EllOperator`` (forward + stored transpose) from scipy."""
    fwd = ell_from_scipy(M, k=k, n_rows=n_rows, n_cols=n_cols, k_multiple=k_multiple)
    # the transpose's max row degree generally differs from the forward one
    bwd = ell_from_scipy(
        M.T.tocsr(), k=None, n_rows=n_cols, n_cols=n_rows, k_multiple=k_multiple
    )
    return EllOperator(fwd=fwd, bwd=bwd)


def _stack_ell(ms: list[EllMatrix]) -> EllMatrix:
    # window=0 means "no banded bound known": if any member lacks one, the
    # batch has none either
    windows = [m.window for m in ms]
    return EllMatrix(
        cols=torch.stack([m.cols for m in ms]),
        vals=torch.stack([m.vals for m in ms]),
        n_cols=ms[0].n_cols,
        window=0 if 0 in windows else max(windows),
    )


def stack_operators(ops: list[EllOperator]) -> EllOperator:
    """Stack per-mesh operators of one padded shape into a batched operator
    (leading axis)."""
    m = ops[0].fwd
    fwd_t = None
    if all(o.fwd_t is not None for o in ops):
        fwd_t = _stack_maps([o.fwd_t for o in ops], m.n_rows * m.k)
    return EllOperator(fwd=_stack_ell([o.fwd for o in ops]), bwd=_stack_ell([o.bwd for o in ops]), fwd_t=fwd_t)


@dataclasses.dataclass
class DiracOperator:
    """Structured quaternionic Dirac operator pair (Di, DiA) of one mesh, or
    a batch of them along a leading axis of every table.

    A ``[N, C]`` feature tensor (``C % 4 == 0``) is read as ``[N, 4, C//4]``
    quaternion channels: the quaternion component is the leading split of
    the channel axis.

    * ``Di v``: faces <- vertices, ``out[i] = sum_c q_fv[i,c] (x) v[faces[i,c]]``;
    * ``DiA f``: vertices <- faces, ``out[j] = sum_s q_vf[j,s] (x) f[vf_face[j,s]]``;
    * ``q_bwd_v`` / ``q_bwd_f``: the adjoint tables the backwards apply.

    Packed valence (``dirac_from_coeffs(base_valence=...)``): the vertex
    tables then hold ``base_valence`` slots, and the few vertices of higher
    valence keep their surplus in ``P`` overflow rows (``ov_*``), which the
    vertex-side apply adds back.  ``ov_rows`` is the JAX package's scatter
    target of each overflow row; the port adds by a gather instead, through
    ``ov_map``, built here on the host: for each vertex row the overflow row
    it takes, or ``P`` for none (a zero row appended to the overflow result),
    so the sum has one fixed order.  The overflow fields are None when
    packing is off.
    """

    faces: torch.Tensor  # int32 [..., M, 3]
    q_fv: torch.Tensor  # f32 [..., M, 3, 4]
    vf_face: torch.Tensor  # int32 [..., N, Kv]
    q_vf: torch.Tensor  # f32 [..., N, Kv, 4]
    q_bwd_v: torch.Tensor  # f32 [..., N, Kv, 4]
    q_bwd_f: torch.Tensor  # f32 [..., M, 3, 4]
    ov_rows: torch.Tensor | None = None  # int32 [..., P] (0-padded)
    ov_face: torch.Tensor | None = None  # int32 [..., P, K_ov]
    q_ov_vf: torch.Tensor | None = None  # f32 [..., P, K_ov, 4]
    q_ov_bwd_v: torch.Tensor | None = None  # f32 [..., P, K_ov, 4]
    ov_map: torch.Tensor | None = None  # int32 [..., N], values in [0, P]

    @property
    def n_vertices(self) -> int:
        return self.vf_face.shape[-2]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[-2]

    def to(self, device, non_blocking: bool = False) -> "DiracOperator":
        check_columns(self.faces, self.n_vertices, "Dirac face vertex")
        check_columns(self.vf_face, self.n_faces, "Dirac incident face")
        if self.ov_map is not None:
            check_columns(self.ov_face, self.n_faces, "Dirac overflow face")
            check_columns(self.ov_map, self.ov_face.shape[-2] + 1, "Dirac overflow map entry")
        return DiracOperator(**{f.name: None if getattr(self, f.name) is None
                                else getattr(self, f.name).to(device, non_blocking=non_blocking)
                                for f in dataclasses.fields(self)})


def dirac_from_coeffs(
    coeffs: DiracCoeffs,
    n_vertices: int | None = None,
    n_faces: int | None = None,
    max_valence: int | None = None,
    base_valence: int | None = None,
    n_overflow: int | None = None,
) -> DiracOperator:
    """Pad a host-side ``DiracCoeffs`` into a static-shape ``DiracOperator``
    (the JAX package's packing, NumPy for NumPy).

    Zero quaternion coefficients make padded faces, vertices and slots inert.
    ``base_valence`` (< ``max_valence``) packs the vertex tables: each vertex
    keeps its first ``base_valence`` used slots; vertices of higher valence
    park the surplus in ``n_overflow`` rows of ``max_valence -
    base_valence`` slots.
    """
    N = n_vertices if n_vertices is not None else coeffs.n_vertices
    M = n_faces if n_faces is not None else coeffs.n_faces
    Kv = max_valence if max_valence is not None else coeffs.vf_face.shape[1]
    if N < coeffs.n_vertices or M < coeffs.n_faces or Kv < coeffs.vf_face.shape[1]:
        raise ValueError("padded shape smaller than mesh")

    def pad(a, shape):
        out = np.zeros(shape, dtype=a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    vf_face = pad(coeffs.vf_face.astype(np.int32), (N, Kv))
    q_vf = pad(coeffs.q_vf, (N, Kv, 4))
    q_bwd_v = pad(coeffs.q_bwd_v, (N, Kv, 4))
    overflow = {}
    if base_valence is not None and base_valence < Kv:
        B, K_ov = base_valence, Kv - base_valence
        # used slots first within each row (stable), then split
        used = (q_vf != 0).any(-1) | (q_bwd_v != 0).any(-1)
        order = np.argsort(~used, axis=1, kind="stable")
        vf_face = np.take_along_axis(vf_face, order, axis=1)
        q_vf = np.take_along_axis(q_vf, order[..., None], axis=1)
        q_bwd_v = np.take_along_axis(q_bwd_v, order[..., None], axis=1)
        used = np.take_along_axis(used, order, axis=1)
        rows = np.flatnonzero(used[:, B:].any(axis=1))
        P = n_overflow if n_overflow is not None else _round_up(max(len(rows), 1), 8)
        if len(rows) > P:
            raise ValueError(
                f"n_overflow={P} smaller than {len(rows)} over-valence vertices"
            )
        ov_rows = np.zeros(P, np.int32)
        ov_face = np.zeros((P, K_ov), np.int32)
        q_ov_vf = np.zeros((P, K_ov, 4), np.float32)
        q_ov_bwd_v = np.zeros((P, K_ov, 4), np.float32)
        ov_rows[: len(rows)] = rows
        ov_face[: len(rows)] = vf_face[rows, B:]
        q_ov_vf[: len(rows)] = q_vf[rows, B:]
        q_ov_bwd_v[: len(rows)] = q_bwd_v[rows, B:]
        vf_face, q_vf, q_bwd_v = vf_face[:, :B], q_vf[:, :B], q_bwd_v[:, :B]
        # the padded overflow rows (q = 0) add nothing, so no vertex takes them
        ov_map = np.full(N, P, np.int32)
        ov_map[rows] = np.arange(len(rows), dtype=np.int32)
        overflow = dict(ov_rows=ov_rows, ov_face=ov_face, q_ov_vf=q_ov_vf, q_ov_bwd_v=q_ov_bwd_v, ov_map=ov_map)

    tables = dict(
        faces=pad(coeffs.F.astype(np.int32), (M, 3)),
        q_fv=pad(coeffs.q_fv, (M, 3, 4)),
        vf_face=vf_face,
        q_vf=q_vf,
        q_bwd_v=q_bwd_v,
        q_bwd_f=pad(coeffs.q_bwd_f, (M, 3, 4)),
        **overflow,
    )
    return DiracOperator(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tables.items()})


def stack_dirac(ops: list[DiracOperator]) -> DiracOperator:
    """Batch per-mesh Dirac operators along a new leading axis."""
    has_ov = [o.ov_map is not None for o in ops]
    if any(has_ov) and not all(has_ov):
        raise ValueError("cannot stack packed and unpacked Dirac operators")
    return DiracOperator(**{f.name: None if getattr(ops[0], f.name) is None
                            else torch.stack([getattr(o, f.name) for o in ops])
                            for f in dataclasses.fields(DiracOperator)})


@dataclasses.dataclass(frozen=True)
class EllSpec:
    """A dataset's static ELL bucket (chosen once, reused for every batch)."""

    n_rows: int
    n_cols: int
    k: int
