"""Padded ELL operators (counterpart of ``surfacenetworks_tpu/sparse/ell.py``).

Mesh operators have bounded row degree, so each row keeps a fixed number
``K`` of (column, value) slots; padding slots are (column 0, value 0) and add
nothing.  The packing is done on the host with NumPy exactly as in the JAX
package, then held as tensors; ``.to(device)`` copies an operator to the card
once per request.  A leading batch axis on ``cols``/``vals`` is a
block-diagonal batch of operators.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


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

    def to(self, device) -> "EllMatrix":
        check_columns(self.cols, self.n_cols, "ELL column")
        return dataclasses.replace(self, cols=self.cols.to(device), vals=self.vals.to(device))


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

    def to(self, device) -> "EllOperator":
        fwd_t = None if self.fwd_t is None else tuple(t.to(device) for t in self.fwd_t)
        return EllOperator(fwd=self.fwd.to(device), bwd=self.bwd.to(device), fwd_t=fwd_t)

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
