"""Block-ELL (BSR) operators (counterpart of ``surfacenetworks_tpu/sparse/bsr.py``).

Mesh Laplacians become banded under a reverse-Cuthill-McKee vertex order, so
a few 128x128 blocks per block-row cover the operator.  Packing is done on the
host with NumPy exactly as in the JAX package (same fitted slot count, same
block layout); the apply is ``sparse.ops.bsr_spmm``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from surfacenetworks_tpu_torch.sparse.ell import check_columns


@dataclasses.dataclass
class BsrMatrix:
    """Padded block-ELL matrix of logical shape (n_rows, n_cols).

    ``block_cols[i, k]``: block-column of the k-th stored block of block-row
    i (0 for padding slots); ``block_vals[i, k]``: that (bs x bs) dense block
    (zero for padding slots).  Leading batch axes allowed.
    """

    block_cols: torch.Tensor  # int32 [..., NB, KB]
    block_vals: torch.Tensor  # float [..., NB, KB, bs, bs]
    n_cols: int

    @property
    def block_size(self) -> int:
        return self.block_vals.shape[-1]

    @property
    def n_rows(self) -> int:
        return self.block_cols.shape[-2] * self.block_size

    def to(self, device) -> "BsrMatrix":
        check_columns(self.block_cols, self.n_cols // self.block_size, "BSR block-column")
        return dataclasses.replace(
            self, block_cols=self.block_cols.to(device), block_vals=self.block_vals.to(device)
        )


@dataclasses.dataclass
class BsrOperator:
    fwd: BsrMatrix
    bwd: BsrMatrix

    def to(self, device) -> "BsrOperator":
        return BsrOperator(fwd=self.fwd.to(device), bwd=self.bwd.to(device))


def rcm_permutation(M: sp.spmatrix) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a (structurally symmetric) operator."""
    return np.asarray(reverse_cuthill_mckee(M.tocsr(), symmetric_mode=True))


def bsr_from_scipy(
    M: sp.spmatrix,
    block_size: int = 128,
    k: int | None = None,
    n_rows: int | None = None,
    n_cols: int | None = None,
    dtype: torch.dtype = torch.float32,
) -> BsrMatrix:
    """Pack a scipy sparse matrix into padded block-ELL (assembled in fp32,
    stored at ``dtype``)."""
    bs = block_size
    R = n_rows if n_rows is not None else M.shape[0]
    C = n_cols if n_cols is not None else M.shape[1]
    R = (R + bs - 1) // bs * bs
    C = (C + bs - 1) // bs * bs
    Mp = sp.csr_matrix(M.astype(np.float32))
    Mp.resize((R, C))
    bsr = Mp.tobsr((bs, bs))
    NB = R // bs
    deg = np.diff(bsr.indptr)
    kmax = int(deg.max()) if deg.size else 0
    if k is None:
        k = max(kmax, 1)
    elif kmax > k:
        raise ValueError(f"BSR k={k} smaller than max block-row degree {kmax}")
    block_cols = np.zeros((NB, k), dtype=np.int32)
    block_vals = np.zeros((NB, k, bs, bs), dtype=np.float32)
    nnzb = bsr.indptr[-1]
    row_of = np.repeat(np.arange(NB), deg)
    slot = np.arange(nnzb) - np.repeat(bsr.indptr[:-1], deg)
    block_cols[row_of, slot] = bsr.indices
    block_vals[row_of, slot] = bsr.data
    return BsrMatrix(
        block_cols=torch.from_numpy(block_cols),
        block_vals=torch.from_numpy(block_vals).to(dtype),
        n_cols=C,
    )


def bsr_operator_from_scipy(
    M: sp.spmatrix,
    block_size: int = 128,
    k: int | None = None,
    n_rows: int | None = None,
    n_cols: int | None = None,
    dtype: torch.dtype = torch.float32,
    k_bwd: int | None = None,
) -> BsrOperator:
    fwd = bsr_from_scipy(M, block_size, k, n_rows, n_cols, dtype)
    bwd = bsr_from_scipy(
        M.T.tocsr(), block_size, k_bwd if k_bwd is not None else k, n_cols, n_rows, dtype
    )
    return BsrOperator(fwd=fwd, bwd=bwd)


def _stack_bsr(ms: list[BsrMatrix]) -> BsrMatrix:
    return BsrMatrix(
        block_cols=torch.stack([m.block_cols for m in ms]),
        block_vals=torch.stack([m.block_vals for m in ms]),
        n_cols=ms[0].n_cols,
    )


def stack_bsr_operators(ops: list[BsrOperator]) -> BsrOperator:
    return BsrOperator(fwd=_stack_bsr([o.fwd for o in ops]), bwd=_stack_bsr([o.bwd for o in ops]))
