"""Block-ELL (BSR) operators (counterpart of ``surfacenetworks_tpu/sparse/bsr.py``).

Mesh Laplacians become banded under a reverse-Cuthill-McKee vertex order, so
a few 128x128 blocks per block-row cover the operator.  Packing is done on the
host with NumPy exactly as in the JAX package (same fitted slot count, same
block layout); the apply is ``sparse.ops.bsr_spmm``.

``BsrOperator`` also carries, per side, the live-chunk mask of its stored
blocks (``live_chunks``), built once on the host: the bf16 kernel skips the
64-row x 32-deep chunks of a block that hold only zeros.  It has no
counterpart in the JAX package and sits beside ``BsrMatrix``, whose fields
are the JAX package's.
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

    def to(self, device, non_blocking: bool = False) -> "BsrMatrix":
        check_columns(self.block_cols, self.n_cols // self.block_size, "BSR block-column")
        return dataclasses.replace(
            self, block_cols=self.block_cols.to(device, non_blocking=non_blocking),
            block_vals=self.block_vals.to(device, non_blocking=non_blocking)
        )


def live_chunks(m: BsrMatrix) -> torch.Tensor:
    """uint8 ``[..., NB, KB]`` of a matrix of 128x128 blocks (the kernels'
    block): bit ``4 h + d`` of slot ``[i, k]`` is set where rows ``64 h ..
    64 h + 63`` and columns ``32 d .. 32 d + 31`` of the stored block hold a
    nonzero, the chunk one CTA of the bf16 kernel loads at a time.  A
    padding slot (all zero) and a block-column outside ``[0, n_cols/128)``
    have no bit set."""
    if m.block_size != 128:
        raise ValueError(f"live_chunks: the kernels' blocks are 128x128, got {m.block_size}")
    lead = m.block_vals.shape[:-2]
    nz = (m.block_vals != 0).reshape(*lead, 2, 64, 4, 32).any(dim=-1).any(dim=-2)  # [..., 2, 4]
    bits = (nz.to(torch.int32) << torch.arange(8, dtype=torch.int32).reshape(2, 4)).sum(dim=(-2, -1))
    in_range = (m.block_cols >= 0) & (m.block_cols < m.n_cols // 128)
    return torch.where(in_range, bits, 0).to(torch.uint8)


@dataclasses.dataclass
class BsrOperator:
    """The operator (``fwd``) and its stored transpose (``bwd``), each with
    its optional live-chunk mask (``live_chunks``; None: every chunk is
    read)."""

    fwd: BsrMatrix
    bwd: BsrMatrix
    fwd_live: torch.Tensor | None = None  # uint8 [..., NB, KB]
    bwd_live: torch.Tensor | None = None

    def to(self, device, non_blocking: bool = False) -> "BsrOperator":
        return BsrOperator(
            fwd=self.fwd.to(device, non_blocking),
            bwd=self.bwd.to(device, non_blocking),
            fwd_live=None if self.fwd_live is None else self.fwd_live.to(device, non_blocking=non_blocking),
            bwd_live=None if self.bwd_live is None else self.bwd_live.to(device, non_blocking=non_blocking),
        )


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
    if block_size != 128:  # no kernel takes other blocks, so no mask
        return BsrOperator(fwd=fwd, bwd=bwd)
    return BsrOperator(fwd=fwd, bwd=bwd, fwd_live=live_chunks(fwd), bwd_live=live_chunks(bwd))


def _stack_bsr(ms: list[BsrMatrix]) -> BsrMatrix:
    return BsrMatrix(
        block_cols=torch.stack([m.block_cols for m in ms]),
        block_vals=torch.stack([m.block_vals for m in ms]),
        n_cols=ms[0].n_cols,
    )


def _stack_live(masks: list) -> torch.Tensor | None:
    return None if any(m is None for m in masks) else torch.stack(masks)


def stack_bsr_operators(ops: list[BsrOperator]) -> BsrOperator:
    """A leading batch axis over operators of one shape; the live-chunk
    masks are stacked where every operator has them."""
    return BsrOperator(
        fwd=_stack_bsr([o.fwd for o in ops]),
        bwd=_stack_bsr([o.bwd for o in ops]),
        fwd_live=_stack_live([o.fwd_live for o in ops]),
        bwd_live=_stack_live([o.bwd_live for o in ops]),
    )
