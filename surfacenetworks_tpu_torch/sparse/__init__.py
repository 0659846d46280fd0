"""Sparse operators, their applies and the SDDMM, and their kernels
(counterpart of ``surfacenetworks_tpu/sparse``)."""

from surfacenetworks_tpu_torch.sparse.bsr import (
    BsrMatrix,
    BsrOperator,
    bsr_from_scipy,
    bsr_operator_from_scipy,
    rcm_permutation,
    stack_bsr_operators,
)
from surfacenetworks_tpu_torch.sparse.ell import (
    EllMatrix,
    EllOperator,
    ell_from_scipy,
    operator_from_scipy,
    stack_operators,
)
from surfacenetworks_tpu_torch.sparse.ops import bsr_spmm, dense_bmm, sddmm, spmm

__all__ = [
    "BsrMatrix",
    "BsrOperator",
    "EllMatrix",
    "EllOperator",
    "bsr_from_scipy",
    "bsr_operator_from_scipy",
    "bsr_spmm",
    "dense_bmm",
    "ell_from_scipy",
    "operator_from_scipy",
    "rcm_permutation",
    "sddmm",
    "spmm",
    "stack_bsr_operators",
    "stack_operators",
]
