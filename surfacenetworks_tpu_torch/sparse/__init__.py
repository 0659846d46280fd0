"""Sparse operators, their applies and the SDDMM, their kernels, and the
structured Dirac operator (counterpart of ``surfacenetworks_tpu/sparse``)."""

from surfacenetworks_tpu_torch.sparse.bsr import (
    BsrMatrix,
    BsrOperator,
    bsr_from_scipy,
    bsr_operator_from_scipy,
    rcm_permutation,
    stack_bsr_operators,
)
from surfacenetworks_tpu_torch.sparse.ell import (
    DiracOperator,
    EllMatrix,
    EllOperator,
    dirac_from_coeffs,
    ell_from_scipy,
    operator_from_scipy,
    stack_dirac,
    stack_operators,
)
from surfacenetworks_tpu_torch.sparse.ops import (
    bsr_spmm,
    dense_bmm,
    dirac_apply_fv,
    dirac_apply_vf,
    sddmm,
    spmm,
)

__all__ = [
    "BsrMatrix",
    "BsrOperator",
    "DiracOperator",
    "EllMatrix",
    "EllOperator",
    "bsr_from_scipy",
    "bsr_operator_from_scipy",
    "bsr_spmm",
    "dense_bmm",
    "dirac_apply_fv",
    "dirac_apply_vf",
    "dirac_from_coeffs",
    "ell_from_scipy",
    "operator_from_scipy",
    "rcm_permutation",
    "sddmm",
    "spmm",
    "stack_dirac",
    "stack_bsr_operators",
    "stack_operators",
]
