"""Operator applies (counterpart of ``surfacenetworks_tpu/sparse/ops.py`` and
the apply half of ``sparse/bsr.py``).

Forward only in this slice: serving needs no gradient.  The stored-transpose
backward (``op.bwd``) arrives with the training slice.  A leading batch axis
on the operator and on ``x`` replaces the JAX package's ``vmap``; the kernels
take it in one launch.
"""

from __future__ import annotations

import torch

from surfacenetworks_tpu_torch.sparse import kernels
from surfacenetworks_tpu_torch.sparse.bsr import BsrOperator
from surfacenetworks_tpu_torch.sparse.ell import EllOperator


def spmm(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """``op.fwd @ x``: ``cols [R,K]``, ``x [N,C]`` -> ``[R,C]``, or batched
    ``cols [B,R,K]``, ``x [B,N,C]`` -> ``[B,R,C]``."""
    m = op.fwd
    if m.cols.dim() != x.dim():
        raise ValueError(f"spmm: operator {tuple(m.cols.shape)} and x {tuple(x.shape)} disagree on batching")
    if x.shape[-2] != m.n_cols:
        raise ValueError(f"spmm: x has {x.shape[-2]} rows, the operator {m.n_cols} columns")
    return kernels.ell_matmul(m.cols, m.vals, x, m.window)


def bsr_spmm(op: BsrOperator, x: torch.Tensor) -> torch.Tensor:
    """``op.fwd @ x`` over 128x128 blocks, batched like ``spmm``; returns the
    fp32 accumulation."""
    m = op.fwd
    if m.block_cols.dim() != x.dim():
        raise ValueError(
            f"bsr_spmm: operator {tuple(m.block_cols.shape)} and x {tuple(x.shape)} disagree on batching"
        )
    if x.shape[-2] != m.n_cols:
        raise ValueError(f"bsr_spmm: x has {x.shape[-2]} rows, the operator {m.n_cols} columns")
    return kernels.bsr_matmul(m.block_cols, m.block_vals, x)


def dense_bmm(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense operator apply ``[..., N, N] @ [..., N, C]``."""
    return torch.matmul(L, x)
