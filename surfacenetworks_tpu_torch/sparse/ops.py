"""Operator applies and the SDDMM (counterpart of
``surfacenetworks_tpu/sparse/ops.py`` and the apply half of ``sparse/bsr.py``).

``spmm``, ``bsr_spmm`` and ``sddmm`` are ``torch.autograd.Function``s, as the
JAX package's are ``custom_vjp``s, on the CPU and on the card alike:

* ``spmm`` / ``bsr_spmm``: forward ``op.fwd @ x``, backward
  ``x_bar = op.bwd @ g`` through the same kernel (the stored transpose); the
  operator gets no gradient.
* ``sddmm``: forward ``<a[r], b[cols[r,k]]>`` at the pattern's live slots;
  backward ``da = ELL-SpMM(cols, gm, b)`` and ``db`` = the segment sum of
  ``gm[r,k] a[r]`` into row ``cols[r,k]``, with ``gm`` the cotangent at
  live slots.  The JAX package leaves that segment sum to XLA
  (``jax.ops.segment_sum``).  Here it is an ELL SpMM too, over the
  pattern's transpose slot map (``EllOperator.transpose_map``): both sums go
  through ``ell_matmul``, which adds each row's slots in a fixed order, so
  the backward gives the same bits on every run (a scatter with atomics
  would not).

The kernel wrappers write into fresh tensors, so autograd would see no graph
through them: these Functions are what carries the gradient.  Cotangents
reach an apply as slices of the ``[x || L x]`` concat's gradient, so they
are made contiguous before a kernel reads them.  A leading batch axis on the
operator and on the dense operands replaces the JAX package's ``vmap``; the
kernels take it in one launch.
"""

from __future__ import annotations

import torch

from surfacenetworks_tpu_torch.sparse import kernels
from surfacenetworks_tpu_torch.sparse.bsr import BsrOperator
from surfacenetworks_tpu_torch.sparse.ell import EllOperator


class _EllApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: EllOperator, x: torch.Tensor) -> torch.Tensor:
        ctx.op, ctx.dtype = op, x.dtype
        m = op.fwd
        return kernels.ell_matmul(m.cols, m.vals, x.contiguous(), m.window)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        m = ctx.op.bwd
        return None, kernels.ell_matmul(m.cols, m.vals, g.contiguous(), m.window).to(ctx.dtype)


class _BsrApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: BsrOperator, x: torch.Tensor) -> torch.Tensor:
        ctx.op, ctx.dtype = op, x.dtype
        m = op.fwd
        return kernels.bsr_matmul(m.block_cols, m.block_vals, x.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        m = ctx.op.bwd
        return None, kernels.bsr_matmul(m.block_cols, m.block_vals, g.contiguous()).to(ctx.dtype)


def spmm(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """``op.fwd @ x``: ``cols [R,K]``, ``x [N,C]`` -> ``[R,C]``, or batched
    ``cols [B,R,K]``, ``x [B,N,C]`` -> ``[B,R,C]``."""
    m = op.fwd
    if m.cols.dim() != x.dim():
        raise ValueError(f"spmm: operator {tuple(m.cols.shape)} and x {tuple(x.shape)} disagree on batching")
    if x.shape[-2] != m.n_cols:
        raise ValueError(f"spmm: x has {x.shape[-2]} rows, the operator {m.n_cols} columns")
    return _EllApply.apply(op, x)


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
    return _BsrApply.apply(op, x)


def dense_bmm(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense operator apply ``[..., N, N] @ [..., N, C]``."""
    return torch.matmul(L, x)


class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: EllOperator, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.op = op
        ctx.save_for_backward(a, b)
        m = op.fwd
        return kernels.sddmm(m.cols, m.vals, a.contiguous(), b.contiguous(), m.window)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        m = ctx.op.fwd
        gm = torch.where(m.vals != 0, g, torch.zeros_like(g)).contiguous()
        da = db = None
        if ctx.needs_input_grad[1]:
            da = kernels.ell_matmul(m.cols, gm, b.contiguous()).to(a.dtype)
        if ctx.needs_input_grad[2]:
            # gm at each transposed entry's slot; padding entries read the appended 0
            t_slots, t_cols = ctx.op.transpose_map()
            flat = torch.cat([gm.flatten(-2), gm.new_zeros(gm.shape[:-2] + (1,))], dim=-1)
            tv = torch.gather(flat, -1, t_slots.flatten(-2).long()).reshape(t_slots.shape)
            db = kernels.ell_matmul(t_cols, tv, a.contiguous()).to(b.dtype)
        return None, da, db


def sddmm(op: EllOperator, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense product at the pattern of ``op.fwd``:
    ``a [..., R, C]``, ``b [..., N, C]`` -> ``[..., R, K]`` ELL values on
    ``op.fwd.cols``.  A slot is live iff its stored value is nonzero (the
    ELL padding convention); padding slots give 0.  Gradients flow to both
    ``a`` and ``b``."""
    m = op.fwd
    if m.cols.dim() != a.dim() or a.dim() != b.dim():
        raise ValueError(
            f"sddmm: operator {tuple(m.cols.shape)}, a {tuple(a.shape)} and b {tuple(b.shape)} disagree on batching"
        )
    if a.shape[-2] != m.n_rows or b.shape[-2] != m.n_cols:
        raise ValueError(
            f"sddmm: a has {a.shape[-2]} rows and b {b.shape[-2]}, the pattern is {m.n_rows} x {m.n_cols}"
        )
    return _Sddmm.apply(op, a, b)
