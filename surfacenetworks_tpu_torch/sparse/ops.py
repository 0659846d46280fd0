"""Operator applies and the SDDMM (counterpart of
``surfacenetworks_tpu/sparse/ops.py`` and the apply half of ``sparse/bsr.py``).

``spmm``, ``bsr_spmm`` and ``sddmm`` are ``torch.autograd.Function``s, as the
JAX package's are ``custom_vjp``s, on the CPU and on the card alike:

* ``spmm`` / ``bsr_spmm``: forward ``op.fwd @ x``, backward
  ``x_bar = op.bwd @ g`` through the same kernel (the stored transpose); the
  operator gets no gradient.
* ``sddmm``: forward ``<a[r], b[cols[r,k]]>`` at the pattern's live slots;
  backward ``da = ELL-SpMM(cols, gm, b)`` through ``ell_matmul`` and
  ``db`` = the segment sum of ``gm[r,k] a[r]`` into row ``cols[r,k]``, with
  ``gm`` the cotangent at live slots.  The JAX package leaves that segment
  sum to XLA (``jax.ops.segment_sum``); here it is ``index_add_``.

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


def segment_sum_rows(cols: torch.Tensor, w: torch.Tensor, a: torch.Tensor, n: int) -> torch.Tensor:
    """``out[j] = sum over (r, k) with cols[r,k] == j of w[r,k] a[r]``:
    ``cols, w [..., R, K]``, ``a [..., R, C]`` -> ``[..., n, C]`` (the
    transpose scatter of the SDDMM's backward)."""
    batched = cols.dim() == 3
    c_, w_, a_ = (t if batched else t[None] for t in (cols, w, a))
    B, R, K = c_.shape
    C = a_.shape[-1]
    contrib = (w_[..., None].to(a_.dtype) * a_[:, :, None, :]).reshape(B * R * K, C)
    rows = (c_.long() + n * torch.arange(B, device=a_.device)[:, None, None]).reshape(-1)
    out = torch.zeros(B * n, C, dtype=contrib.dtype, device=a_.device).index_add_(0, rows, contrib)
    out = out.reshape(B, n, C)
    return out if batched else out[0]


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
            db = segment_sum_rows(m.cols, gm, a, b.shape[-2]).to(b.dtype)
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
