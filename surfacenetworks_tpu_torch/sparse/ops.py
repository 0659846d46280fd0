"""Operator applies, the SDDMM and the structured Dirac applies (counterpart
of ``surfacenetworks_tpu/sparse/ops.py`` and the apply half of
``sparse/bsr.py``).

``spmm``, ``bsr_spmm`` and ``sddmm`` are ``torch.autograd.Function``s, as the
JAX package's are ``custom_vjp``s, on the CPU and on the card alike.  Under
mixed precision (bf16 activations) they keep the JAX package's dtypes: the
operator applies return fp32 (fp32 ELL values, or bf16 BSR blocks with fp32
sums) and cast their backward to x's dtype; the SDDMM of bf16 features is
bf16 and so are its gradients; the dense and the Dirac applies promote
(fp32 tables on bf16 x give fp32) and cast their backward back.

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

``dirac_apply_vf`` / ``dirac_apply_fv`` apply the structured Dirac pair in
plain PyTorch (the JAX package computes them in XLA, with no Pallas kernel):
one row gather of every slot and one batched product with the slots'
Hamilton matrices ``L(q)``, expanded on the device from the ``[..., 4]``
tables.  Their backwards apply the stored adjoint tables the same way, so
every sum is a gather and a product in a fixed order: no scatter, and the
same bits on every run.

The forward and the backward of each operator and Dirac apply run inside a
span (``spans.py``): ``snx:apply:lap`` for ``spmm`` and ``bsr_spmm``,
``snx:apply:dirac`` for the Dirac pair.  ``_gather_apply`` and
``_vertex_side`` stay module globals that the Functions look up at each
call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

from surfacenetworks_tpu_torch.sparse import kernels
from surfacenetworks_tpu_torch.sparse.bsr import BsrOperator
from surfacenetworks_tpu_torch.sparse.ell import DiracOperator, EllOperator
from surfacenetworks_tpu_torch.spans import span


class _EllApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: EllOperator, x: torch.Tensor) -> torch.Tensor:
        ctx.op, ctx.dtype = op, x.dtype
        m = op.fwd
        with span("snx:apply:lap"):
            return kernels.ell_matmul(m.cols, m.vals, x.contiguous(), m.window)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        m = ctx.op.bwd
        with span("snx:apply:lap"):
            return None, kernels.ell_matmul(m.cols, m.vals, g.contiguous(), m.window).to(ctx.dtype)


class _BsrApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: BsrOperator, x: torch.Tensor) -> torch.Tensor:
        ctx.op, ctx.dtype = op, x.dtype
        m = op.fwd
        with span("snx:apply:lap"):
            return kernels.bsr_matmul(m.block_cols, m.block_vals, x.contiguous(), op.fwd_live)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        m = ctx.op.bwd
        with span("snx:apply:lap"):
            return None, kernels.bsr_matmul(m.block_cols, m.block_vals, g.contiguous(), ctx.op.bwd_live).to(ctx.dtype)


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
    """Dense operator apply ``[..., N, N] @ [..., N, C]`` in the wider of the
    two dtypes, as ``jnp.einsum`` promotes: an fp32 operator on bf16 x gives
    fp32 (``torch.matmul`` of mixed dtypes would raise)."""
    dt = torch.promote_types(L.dtype, x.dtype)
    return torch.matmul(L.to(dt), x.to(dt))


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
        gm = torch.where(m.vals != 0, g, torch.zeros_like(g))
        # the cotangent is the sums' ELL values, which the kernels take in fp32:
        # a bf16 cotangent is widened (exactly); its products are then exact
        gm = gm.to(torch.promote_types(gm.dtype, torch.float32)).contiguous()
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


# ---------------------------------------------------------------------------
# quaternion algebra and the structured Dirac applies
# ---------------------------------------------------------------------------


# L(q)[i, j] is q[k] or -q[k]: its column in cat([q, -q]) per (i, j), from
# geometry.quaternion_matrix's rows (a,-b,-c,-d), (b,a,-d,c), (c,d,a,-b), (d,-c,b,a).
_HAMILTON = np.array([[0, 5, 6, 7], [1, 0, 7, 2], [2, 3, 0, 5], [3, 6, 1, 0]])


@functools.lru_cache(maxsize=None)
def _hamilton_cached(slots: int, device: torch.device) -> torch.Tensor:
    idx = np.arange(slots)[None, :, None] * 8 + _HAMILTON[:, None, :]
    return torch.from_numpy(idx.reshape(-1)).to(device)


def _hamilton_index(slots: int, device: torch.device) -> torch.Tensor:
    """For ``S`` slots, the column of ``cat([q, -q], -1).reshape(R, S*8)``
    that each entry of the ``[4, S, 4]`` layout ``L(q_s)[i, j]`` reads;
    built once per device, always as a real tensor on it: while
    ``torch.export`` traces, it enters the program as a constant on the
    device (not a host array copied to it at every call, nor a fake tensor
    left in the cache)."""
    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        return _hamilton_cached(slots, device)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [*lead, N, C]`` at rows ``idx [*lead, ...]`` of its own batch
    member: ``[*lead, ..., C]``, one ``index_select`` (a gather: its
    forward is deterministic, and no autograd runs through it)."""
    lead, n, c = idx.shape[: x.dim() - 2], x.shape[-2], x.shape[-1]
    flat = idx.reshape(-1) if not lead or int(np.prod(lead)) == 1 else (
        idx.reshape(int(np.prod(lead)), -1) + torch.arange(int(np.prod(lead)), device=idx.device)[:, None] * n
    ).reshape(-1)
    return x.reshape(-1, c).index_select(0, flat).reshape(*idx.shape, c)


def _gather_apply(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_s q[r,s] (x) x[idx[r,s]]``: ``idx [*lead, R, S]``,
    ``q [*lead, R, S, 4]``, ``x [*lead, N, C]`` -> ``[*lead, R, C]`` in the
    wider of the tables' and ``x``'s dtypes, as the JAX package's products
    promote: fp32 on bf16 ``x``, fp64 on fp64 ``x``.  One gather of every
    slot, viewed ``[R, S*4, C/4]``, and one batched product with ``L(q)``
    laid out ``[R, 4, S*4]``: the sum over (slot, component) is a matrix
    product, so fp32 needs TF32 off (``torch.backends.cuda.matmul.
    allow_tf32``, off by default)."""
    *lead, r, s = idx.shape
    c = x.shape[-1]
    dt = torch.promote_types(q.dtype, x.dtype)
    g = _rows(x, idx).to(dt).reshape(-1, s * 4, c // 4)
    qq = q.to(dt).reshape(-1, s, 4)
    lq = torch.cat([qq, -qq], dim=-1).reshape(-1, s * 8).index_select(1, _hamilton_index(s, x.device))
    return torch.bmm(lq.reshape(-1, 4, s * 4), g).reshape(*lead, r, c)


def _vertex_side(op: DiracOperator, q_main: torch.Tensor, q_ov: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """Faces -> vertices through the vertex tables, plus the packed-valence
    overflow: each vertex row adds the overflow row ``ov_map`` names (a
    gather from the overflow result with a zero row appended), which is the
    JAX package's ``out.at[ov_rows].add(o)`` with the sum in one order."""
    out = _gather_apply(op.vf_face, q_main, x)
    if op.ov_map is None:
        return out
    o = _gather_apply(op.ov_face, q_ov, x)
    o = torch.cat([o, o.new_zeros(*o.shape[:-2], 1, o.shape[-1])], dim=-2)
    return out + _rows(o, op.ov_map)


class _DiracVF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: DiracOperator, v: torch.Tensor) -> torch.Tensor:
        ctx.op, ctx.dtype = op, v.dtype
        with span("snx:apply:dirac"):
            return _gather_apply(op.faces, op.q_fv, v)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # v_bar[j] = sum over incident (face, corner): conj(q_fv) (x) g[face]
        op = ctx.op
        with span("snx:apply:dirac"):
            return None, _vertex_side(op, op.q_bwd_v, op.q_ov_bwd_v, g).to(ctx.dtype)


class _DiracFV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op: DiracOperator, f: torch.Tensor) -> torch.Tensor:
        ctx.op, ctx.dtype = op, f.dtype
        with span("snx:apply:dirac"):
            return _vertex_side(op, op.q_vf, op.q_ov_vf, f)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # f_bar[i] = sum_c conj(q_vf at (faces[i,c], slot)) (x) g[faces[i,c]]
        op = ctx.op
        with span("snx:apply:dirac"):
            return None, _gather_apply(op.faces, op.q_bwd_f, g).to(ctx.dtype)


def _check_dirac(op: DiracOperator, x: torch.Tensor, rows: int, what: str) -> None:
    if x.shape[-1] % 4:
        raise ValueError(f"{what}: channels {x.shape[-1]} not divisible by 4")
    if op.faces.dim() != x.dim() or x.shape[-2] != rows:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not fit the operator's faces {tuple(op.faces.shape)} "
                         f"and incidence {tuple(op.vf_face.shape)}")


def dirac_apply_vf(op: DiracOperator, v: torch.Tensor) -> torch.Tensor:
    """``Di @ v``: vertex features ``v [..., N, C]`` (C % 4 == 0) -> face
    features ``[..., M, C]``; the gradient flows to ``v``, not to ``op``."""
    _check_dirac(op, v, op.n_vertices, "dirac_apply_vf")
    return _DiracVF.apply(op, v)


def dirac_apply_fv(op: DiracOperator, f: torch.Tensor) -> torch.Tensor:
    """``DiA @ f``: face features ``f [..., M, C]`` -> vertex features
    ``[..., N, C]``."""
    _check_dirac(op, f, op.n_faces, "dirac_apply_fv")
    return _DiracFV.apply(op, f)


# ---------------------------------------------------------------------------
# quaternion algebra on the channel layout the Dirac blocks use
# ---------------------------------------------------------------------------


def quaternion_mul(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The Hamilton product ``q (x) x`` broadcast over channels: ``q [...,
    4]`` (coefficients), ``x [..., 4, C]`` (quaternion features) -> ``[...,
    4, C]``; the same as multiplying by ``q``'s left-multiplication matrix."""
    a, b, c, d = (q[..., i, None] for i in range(4))
    xw, xx, xy, xz = (x[..., i, :] for i in range(4))
    return torch.stack([
        a * xw - b * xx - c * xy - d * xz,
        a * xx + b * xw + c * xz - d * xy,
        a * xy - b * xz + c * xw + d * xx,
        a * xz + b * xy - c * xx + d * xw,
    ], dim=-2)


def to_quaternion_layout(x: torch.Tensor) -> torch.Tensor:
    """``[..., N, C]`` -> ``[..., N, 4, C // 4]``."""
    *lead, n, ch = x.shape
    if ch % 4:
        raise ValueError(f"channels {ch} not divisible by 4")
    return x.reshape(*lead, n, 4, ch // 4)


def from_quaternion_layout(x: torch.Tensor) -> torch.Tensor:
    """``[..., N, 4, C // 4]`` -> ``[..., N, C]``."""
    *lead, n, four, c4 = x.shape
    return x.reshape(*lead, n, four * c4)
