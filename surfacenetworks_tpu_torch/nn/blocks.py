"""Residual Laplacian, average and Dirac blocks (counterpart of
``surfacenetworks_tpu/nn/blocks.py``).

Every block keeps the signature ``block(op, mask, x)`` (Dirac:
``block(dirac_op, v, f)``):

* ``LapResNet2``: x -> ELU -> [x || L x] -> conv(2d -> d, 'pre') twice, + input.
* ``AvgResNet2``: the operator replaced by the masked global average.
* ``MlpResNet2``: no operator; batch norm, ELU and conv per vertex, twice.
* ``WideLapResNet2`` / ``WideAvgResNet2``: width-changing versions with
  ``inner_layers`` steps and the truncating or doubling residual.
* ``DirResNet2``: vertex and face streams coupled through the Dirac pair in
  quaternion layout; the face stream has no residual.
* ``IdResNet2``: the operator replaced by the identity ([x || x]).
* ``GatResNet2``: the LapResNet2 scheme with ``L x`` replaced by masked
  multi-head attention over the operator's ELL pattern (``gat_attend``).

Every block takes ``dtype``, the computation dtype of its ``GraphConv1x1``s
(None: fp32; ``torch.bfloat16``: mixed precision, as the JAX blocks'
``dtype``).  Operator results may arrive wider than ``x`` (fp32 on bf16
``x``), and ``[x || L x]`` is concatenated in the wider dtype, so the 'pre'
batch norm reads the operator result unrounded.

``op`` is an ``EllOperator``, a ``BsrOperator``, a dense ``[B, N, N]``
tensor, a rank's shard of a row-partitioned ``PartitionedOperator`` (inside
the graph-sharded context: ``dist.edge_partition.partitioned_spmm``), or any
callable ``x -> L x`` (dispatch in ``apply_operator``).  A
Dirac operator is a structured ``DiracOperator``, a rank's shard of a
row-partitioned ``PartitionedDirac`` (inside the graph-sharded context:
``dist.dirac_partition.partitioned_dirac_vf`` / ``_fv``), or a pair ``(Di,
DiA)`` on quaternion rows, each a dense ``[B, 4M, 4N]`` tensor or an
``EllOperator`` (applied through ``spmm``, the ``ell_matmul`` kernel)
(dispatch in ``apply_dirac_vf`` / ``apply_dirac_fv``).  ``gat_attend``
takes an ``EllOperator`` or, inside the graph-sharded context, a rank's
shard of a ``PartitionedOperator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.dist.dirac_partition import PartitionedDirac, partitioned_dirac_fv, partitioned_dirac_vf
from surfacenetworks_tpu_torch.dist.edge_partition import PartitionedOperator, halo_exchange, partitioned_spmm
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm, GraphConv1x1, global_average
from surfacenetworks_tpu_torch.sparse.bsr import BsrOperator
from surfacenetworks_tpu_torch.sparse.ell import DiracOperator, EllOperator
from surfacenetworks_tpu_torch.sparse.ops import bsr_spmm, dense_bmm, dirac_apply_fv, dirac_apply_vf, spmm
from surfacenetworks_tpu_torch.spans import span

GAT_HEADS = 4


def apply_operator(op: Any, x: torch.Tensor) -> torch.Tensor:
    """``L @ x`` over the supported operator representations."""
    if isinstance(op, EllOperator):
        return spmm(op, x)
    if isinstance(op, BsrOperator):
        return bsr_spmm(op, x)
    if isinstance(op, torch.Tensor):
        return dense_bmm(op, x)
    if isinstance(op, PartitionedOperator):
        return partitioned_spmm(op, x)
    if callable(op):
        return op(x)
    raise TypeError(f"unsupported operator {type(op).__name__}")


def _pair(op: Any, side: int) -> Any:
    """Matrix ``side`` (0: ``Di``, 1: ``DiA``) of a ``(Di, DiA)`` pair; the
    other may be None where only one direction is applied."""
    if isinstance(op, tuple) and len(op) == 2 and isinstance(op[side], (torch.Tensor, EllOperator)):
        return op[side]
    raise TypeError(f"unsupported Dirac operator {type(op).__name__}: a DiracOperator, a PartitionedDirac, or a "
                    "(Di, DiA) pair of dense tensors or of EllOperators")


def _quaternion_rows(d: Any, x: torch.Tensor) -> torch.Tensor:
    """One matrix of a Dirac pair on ``x [B, S, C]`` in quaternion layout:
    ``x`` viewed ``[B, 4S, C/4]``, through ``spmm`` (``ell_matmul``) for an
    ``EllOperator`` or ``dense_bmm`` for a dense ``[B, 4R, 4S]`` tensor; a
    dense product is in the wider of the two dtypes (fp32 on bf16 ``x``,
    fp64 on fp64 ``x``), as in the JAX package."""
    *lead, n, c = x.shape
    xq = x.reshape(*lead, n * 4, c // 4)
    out = spmm(d, xq) if isinstance(d, EllOperator) else dense_bmm(d, xq)
    return out.reshape(*lead, out.shape[-2] // 4, c)


def apply_dirac_vf(op: Any, v: torch.Tensor) -> torch.Tensor:
    """``Di @ v`` (vertices -> faces) for a structured, a partitioned, an
    ELL-pair or a dense operator."""
    if isinstance(op, DiracOperator):
        return dirac_apply_vf(op, v)
    if isinstance(op, PartitionedDirac):
        return partitioned_dirac_vf(op, v)
    return _quaternion_rows(_pair(op, 0), v)


def apply_dirac_fv(op: Any, f: torch.Tensor) -> torch.Tensor:
    """``DiA @ f`` (faces -> vertices)."""
    if isinstance(op, DiracOperator):
        return dirac_apply_fv(op, f)
    if isinstance(op, PartitionedDirac):
        return partitioned_dirac_fv(op, f)
    return _quaternion_rows(_pair(op, 1), f)


def dirac_num_faces(op: Any) -> int:
    """Face count of a Dirac operator; of a ``PartitionedDirac`` shard the
    LOCAL face count, which the zero face stream needs there."""
    if isinstance(op, (DiracOperator, PartitionedDirac)):
        return op.faces.shape[-2]
    di = _pair(op, 0)
    return (di.fwd.n_rows if isinstance(di, EllOperator) else di.shape[-2]) // 4


def _cat_op(x: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """Concat [x || Op x] in the wider of the two dtypes."""
    dt = torch.promote_types(x.dtype, ox.dtype)
    return torch.cat([x.to(dt), ox.to(dt)], dim=-1)


def _bn_mode(bnmode: str | None) -> str | None:
    """Reference convention: bnmode '' -> 'pre'; None -> no norm; other strings
    pass through (and unknown strings disable norm inside GraphConv1x1)."""
    if bnmode is None:
        return None
    return bnmode + "pre"


def _cat_avg(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, global_average(x, mask).expand_as(x)], dim=-1)


class LapResNet2(nn.Module):
    """Two-step Laplacian residual block."""

    def __init__(self, features: int, bnmode: str | None = "", dtype: torch.dtype | None = None):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, _bn_mode(bnmode), dtype=dtype)
        self.bn_fc1 = GraphConv1x1(2 * features, features, _bn_mode(bnmode), dtype=dtype)

    def forward(self, op, mask, inputs):
        x = F.elu(inputs)
        x = self.bn_fc0(_cat_op(x, apply_operator(op, x)))
        x = F.elu(x)
        x = self.bn_fc1(_cat_op(x, apply_operator(op, x)))
        return x + inputs


# the dense-operator block is LapResNet2: ``apply_operator`` dispatches on the operator's type
DenseLapResNet2 = LapResNet2


class AvgResNet2(nn.Module):
    """Global-average residual block."""

    def __init__(self, features: int, bnmode: str | None = "", dtype: torch.dtype | None = None):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, _bn_mode(bnmode), dtype=dtype)
        self.bn_fc1 = GraphConv1x1(2 * features, features, _bn_mode(bnmode), dtype=dtype)

    def forward(self, op, mask, inputs):
        x = F.elu(inputs)
        x = self.bn_fc0(_cat_avg(x, mask))
        x = F.elu(x)
        x = self.bn_fc1(_cat_avg(x, mask))
        return x + inputs


class MlpResNet2(nn.Module):
    """Pointwise residual block: two steps of batch norm (over every row,
    padding included) -> ELU -> conv, + input; no operator."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.bn0 = GraphBatchNorm(features)
        self.fc0 = GraphConv1x1(features, features, None, dtype=dtype)
        self.bn1 = GraphBatchNorm(features)
        self.fc1 = GraphConv1x1(features, features, None, dtype=dtype)

    def forward(self, op, mask, inputs):
        x = self.fc0(F.elu(self.bn0(inputs)))
        x = self.fc1(F.elu(self.bn1(x)))
        return x + inputs


class _WideBlock(nn.Module):
    """Shared body of the width-changing blocks: ``inner_layers`` steps of
    ELU -> [x || neighbourhood(x)] -> conv, then the truncating (narrower or
    equal output) or doubling (wider output) input residual."""

    def __init__(self, num_inputs: int, num_outputs: int | None = None, bnmode: str | None = "",
                 inner_layers: int = 2, dtype: torch.dtype | None = None):
        super().__init__()
        num_outputs = num_inputs if num_outputs is None else num_outputs
        self.num_outputs = num_outputs
        self.inner_layers = inner_layers
        widths_in = [num_inputs] + [num_outputs] * (inner_layers - 1)
        for i in range(inner_layers):
            self.add_module(f"bn_fc{i}", GraphConv1x1(2 * widths_in[i], num_outputs, _bn_mode(bnmode), dtype=dtype))

    def _neighbourhood(self, op, mask, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, op, mask, inputs):
        x = inputs
        for i in range(self.inner_layers):
            x = F.elu(x)
            x = getattr(self, f"bn_fc{i}")(self._neighbourhood(op, mask, x))
        if self.num_outputs <= inputs.shape[-1]:
            return x + inputs[..., : self.num_outputs]
        return x + torch.cat([inputs, inputs], dim=-1)


class WideLapResNet2(_WideBlock):
    """Width-changing Laplacian block."""

    def _neighbourhood(self, op, mask, x):
        return _cat_op(x, apply_operator(op, x))


class WideAvgResNet2(_WideBlock):
    """Width-changing global-average block."""

    def _neighbourhood(self, op, mask, x):
        return _cat_avg(x, mask)


class DirResNet2(nn.Module):
    """Dirac residual block over coupled vertex and face streams:
    ``forward(op, v, f) -> (v + v', f')`` (channels divisible by 4).  The
    face stream's batch norm takes every ``B*M`` face row, padded faces
    included, as the JAX package's does."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, "pre", dtype=dtype)
        self.bn_fc1 = GraphConv1x1(2 * features, features, "pre", dtype=dtype)

    def forward(self, op, v, f):
        x_in, f_in = F.elu(v), F.elu(f)
        f_out = self.bn_fc0(_cat_op(f_in, apply_dirac_vf(op, x_in)))
        v_out = self.bn_fc1(_cat_op(x_in, apply_dirac_fv(op, F.elu(f_out))))
        return v + v_out, f_out


class IdResNet2(nn.Module):
    """Identity-op ablation block: the operator replaced by the identity,
    ``[x || x]``, with 'pre' batch norms."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.bn_fc0 = GraphConv1x1(2 * features, features, "pre", dtype=dtype)
        self.bn_fc1 = GraphConv1x1(2 * features, features, "pre", dtype=dtype)

    def forward(self, op, mask, inputs):
        x = F.elu(inputs)
        x = self.bn_fc0(torch.cat([x, x], dim=-1))
        x = F.elu(x)
        x = self.bn_fc1(torch.cat([x, x], dim=-1))
        return x + inputs


def _pattern_slots_t(op: EllOperator) -> torch.Tensor:
    """For each row ``n`` of ``op.fwd``'s transpose, the flat slots ``r * K
    + k`` of ``op.fwd`` whose live column is ``n``, in the order of the
    stored transpose ``op.bwd`` (``[B, N, K_bwd]``, int64; ``R * K`` where
    a transpose slot is padding).  Found on the device: each transpose
    entry ``(n, r)`` takes the slot of row ``r`` that holds column ``n``."""
    fc, fv, bc, bv = op.fwd.cols, op.fwd.vals, op.bwd.cols.long(), op.bwd.vals
    B, R, K = fc.shape
    N, Kb = bc.shape[1:]
    flat = bc.reshape(B, N * Kb, 1).expand(B, N * Kb, K)
    cols_r = torch.gather(fc, 1, flat).view(B, N, Kb, K)
    live_r = torch.gather(fv, 1, flat).view(B, N, Kb, K) != 0
    n_idx = torch.arange(N, device=fc.device).view(1, N, 1, 1)
    match = (cols_r == n_idx) & live_r & (bv != 0)[..., None]
    k = (match * torch.arange(K, device=fc.device)).sum(dim=-1)  # a transpose entry matches one slot at most
    return torch.where(match.any(dim=-1), bc * K + k, torch.full_like(bc, R * K))


class _SlotGather(torch.autograd.Function):
    """The payload rows each slot of ``op.fwd`` reads: ``[B, N, P]`` ->
    ``[B, R, K, P]`` (one gather).  The backward sums each row's slot
    cotangents through the stored transpose (``_pattern_slots_t``): a
    gather and a sum in a fixed order, no scatter, so every run gives the
    same bits.  Only live slots are summed back: the attention gives the
    dead ones an exactly zero cotangent (weight ``exp(-1e9 - max) = 0``)."""

    @staticmethod
    def forward(ctx, op: EllOperator, payload: torch.Tensor) -> torch.Tensor:
        ctx.op = op
        B, N, P = payload.shape
        R, K = op.fwd.cols.shape[1:]
        idx = op.fwd.cols.reshape(B, R * K, 1).long().expand(B, R * K, P)
        return torch.gather(payload, 1, idx).view(B, R, K, P)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        B, R, K, P = g.shape
        slots = _pattern_slots_t(ctx.op)
        N, Kb = slots.shape[1:]
        flat = torch.cat([g.reshape(B, R * K, P), g.new_zeros(B, 1, P)], dim=1)
        per = torch.gather(flat, 1, slots.reshape(B, N * Kb, 1).expand(B, N * Kb, P)).view(B, N, Kb, P)
        return None, per.sum(dim=2)


def _attend_slots(g: torch.Tensor, live: torch.Tensor, s_src: torch.Tensor, heads: int, ch: int,
                  negative_slope: float) -> torch.Tensor:
    """The attention of rows over their gathered slots: ``g [B, R, K, H *
    ch + H]`` (features and destination scores), ``live [B, R, K]``,
    ``s_src [B, R, H]`` -> ``[B, R, H, ch]``; dead slots score -1e9, rows
    without a live slot give zero."""
    live = live[..., None]
    e = F.leaky_relu(s_src[:, :, None, :] + g[..., heads * ch:], negative_slope)
    a = torch.softmax(torch.where(live, e, torch.full_like(e, -1e9)), dim=2)  # [B, R, K, H]
    out = (a[..., None] * g[..., : heads * ch].unflatten(-1, (heads, ch))).sum(dim=2)  # [B, R, H, ch]
    return out * live.any(dim=2)[..., None].to(out.dtype)


def _slots(payload: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``payload [B, N, P]`` at each slot of ``cols [B, R, K]``: ``[B, R, K,
    P]`` (one gather; its backward is autograd's)."""
    B, R, K = cols.shape
    P = payload.shape[-1]
    return torch.gather(payload, 1, cols.reshape(B, R * K, 1).long().expand(B, R * K, P)).view(B, R, K, P)


def _gat_attend_partitioned(pop: PartitionedOperator, xh: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                            negative_slope: float) -> torch.Tensor:
    """The attend on a rank's shard of a row-partitioned operator, inside
    the graph-sharded context (JAX's ``_gat_attend_partitioned``).  The
    partition's split is softmax-exact: each row's whole slot list lives in
    one table (interior rows in the local table, whose boundary rows are
    all dead, boundary rows in the side table), so the two tables' outputs
    are computed apart and added.  The payload (features and destination
    scores, ``[rows, H * ch + H]``) crosses the partition once per attend,
    through the differentiable ``halo_exchange``; the gradients are
    autograd's through the gathers and the exchange."""
    m = pop.fwd
    batched = m.cols.dim() == 3
    if not batched:
        m = dataclasses.replace(m, **{f: getattr(m, f)[None] for f in ("cols", "vals", "bnd_rows", "bnd_cols",
                                                                       "bnd_vals")})
        xh, s_src, s_dst = xh[None], s_src[None], s_dst[None]
    B, N, H, ch = xh.shape
    dt = torch.promote_types(xh.dtype, s_dst.dtype)
    payload = torch.cat([xh.reshape(B, N, H * ch).to(dt), s_dst.to(dt)], dim=-1)
    s_src = s_src.to(dt)
    out = _attend_slots(_slots(payload, m.cols), m.vals != 0, s_src, H, ch, negative_slope)
    if m.halo > 0 and m.bnd_rows.shape[-1] > 0:
        axis = parallel_context.vertex_reduction_axis()
        if axis is None or axis.size != m.n_parts:
            raise RuntimeError(f"gat_attend: an operator of {m.n_parts} partitions needs a graph axis of "
                               f"{m.n_parts} ranks in the sharded context, got {None if axis is None else axis.size}")
        pext = halo_exchange(payload, m.halo, axis)
        rows = m.bnd_rows.long()
        s_b = torch.gather(s_src, 1, rows[..., None].expand(B, rows.shape[1], H))
        out_b = _attend_slots(_slots(pext, m.bnd_cols), m.bnd_vals != 0, s_b, H, ch, negative_slope)
        flat = (rows + torch.arange(B, device=rows.device)[:, None] * N).reshape(-1)
        out = out.reshape(B * N, H, ch).index_add(0, flat, out_b.reshape(-1, H, ch)).view(B, N, H, ch)
    return out if batched else out[0]


def gat_attend(op, xh: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
               negative_slope: float = 0.2) -> torch.Tensor:
    """Masked multi-head graph attention over ``op.fwd``'s ELL pattern:
    per-slot additive scores ``e[r, k] = leaky_relu(s_src[r] + s_dst[cols[r,
    k]])``, a softmax over the row's K slots with -1e9 at dead slots (value
    0), and the attention-weighted sum of the slots' features; rows with no
    live slot return zero.  ``xh [(B,) N, H, ch]``, ``s_src``/``s_dst``
    ``[(B,) N, H]`` -> ``[(B,) N, H, ch]``, in the wider of ``xh``'s and the
    scores' dtypes (fp32 on bf16 ``xh``).

    One gather of ``[R * K, H * ch + H]`` payload rows (features and
    destination scores together), as the JAX package's gather formulation
    (``nn/blocks.py::_gat_slots_attend``); its banded formulation computes
    the same function (the same finite support).  Plain PyTorch: the
    backward is autograd's, but for the gather's (``_SlotGather``).  A
    ``PartitionedOperator`` shard attends on this rank's rows
    (``_gat_attend_partitioned``).  The attend runs inside the span
    ``snx:apply:gat`` (``spans.py``); its backward is put down to the span
    by the readers of a trace."""
    with span("snx:apply:gat"):
        return _gat_attend(op, xh, s_src, s_dst, negative_slope)


def _gat_attend(op, xh: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
                negative_slope: float) -> torch.Tensor:
    if isinstance(op, PartitionedOperator):
        return _gat_attend_partitioned(op, xh, s_src, s_dst, negative_slope)
    if not isinstance(op, EllOperator):
        raise TypeError(f"gat_attend needs an EllOperator (the pattern) or a PartitionedOperator shard, got "
                        f"{type(op).__name__}")
    batched = op.fwd.cols.dim() == 3
    if not batched:
        op = EllOperator(fwd=dataclasses.replace(op.fwd, cols=op.fwd.cols[None], vals=op.fwd.vals[None]),
                         bwd=dataclasses.replace(op.bwd, cols=op.bwd.cols[None], vals=op.bwd.vals[None]))
        xh, s_src, s_dst = xh[None], s_src[None], s_dst[None]
    B, N, H, ch = xh.shape
    dt = torch.promote_types(xh.dtype, s_dst.dtype)
    payload = torch.cat([xh.reshape(B, N, H * ch).to(dt), s_dst.to(dt)], dim=-1)
    g = _SlotGather.apply(op, payload)  # [B, R, K, H * ch + H]
    out = _attend_slots(g, op.fwd.vals != 0, s_src.to(dt), H, ch, negative_slope)
    return out if batched else out[0]


class GatResNet2(nn.Module):
    """Graph-attention residual block: the LapResNet2 scheme with ``L x``
    replaced by ``gat_attend`` over ``H`` heads of ``features / H``
    channels.  Its attention vectors ``att{0,1}_a_src`` / ``_a_dst`` ``[H,
    ch]`` are bare parameters (the JAX block's names and shapes)."""

    def __init__(self, features: int, heads: int = GAT_HEADS, bnmode: str | None = "",
                 dtype: torch.dtype | None = None):
        super().__init__()
        if features % heads:
            raise ValueError(f"features {features} not divisible by heads {heads}")
        self.heads = heads
        ch = features // heads
        for name in ("att0", "att1"):
            for side in ("a_src", "a_dst"):
                self.register_parameter(f"{name}_{side}", nn.Parameter(torch.zeros(heads, ch)))
        self.bn_fc0 = GraphConv1x1(2 * features, features, _bn_mode(bnmode), dtype=dtype)
        self.bn_fc1 = GraphConv1x1(2 * features, features, _bn_mode(bnmode), dtype=dtype)

    def _attend(self, op, x: torch.Tensor, name: str) -> torch.Tensor:
        a_src, a_dst = getattr(self, f"{name}_a_src"), getattr(self, f"{name}_a_dst")
        xh = x.unflatten(-1, (self.heads, x.shape[-1] // self.heads))
        dt = torch.promote_types(xh.dtype, a_src.dtype)  # jnp.einsum promotes bf16 x fp32 to fp32
        s_src = torch.einsum("...hc,hc->...h", xh.to(dt), a_src.to(dt))
        s_dst = torch.einsum("...hc,hc->...h", xh.to(dt), a_dst.to(dt))
        return gat_attend(op, xh, s_src, s_dst).flatten(-2)

    def forward(self, op, mask, inputs):
        x = F.elu(inputs)
        x = self.bn_fc0(_cat_op(x, self._attend(op, x, "att0")))
        x = F.elu(x)
        x = self.bn_fc1(_cat_op(x, self._attend(op, x, "att1")))
        return x + inputs
