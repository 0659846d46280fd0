"""The sharded context a model body runs in (counterpart of
``surfacenetworks_tpu/parallel_context.py``).

The port runs one process per rank (``dist/mesh_setup.py``).  When a rank
holds only a slice of a global tensor, every *global* reduction becomes a
collective over the ranks that hold the other slices:

* ``global_average`` (a masked mean over vertices) sums over the vertex axis;
* ``GraphBatchNorm`` statistics (over all batch x vertex rows) sum over the
  vertex axis AND the batch axis;
* the losses divide their rank's terms by the global normaliser (the mask
  sum over both axes, or the global batch), so the global loss is the sum
  of the ranks' shares.

Where the JAX package names mesh axes, the context here holds ``Axis``
objects: a process group, the global ranks along it and this rank's
position.  The data-parallel and graph-parallel runners set the context
around the model body; ``nn/layers.py`` and ``train/losses.py`` read it.
Outside any context both axes are None and everything reduces locally (the
single-device path).

``psum`` is ``all_reduce(SUM)`` as an autograd Function: its backward sums
the cotangents over the same axes, which is the gradient of the global loss
when that loss is the sum of the ranks' shares (a value every rank of the
vertex axis holds whole, such as a pooled head's loss, enters as its
``replicated_share``).  ``gather_rows`` is the differentiable all-gather of
a row-sharded value that every rank reads whole.  ``total`` is the same sum
without a graph (normalisers and reported metrics), and ``sum_gradients``
sums the replicated parameters' gradients before an update.  On an axis whose group
runs over gloo while the tensors live on a card (``Axis.staged``), each
collective goes through a host copy: gloo's own CUDA support is not relied
on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the rank grid, seen from one rank: the process group of
    the ranks along it, their global ranks in order, this rank's position,
    and whether its CUDA tensors go through the host (a gloo group on a
    card)."""

    group: Any
    ranks: tuple[int, ...]
    index: int
    staged: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class ShardedAxes:
    vertex_axis: Axis | None = None  # the axis sharding the vertex dim (-2)
    batch_axis: Axis | None = None  # the axis sharding the mesh-batch dim (0)


_state = threading.local()


def current_axes() -> ShardedAxes:
    return getattr(_state, "axes", ShardedAxes())


def _live(axis: Axis | None) -> Axis | None:
    return axis if axis is not None and axis.size > 1 else None


@contextlib.contextmanager
def sharded_axes(vertex_axis: Axis | None = None, batch_axis: Axis | None = None):
    """Run the body with these axes sharded (an axis of one rank is none)."""
    prev = current_axes()
    _state.axes = ShardedAxes(vertex_axis=_live(vertex_axis), batch_axis=_live(batch_axis))
    try:
        yield
    finally:
        _state.axes = prev


def reduction_axes_for_stats() -> tuple[Axis, ...]:
    """Axes batch-norm-style whole-tensor statistics must sum over."""
    axes = current_axes()
    return tuple(a for a in (axes.batch_axis, axes.vertex_axis) if a is not None)


def vertex_reduction_axis() -> Axis | None:
    """Axis a vertex-dim reduction (``global_average``) must sum over."""
    return current_axes().vertex_axis


def batch_reduction_axis() -> Axis | None:
    """Axis a mean over the mesh batch (a per-sample loss) must sum over."""
    return current_axes().batch_axis


def replicated_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a value that every rank of the vertex axis
    holds whole (a loss of pooled, graph-replicated outputs): ``x`` over the
    axis's size, so the shares sum to ``x`` and its gradient enters once."""
    axis = vertex_reduction_axis()
    return x if axis is None else x / axis.size


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``all_reduce(SUM)`` of ``t`` in place over ``axis`` (also over a
    group of one rank); a CUDA tensor on a staged axis goes through a host
    copy."""
    import torch.distributed as dist

    if axis.group is None:  # a lone rank without a process group
        return t
    if axis.staged and t.is_cuda:
        host = t.detach().cpu()
        dist.all_reduce(host, group=axis.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=axis.group)
    return t


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axes: tuple[Axis, ...]) -> torch.Tensor:
        ctx.axes = axes
        y = x.detach().clone().contiguous()
        for a in axes:
            all_reduce_(y, a)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone().contiguous()
        for a in ctx.axes:
            all_reduce_(g, a)
        return g, None


def psum(x: torch.Tensor, axes: Sequence[Axis | None]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (None entries skipped),
    differentiable: the backward sums the cotangents over the same axes."""
    axes = tuple(a for a in axes if a is not None and a.size > 1)
    if not axes:
        return x
    return _Psum.apply(x, axes)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: Axis) -> torch.Tensor:
        import torch.distributed as dist

        ctx.axis, ctx.n = axis, x.shape[-2]
        src = x.detach().cpu() if axis.staged and x.is_cuda else x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.group)
        return torch.cat(parts, dim=-2).to(x.device)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        axis, n = ctx.axis, ctx.n
        if axis.staged or dist.get_backend(axis.group) != "nccl":
            # gloo: the whole cotangent summed over the axis, then the owner's rows
            full = all_reduce_(g.clone().contiguous(), axis)
            return full.narrow(-2, axis.index * n, n).contiguous(), None
        out = g.new_empty(g.shape[:-2] + (n, g.shape[-1]))
        chunks = [c.contiguous() for c in g.split(n, dim=-2)]
        dist.reduce_scatter(out, chunks, group=axis.group)
        return out, None


def gather_rows(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``axis``, concatenated along the row
    axis (-2) in the axis's order, differentiable: the backward sums every
    rank's cotangent of the whole and returns this rank's rows of the sum (a
    reduce-scatter: NCCL's own; on a gloo axis an ``all_reduce`` of the
    whole cotangent and this rank's slice, staged through the host on a
    card).  What a row-sharded value read whole by every rank needs, as the
    FAUST logits read the second shape's features."""
    if axis is None or axis.size == 1:
        return x
    return _GatherRows.apply(x, axis)


@torch.no_grad()
def total(x: torch.Tensor, axes: Sequence[Axis | None] | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (default: every sharded axis of the
    context), without a graph: normalisers and reported metrics."""
    if axes is None:
        axes = reduction_axes_for_stats()
    axes = tuple(a for a in axes if a is not None and a.size > 1)
    if not axes:
        return x
    y = x.detach().clone().contiguous()
    for a in axes:
        all_reduce_(y, a)
    return y


@torch.no_grad()
def sum_gradients(params, axis: Axis) -> None:
    """Sum every parameter's gradient over ``axis`` (the ranks that hold the
    replicated parameters): one ``all_reduce(SUM)`` of the gradients
    flattened in the parameters' order, so every rank then holds the same
    sums.  A parameter without a gradient contributes zeros and gets none
    back."""
    if axis.group is None:
        return
    params = [p for p in params if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])
    all_reduce_(flat, axis)
    off = 0
    for p in params:
        n = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[off:off + n].view_as(p))
        off += n
