"""Whole-model graph-sharded execution (counterpart of the Laplacian half of
``surfacenetworks_tpu/dist/graph_parallel.py``).

A model runs with its operator row-partitioned over the graph axis of the
rank grid: each rank holds its rows of every sample of its batch shard, and
the model body runs in the graph-sharded context (``parallel_context``):

* every ``apply_operator`` on a ``PartitionedOperator`` exchanges the halo
  with the neighbouring ranks and runs the local products
  (``edge_partition.partitioned_spmm``);
* ``global_average`` and batch-norm statistics sum over the sharded axes,
  so each rank's rows see the global statistics;
* parameters are replicated; the update sums their gradients over every
  rank (``train/loop.py``'s ``update``).

With a data axis of more than one rank (DP x GP) the mesh batch is sharded
over it too.  ``GraphStore`` keeps every sample's rows of this rank on the
device, so a step gathers its batch there.
"""

from __future__ import annotations

from typing import Callable

import torch

from surfacenetworks_tpu_torch.data.pipeline import DEVICE_BUDGET_BYTES, _nbytes
from surfacenetworks_tpu_torch.dist.edge_partition import (
    PartitionedOperator,
    partition_operator,
    shard_partitioned,
    stack_partitioned,
    suggest_halo,
)
from surfacenetworks_tpu_torch.dist.mesh_setup import Mesh, batch_sharding, put_global, replicated, shard_slice


def partition_batch_operator(Ls, n_parts: int, n_rows: int, halo: int | None = None, k: int = 16,
                             axis: str = "graph", interior_fmt: str = "ell") -> PartitionedOperator:
    """Partition a list of per-mesh scipy operators (RCM-reordered) into one
    batched ``PartitionedOperator`` [B, N, K].  ``halo=None`` derives the
    narrowest sufficient halo from the worst member bandwidth."""
    if halo is None:
        halo = max(suggest_halo(L) for L in Ls)
    ops = [partition_operator(L, n_parts, halo=halo, k=k, n_rows=n_rows, axis=axis, interior_fmt=interior_fmt)
           for L in Ls]
    return stack_partitioned(ops)


def prepartition_ell(Ls, n_parts: int, n_rows: int, k: int = 16, interior_fmt: str = "ell", axis: str = "graph"):
    """Partition each operator once with a dataset-wide halo and width
    floors.  Returns ``(ops, floors)``, ``floors = {'min_mb': ...,
    'min_kb': ...}`` for ``stack_partitioned``, so every batch over the
    dataset stacks to the same shapes."""
    halo = min(max(suggest_halo(L) for L in Ls), n_rows // n_parts)
    ops = [partition_operator(L, n_parts, halo=halo, k=k, n_rows=n_rows, axis=axis, interior_fmt=interior_fmt)
           for L in Ls]
    floors = {
        "min_mb": max(max(o.fwd.bnd_rows.shape[0], o.bwd.bnd_rows.shape[0]) // n_parts for o in ops),
        "min_kb": (max(max(o.fwd.bsr_cols.shape[-1], o.bwd.bsr_cols.shape[-1]) for o in ops)
                   if interior_fmt == "bsr" else 0),
    }
    return ops, floors


def make_graph_sharded_apply(mesh: Mesh, apply_fn: Callable, batch_sharded: bool = False) -> Callable:
    """Wrap ``apply_fn(op, mask, inputs, *extra) -> outputs`` to run on this
    rank's shards (placed by ``place_graph_batch`` or ``GraphStore``) in the
    graph-sharded context, the mesh batch sharded over the data axis too
    with ``batch_sharded``.  A rank returns its rows of per-vertex outputs;
    a globally pooled head's value, summed over the graph axis in the body,
    is the same on every rank of it, so JAX's ``out_vertex_sharded`` (an
    output sharding) has no counterpart here."""

    def run(op, mask, inputs, *extra):
        with mesh.context(vertex=True, batch=batch_sharded):
            return apply_fn(op, mask, inputs, *extra)

    return run


def place_graph_batch(mesh: Mesh, op: PartitionedOperator, arrays: dict, batch_sharded: bool = False):
    """This rank's shards of a global batched operator and of ``[B, N, ...]``
    arrays, on its device: rows of its graph position, and of its data
    position's batch slice with ``batch_sharded``.  Returns (op, dict)."""
    B, N = op.fwd.cols.shape[:2]
    sl = batch_sharding(mesh, B) if batch_sharded else replicated(mesh, B)
    rows = shard_slice(N, op.fwd.n_parts, mesh.graph_index)
    op_loc = shard_partitioned(op, mesh.graph_index, sl).to(mesh.device)
    return op_loc, {k: put_global(torch.as_tensor(v)[sl], rows, mesh.device, dim=1) for k, v in arrays.items()}


class GraphStore:
    """Device-resident graph-parallel sample store: every sample's rows of
    this rank (its partitioned operator shard and padded arrays, stacked
    ``[S, ...]``), placed once; a batch is an index gather on the device
    (``gather``), of this rank's batch slice under DP x GP."""

    def __init__(self, mesh: Mesh, op: PartitionedOperator, arrays: dict, index_of: dict, items: list,
                 batch_sharded: bool):
        self.mesh = mesh
        self.op = op
        self.arrays = arrays
        self._index_of = index_of
        self._items = items  # held, so id() keys stay valid
        self.batch_sharded = batch_sharded

    @classmethod
    def build(cls, mesh: Mesh, samples: list, op_stacked: PartitionedOperator, arrays: dict,
              batch_sharded: bool = False, budget_bytes: int = DEVICE_BUDGET_BYTES) -> "GraphStore | None":
        """``op_stacked``: the ``[S, ...]``-stacked partitioned operator of
        all ``samples``; ``arrays``: ``[S, N, ...]`` host arrays.  None past
        ``budget_bytes`` of the whole store, as in the JAX package (the
        caller keeps the host route); else every sample's rows of this rank,
        placed on its device."""
        if _nbytes(op_stacked) + sum(_nbytes(torch.as_tensor(v)) for v in arrays.values()) > budget_bytes:
            return None
        op_loc, arrs = place_graph_batch(mesh, op_stacked, arrays)
        return cls(mesh, op_loc, arrs, {id(s): i for i, s in enumerate(samples)}, list(samples), batch_sharded)

    def indices(self, samples: list) -> torch.Tensor:
        idx = torch.tensor([self._index_of[id(s)] for s in samples], dtype=torch.int64)
        if self.batch_sharded:
            idx = idx[batch_sharding(self.mesh, idx.shape[0])]
        return idx.to(self.mesh.device)

    def gather(self, samples: list):
        """This rank's shards of the batch of ``samples``: (op, arrays)."""
        from surfacenetworks_tpu_torch.data.pipeline import _take

        idx = self.indices(samples)
        return _take(self.op, idx), {k: v.index_select(0, idx) for k, v in self.arrays.items()}

    def stats(self) -> str:
        nbytes = _nbytes(self.op) + _nbytes(self.arrays)
        return (f"graph store: {len(self._index_of)} samples, {nbytes / 1e6:.1f} MB resident on rank "
                f"{self.mesh.rank} (rows sharded over 'graph')")
