"""Whole-model graph-sharded execution (counterpart of
``surfacenetworks_tpu/dist/graph_parallel.py``).

A model runs with its operator row-partitioned over the graph axis of the
rank grid: each rank holds its rows of every sample of its batch shard, and
the model body runs in the graph-sharded context (``parallel_context``):

* every ``apply_operator`` on a ``PartitionedOperator`` exchanges the halo
  with the neighbouring ranks and runs the local products
  (``edge_partition.partitioned_spmm``); every Dirac apply on a
  ``PartitionedDirac`` exchanges a vertex or a face halo
  (``dirac_partition``), and a GAT attend on a ``PartitionedOperator``
  exchanges its payload once;
* ``global_average`` and batch-norm statistics sum over the sharded axes,
  so each rank's rows see the global statistics;
* parameters are replicated; the update sums their gradients over every
  rank (``train/loop.py``'s ``update``).

With a data axis of more than one rank (DP x GP) the mesh batch is sharded
over it too.  ``GraphStore`` keeps every sample's rows of this rank on the
device, so a step gathers its batch there.  A ``PartitionedDirac`` shards
its vertex rows and its face rows each by its own count (``N / G`` and ``M
/ G`` a rank), and the batch's per-vertex arrays by the vertex count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from surfacenetworks_tpu_torch.data.pipeline import DEVICE_BUDGET_BYTES, _nbytes
from surfacenetworks_tpu_torch.dist import dirac_partition as dp
from surfacenetworks_tpu_torch.dist.dirac_partition import PartitionedDirac, shard_partitioned_dirac
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


def partition_batch_dirac(coeffs_list, n_parts: int, n_vertices: int, n_faces: int, max_valence: int | None = None,
                          axis: str = "graph") -> PartitionedDirac:
    """Partition a list of per-mesh ``DiracCoeffs`` (vertices RCM-ordered,
    faces sorted by ``sort_faces_for_partition``) into one batched
    ``PartitionedDirac`` with shared (largest-need) halos."""
    ops = [dp.partition_dirac(c, n_parts, n_vertices, n_faces, max_valence=max_valence, axis=axis)
           for c in coeffs_list]
    halo_v = max(o.halo_v for o in ops)
    halo_f = max(o.halo_f for o in ops)
    if any(o.halo_v != halo_v or o.halo_f != halo_f for o in ops):
        ops = [dp.partition_dirac(c, n_parts, n_vertices, n_faces, halo_v=halo_v, halo_f=halo_f,
                                  max_valence=max_valence, axis=axis) for c in coeffs_list]
    return dp.stack_partitioned_dirac(ops)


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


def prepartition_dirac(coeffs_list, n_parts: int, n_vertices: int, n_faces: int, max_valence: int | None = None,
                       axis: str = "graph"):
    """Partition each ``DiracCoeffs`` once with shared halos and width
    floors.  Returns ``(ops, floors)``, ``floors = {'min_mbf': ...,
    'min_mbv': ...}`` for ``dirac_partition.stack_partitioned_dirac``."""
    ops = [dp.partition_dirac(c, n_parts, n_vertices, n_faces, max_valence=max_valence, axis=axis)
           for c in coeffs_list]
    halo_v = max(o.halo_v for o in ops)
    halo_f = max(o.halo_f for o in ops)
    ops = [o if (o.halo_v == halo_v and o.halo_f == halo_f) else
           dp.partition_dirac(c, n_parts, n_vertices, n_faces, halo_v=halo_v, halo_f=halo_f, max_valence=max_valence,
                              axis=axis) for o, c in zip(ops, coeffs_list)]
    floors = {"min_mbf": max(o.fbnd_rows.shape[0] // n_parts for o in ops),
              "min_mbv": max(o.vbnd_rows.shape[0] // n_parts for o in ops)}
    return ops, floors


def shard_operator(op, index: int, batch: slice | None = None):
    """Partition ``index``'s shard of a partitioned operator (a
    ``PartitionedOperator`` or a ``PartitionedDirac``), of the mesh-batch
    slice ``batch`` where given."""
    if isinstance(op, PartitionedDirac):
        return shard_partitioned_dirac(op, index, batch)
    return shard_partitioned(op, index, batch)


def _n_parts(op) -> int:
    return op.n_parts if isinstance(op, PartitionedDirac) else op.fwd.n_parts


def shard_batch_rows(batch, n_parts: int, index: int):
    """Partition ``index``'s rows of a host batch (a ``MeshBatch``): every
    per-vertex array (``[B, N, ...]``, ``N`` the inputs' rows) cut along its
    rows, every partitioned operator (the batch's and the operators in
    ``aux``) to its shard; per-sample arrays (class labels) and the faces
    stay whole."""
    n = batch.inputs.shape[1]

    def cut(v):
        if isinstance(v, (PartitionedOperator, PartitionedDirac)):
            return shard_operator(v, index)
        if isinstance(v, torch.Tensor) and v.dim() >= 2 and v.shape[1] == n:
            return v.narrow(1, index * (n // n_parts), n // n_parts).contiguous()
        return v

    return dataclasses.replace(batch, inputs=cut(batch.inputs), targets=cut(batch.targets), mask=cut(batch.mask),
                               operator=cut(batch.operator),
                               aux=None if batch.aux is None else {k: cut(v) for k, v in batch.aux.items()})


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


def place_graph_batch(mesh: Mesh, op, arrays: dict, batch_sharded: bool = False):
    """This rank's shards of a global batched operator (a
    ``PartitionedOperator`` or a ``PartitionedDirac``) and of ``[B, N,
    ...]`` arrays, on its device: rows of its graph position, and of its
    data position's batch slice with ``batch_sharded``.  Returns (op,
    dict)."""
    arrays = {k: torch.as_tensor(v) for k, v in arrays.items()}
    B, N = next(iter(arrays.values())).shape[:2]
    sl = batch_sharding(mesh, B) if batch_sharded else replicated(mesh, B)
    rows = shard_slice(N, _n_parts(op), mesh.graph_index)
    op_loc = shard_operator(op, mesh.graph_index, sl).to(mesh.device)
    return op_loc, {k: put_global(v[sl], rows, mesh.device, dim=1) for k, v in arrays.items()}


class GraphStore:
    """Device-resident graph-parallel sample store: every sample's rows of
    this rank (its partitioned operator shard and padded arrays, stacked
    ``[S, ...]``), placed once; a batch is an index gather on the device
    (``gather``), of this rank's batch slice under DP x GP."""

    def __init__(self, mesh: Mesh, op, arrays: dict, index_of: dict, items: list,
                 batch_sharded: bool):
        self.mesh = mesh
        self.op = op
        self.arrays = arrays
        self._index_of = index_of
        self._items = items  # held, so id() keys stay valid
        self.batch_sharded = batch_sharded

    @classmethod
    def build(cls, mesh: Mesh, samples: list, op_stacked, arrays: dict,
              batch_sharded: bool = False, budget_bytes: int = DEVICE_BUDGET_BYTES) -> "GraphStore | None":
        """``op_stacked``: the ``[S, ...]``-stacked partitioned operator of
        all ``samples`` (a ``PartitionedOperator`` or a
        ``PartitionedDirac``); ``arrays``: ``[S, N, ...]`` host arrays.  None past
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
