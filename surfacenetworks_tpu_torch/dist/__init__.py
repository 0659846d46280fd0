"""Distribution: the rank grid, data parallelism and row-partitioned
Laplacians (counterpart of the Laplacian half of
``surfacenetworks_tpu/dist``).  The Dirac partition, the partitioned GAT
attend and the overlap analysis are not ported yet."""

from surfacenetworks_tpu_torch.dist import data_parallel, edge_partition, graph_parallel, mesh_setup
from surfacenetworks_tpu_torch.dist.data_parallel import make_dp_train_step, replicate, shard_batch
from surfacenetworks_tpu_torch.dist.edge_partition import (
    PartitionedEll,
    PartitionedOperator,
    make_partitioned_spmm,
    partition_ell,
    partition_operator,
    partitioned_spmm,
    shard_partitioned,
    shard_rows,
    stack_partitioned,
    suggest_halo,
)
from surfacenetworks_tpu_torch.dist.graph_parallel import (
    GraphStore,
    make_graph_sharded_apply,
    partition_batch_operator,
    place_graph_batch,
    prepartition_ell,
)
from surfacenetworks_tpu_torch.dist.mesh_setup import (
    Mesh,
    batch_sharding,
    choose_backend,
    initialize_multihost,
    launch,
    make_mesh,
    replicated,
)

__all__ = [
    "GraphStore",
    "Mesh",
    "PartitionedEll",
    "PartitionedOperator",
    "batch_sharding",
    "choose_backend",
    "data_parallel",
    "edge_partition",
    "graph_parallel",
    "initialize_multihost",
    "launch",
    "make_dp_train_step",
    "make_graph_sharded_apply",
    "make_mesh",
    "make_partitioned_spmm",
    "mesh_setup",
    "partition_batch_operator",
    "partition_ell",
    "partition_operator",
    "partitioned_spmm",
    "place_graph_batch",
    "prepartition_ell",
    "replicate",
    "replicated",
    "shard_batch",
    "shard_partitioned",
    "shard_rows",
    "stack_partitioned",
    "suggest_halo",
]
