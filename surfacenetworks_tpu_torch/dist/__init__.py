"""Distribution: the rank grid and its start across launches
(``--multihost``), data parallelism, row-partitioned Laplacians and Dirac
pairs, the graph-sharded model run and the overlap check of the partitioned
applies (counterpart of ``surfacenetworks_tpu/dist``; the partitioned GAT
attend is ``nn.blocks.gat_attend`` on a ``PartitionedOperator``)."""

from surfacenetworks_tpu_torch.dist import (
    analysis,
    data_parallel,
    dirac_partition,
    edge_partition,
    graph_parallel,
    mesh_setup,
)
from surfacenetworks_tpu_torch.dist.analysis import check_overlap_structure
from surfacenetworks_tpu_torch.dist.data_parallel import make_dp_train_step, replicate, shard_batch
from surfacenetworks_tpu_torch.dist.dirac_partition import (
    PartitionedDirac,
    partition_dirac,
    partitioned_dirac_fv,
    partitioned_dirac_vf,
    shard_partitioned_dirac,
    sort_faces_for_partition,
    stack_partitioned_dirac,
)
from surfacenetworks_tpu_torch.dist.edge_partition import (
    PartitionedEll,
    PartitionedOperator,
    halo_exchange,
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
    partition_batch_dirac,
    partition_batch_operator,
    place_graph_batch,
    prepartition_dirac,
    prepartition_ell,
    shard_batch_rows,
    shard_operator,
)
from surfacenetworks_tpu_torch.dist.mesh_setup import (
    Mesh,
    batch_sharding,
    choose_backend,
    initialize_multihost,
    launch,
    launch_multihost,
    make_mesh,
    replicated,
)

__all__ = [
    "GraphStore",
    "Mesh",
    "analysis",
    "PartitionedDirac",
    "PartitionedEll",
    "PartitionedOperator",
    "batch_sharding",
    "check_overlap_structure",
    "choose_backend",
    "data_parallel",
    "dirac_partition",
    "edge_partition",
    "graph_parallel",
    "halo_exchange",
    "initialize_multihost",
    "launch",
    "launch_multihost",
    "make_dp_train_step",
    "make_graph_sharded_apply",
    "make_mesh",
    "make_partitioned_spmm",
    "mesh_setup",
    "partition_batch_dirac",
    "partition_batch_operator",
    "partition_dirac",
    "partition_ell",
    "partition_operator",
    "partitioned_dirac_fv",
    "partitioned_dirac_vf",
    "partitioned_spmm",
    "place_graph_batch",
    "prepartition_dirac",
    "prepartition_ell",
    "replicate",
    "replicated",
    "shard_batch",
    "shard_batch_rows",
    "shard_operator",
    "shard_partitioned",
    "shard_partitioned_dirac",
    "shard_rows",
    "sort_faces_for_partition",
    "stack_partitioned",
    "stack_partitioned_dirac",
    "suggest_halo",
]
