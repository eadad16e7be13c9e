"""The giant-graph path: edge-partitioned aggregation, whole-graph PE
and GIN encoding of graphs beyond the dense bucket, the partition axis
in one process (counterpart of ``gcc_tpu/parallel``; its mesh helpers,
data-parallel and multi-host modules are not ported yet)."""

from gcc_tpu_torch.parallel.giant_features import (
    choose_partition,
    giant_graph_embedding,
    giant_laplacian_pe,
)
from gcc_tpu_torch.parallel.partitioned import (
    DensePartitionedGraph,
    PartitionedGraph,
    RingPartitionedGraph,
    partition_dense,
    partition_edges,
    partition_edges_ring,
    partitioned_aggregate,
    partitioned_aggregate_batched,
    partitioned_aggregate_dense,
    partitioned_aggregate_ring,
    shard_dense_partition,
)

__all__ = [
    "choose_partition",
    "giant_graph_embedding",
    "giant_laplacian_pe",
    "DensePartitionedGraph",
    "PartitionedGraph",
    "RingPartitionedGraph",
    "partition_dense",
    "shard_dense_partition",
    "partition_edges",
    "partition_edges_ring",
    "partitioned_aggregate",
    "partitioned_aggregate_batched",
    "partitioned_aggregate_dense",
    "partitioned_aggregate_ring",
]
