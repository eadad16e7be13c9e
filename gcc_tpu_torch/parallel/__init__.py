"""Parallel paths (counterpart of ``gcc_tpu/parallel``): the giant-graph
path — edge-partitioned aggregation, whole-graph PE and GIN encoding of
graphs beyond the dense bucket, the partition axis in one process or
across the ranks of a ``torch.distributed`` group (each rank its block of
node rows and its shard of the partition, :func:`place_shard`) — and
data-parallel, multi-host pre-training on ``torch.distributed``
(``data_parallel.py``, ``multihost.py``). The reference's ``mesh.py``
has no counterpart: the ranks are the mesh."""

from gcc_tpu_torch.parallel.data_parallel import (
    all_reduce_max,
    all_reduce_sum,
)
from gcc_tpu_torch.parallel.giant import giant_gin_encode
from gcc_tpu_torch.parallel.giant_features import (
    choose_partition,
    giant_graph_embedding,
    giant_laplacian_pe,
    giant_partitions,
)
from gcc_tpu_torch.parallel.partitioned import (
    DensePartitionedGraph,
    PartitionedGraph,
    PartitionShard,
    RingPartitionedGraph,
    partition_dense,
    partition_edges,
    partition_edges_ring,
    partitioned_aggregate,
    partitioned_aggregate_batched,
    partitioned_aggregate_dense,
    partitioned_aggregate_dist,
    partitioned_aggregate_ring,
    place_shard,
    shard_dense_partition,
)

__all__ = [
    "all_reduce_max",
    "all_reduce_sum",
    "choose_partition",
    "giant_gin_encode",
    "giant_graph_embedding",
    "giant_laplacian_pe",
    "giant_partitions",
    "DensePartitionedGraph",
    "PartitionedGraph",
    "PartitionShard",
    "RingPartitionedGraph",
    "partition_dense",
    "shard_dense_partition",
    "partition_edges",
    "partition_edges_ring",
    "partitioned_aggregate",
    "partitioned_aggregate_batched",
    "partitioned_aggregate_dense",
    "partitioned_aggregate_dist",
    "partitioned_aggregate_ring",
    "place_shard",
]
