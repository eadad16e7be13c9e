"""Giant-graph GIN encoding over a partitioned graph.

Counterpart of ``gcc_tpu/parallel/giant.py``. The dense per-subgraph
path (``models/gin.py``) holds one (N, N) adjacency per graph; a whole
graph beyond that envelope is encoded here with the same GIN semantics,
each layer aggregating over a partition of its edges
(:mod:`gcc_tpu_torch.parallel.partitioned`) — the schedule follows the
partition type — with eval-mode BatchNorm and a masked-sum readout per
layer. The partition axis runs in one process, or across the ranks of a
``torch.distributed`` group (the reference's "part" mesh axis): each rank
holds a block of node rows and its shard of the partition, and the
readout sums are all-reduced.

It reads the weights and running statistics of the port's own
``UnsupervisedGIN`` modules, so a checkpoint of the subgraph path
encodes giant graphs without conversion, as in the reference.
"""

from __future__ import annotations

import torch

from gcc_tpu_torch.parallel import data_parallel as dp
from gcc_tpu_torch.parallel.partitioned import (
    DensePartitionedGraph,
    RingPartitionedGraph,
    partitioned_aggregate,
    partitioned_aggregate_dense,
    partitioned_aggregate_dist,
    partitioned_aggregate_ring,
)


def aggregate_for(pg, group=None):
    """The aggregation of a partition's schedule: in one process, or
    across the ranks of ``group`` (:func:`~gcc_tpu_torch.parallel.
    partitioned.partitioned_aggregate_dist`)."""
    if group is not None:
        return lambda pg_, h: partitioned_aggregate_dist(pg_, h, group)
    if isinstance(pg, RingPartitionedGraph):
        return partitioned_aggregate_ring
    if isinstance(pg, DensePartitionedGraph):
        return partitioned_aggregate_dense
    return partitioned_aggregate


def check_giant_encoder(model) -> None:
    """Raise on encoders the giant path cannot run: it takes GIN with
    BatchNorm only (the reference's reads the GIN's BatchNorm parameters
    and statistics and fails on others with a ``KeyError``)."""
    cfg = model.cfg
    if cfg.model != "gin" or cfg.use_selayer:
        raise ValueError(
            f"the giant-graph path encodes with GIN and BatchNorm only, not "
            f"model={cfg.model!r}, use_selayer={cfg.use_selayer} — raise "
            "n_max to cover the graphs on the dense path")


def giant_gin_encode(model, pg, node_feat: torch.Tensor,
                     node_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Eval-mode GIN forward over a partitioned graph
    (``giant.py:45-99``).

    model: the port's ``GraphEncoder`` (its ``gnn`` an
    ``UnsupervisedGIN``); its running statistics are used whatever its
    train/eval mode. node_feat: (N, F_in) on the partition's device;
    node_mask: (N,) 1.0 for real nodes. With ``group``, pg is this rank's
    shard (or the whole partition) and node_feat, node_mask are its rows;
    the BatchNorm and the MLPs stay row-local, the layers' masked sums are
    all-reduced in one call, and every rank returns the same bits.
    Returns the graph embedding (output_dim,), L2-normalized with a 1e-5
    floor."""
    check_giant_encoder(model)
    gin = model.gnn
    aggregate = aggregate_for(pg, group)
    h = node_feat * node_mask[:, None]
    hidden_rep = [h]
    for i, mlp in enumerate(gin.mlps):
        agg = h + aggregate(pg, h)
        z = torch.relu(mlp.bn.eval_apply(mlp.linear0(agg)))
        z = mlp.linear1(z)
        z = torch.relu(gin.norms[2 * i].eval_apply(z))
        h = torch.relu(gin.norms[2 * i + 1].eval_apply(z))
        hidden_rep.append(h)
    pooled = [(rep * node_mask[:, None]).sum(0) for rep in hidden_rep]
    if group is not None:
        pooled = dp.all_reduce_sum(torch.cat(pooled), group).split(
            [p.numel() for p in pooled])
    score = 0.0
    for p, lin in zip(pooled, gin.readouts):
        score = score + lin(p)
    return score / torch.clamp_min(torch.linalg.vector_norm(score), 1e-5)
