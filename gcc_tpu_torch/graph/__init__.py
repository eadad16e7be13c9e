from gcc_tpu_torch.graph.batch import (
    CompactWireBatch,
    PaddedSubgraphBatch,
    Subgraph,
    WireBatch,
    batch_subgraphs,
    expand_compact,
    pack_edge_ids,
    pick_bucket,
)
from gcc_tpu_torch.graph.corpus import (
    CorpusStore,
    partition_graphs,
    synthetic_corpus,
)
from gcc_tpu_torch.graph.csr import CSRGraph

__all__ = [
    "CSRGraph",
    "CompactWireBatch",
    "CorpusStore",
    "PaddedSubgraphBatch",
    "Subgraph",
    "WireBatch",
    "batch_subgraphs",
    "expand_compact",
    "pack_edge_ids",
    "partition_graphs",
    "pick_bucket",
    "synthetic_corpus",
]
