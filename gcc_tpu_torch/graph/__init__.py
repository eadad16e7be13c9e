from gcc_tpu_torch.graph.batch import (
    CompactWireBatch,
    PaddedSubgraphBatch,
    Subgraph,
    WireBatch,
    batch_subgraphs,
    concat_padded,
    expand_compact,
    expand_wire,
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
    "concat_padded",
    "expand_compact",
    "expand_wire",
    "pack_edge_ids",
    "partition_graphs",
    "pick_bucket",
    "synthetic_corpus",
]
