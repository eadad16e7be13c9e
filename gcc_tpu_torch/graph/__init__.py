from gcc_tpu_torch.graph.batch import (
    CompactWireBatch,
    Subgraph,
    WireBatch,
    pack_edge_ids,
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
    "Subgraph",
    "WireBatch",
    "pack_edge_ids",
    "partition_graphs",
    "synthetic_corpus",
]
