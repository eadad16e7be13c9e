from gcc_tpu_torch.tasks.node_classification import NodeClassification, evaluate_node_embeddings
from gcc_tpu_torch.tasks.graph_classification import GraphClassification, evaluate_graph_embeddings
from gcc_tpu_torch.tasks.similarity_search import SimilaritySearch, evaluate_similarity

__all__ = [
    "NodeClassification",
    "GraphClassification",
    "SimilaritySearch",
    "evaluate_node_embeddings",
    "evaluate_graph_embeddings",
    "evaluate_similarity",
]
