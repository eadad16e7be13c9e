from gcc_tpu_torch.sampling.native import (
    native_available,
    random_walk_final,
    sample_subgraphs,
    weighted_sample,
)
from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline
from gcc_tpu_torch.sampling.sampler import (
    degree_weights,
    entire_graph_subgraph,
    rwr_budgets,
    sample_contrastive_pairs,
)

__all__ = [
    "PipelineConfig",
    "PretrainPipeline",
    "native_available",
    "sample_subgraphs",
    "random_walk_final",
    "weighted_sample",
    "rwr_budgets",
    "sample_contrastive_pairs",
    "entire_graph_subgraph",
    "degree_weights",
]
