from gcc_tpu_torch.models.emb.adapters import FromNumpy, FromNumpyAlign, FromNumpyGraph, Zero
from gcc_tpu_torch.models.emb.prone import ProNE
from gcc_tpu_torch.models.emb.graphwave import GraphWave

# Task-model registry (reference gcc/tasks/__init__.py:11-19).
REGISTRY = {
    "zero": Zero,
    "from_numpy": FromNumpy,
    "from_numpy_align": FromNumpyAlign,
    "from_numpy_graph": FromNumpyGraph,
    "prone": ProNE,
    "graphwave": GraphWave,
}


def build_model(name: str, hidden_size: int, **kwargs):
    return REGISTRY[name](hidden_size, **kwargs)


__all__ = ["build_model", "REGISTRY", "Zero", "FromNumpy", "FromNumpyAlign",
           "FromNumpyGraph", "ProNE", "GraphWave"]
