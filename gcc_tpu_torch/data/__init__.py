from gcc_tpu_torch.data.formats import (
    Edgelist,
    SSDataset,
    SSSingleDataset,
    create_node_classification_dataset,
)

__all__ = [
    "Edgelist",
    "SSDataset",
    "SSSingleDataset",
    "create_node_classification_dataset",
]
