from gcc_tpu_torch.features.featurize import (
    BatchFeatures,
    featurize_batch,
    featurize_compact,
)
from gcc_tpu_torch.features.positional import laplacian_positional_embedding

__all__ = ["BatchFeatures", "featurize_batch", "featurize_compact",
           "laplacian_positional_embedding"]
