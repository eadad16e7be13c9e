"""Operations of the encoder, by the configuration's model, and of the
contrastive logits.

``forward`` counts one forward pass with ``forward`` of
``counts/models/<cfg["model"]>.py`` (``gin`` where the configuration names
no model), for a batch of graphs at their real n nodes and e edges. A
backward is counted as twice the forward. The contrastive logits: 2·d per
query and candidate, backward twice (the queries' gradient only)."""

from __future__ import annotations

import importlib

from benchmark.reference.encoder import model_name


def model_module(name: str):
    """``benchmark.counts.models.<name>``."""
    return importlib.import_module(f"benchmark.counts.models.{name}")


def forward(n_nodes, n_edges, cfg: dict) -> float:
    return model_module(model_name(cfg)).forward(n_nodes, n_edges, cfg)


def logits(queries: int, candidates: int, dim: int) -> float:
    return 2.0 * queries * candidates * dim
