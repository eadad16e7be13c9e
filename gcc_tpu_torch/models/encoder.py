"""GraphEncoder: input features + GIN + output L2 normalization.

Counterpart of ``gcc_tpu/models/encoder.py`` (GIN branch,
``:27-58,93-100``; reference gcc/models/graph_encoder.py:19-200 with
degree_input=True): node features = concat(positional embedding, degree
embedding of clamp(deg, 0, max_degree), seed flag) → 49-d at the
canonical config, masked to real nodes, through the GIN, then
F.normalize(p=2, eps=1e-5) of the graph embedding.

Train/eval follows ``module.train()`` / ``module.eval()``: train mode
normalizes by batch statistics (and updates the running buffers) and
applies the final dropout with the generator passed to ``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from gcc_tpu_torch.config import EncoderConfig
from gcc_tpu_torch.features.featurize import BatchFeatures
from gcc_tpu_torch.models.gin import UnsupervisedGIN
from gcc_tpu_torch.models.layers import DegreeEmbedding


class GraphEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.model != "gin" or not cfg.degree_input or cfg.use_selayer:
            raise NotImplementedError(
                "only the GIN encoder with degree input and BatchNorm is "
                "ported so far")
        self.cfg = cfg
        self.degree_embedding = DegreeEmbedding(cfg.max_degree,
                                                cfg.degree_embedding_size)
        self.gnn = UnsupervisedGIN(
            input_dim=cfg.node_input_dim, num_layers=cfg.num_layers,
            hidden_dim=cfg.hidden_size, output_dim=cfg.output_size,
            final_dropout=cfg.final_dropout)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        """Torch-default initialization drawn from ``gen``."""
        self.degree_embedding.reset_parameters(gen)
        self.gnn.reset_parameters(gen)

    def forward(self, feats: BatchFeatures,
                gen: torch.Generator | None = None,
                return_all_outputs: bool = False):
        """Graph embeddings (B, output_size); with ``return_all_outputs``
        also the GIN's pooled list (input features, then every conv
        layer), the ingredients of the composite readout."""
        parts = [feats.pos, self.degree_embedding(feats.degrees),
                 feats.seed_flag[..., None]]
        # Padded nodes contribute zero to every node sum downstream; the
        # degree-0 embedding row is nonzero, so mask the input.
        n_feat = torch.cat(parts, dim=-1) * feats.node_mask[..., None]
        x, pooled = self.gnn(n_feat, feats.adj, feats.node_mask, gen)
        if self.cfg.norm:
            norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            x = x / torch.clamp_min(norm, 1e-5)
        if return_all_outputs:
            return x, pooled
        return x
