"""GraphEncoder: input features + GNN dispatch + output L2 normalization.

Counterpart of ``gcc_tpu/models/encoder.py`` (reference
gcc/models/graph_encoder.py:19-200): node features = concat(positional
embedding, degree embedding of clamp(deg, 0, max_degree) — with
``degree_input``, the default — and seed flag) → 49-d at the canonical
config (33-d without degree input), masked to real nodes, through the
GNN — GIN (the default; BatchNorm or SE), or GAT / MPNN, whose node
states go through Set2Set → Linear → ReLU → Linear — then
F.normalize(p=2, eps=1e-5) of the graph embedding.

Train/eval follows ``module.train()`` / ``module.eval()``: train mode
normalizes by batch statistics (and updates the running buffers) and
applies GIN's final dropout with the generator passed to ``forward``.

Inside a train step on the card a call replays CUDA graphs of this
forward (``models/step_graphs.py``); everywhere else it runs eagerly.
"""

from __future__ import annotations

import torch
from torch import nn

from gcc_tpu_torch.config import EncoderConfig
from gcc_tpu_torch.features.featurize import BatchFeatures
from gcc_tpu_torch.models.gat import UnsupervisedGAT
from gcc_tpu_torch.models.gin import UnsupervisedGIN
from gcc_tpu_torch.models.layers import DegreeEmbedding, init_linear_
from gcc_tpu_torch.models.mpnn import UnsupervisedMPNN
from gcc_tpu_torch.models.set2set import Set2Set
from gcc_tpu_torch.models.step_graphs import StepGraphs


class GraphEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.step_graphs = StepGraphs()
        # Without degree input the features are [PE, seed flag]
        # (gcc_tpu/models/encoder.py:39-44), node_input_dim pos + 1.
        self.degree_embedding = (
            DegreeEmbedding(cfg.max_degree, cfg.degree_embedding_size)
            if cfg.degree_input else None)
        d, h = cfg.node_input_dim, cfg.hidden_size
        if cfg.model == "gin":
            self.gnn = UnsupervisedGIN(
                input_dim=d, num_layers=cfg.num_layers, hidden_dim=h,
                output_dim=cfg.output_size, final_dropout=cfg.final_dropout,
                use_selayer=cfg.use_selayer)
            return
        if cfg.model == "gat":
            self.gnn = UnsupervisedGAT(d, h, cfg.num_layers, cfg.num_heads)
        elif cfg.model == "mpnn":
            self.gnn = UnsupervisedMPNN(d, h,
                                        num_step_message_passing=cfg.num_layers)
        else:
            raise ValueError(f"unknown gnn model: {cfg.model}")
        self.set2set = Set2Set(h, cfg.set2set_iter, cfg.set2set_lstm_layer)
        self.readout0 = nn.Linear(2 * h, h)
        self.readout1 = nn.Linear(h, cfg.output_size)

    def reset_parameters(self, gen: torch.Generator | None) -> None:
        """Torch-default initialization drawn from ``gen``."""
        if self.degree_embedding is not None:
            self.degree_embedding.reset_parameters(gen)
        self.gnn.reset_parameters(gen)
        if self.cfg.model != "gin":
            self.set2set.reset_parameters(gen)
            init_linear_(self.readout0, gen)
            init_linear_(self.readout1, gen)

    def forward(self, feats: BatchFeatures,
                gen: torch.Generator | None = None,
                return_all_outputs: bool = False):
        """Graph embeddings (B, output_size); with ``return_all_outputs``
        also the GIN's pooled list (input features, then every conv
        layer), the ingredients of the composite readout — None for the
        other encoders."""
        if return_all_outputs:
            return self._encode(feats, gen, return_all_outputs=True)
        return self.step_graphs(self, feats, gen, self._encode)

    def _encode(self, feats: BatchFeatures, gen: torch.Generator | None,
                return_all_outputs: bool = False):
        parts = [feats.pos]
        if self.degree_embedding is not None:
            parts.append(self.degree_embedding(feats.degrees))
        parts.append(feats.seed_flag[..., None])
        # Padded nodes contribute zero to every node sum downstream; the
        # degree-0 embedding row is nonzero, so mask the input.
        n_feat = torch.cat(parts, dim=-1) * feats.node_mask[..., None]
        if self.cfg.model == "gin":
            x, pooled = self.gnn(n_feat, feats.adj, feats.node_mask, gen)
        else:
            h = self.gnn(n_feat, feats.adj, feats.node_mask)
            x = self.set2set(h, feats.node_mask)
            x = self.readout1(torch.relu(self.readout0(x)))
            pooled = None
        if self.cfg.norm:
            norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            x = x / torch.clamp_min(norm, 1e-5)
        if return_all_outputs:
            return x, pooled
        return x
