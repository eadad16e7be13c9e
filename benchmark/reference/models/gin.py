"""Plain GIN encoder of GCC (reference gcc/models/graph_encoder.py and
gin.py: learn_eps False, sum aggregation and pooling, 2-layer MLPs, final
dropout), as a function of a parameter dict.

Node features: PE ⊕ degree embedding of clamp(deg, 0, max_degree) ⊕ seed
flag, zeroed on padding. Per conv layer: agg = h + A h;
z = Linear1(ReLU(BN(Linear0(agg)))); z = ReLU(BN(z)); h = ReLU(BN(z)).
Score: Σ over [input, every conv layer] of Dropout(Linear(sum-pool)), then
L2-normalized (eps 1e-5). BatchNorm normalizes over real nodes only: in
training by the batch's masked mean and biased variance (the running
buffers move by 0.1 toward the batch's, the variance unbiased), in eval
mode by the running buffers. Dropout keeps an entry where a uniform draw
from the given generator is at least p, and scales by 1 / (1 - p).

Parameter names follow the state dict of the program's encoder
(``degree_embedding.embedding.weight``, ``gnn.mlps.<i>.linear0.weight``,
``gnn.norms.<j>.running_var``, ``gnn.readouts.<l>.bias``, ...), so that the
benchmark hands both sides one dict.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import bmm, linear


def _bn(x, mask, p: dict, name: str, training: bool, buffers: dict,
        momentum: float = 0.1, eps: float = 1e-5):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if not training:
        mean = buffers[f"{name}.running_mean"]
        var = buffers[f"{name}.running_var"]
        return (x - mean) * torch.rsqrt(var + eps) * w + b
    dims = tuple(range(x.dim() - 1))
    m = mask[..., None]
    count = torch.clamp_min(mask.sum(), 1.0)
    mean = (x * m).sum(dim=dims) / count
    diff = (x - mean) * m
    var = (diff * diff).sum(dim=dims) / count
    with torch.no_grad():
        unbias = count / torch.clamp_min(count - 1.0, 1.0)
        rm, rv = f"{name}.running_mean", f"{name}.running_var"
        buffers[rm] = (1 - momentum) * buffers[rm] + momentum * mean.detach()
        buffers[rv] = (1 - momentum) * buffers[rv] \
            + momentum * var.detach() * unbias
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def encode(p: dict, buffers: dict, pos, degrees, seed_flag, node_mask, adj,
           cfg: dict, training: bool, gen=None, prec: str = "f32"):
    """(B, output_size) embeddings. ``buffers`` (BatchNorm running
    statistics) is updated in place in training mode; ``gen`` draws the
    dropout masks."""
    emb = p["degree_embedding.embedding.weight"][
        torch.clamp(degrees, 0, cfg["max_degree"]).long()]
    h = torch.cat([pos, emb, seed_flag[..., None]], dim=-1) \
        * node_mask[..., None]
    reps = [h]
    for i in range(cfg["num_layers"] - 1):
        mlp = f"gnn.mlps.{i}"
        agg = h + bmm(adj, h, prec)
        z = linear(agg, p[f"{mlp}.linear0.weight"], p[f"{mlp}.linear0.bias"],
                   prec)
        z = torch.relu(_bn(z, node_mask, p, f"{mlp}.bn", training, buffers))
        z = linear(z, p[f"{mlp}.linear1.weight"], p[f"{mlp}.linear1.bias"],
                   prec)
        z = torch.relu(_bn(z, node_mask, p, f"gnn.norms.{2 * i}", training,
                           buffers))
        h = torch.relu(_bn(z, node_mask, p, f"gnn.norms.{2 * i + 1}",
                           training, buffers))
        reps.append(h)
    score = 0.0
    drop = cfg["final_dropout"]
    for l, rep in enumerate(reps):
        pooled = torch.einsum("bnf,bn->bf", rep, node_mask)
        y = linear(pooled, p[f"gnn.readouts.{l}.weight"],
                   p[f"gnn.readouts.{l}.bias"], prec)
        if training and drop > 0:
            keep = torch.rand(y.shape, generator=gen, device=y.device) >= drop
            y = y * keep / (1.0 - drop)
        score = score + y
    norm = torch.linalg.vector_norm(score, dim=-1, keepdim=True)
    return score / torch.clamp_min(norm, 1e-5)
