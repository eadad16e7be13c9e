"""Frozen-embedding generation (reference generate.py:33-125).

Counterpart of ``gcc_tpu/generate.py``. For every node (or graph, in
entire-graph mode) of an evaluation dataset: sample two independent RWR
subgraph views exactly as in pre-training, encode both with the trained
encoder in eval mode, and emit (feat_q + feat_k) / 2 — the same model
encodes both views; the EMA key encoder is never used at generation
time. Batches stream through one fixed (n_max, e_max) bucket, so any
dataset size runs at one set of shapes.

Featurization runs the eval PE profile (16 guard columns, the guarded
generalized Rayleigh–Ritz): per encode call one launch of Kernel 2 and
two of Kernel 3. Entire graphs beyond the bucket go to the partitioned
giant path (``parallel/``): two launches of Kernel 3 per graph.

Every function takes the port's ``GraphEncoder`` or a ``PretrainState``
(whose query encoder is used) and ``device`` (default ``"cuda"``; an
encoder that lives elsewhere is copied there, never moved).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.features.featurize import featurize_batch
from gcc_tpu_torch.graph.batch import Subgraph, batch_subgraphs
from gcc_tpu_torch.graph.csr import CSRGraph
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.parallel.giant_features import giant_graph_embedding
from gcc_tpu_torch.sampling import native
from gcc_tpu_torch.sampling.sampler import entire_graph_subgraph, rwr_budgets


def _encoder_of(model) -> GraphEncoder:
    return model if isinstance(model, GraphEncoder) else model.model


@contextlib.contextmanager
def _eval_mode(enc: GraphEncoder, device: torch.device):
    """The encoder on ``device`` in eval mode (BatchNorm on its running
    statistics, no dropout), no gradients; its mode is restored. An
    encoder on another device is copied, so a training state passed in
    stays whole."""
    if next(enc.parameters()).device.type != device.type:
        enc = copy.deepcopy(enc).to(device)
    was_training = enc.training
    enc.eval()
    try:
        with torch.no_grad():
            yield enc
    finally:
        enc.train(was_training)


def _guarded_batch_size(batch_size: int, n_max: int) -> int:
    # Dense adjacency memory guard: keep the batch's (B, N, N) blocks
    # under ~1 GB — entire-graph datasets of a few thousand nodes per
    # graph need small batches at big buckets.
    return min(batch_size, max(1, (1 << 30) // max(1, n_max * n_max * 4)))


def _encode_chunks(cfg: TrainConfig, enc: GraphEncoder, subgraphs, n_max,
                   e_max, batch_size, device, return_all_outputs=False):
    """Yield (encoder output, rows to keep) per chunk of ``batch_size``
    subgraphs; the last chunk is padded with copies of its last graph so
    every call runs at one shape."""
    for i in range(0, len(subgraphs), batch_size):
        chunk = subgraphs[i: i + batch_size]
        keep = len(chunk)
        if keep < batch_size:
            chunk = chunk + [chunk[-1]] * (batch_size - keep)
        feats = featurize_batch(
            batch_subgraphs(chunk, n_max=n_max, e_max=e_max),
            cfg.encoder.positional_embedding_size,
            pe_method=cfg.encoder.pe_method, profile="eval", device=device)
        yield enc(feats, return_all_outputs=return_all_outputs), keep


def generate_embeddings(
    cfg: TrainConfig,
    model,
    subgraphs: list[Subgraph],
    n_max: int = 512,
    e_max: int = 8192,
    batch_size: int = 64,
    subgraphs_k: list[Subgraph] | None = None,
    device="cuda",
) -> np.ndarray:
    """Encode subgraph views with the trained encoder in eval mode.

    With ``subgraphs_k`` given, returns (enc(q) + enc(k)) / 2 over the two
    independently sampled views (the reference freeze protocol,
    generate.py:40-52); otherwise encodes the single view (entire-graph
    mode, where both reference views are the identical whole graph)."""
    device = resolve_device(device)
    batch_size = _guarded_batch_size(batch_size, n_max)
    with _eval_mode(_encoder_of(model), device) as enc:
        def run(subs):
            # Device tensors are gathered once at the end, so the encode
            # calls queue up without a host round trip per chunk.
            outs = [emb[:keep] for emb, keep in _encode_chunks(
                cfg, enc, subs, n_max, e_max, batch_size, device)]
            return torch.cat(outs, dim=0)

        emb = run(subgraphs)
        if subgraphs_k is not None:
            emb = (emb + run(subgraphs_k)) / 2.0
        return emb.cpu().numpy()


def node_subgraphs(
    g: CSRGraph, cfg: TrainConfig, n_max: int, e_max: int,
    rng_seed: int = 0, two_views: bool = False,
):
    """Per-node RWR subgraphs with the map-style dataset budget
    (out-degree, no ^0.75 — reference graph_dataset.py:243-254 via
    NodeClassificationDataset). With two_views=True returns (q, k)
    lists sampled from independent RNG streams (the reference dataset
    draws two traces per seed, graph_dataset.py:255-260)."""
    seeds = np.arange(g.num_nodes, dtype=np.int64)
    budgets = rwr_budgets(g, seeds, cfg.sampler, degree_power=False)

    def run(stream_ids):
        out = native.sample_subgraphs(
            g, seeds, budgets, restart_prob=cfg.sampler.restart_prob,
            aug=cfg.sampler.aug, expand=cfg.sampler.num_neighbors,
            hops=cfg.sampler.rw_hops, rng_seed=rng_seed,
            sample_ids=stream_ids, node_cap=n_max, e_cap=e_max, n_threads=2,
        )
        return [
            Subgraph(src=out.src[i, :out.e[i]].copy(),
                     dst=out.dst[i, :out.e[i]].copy(),
                     num_nodes=int(out.n[i]), seed=0)
            for i in range(g.num_nodes)
        ]

    if not two_views:
        return run(2 * seeds)
    return run(2 * seeds), run(2 * seeds + 1)


def generate_subgraph_readouts(
    cfg: TrainConfig,
    model,
    subs: list[Subgraph],
    n_max: int = 256,
    e_max: int = 2048,
    batch_size: int = 64,
    device="cuda",
) -> dict:
    """Encode subgraph views capturing every readout ingredient:

      {"score": (G, out), "pooled": [num_layers arrays (G, F_l)],
       "n_nodes": (G,)}

    The reference's embedding is the summed-head score alone; the GIN
    also computes per-layer pooled activations (entry 0: the pooled
    input features), returned here so a readout can be composed
    (:func:`composite_graph_readout`)."""
    device = resolve_device(device)
    batch_size = _guarded_batch_size(batch_size, n_max)
    scores, pooled_chunks = [], []
    with _eval_mode(_encoder_of(model), device) as enc:
        for (score, pooled), keep in _encode_chunks(
                cfg, enc, subs, n_max, e_max, batch_size, device,
                return_all_outputs=True):
            scores.append(score[:keep])
            pooled_chunks.append([p[:keep] for p in pooled])
        return {
            "score": torch.cat(scores, dim=0).cpu().numpy(),
            "pooled": [torch.cat(layer, dim=0).cpu().numpy()
                       for layer in zip(*pooled_chunks)],
            "n_nodes": np.array([min(s.num_nodes, n_max) for s in subs],
                                np.float32),
        }


def generate_graph_readouts(
    cfg: TrainConfig,
    model,
    graphs: list[CSRGraph],
    n_max: int = 256,
    e_max: int = 8192,
    batch_size: int = 64,
    device="cuda",
) -> dict:
    """Entire-graph encode capturing every readout ingredient (see
    :func:`generate_subgraph_readouts`)."""
    return generate_subgraph_readouts(
        cfg, model, graph_subgraphs(graphs), n_max=n_max, e_max=e_max,
        batch_size=batch_size, device=device)


def composite_graph_readout(ro: dict) -> np.ndarray:
    """The frozen graph-level readout "inmean+convl2": concat(mean-pooled
    input features, per-layer L2-normalized pooled conv activations).
    Every pooled layer enters, magnitudes equalized by L2 so no block
    drowns another (``gcc_tpu/generate.py:204-224``)."""
    pooled, n = ro["pooled"], ro["n_nodes"][:, None]

    def _unit(x):
        m = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.where(m == 0, 1.0, m)

    return np.concatenate(
        [pooled[0] / n] + [_unit(p) for p in pooled[1:]], axis=1)


def graph_subgraphs(graphs: list[CSRGraph]) -> list[Subgraph]:
    """Entire-graph mode for graph classification (reference
    graph_dataset.py:327-361)."""
    return [entire_graph_subgraph(g) for g in graphs]


def generate_graph_embeddings(
    cfg: TrainConfig,
    model,
    graphs: list[CSRGraph],
    n_max: int = 512,
    e_max: int = 8192,
    batch_size: int = 64,
    parts: int | None = None,
    giant_iters: int = 64,
    readout: str = "score",
    group=None,
    device="cuda",
) -> np.ndarray:
    """Entire-graph embeddings with automatic giant-graph routing, rows in
    the order of ``graphs`` (``gcc_tpu/generate.py:228-291``).

    readout: "score" (the reference protocol, generate.py:33-53) or
    "composite" (:func:`composite_graph_readout`; dense-bucket graphs
    only: the partitioned giant path exposes no per-layer pooled outputs,
    so a graph beyond ``n_max`` raises ``NotImplementedError``).

    Graphs that fit the dense bucket (num_nodes <= n_max) run the
    reference's entire-graph batch path (graph_dataset.py:327-361).
    Graphs beyond it go to the partitioned giant path, one at a time:
    whole-graph PE and GIN over a partition of ``parts`` shards
    (:func:`gcc_tpu_torch.parallel.giant_features.giant_graph_embedding`,
    ``giant_iters`` power steps; GIN with BatchNorm and degree input
    only, others raise ``ValueError``).

    group: a ``torch.distributed`` group across whose ranks each giant
    graph is spread, one shard a rank (``parts`` defaults to its size;
    the reference spreads it over the "part" axis of a mesh of every
    device). Every rank of the group makes the call, runs the dense-bucket
    graphs itself, and returns the whole array, the same on every rank.
    Without a group the shards run in one process (``parts`` default 1)."""
    if readout not in ("score", "composite"):
        raise ValueError(f"unknown graph readout: {readout!r}")
    small = [i for i, g in enumerate(graphs) if g.num_nodes <= n_max]
    giant = [i for i, g in enumerate(graphs) if g.num_nodes > n_max]
    if readout == "composite":
        if giant:
            raise NotImplementedError(
                "readout='composite' needs per-layer pooled outputs, "
                "which the partitioned giant path does not expose — "
                "raise n_max to cover the graphs or use readout='score'")
        return composite_graph_readout(generate_graph_readouts(
            cfg, model, graphs, n_max=n_max, e_max=e_max,
            batch_size=batch_size, device=device))
    out = np.zeros((len(graphs), cfg.encoder.output_size), np.float32)
    if small:
        out[small] = generate_embeddings(
            cfg, model, graph_subgraphs([graphs[i] for i in small]),
            n_max=n_max, e_max=e_max, batch_size=batch_size, device=device)
    if giant:
        device = resolve_device(device)
        with _eval_mode(_encoder_of(model), device) as enc:
            # Device tensors gathered once at the end: the host builds
            # the next graph's partition while the card runs this one.
            embs = [giant_graph_embedding(enc, graphs[i], parts=parts,
                                          iters=giant_iters, group=group,
                                          device=device)
                    for i in giant]
            out[giant] = torch.stack(embs).cpu().numpy()
    return out
