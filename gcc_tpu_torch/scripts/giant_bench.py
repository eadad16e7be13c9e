"""The giant path's wall time on one card.

Counterpart of ``scripts/giant_bench.py``: one heavy-tailed graph of
50,000 nodes through ``parallel.giant_features.giant_graph_embedding``
(host partition build, the whole-graph PE at the eval profile's guards
with its Jacobi finish on Kernel 3, the giant GIN encode), first call
then 3 warm calls at the same shape, their median; edge-messages/s
through the 4 GIN aggregation layers of the encode. The canonical
encoder with seed-0 weights, one partition (``parts=1``).

Usage: python -m gcc_tpu_torch.scripts.giant_bench [--nodes 50000]
    [--out build/gcc_tpu_torch/GIANT.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gcc_tpu_torch.bench import gpu_line
from gcc_tpu_torch.config import TrainConfig
from gcc_tpu_torch.device import resolve_device
from gcc_tpu_torch.graph.csr import CSRGraph
from gcc_tpu_torch.models import GraphEncoder
from gcc_tpu_torch.parallel.giant_features import giant_graph_embedding
from gcc_tpu_torch.paths import BUILD_DIR

WARM_TRIALS = 3


def heavy_tailed_graph(n: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    """The draw of ``scripts/giant_bench.py:58-66``: n·avg_degree/2 edges
    with ``src = n·U²`` (low ids are hubs), self-loops dropped,
    symmetrized."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree // 2
    src = (n * rng.random(m) ** 2.0).astype(np.int64)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return CSRGraph.from_edges(src[keep], dst[keep], num_nodes=n,
                               symmetrize=True)


def run(nodes: int = 50_000, avg_degree: int = 12, iters: int = 64,
        device="cuda") -> dict:
    device = resolve_device(device)
    g = heavy_tailed_graph(nodes, avg_degree)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges", flush=True)
    cfg = TrainConfig()
    model = GraphEncoder(cfg.encoder)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device).eval()

    def embed() -> tuple[np.ndarray, float]:
        t0 = time.perf_counter()
        emb = giant_graph_embedding(model, g, parts=1, iters=iters,
                                    device=device).cpu().numpy()
        return emb, time.perf_counter() - t0

    emb, first_s = embed()
    if not np.isfinite(emb).all():
        raise RuntimeError("giant_bench: the embedding is not finite")
    print(f"first encode: {first_s:.1f}s", flush=True)
    warm = sorted(embed()[1] for _ in range(WARM_TRIALS))
    warm_s = warm[len(warm) // 2]
    layers = cfg.encoder.num_layers - 1
    return {
        "metric": "giant_encode_ms",
        "nodes": g.num_nodes,
        "edges": g.num_edges,
        "pe_iters": iters,
        "first_encode_s": round(first_s, 2),
        "warm_encode_s": round(warm_s, 3),
        "warm_trials_s": [round(t, 3) for t in warm],
        "edge_msgs_per_s_encode": round(g.num_edges * layers / warm_s, 1),
        "devices": 1,
        "gpu": gpu_line() if device.type == "cuda" else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The giant path's wall time.")
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--avg-degree", type=int, default=12)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(BUILD_DIR, "GIANT.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.nodes, args.avg_degree, args.iters, args.device)
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
