"""Host sampler throughput at the reference's corpus scale.

Counterpart of ``scripts/refscale_bench.py``. Pure host: it launches
nothing on the card. The production pipeline (C++ RWR walk → induced-edge
extract → compact-wire pack, routed emission, ``python -m
gcc_tpu_torch.bench moco``'s buckets) runs against two corpora:

  small     the bench corpus, 6 × ~100k nodes: its CSR fits in the
            last-level cache.
  refscale  ``graph.corpus.synthetic_corpus_reference_scale``, the
            reference corpus's shape (~9.8M nodes, ~160M directed edges,
            rows sorted): visit-word and adjacency probes miss the cache.

Reports pair rates, the native sampler's per-phase counters (walk,
extract, pack ns) and the refscale/small cost ratio; the refscale corpus
at 1 thread and at 2.

Usage: python -m gcc_tpu_torch.scripts.refscale_bench [--pairs 4096]
    [--out build/gcc_tpu_torch/REFSCALE.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gcc_tpu_torch.bench import DEFAULT_CORPUS, ensure_corpus
from gcc_tpu_torch.config import SamplerConfig
from gcc_tpu_torch.graph.corpus import (
    CorpusStore,
    synthetic_corpus_reference_scale,
)
from gcc_tpu_torch.paths import BUILD_DIR
from gcc_tpu_torch.sampling import native
from gcc_tpu_torch.sampling.pipeline import PipelineConfig, PretrainPipeline

REFSCALE_CORPUS = os.path.join(BUILD_DIR, "refscale_corpus")


def bench_corpus(corpus_dir: str, pairs_target: int, super_batch: int = 64,
                 threads: int = 1) -> dict:
    """Pairs/s of the routed pipeline in the calling thread
    (``num_workers=0``) over ``corpus_dir``: two warm items (the mmap'd
    CSR is touched, the seed CDFs built), the native counters reset, then
    items until ``pairs_target`` pairs (``refscale_bench.py:40-80``)."""
    store = CorpusStore.open(corpus_dir)
    pcfg = PipelineConfig(
        batch_size=32, n_max=256, e_max=2048, num_samples=1_000_000,
        num_workers=0, emit="routed", super_batch=super_batch, n_small=128,
        threads_per_worker=threads,
    )
    with PretrainPipeline(store, SamplerConfig(rw_hops=256), pcfg,
                          seed=0) as pipe:
        for _ in range(2):
            next(pipe)
        native.sampler_stats(reset=True)
        t0 = time.perf_counter()
        pairs = 0
        edges = 0
        while pairs < pairs_target:
            sq, sk = next(pipe)
            pairs += sq.meta.shape[0] * sq.meta.shape[2]
            edges += int(sq.meta[:, 1, :].sum(dtype=np.int64))
            edges += int(sk.meta[:, 1, :].sum(dtype=np.int64))
        dt = time.perf_counter() - t0
        stats = native.sampler_stats()
    return {
        "corpus": corpus_dir,
        "graphs": store.num_graphs,
        "total_nodes": int(sum(store.graph_sizes)),
        "total_edges": int(sum(g["num_edges"]
                               for g in store.manifest["graphs"])),
        "pairs": pairs,
        "seconds": round(dt, 3),
        "pairs_per_s": round(pairs / dt, 1),
        "ms_per_batch_pair_32": round(dt / (pairs / 32) * 1e3, 3),
        "subgraph_edges": edges,
        "host_ceiling_edge_msgs_per_s": round(edges * 4 / dt, 1),
        "native_stats": stats,
    }


def ensure_refscale_corpus(path: str) -> None:
    """Build the sorted-rows reference-scale corpus under path unless it
    is there. An unsorted build would bench the scan-only extraction, so
    it is rebuilt sorted."""
    manifest_path = os.path.join(path, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            if json.load(f).get("rows_sorted", False):
                return
        print("refscale corpus lacks rows_sorted: rebuilding it sorted",
              flush=True)
    print("building the reference-scale corpus (~160M edges, minutes)...",
          flush=True)
    t0 = time.perf_counter()
    synthetic_corpus_reference_scale(path, seed=0)
    print(f"built in {time.perf_counter() - t0:.0f}s", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Host sampler pairs/s at the reference's corpus scale.")
    ap.add_argument("--pairs", type=int, default=4096)
    ap.add_argument("--small-corpus", default=DEFAULT_CORPUS)
    ap.add_argument("--refscale-corpus", default=REFSCALE_CORPUS)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--out",
                    default=os.path.join(BUILD_DIR, "REFSCALE.json"))
    args = ap.parse_args(argv)

    ensure_corpus(args.small_corpus)
    ensure_refscale_corpus(args.refscale_corpus)
    out = {}
    for name, corpus in (("small", args.small_corpus),
                         ("refscale", args.refscale_corpus)):
        print(f"benching {name} ({corpus})...", flush=True)
        out[name] = bench_corpus(corpus, args.pairs, threads=args.threads)
        print(json.dumps(out[name], indent=1), flush=True)
    # Two threads: the setting for miss-bound corpora.
    if args.threads != 2:
        print("benching refscale_t2...", flush=True)
        out["refscale_t2"] = bench_corpus(args.refscale_corpus, args.pairs,
                                          threads=2)
        print(json.dumps(out["refscale_t2"], indent=1), flush=True)
    else:
        out["refscale_t2"] = out["refscale"]
    out["refscale_over_small_ms_ratio"] = round(
        out["refscale"]["ms_per_batch_pair_32"]
        / out["small"]["ms_per_batch_pair_32"], 3)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}: refscale/small batch-pair cost ratio "
          f"{out['refscale_over_small_ms_ratio']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
