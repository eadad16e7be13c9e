"""A/B of the sampler's hub-row binary-search extraction on the
reference-scale corpus.

Counterpart of ``scripts/hub_ab.py``. Pure host: it launches nothing on
the card. The corpus must be the sorted-rows build (``python -m
gcc_tpu_torch.scripts.refscale_bench`` makes it), so that every arm
samples identical trajectories: the arms differ only in the shared
sampler's hub threshold multiplier, the ``GCC_TPU_HUB_MULT`` variable
that ``csrc/sampler.cpp`` reads at each call (rows with degree above
mult × |visit set| take the binary search instead of the full scan; 0
turns it off). This script sets it for each arm and restores it after.

A warm pass first (the first pass after a build pays cold page-cache
faults), then a coarse one-trial sweep of multipliers at 1 thread, then
the winner against 0 at 2 threads.

Usage: python -m gcc_tpu_torch.scripts.hub_ab [--pairs 2048]
    [--out build/gcc_tpu_torch/HUB_AB.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

from gcc_tpu_torch.graph.corpus import CorpusStore
from gcc_tpu_torch.paths import BUILD_DIR
from gcc_tpu_torch.scripts.refscale_bench import REFSCALE_CORPUS, bench_corpus

HUB_MULT = "GCC_TPU_HUB_MULT"


@contextlib.contextmanager
def hub_mult(mult: int):
    """The shared sampler's hub multiplier set to mult while the block
    runs, the earlier value (or its absence) restored after."""
    before = os.environ.get(HUB_MULT)
    os.environ[HUB_MULT] = str(mult)
    try:
        yield
    finally:
        if before is None:
            del os.environ[HUB_MULT]
        else:
            os.environ[HUB_MULT] = before


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="A/B of the sampler's hub-row extraction.")
    ap.add_argument("--pairs", type=int, default=2048)
    ap.add_argument("--final-pairs", type=int, default=4096)
    ap.add_argument("--corpus", default=REFSCALE_CORPUS)
    ap.add_argument("--mults", default="0,2,4,8,16,64")
    ap.add_argument("--out", default=os.path.join(BUILD_DIR, "HUB_AB.json"))
    args = ap.parse_args(argv)

    store = CorpusStore.open(args.corpus)
    if not store.manifest.get("rows_sorted"):
        raise ValueError(f"{args.corpus}: the hub A/B needs the sorted-rows "
                         "corpus build")

    results = {}

    def run(mult: int, threads: int, pairs: int) -> None:
        with hub_mult(mult):
            r = bench_corpus(args.corpus, pairs, threads=threads)
        ns = r["native_stats"]
        sub = max(ns.get("subgraphs", 0), 1)
        row = {
            "ms_per_batch_pair": r["ms_per_batch_pair_32"],
            "walk_us_per_sg": round(ns["walk_ns"] / sub / 1e3, 2),
            "extract_us_per_sg": round(ns["extract_ns"] / sub / 1e3, 2),
            "host_ceiling_msgs_per_s": r["host_ceiling_edge_msgs_per_s"],
            "pairs": pairs,
        }
        key = f"mult{mult}_t{threads}"
        results[key] = row
        print(json.dumps({key: row}), flush=True)

    mults = [int(m) for m in args.mults.split(",")]
    with hub_mult(0):
        bench_corpus(args.corpus, max(256, args.pairs // 8), threads=1)
    for m in mults:
        run(m, threads=1, pairs=args.pairs)
    best = min(mults,
               key=lambda m: results[f"mult{m}_t1"]["ms_per_batch_pair"])
    print(f"sweep winner: mult={best}", flush=True)
    run(0, threads=2, pairs=args.final_pairs)
    if best != 0:
        run(best, threads=2, pairs=args.final_pairs)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
