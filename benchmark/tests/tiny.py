"""Tiny overrides of the cells for CPU runs, and a helper that runs a
cell in-process and returns its result line."""

from __future__ import annotations

import json

from benchmark import run

CORPUS = {"num_graphs": 2, "nodes_per_graph": 3000, "avg_degree": 8,
          "seed": 0}
TINY = {
    "moco-pretrain": {
        "config": {"corpus": CORPUS, "nce_k": 64, "batch_size": 8,
                   "steps_per_dispatch": 4, "n_small": 32, "n_max": 64,
                   "e_max": 512},
        "traffic": {"num_samples": 512, "trace_steps": 4}},
    "e2e-pretrain": {
        "config": {"corpus": CORPUS, "batch_size": 16, "e2e_split": "32:12",
                   "steps_per_dispatch": 4, "n_max": 64, "e_max": 512},
        "traffic": {"num_samples": 512, "trace_steps": 4}},
    "moco-embed": {
        "traffic": {"dataset_nodes": 512, "batch": 64, "n_max": 64,
                    "e_max": 1024, "check_every": 1, "check_calls": 2,
                    "warm_calls": 1, "trace_calls": 1}},
}


def run_cell(capsys, workload: str, seed: int = 20260, trace: int = 0,
             seconds: float = 0.5, override=None, bench=None) -> dict:
    """Run ``workload`` on the CPU at its tiny size; the parsed last line
    of stdout."""
    args = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu",
            "--override",
            json.dumps(TINY[workload] if override is None else override)]
    if bench:
        args += ["--benchmark-json", bench]
    capsys.readouterr()
    assert run.main(args) == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
