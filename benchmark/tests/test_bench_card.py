"""On the card: each cell at a short window, correct, every metric of the
cell read (device-trace ones too). Skipped without a card; the decision is
made in the fixture."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import common

BENCH = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, workload, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "3", "--trace", str(trace)],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    wanted = {m["name"] for m in common.cell_metrics(BENCH, workload, trace)}
    assert set(line["metrics"]) == wanted
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name
        if m["unit"] == "%":
            assert m["value"] <= 100.0, name
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
