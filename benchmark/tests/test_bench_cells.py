"""Every cell end to end on the CPU at a tiny size (the program's plain
versions in place of its kernels): a well-formed result line, correct."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.harness import common
from benchmark.tests.tiny import TINY, run_cell

BENCH = common.load_json(os.path.join(common.ROOT, "BENCHMARK.json"))
TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(capsys, workload, trace):
    line = run_cell(capsys, workload, trace=trace)
    for key in TOP_KEYS:
        assert key in line
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    wanted = {m["name"] for m in common.cell_metrics(BENCH, workload, trace)}
    # Every host-clock metric reads on the CPU; device-trace ones need the
    # card and are left out, not written as 0.
    host = {m["name"] for m in (BENCH["per_layer"] if trace
                                else BENCH["end_to_end"])
            if m["source"] == "host_clock"} & wanted
    assert host <= set(line["metrics"]) <= wanted
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_benchmark_json_names_every_file():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert os.path.exists(common.traffic_path(w["traffic"]))
        assert os.path.exists(common.limits_path(w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
    json.dumps(BENCH)


def test_no_card_no_result(capsys, monkeypatch):
    """Without a card the run exits non-zero before any result."""
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "moco-pretrain", "--seed", "1", "--seconds",
                  "1", "--trace", "0"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "moco-pretrain",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
