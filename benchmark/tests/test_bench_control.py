"""The control (the reference in the program's place at TF32 operands)
comes out not correct, at a size a test run holds; on the card the same
script runs at each cell's own size."""

from __future__ import annotations

import json

import pytest

from benchmark import control
from benchmark.tests.tiny import TINY


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(capsys, workload):
    capsys.readouterr()
    control.main(["--workload", workload, "--seed", "11", "--seed", "12",
                  "--device", "cpu", "--override", json.dumps(TINY[workload])])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert line["correct"] is False, line["checks"]
