"""The program's spans land in a profiler's trace as ``user_annotation``
events named ``gcc.*`` (``gcc_tpu_torch/utils/profiling.py``, while a
``tracing()`` body is open), which the profiler also projects onto the
card's timeline as ``gpu_user_annotation`` events. A traced stretch that
holds them reads the same numbers as one that does not."""

from __future__ import annotations

import copy

from benchmark.harness.trace import MARK, summarize


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _stretch():
    """A 1 ms stretch: two launches and their kernels, host ops between,
    and a copy; idle gaps before, between and after."""
    return [
        _x("user_annotation", MARK, 1000.0, 1000.0),
        _x("cpu_op", "aten::copy_", 1010.0, 120.0),
        _x("gpu_memcpy", "Memcpy HtoD", 1100.0, 40.0),
        _x("cpu_op", "aten::mm", 1200.0, 30.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1210.0, 10.0, correlation=1),
        _x("kernel", "gemm", 1230.0, 200.0, correlation=1),
        _x("cpu_op", "aten::add", 1600.0, 20.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1605.0, 8.0, correlation=2),
        _x("kernel", "add", 1700.0, 50.0, correlation=2),
        _x("kernel", "outside", 2500.0, 50.0, correlation=3),
    ]


def test_spans_leave_the_stretch_numbers_alone():
    plain = _stretch()
    spanned = copy.deepcopy(plain) + [
        _x("user_annotation", "gcc.train.dispatch", 1005.0, 900.0),
        _x("user_annotation", "gcc.train.featurize", 1008.0, 150.0),
        _x("user_annotation", "gcc.wire.upload", 1009.0, 125.0),
        _x("user_annotation", "gcc.train.step", 1190.0, 700.0),
        _x("user_annotation", "gcc.train.forward", 1195.0, 300.0),
        _x("user_annotation", "gcc.train.backward", 1590.0, 200.0),
        _x("gpu_user_annotation", "gcc.train.forward", 1100.0, 600.0),
        _x("gpu_user_annotation", "gcc.train.backward", 1700.0, 250.0),
    ]
    a, b = summarize(plain), summarize(spanned)
    assert a == b
    assert a["launches"] == 2 and a["window_s"] == 1000.0 * 1e-6
    assert a["busy_s"] == (40.0 + 200.0 + 50.0) * 1e-6
    assert sorted(g for _, g in a["breakdown"]["idle_gaps"]) == sorted(
        x * 1e-6 for x in (100.0, 90.0, 270.0, 250.0))
