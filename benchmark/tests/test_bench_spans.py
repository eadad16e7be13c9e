"""The program's spans land in a profiler's trace as ``user_annotation``
events named ``gcc.*`` (``gcc_tpu_torch/utils/profiling.py``, while a
``tracing()`` body is open), which the profiler also projects onto the
card's timeline as ``gpu_user_annotation`` events. A traced stretch that
holds them reads the same numbers as one that does not, and its idle time
falls to the innermost span open. The readers of the spans and counters
a run records read only their own kind of record."""

from __future__ import annotations

import copy

import pytest

from benchmark.harness import common
from benchmark.harness.trace import MARK, idle_by_span, summarize


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


# The program's spans over the stretch above, as the profiler exports them:
# host annotations, and their projections onto the card's timeline, which
# idle_by_span does not read.
SPANS = [
    _x("user_annotation", "gcc.train.dispatch", 1005.0, 900.0),
    _x("user_annotation", "gcc.train.featurize", 1008.0, 150.0),
    _x("user_annotation", "gcc.wire.upload", 1009.0, 125.0),
    _x("user_annotation", "gcc.train.step", 1190.0, 700.0),
    _x("user_annotation", "gcc.train.forward", 1195.0, 300.0),
    _x("user_annotation", "gcc.train.backward", 1590.0, 200.0),
    _x("gpu_user_annotation", "gcc.train.forward", 1100.0, 600.0),
    _x("gpu_user_annotation", "gcc.train.backward", 1700.0, 250.0),
]


def test_idle_by_span():
    """Gaps 1000-1100, 1140-1230, 1430-1700, 1750-2000 µs, cut by the
    innermost host span open (device-side annotations ignored)."""
    got = idle_by_span(_stretch() + copy.deepcopy(SPANS))
    want = {"gcc.train.dispatch": 3 + 32 + 15, "gcc.train.featurize": 1 + 18,
            "gcc.wire.upload": 91, "gcc.train.step": 5 + 95 + 100,
            "gcc.train.forward": 35 + 65, "gcc.train.backward": 110 + 40}
    assert got.keys() == want.keys()
    for name, us in want.items():
        assert got[name] == pytest.approx(us * 1e-6), name
    assert idle_by_span(_stretch()) == {}


SPAN_READERS = ("step_host_ms", "featurize_host_ms", "forward_host_ms",
                "backward_host_ms", "optimizer_host_ms", "pipeline_wait_ms",
                "pipeline_ready_items", "embed_batch_host_ms",
                "embed_fetch_wait_ms", "idle_in_batch.embed",
                "train_replayed_share")
EMBED_READERS = ("embed_batch_host_ms", "embed_fetch_wait_ms",
                 "idle_in_batch.embed")


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_and_counter_readers_are_silent_off_their_kind(name):
    """Each reader gives None on a record of the other kind and on one
    from a program without spans or counters, and a number on a full one
    of its own kind."""
    read = common.metric_reader(name)
    spans = {n: {"count": 2, "total_ms": 4.0, "self_ms": 1.0}
             for n in ("gcc.train.dispatch", "gcc.train.featurize",
                       "gcc.train.step", "gcc.train.forward",
                       "gcc.train.backward", "gcc.train.optimizer",
                       "gcc.generate.call", "gcc.generate.batch",
                       "gcc.generate.fetch")}
    full = {"device": "cuda", "spans": spans,
            "pipeline": {"gets": 4, "wait_ns": 8e6, "ready_items": 16},
            "step_graphs": {"replays": 62, "captures": 2, "eager": 2},
            "trace": {"window_s": 1.0, "busy_s": 0.5,
                      "idle_by_span": {"gcc.generate.batch": 0.25}}}
    own, other = (("embed", "pretrain") if name in EMBED_READERS
                  else ("pretrain", "embed"))
    assert read({"kind": other, **full}) is None
    assert read({"kind": own}) is None
    bare = {**full, "spans": None, "pipeline": None, "step_graphs": None,
            "trace": {**full["trace"], "idle_by_span": {}}}
    assert read({"kind": own, **bare}) is None
    assert read({"kind": own, **full}) > 0


def test_replayed_share_reads_the_card_only():
    read = common.metric_reader("train_replayed_share")
    counts = {"replays": 124, "captures": 2, "eager": 4}
    assert read({"kind": "pretrain", "device": "cuda",
                 "step_graphs": counts}) == pytest.approx(100.0 * 124 / 128)
    assert read({"kind": "pretrain", "device": "cpu",
                 "step_graphs": counts}) is None
