"""Profiling and observability hooks.

Counterpart of ``gcc_tpu/utils/profiling.py``: the run's JSONL metrics
are always on (``training/loop.py``); this module adds an optional
TensorBoard writer, a ``torch.profiler`` trace of one dispatch for an
on-device timeline, and the program's spans.

Spans split the host's work into named phases (``gcc.train.step``,
``gcc.generate.batch``, ...). They are off unless a :func:`tracing` body
is open: :func:`span` then returns one shared no-op context, calls no
clock and allocates nothing. Inside :func:`tracing` each span records
``(id, name, root, parent, t0_ns, t1_ns)`` on ``time.perf_counter_ns``;
a span opened with no span open around it starts a new root, and the
spans inside it share that root (one dispatch, or one generation call,
is one root). While a ``torch.profiler`` is recording, an open span also
enters ``record_function(name)``, so it is an event of the same trace as
the kernels it launched. Spans are opened only from the thread that
drives the card; the stack of open spans is per thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# Records one tracing() body keeps; spans past it are counted, not kept.
SPAN_CAP = 1 << 16


_NOOP = contextlib.nullcontext()


class _Tracer:
    """The records of the last :func:`tracing` body."""

    def __init__(self):
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.on = False
        self.cap = SPAN_CAP
        self.records: list[tuple] = []
        self.dropped = 0
        self.next_id = 0
        self.next_root = 0

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_tracer = _Tracer()


class _Span:
    __slots__ = ("name", "id", "root", "parent", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tr = _tracer
        stack = tr.stack()
        self.id = tr.next_id
        tr.next_id += 1
        if stack:
            self.parent = stack[-1].id
            self.root = stack[-1].root
        else:
            self.parent = -1
            self.root = tr.next_root
            tr.next_root += 1
        stack.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        tr = _tracer
        tr.stack().pop()
        if len(tr.records) < tr.cap:
            tr.records.append((self.id, self.name, self.root, self.parent,
                               self.t0, t1))
        else:
            tr.dropped += 1
        return False


def span(name: str):
    """A context that times the host's work in its body as span ``name``
    inside a :func:`tracing` body, and is a shared no-op outside one."""
    if not _tracer.on:
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def tracing():
    """Reset the span records and turn spans on for the body.
    :func:`span_table` and :func:`span_records` read this body's records,
    inside it and after it until the next one opens."""
    _tracer.reset()
    _tracer.on = True
    try:
        yield
    finally:
        _tracer.on = False


def span_table() -> dict[str, dict]:
    """Per span name: ``count``, ``total_ms`` (summed durations) and
    ``self_ms`` (each duration less its recorded children's)."""
    child_ns: dict[int, int] = {}
    for _, _, _, parent, t0, t1 in _tracer.records:
        if parent >= 0:
            child_ns[parent] = child_ns.get(parent, 0) + t1 - t0
    table: dict[str, dict] = {}
    for sid, name, _, _, t0, t1 in _tracer.records:
        row = table.setdefault(name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += (t1 - t0) * 1e-6
        row["self_ms"] += (t1 - t0 - child_ns.get(sid, 0)) * 1e-6
    return table


def span_records() -> dict:
    """The raw records in the order the spans closed (children before
    their parent), with the cap and the count that fell past it."""
    keys = ("id", "name", "root", "parent", "t0_ns", "t1_ns")
    return {"cap": _tracer.cap, "dropped": _tracer.dropped,
            "records": [dict(zip(keys, r)) for r in _tracer.records]}


def _no_step() -> None:
    pass


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """With ``trace_dir`` set, a ``torch.profiler`` trace (host and, with
    a card, device activity) of one dispatch: yields ``step``, to be
    called after each dispatch. The first dispatch warms the profiler
    and is not recorded; the second is recorded inside :func:`tracing`,
    then written there as ``trace.json`` (Chrome trace format, the
    ``gcc.*`` spans among its events) and ``spans.json`` (the per-name
    :func:`span_table` under ``table``, and :func:`span_records`). The
    card is synchronized before and after the second dispatch, so the
    trace holds its kernels alone. Later dispatches run with both off; a
    run of one dispatch writes no ``spans.json``. Without ``trace_dir``,
    ``step`` does nothing."""
    if not trace_dir:
        yield _no_step
        return
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    steps = [0]
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=write))

        def step() -> None:
            steps[0] += 1
            if steps[0] > 2:
                return
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.step()
            if steps[0] == 1:
                stack.enter_context(tracing())
                return
            with open(os.path.join(trace_dir, "spans.json"), "w") as f:
                json.dump({"table": span_table(), **span_records()}, f)
            stack.close()

        yield step


class TensorBoardWriter:
    """Optional TensorBoard scalars (torch's writer, imported only when a
    log directory is given; disabled if the tensorboard package is
    missing)."""

    def __init__(self, logdir: str | None):
        self._sw = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._sw = SummaryWriter(logdir)

    def scalar(self, tag: str, value: float, step: int):
        if self._sw is not None:
            self._sw.add_scalar(tag, value, step)

    def close(self):
        if self._sw is not None:
            self._sw.close()
