"""The program's own spans and counters, read where the program has them.

Spans (``gcc_tpu_torch/utils/profiling.py``) record nothing outside a
``tracing()`` body, so a run that opens none pays nothing for them. The
counters (``PretrainPipeline.stats()``, ``models/step_graphs.py``
``counts``) are always on; a window's are the difference of two reads.
A program without one of these gives ``None`` for it. The per-layer
readers take them from a run's record with ``span_mean``.
"""

from __future__ import annotations

import contextlib

from benchmark.harness.common import sync


def _spans_module():
    try:
        from gcc_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "tracing") and hasattr(profiling,
                                                      "span_table")):
        return None
    return profiling


def span_table(run, device):
    """The program's ``span_table()`` of ``run()`` with spans on, the card
    synchronized before and after; ``None``, and ``run`` not called, where
    the program has no spans."""
    prof = _spans_module()
    if prof is None:
        return None
    sync(device)
    with prof.tracing():
        run()
        sync(device)
    return prof.span_table()


def spans_on():
    """A context with the program's spans on (a no-op where it has none):
    under a profiler they are ``gcc.*`` annotations of its trace."""
    prof = _spans_module()
    return prof.tracing() if prof is not None else contextlib.nullcontext()


def pipeline_stats(pipe):
    stats = getattr(pipe, "stats", None)
    return stats() if stats is not None else None


def step_graph_counts():
    try:
        from gcc_tpu_torch.models import step_graphs
    except ImportError:
        return None
    counts = getattr(step_graphs, "counts", None)
    return counts.snapshot() if counts is not None else None


def delta(before, after):
    """``after - before`` key by key; ``None`` where either is."""
    if before is None or after is None:
        return None
    return {k: after[k] - before[k] for k in after}


def span_mean(rec: dict, kind: str, name: str, per: str):
    """Host ms of span ``name`` a ``per`` span in the record's spans table,
    in a record of ``kind``; None where the table lacks either."""
    spans = rec.get("spans") or {}
    if rec.get("kind") != kind or name not in spans \
            or not spans.get(per, {}).get("count"):
        return None
    return spans[name]["total_ms"] / spans[per]["count"]
