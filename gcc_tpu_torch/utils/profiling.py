"""Profiling and observability hooks.

Counterpart of ``gcc_tpu/utils/profiling.py``: the run's JSONL metrics
are always on (``training/loop.py``); this module adds an optional
TensorBoard writer and a ``torch.profiler`` trace context for an
on-device timeline.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """``torch.profiler`` trace (host and, with a card, device activity)
    over the wrapped block when ``trace_dir`` is set; written there as
    ``trace.json`` in Chrome trace format."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


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
