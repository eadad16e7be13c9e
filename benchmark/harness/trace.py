"""A profiled stretch of the timed path, read from the profiler's trace.

The stretch runs under ``torch.profiler`` (host operations and the card's
activity) inside one ``benchmark.stretch`` annotation that ends with a
synchronization, so every device operation it started lies inside it.
From the exported trace: the stretch's length, the seconds in which a
kernel, copy or set ran on the card (overlaps counted once), the kernels'
device time by name and their count, the longest idle gaps labelled by
the host operation that covered them, and, where the stretch ran with the
program's spans on, the idle seconds under each span.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "benchmark.stretch"
# The program's spans are profiler annotations named so.
SPAN_PREFIX = "gcc."
# A kernel's name in the breakdown is cut to this many characters (the
# templates' argument lists run to hundreds).
NAME_CHARS = 100


class Stretch:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.mark = None
        self.wall_s = None
        self.done = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self._t0 = time.perf_counter()
        self._torch = torch

    def stop(self) -> None:
        if self.done:
            return
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)
        self.mark.__exit__(None, None, None)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.done = True

    def read(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        out = summarize(events, self.wall_s)
        out["idle_by_span"] = idle_by_span(events)
        return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _bounds(events):
    """(start, end, True) of the stretch's mark in µs; infinite ends and
    False where the trace has none."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("name") == MARK and e.get("cat") == "user_annotation"]
    if not marks:
        return float("-inf"), float("inf"), False
    lo = float(marks[0]["ts"])
    return lo, lo + float(marks[0]["dur"]), True


def _device_intervals(events, lo, hi):
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= lo or a >= hi:
            continue
        yield e, max(a, lo), min(b, hi)


def _gaps(busy, lo, hi):
    """The idle intervals of the stretch between the merged busy ones."""
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def summarize(events, wall_s: float | None = None, top: int = 10) -> dict:
    """The stretch's numbers from chrome-trace events (times in µs)."""
    lo, hi, marked = _bounds(events)
    dev, kernel_s, launches = [], {}, 0
    for e, a, b in _device_intervals(events, lo, hi):
        dev.append((a, b))
        if e["cat"] == "kernel":
            launches += 1
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) \
                + (b - a) * 1e-6
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    window_s = (hi - lo) * 1e-6 if marked else (wall_s or 0.0)
    gaps = _gaps(busy, lo, hi) if marked else []
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"]) for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("cpu_op", "cuda_runtime")),
                 key=lambda o: o[0])
    starts = [o[0] for o in ops]
    labelled = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        best = None
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, t, name = ops[j]
            if t >= mid and (best is None or t - s < best[0]):
                best = (t - s, name)
            if mid - s > 5e6:
                break
        labelled.append([best[1] if best else "host", (b - a) * 1e-6])
    device_ops = sorted(kernel_s.items(), key=lambda kv: kv[1],
                        reverse=True)[:top]
    return {"window_s": window_s, "busy_s": busy_s, "launches": launches,
            "kernel_s": kernel_s,
            "breakdown": {"device_ops": [[n[:NAME_CHARS], s]
                                         for n, s in device_ops],
                          "idle_gaps": labelled}}


def _host_spans(events, lo, hi):
    """The program's ``gcc.*`` host spans that overlap the stretch, as
    (start, end, name), outer before inner."""
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e["name"]) for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(SPAN_PREFIX)
                   and float(e["ts"]) < hi
                   and float(e["ts"]) + float(e.get("dur", 0.0)) > lo),
                  key=lambda x: (x[0], -x[1]))


def _span_segments(events, lo, hi):
    """The stretch cut at every ``gcc.*`` span's ends: (start, end, the
    innermost open span's name or None), in order."""
    spans = _host_spans(events, lo, hi)
    points = sorted({lo, hi} | {min(max(x, lo), hi) for a, b, _ in spans
                                for x in (a, b)})
    segs, stack, k = [], [], 0
    for a, b in zip(points, points[1:]):
        while stack and stack[-1][1] <= a:
            stack.pop()
        while k < len(spans) and spans[k][0] <= a:
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            if spans[k][1] > a:
                stack.append(spans[k])
            k += 1
        segs.append((a, b, stack[-1][2] if stack else None))
    return segs


def idle_by_span(events) -> dict:
    """Seconds of the stretch with nothing on the card, by the innermost
    of the program's ``gcc.*`` host spans open at the time (the device-side
    projections of spans are not read); {} where the stretch holds no span
    or has no mark."""
    lo, hi, marked = _bounds(events)
    if not marked:
        return {}
    busy = _merge([(a, b) for _, a, b in _device_intervals(events, lo, hi)])
    segs = _span_segments(events, lo, hi)
    starts = [g[0] for g in segs]
    out = {}
    for a, b in _gaps(busy, lo, hi):
        j = max(0, bisect.bisect_right(starts, a) - 1)
        while j < len(segs) and segs[j][0] < b:
            s, t, name = segs[j]
            cut = min(b, t) - max(a, s)
            if name and cut > 0:
                out[name] = out.get(name, 0.0) + cut * 1e-6
            j += 1
    return out
