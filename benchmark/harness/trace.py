"""A profiled stretch of the timed path, read from the profiler's trace.

The stretch runs under ``torch.profiler`` (host operations and the card's
activity) inside one ``benchmark.stretch`` annotation that ends with a
synchronization, so every device operation it started lies inside it.
From the exported trace: the stretch's length, the seconds in which a
kernel, copy or set ran on the card (overlaps counted once), the kernels'
device time by name and their count, and the longest idle gaps labelled by
the host operation that covered them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "benchmark.stretch"
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
        return summarize(events, self.wall_s)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, wall_s: float | None = None, top: int = 10) -> dict:
    """The stretch's numbers from chrome-trace events (times in µs)."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("name") == MARK and e.get("cat") == "user_annotation"]
    if marks:
        lo = float(marks[0]["ts"])
        hi = lo + float(marks[0]["dur"])
    else:
        lo, hi = float("-inf"), float("inf")
    dev, kernel_s, launches = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        dev.append((a, b))
        if e["cat"] == "kernel":
            launches += 1
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) \
                + (b - a) * 1e-6
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    window_s = (hi - lo) * 1e-6 if marks else (wall_s or 0.0)
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi] if marks else []
    for i in range(0, len(edges) - 1, 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
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
