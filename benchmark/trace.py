"""A profiled stretch of a run, reduced to what the per-layer metrics read.

`profiled(fn)` runs `fn` under `torch.profiler` (host operators and device
activity), inside one host span that marks the traced window, writes the
Chrome trace to a temporary file, reads it back and deletes it. `Trace`
keeps the device operations (kernels, copies, fills) and the host
operators, and works out the device's busy time (the union of its
operations' intervals inside the window), the idle gaps between them, and
the breakdown the result line carries.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

WINDOW_SPAN = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """Device operations and host operators of a traced window, times in
    microseconds on the trace's clock."""

    start: float
    end: float
    device: list          # (name, start, end), sorted by start
    host: list            # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        merged = []
        for _, s, e in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, match) -> float:
        """Seconds of the device operations whose name `match` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[name, seconds] of the `n` device operations that took the most
        time in all, longest first."""
        total = collections.Counter()
        for name, s, e in self.device:
            total[name] += (e - s) / 1e6
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """[host activity, seconds] of the `n` longest stretches in which no
        device operation ran, each named by the innermost host operator
        that covered its midpoint, or, where none did (the host was in
        Python), by the operators it ran between."""
        edges = [self.start]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for length, at in gaps:
            mid = at + length / 2
            before = host[:bisect.bisect_right(starts, mid)]
            covering = [h for h in before if h[2] >= mid]
            if covering:
                name = min(covering, key=lambda h: h[2] - h[1])[0]
            else:
                prev = max(before, key=lambda h: h[2])[0] if before else "start"
                after = host[bisect.bisect_right(starts, mid):]
                name = (f"python between {prev} and "
                        f"{after[0][0] if after else 'the end'}")
            out.append([name, length / 1e6])
        return out


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        span = (ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            device.append(span)
        elif cat in HOST_CATS:
            if ev["name"] == WINDOW_SPAN and cat == "user_annotation":
                window = span
            else:
                host.append(span)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    device.sort(key=lambda d: d[1])
    return Trace(start=window[1], end=window[2], device=device, host=host)


def profiled(fn):
    """(fn()'s result, its Trace). The stretch ends in whatever
    synchronisation `fn` makes; a last synchronize closes it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return out, read_chrome_trace(path)
    finally:
        os.remove(path)
