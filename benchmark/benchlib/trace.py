"""A profiler window over whole jobs, and what the benchmark reads from it:
device time by kernel, the device's busy seconds, and the idle gaps by
what the host was doing.

The window's method is a frozen copy, as of commit c5dc2a4, of
``bammmotif2_tpu_torch/tools/ab.py::device_ms``: torch.profiler (CPU and
CUDA activities) opened by LEAD_OPS short spin kernels
(``torch.cuda._sleep``), since on an H100 a window lost its first device
operations, window after window, in long processes; the spin kernels lie
before the jobs and are not counted.  Each counted job runs inside a
``record_function`` span named ``SPAN`` + its index, and only activity
between the first span's start and the last one's end counts; the spans'
own records (user annotations, on the host and on the device's timeline)
are not operations.
"""

from __future__ import annotations

import re

LEAD_OPS = 32
SPAN = "bench_job_"


def open_window():
    """A started torch.profiler over CPU and CUDA, its spin kernels
    enqueued and drained."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    for _ in range(LEAD_OPS):
        torch.cuda._sleep(1_000)
    torch.cuda.synchronize()
    return prof


def span(i: int):
    import torch

    return torch.profiler.record_function(f"{SPAN}{i}")


def union(intervals: list) -> list:
    """Sorted, merged [start, end] intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Window:
    """The events of a stopped profiler, read over its job spans: ``t0``,
    ``t1`` (µs) the first span's start and the last one's end."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        spans = [e for e in events if e.name.startswith(SPAN)]
        if not spans:
            raise RuntimeError("the profiler recorded no job span")
        self.t0 = min(e.time_range.start for e in spans)
        self.t1 = max(e.time_range.end for e in spans)
        host_thread = spans[0].thread
        self.device = []  # (start, end, name) of device operations inside [t0, t1]
        self.host = []    # (start, end, name) of host operations of the jobs' thread
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if t <= self.t0 or s >= self.t1:
                continue
            if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN):
                continue  # a span's own records, on the host and the device's timeline
            if e.device_type == DeviceType.CUDA:
                self.device.append((max(s, self.t0), min(t, self.t1), e.name))
            elif e.thread == host_thread:
                self.host.append((s, t, e.name))
        self.busy = union([[s, t] for s, t, _n in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) / 1e6

    def kernel(self, function: str) -> tuple:
        """(launches, device seconds) of the ``__global__`` function named
        ``function`` (any template instance)."""
        pat = re.compile(rf"(^|[\s:]){re.escape(function)}(<|\(|$)")
        hits = [t - s for s, t, n in self.device if pat.search(n)]
        return len(hits), sum(hits) / 1e6

    def device_ops(self, n: int = 10) -> list:
        """The n device operations that took the most time: [[name, s]]."""
        by: dict = {}
        for s, t, name in self.device:
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the window by what the host was doing:
        each gap between device activity goes to the innermost host
        operation running at its middle ("python" where none was), summed
        by name, the n largest: [[name, s]]."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host)
        by: dict = {}
        stack: list = []  # the host operations open at the last point, outermost first
        nxt = 0
        for s, t in gaps:
            mid = 0.5 * (s + t)
            while nxt < len(host) and host[nxt][0] <= mid:
                while stack and stack[-1][1] <= host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "python"
            by[label] = by.get(label, 0.0) + (t - s) / 1e6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
