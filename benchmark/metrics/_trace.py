"""Reading torch.profiler's trace of a window: the device's operations
(kernels, copies, sets) as intervals, the union of them (busy time), the
idle gaps between them, and what the host was doing in each gap.

The harness profiles the window with the CPU and CUDA activities and wraps
its own calls into the program in ``record_function`` ranges named
``bench.*``; those ranges are host activity, never device work. Times are
the profiler's nanosecond stamps (the host's wall clock), so the window's
bounds are taken with ``time.time_ns()``.
"""
from __future__ import annotations

import time

import torch

ANNOTATION = "bench."
NAME_CHARS = 160  # a kernel's name in the breakdown: its template head


class Window:
    """torch.profiler over the block; ``start_ns``/``end_ns`` bound the work
    (the caller ends it with a synchronize); ``events()`` reads the trace."""

    def __init__(self, device_activity=True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device_activity:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        return self.prof.__exit__(*exc)

    def events(self):
        """(device, host): lists of (name, start_ns, end_ns), each sorted by
        start; device operations exclude the harness's own ranges."""
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            rec = (name, start, start + e.duration_ns())
            if e.device_type() == cuda:
                if not name.startswith(ANNOTATION):
                    dev.append(rec)
            else:
                host.append(rec)
        dev.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])
        return dev, host


def busy_intervals(dev, t0, t1):
    """The union of the device intervals, clipped to [t0, t1], as a list of
    disjoint (start, end) in order."""
    out = []
    for _, s, e in dev:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(dev, t0, t1):
    return sum(e - s for s, e in busy_intervals(dev, t0, t1)) / 1e9


def idle_gaps(dev, t0, t1):
    """(start, end) of every stretch of [t0, t1] in which no device
    operation runs."""
    gaps, cur = [], t0
    for s, e in busy_intervals(dev, t0, t1):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def device_seconds(dev, t0, t1, match=None):
    """Summed duration of the device operations inside [t0, t1] whose name
    `match` accepts (all by default)."""
    return sum(min(e, t1) - max(s, t0) for n, s, e in dev
               if e > t0 and s < t1 and (match is None or match(n))) / 1e9


def host_activity(host, gaps):
    """For each gap (in time order), what the host was doing at its
    midpoint: the innermost host range covering it (ranges nest, so the
    latest-starting open one), or "host: none". One sweep over both."""
    names, stack, j = [], [], 0
    for g0, g1 in gaps:
        m = (g0 + g1) // 2
        while j < len(host) and host[j][1] <= m:
            while stack and stack[-1][2] < host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < m:
            stack.pop()
        names.append(stack[-1][0] if stack else "host: none")
    return names


def breakdown(dev, host, t0, t1, top=10):
    """{"device_ops": [[name, seconds]] of the device operations that took
    most time, "idle_gaps": [[host activity, seconds]] of the idle time by
    what the host was doing}, each the `top` largest."""
    by_op = {}
    for n, s, e in dev:
        if e > t0 and s < t1:
            n = n[:NAME_CHARS]
            by_op[n] = by_op.get(n, 0.0) + (min(e, t1) - max(s, t0)) / 1e9
    gaps = idle_gaps(dev, t0, t1)
    by_host = {}
    for (g0, g1), name in zip(gaps, host_activity(host, gaps)):
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e9
    def order(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]

    return {"device_ops": order(by_op), "idle_gaps": order(by_host)}
