"""The port's tracing: launch counters of its CUDA kernels, and spans and
counters at its layer boundaries, on the clock of the device trace.

Launch counters. Each kernel wrapper adds one to its kernel's count where
it launches the kernel on the card, and nowhere else: a CPU tensor runs the
plain twin and counts nothing. A run sets the counts to 0 just before the
path it checks (``reset_kernel_launches``) and reads them just after.

Spans. ``with span(name, **attrs):`` marks one stage of the program on the
host: a frame's dispatch and fetch, the tracer's binning and its one
device->host read, an epoch's host turn and its graph replay. A span
records only while torch.profiler is profiling (a benchmark's traced
window, the Trainer's ``training.profile_dir`` epoch; ``tracing()`` says
so, for work done only to fill a span); otherwise it returns one shared
null context and reads no clock. A record holds the
name, its id, the id of the innermost span open on the thread when it
opened (its parent), start and end from ``time.time_ns()`` and the
attributes. ``time.time_ns()`` is the clock of the profiler's own stamps,
so spans and the device trace share one clock. Records go into a ring of
2^16 in memory and leave it only when a reader asks (``spans``, or
``add_spans_to_chrome_trace`` beside a profiler's own export); the ring
counts what it drops. ``add(name, n)`` adds to an attribute of the
innermost open span: the counters (rays, hit rays, the tracer's chunk
steps) are span attributes, never entries of the launch counters, which
``train.launches_per_step`` sums whole. An attribute may be a device
tensor: it is read as an int when the records are read.

A span is no ``record_function`` range: kineto copies every such range
onto the device timeline as a user annotation, where it would count as
device time.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch

RING = 1 << 16  # span records kept

_launches = {}  # kernel name -> launches since the last reset
tracing = torch._C._autograd._profiler_enabled  # True while spans record
_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()  # .open: this thread's open spans, innermost last
_lock = threading.Lock()
_ring = collections.deque(maxlen=RING)
_dropped = {"n": 0, "last_start_ns": -1}  # since the last reset


def register(*names):
    """Add kernels to the registry (a module does this when imported)."""
    for name in names:
        _launches.setdefault(name, 0)


def kernel_launches():
    """{kernel: launches since the last reset} for every registered kernel."""
    return dict(_launches)


def reset_kernel_launches():
    """Zero the launch counts and empty the span ring."""
    for name in _launches:
        _launches[name] = 0
    with _lock:
        _ring.clear()
        _dropped.update(n=0, last_start_ns=-1)


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _open()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _open().pop()
        with _lock:
            if len(_ring) == RING:
                _dropped["n"] += 1
                _dropped["last_start_ns"] = max(_dropped["last_start_ns"], _ring[0].start_ns)
            _ring.append(self)
        return False

    def record(self):
        attrs = {k: int(v) if isinstance(v, torch.Tensor) else v for k, v in self.attrs.items()}
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": attrs}


def _open():
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name, **attrs):
    """A context that records the block as a span named `name` with
    `attrs` while torch.profiler is profiling, else the shared null
    context."""
    if not tracing():
        return _OFF
    return _Span(name, attrs)


def add(name, n):
    """Add n (a number or a device tensor) to attribute `name` of the
    innermost span open on this thread; nothing when none is open."""
    stack = getattr(_local, "open", None)
    if stack:
        attrs = stack[-1].attrs
        attrs[name] = attrs[name] + n if name in attrs else n


def spans(t0_ns, t1_ns):
    """(records, dropped): the closed spans that started in [t0_ns, t1_ns],
    in the order they closed, each a dict (name, id, parent, start_ns,
    end_ns, attrs); dropped: the records the ring let go since the last
    reset if any of them started at or after t0_ns, else 0."""
    with _lock:
        kept = [s for s in _ring if t0_ns <= s.start_ns <= t1_ns]
        dropped = _dropped["n"] if _dropped["last_start_ns"] >= t0_ns else 0
    return [s.record() for s in kept], dropped


def add_spans_to_chrome_trace(path, t0_ns, t1_ns):
    """Append the spans that started in [t0_ns, t1_ns] to a Chrome trace
    that torch.profiler exported to `path`: a "program spans" track of
    complete ("X") events on the file's own time base, each with its id,
    parent and attributes as args."""
    records, dropped = spans(t0_ns, t1_ns)
    with open(path) as f:
        trace = json.load(f)
    base, pid, tid = trace.get("baseTimeNanoseconds", 0), os.getpid(), 0
    events = trace["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "program spans"}})
    for r in records:
        events.append({"ph": "X", "cat": "program", "name": r["name"], "pid": pid, "tid": tid,
                       "ts": (r["start_ns"] - base) / 1e3,
                       "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
                       "args": {"id": r["id"], "parent": r["parent"], **r["attrs"]}})
    trace["programSpansDropped"] = dropped
    with open(path, "w") as f:
        json.dump(trace, f)
