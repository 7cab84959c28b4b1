"""Reading the program's own spans over a traced window: the records of
``intrinsic_neural_fields_tpu_torch/ops/launches.py`` (``span``, ``add``,
``spans``) that started in the window, a span's self time, and the share of
the window in which the device is idle while the host is inside a span of a
given name (the device's idle gaps from ``_trace.idle_gaps``), split by the
innermost span the host was in, and each train epoch's kernels matched to
its graph replay by time. The spans and the device trace share the host's
wall clock, ``time.time_ns()``.

A program without spans, an untraced run, a window that holds no span and
a window from which the program's ring dropped records have nothing to
read: ``window`` gives None, and so does every reader built on it.
"""
from __future__ import annotations

import bisect
import statistics

from benchmark.metrics import _trace


def window(run):
    """The program's span records that started in the traced window, or
    None."""
    if "t0" not in run:
        return None
    from intrinsic_neural_fields_tpu_torch.ops import launches

    read = getattr(launches, "spans", None)
    if read is None:
        return None
    records, dropped = read(run["t0"], run["t1"])
    if dropped or not records:
        return None
    return records


def named(records, name):
    return [r for r in records if r["name"] == name]


def union(intervals):
    """The union of (start, end) intervals as disjoint ones, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a, b):
    """The length of the intersection of two lists of disjoint intervals,
    each in order."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(interval, holes):
    """The parts of one (start, end) interval outside `holes`, disjoint
    intervals in order."""
    s, e = interval
    out, cur = [], s
    for hs, he in holes:
        if he <= cur:
            continue
        if hs >= e:
            break
        if hs > cur:
            out.append((cur, hs))
        cur = max(cur, he)
    if cur < e:
        out.append((cur, e))
    return out


def self_ns(record, records, children=None):
    """The record's duration less the part of it that its child spans
    cover (only the children named in `children`, if given)."""
    kids = [(r["start_ns"], r["end_ns"]) for r in records if r["parent"] == record["id"]
            and (children is None or r["name"] in children)]
    s, e = record["start_ns"], record["end_ns"]
    return (e - s) - overlap_ns([(s, e)], union(kids))


def median_ms(values_ns):
    return None if not values_ns else statistics.median(values_ns) / 1e6


def idle_inside_share(run, records, name):
    """The share (%) of the traced window in which no device operation runs
    while the host is inside a span named `name`."""
    t0, t1 = run["t0"], run["t1"]
    inside = union((max(r["start_ns"], t0), min(r["end_ns"], t1)) for r in named(records, name))
    return 100.0 * overlap_ns(_trace.idle_gaps(run["dev"], t0, t1), inside) / (t1 - t0)


def attr_sum(records, name, attr):
    return sum(r["attrs"].get(attr, 0) for r in named(records, name))


def idle_by_span(run, records):
    """{span name: share (%) of the traced window in which the device is
    idle while that span is the innermost one open on the host} (a span's
    own time: its children's left out), and "outside" for idle time under
    no span."""
    t0, t1 = run["t0"], run["t1"]
    gaps = _trace.idle_gaps(run["dev"], t0, t1)
    gap_starts, gap_ends = [g[0] for g in gaps], [g[1] for g in gaps]
    ids = {r["id"] for r in records}
    kids = {}
    for r in records:
        kids.setdefault(r["parent"], []).append((r["start_ns"], r["end_ns"]))
    own = {}
    for r in records:
        s, e = r["start_ns"], r["end_ns"]
        near = gaps[bisect.bisect_right(gap_ends, s):bisect.bisect_left(gap_starts, e)]
        rest = subtract((s, e), union(kids.get(r["id"], [])))
        own[r["name"]] = own.get(r["name"], 0) + overlap_ns(near, rest)
    top = union((r["start_ns"], r["end_ns"]) for r in records if r["parent"] not in ids)
    own["outside"] = sum(e - s for s, e in gaps) - overlap_ns(gaps, top)
    return {name: 100.0 * ns / (t1 - t0) for name, ns in own.items()}


def epoch_kernels(run, records, kernel="fwd_bwd"):
    """The train epochs that lie inside the traced window, each against the
    device operations whose name holds `kernel` and that start between its
    train.epoch span's start and the next one's (the window's end after
    the last): the host waits for an epoch's loss before the next starts,
    so these are its kernels, matched by time. Per epoch in order: steps,
    kernels (how many), and the first one's start less its train.replay
    span's start (after_start_ns) and end (after_end_ns), None without a
    kernel or a replay."""
    t0, t1 = run["t0"], run["t1"]
    epochs = sorted(named(records, "train.epoch"), key=lambda r: r["start_ns"])
    replay = {r["parent"]: r for r in named(records, "train.replay")}
    starts = sorted(s for n, s, _ in run["dev"] if kernel in n)
    out = []
    for i, ep in enumerate(epochs):
        if ep["end_ns"] > t1:
            continue
        until = epochs[i + 1]["start_ns"] if i + 1 < len(epochs) else t1
        mine = starts[bisect.bisect_left(starts, ep["start_ns"]):bisect.bisect_left(starts, until)]
        rp = replay.get(ep["id"])
        first = mine[0] if mine and rp is not None else None
        out.append({"steps": ep["attrs"].get("steps"), "kernels": len(mine),
                    "after_start_ns": None if first is None else first - rp["start_ns"],
                    "after_end_ns": None if first is None else first - rp["end_ns"]})
    return out
