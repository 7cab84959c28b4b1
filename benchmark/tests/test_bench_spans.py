"""The readers of the program's spans (benchmark/metrics/_spans.py and the
metrics built on it), on synthetic records: self time, the device's idle
time inside a span and by innermost span, each epoch's kernels matched by
time, the medians and sums, and None wherever the run has nothing to
read."""
import pytest

from benchmark.metrics import _spans
from benchmark.registry import Registry

from intrinsic_neural_fields_tpu_torch.ops import launches

MS = 1_000_000


def rec(i, name, start, end, parent=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "start_ns": start * MS,
            "end_ns": end * MS, "attrs": attrs}


def run_of(kind, dev=(), t0=0, t1=100):
    """A traced run's record: device ops (name, start ms, end ms), window."""
    return {"kind": kind, "dev": [(n, s * MS, e * MS) for n, s, e in dev],
            "t0": t0 * MS, "t1": t1 * MS}


@pytest.fixture
def program(monkeypatch):
    """Serve `records` (and `dropped`) as the program's spans of a window."""
    served = {"records": [], "dropped": 0}

    def spans(t0, t1):
        return [r for r in served["records"] if t0 <= r["start_ns"] <= t1], served["dropped"]

    monkeypatch.setattr(launches, "spans", spans)
    return served


def read(metric, run):
    return Registry().reader(metric)(run)


def test_union_and_overlap():
    assert _spans.union([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    assert _spans.overlap_ns([(0, 3), (5, 9)], [(2, 6), (8, 20)]) == 1 + 1 + 1


def test_self_time_excludes_children():
    """Self time: the duration less what the children cover, overlapping
    children counted once; with `children`, only those names."""
    epoch = rec(1, "train.epoch", 0, 10)
    records = [epoch, rec(2, "train.hyper_rows", 1, 2, 1), rec(3, "train.replay", 4, 7, 1),
               rec(4, "train.capture", 6, 8, 1), rec(5, "other", 0, 10)]
    assert _spans.self_ns(epoch, records) == (10 - 1 - 4) * MS
    assert _spans.self_ns(epoch, records, {"train.replay"}) == 7 * MS


def test_subtract():
    assert _spans.subtract((0, 10), [(-5, 1), (3, 4), (4, 6), (9, 20)]) == [(1, 3), (6, 9)]
    assert _spans.subtract((0, 10), []) == [(0, 10)]
    assert _spans.subtract((2, 3), [(0, 5)]) == []


def test_idle_by_span():
    """Idle time by the innermost open span: the device busy in [20, 50);
    render.async [10, 60) with child render.trace [12, 25) and its child
    raster.sync [14, 16); render.fetch [70, 90); nothing open elsewhere."""
    run = run_of("render", dev=[("k", 20, 50)])
    records = [rec(1, "render.async", 10, 60), rec(2, "render.trace", 12, 25, 1),
               rec(3, "raster.sync", 14, 16, 2), rec(4, "render.fetch", 70, 90)]
    split = _spans.idle_by_span(run, records)
    assert split == pytest.approx({"render.async": 2 + 10, "render.trace": 6,
                                   "raster.sync": 2, "render.fetch": 20,
                                   "outside": 10 + 10 + 10})
    assert sum(split.values()) == pytest.approx(70.0)  # all of the idle time, once


def test_epoch_kernels_matched_by_time():
    """Each epoch's fwd_bwd kernels are those between its span's start and
    the next epoch's: counted, the first against its replay span; an
    epoch ending past the window is left out."""
    run = run_of("train", t0=0, t1=100, dev=[
        ("fwd_bwd", 4, 5), ("wgrad_adam", 5, 6), ("fwd_bwd", 6, 7),
        ("fwd_bwd", 21, 22), ("fwd_bwd", 24, 25), ("fwd_bwd", 26, 27),
        ("fwd_bwd", 95, 96)])
    records = [rec(1, "train.epoch", 0, 8, steps=2), rec(2, "train.replay", 2, 5, 1),
               rec(3, "train.epoch", 20, 28, steps=3), rec(4, "train.replay", 22, 24, 3),
               rec(5, "train.epoch", 90, 101, steps=2), rec(6, "train.replay", 91, 93, 5)]
    first, second = _spans.epoch_kernels(run, records)
    assert first == {"steps": 2, "kernels": 2, "after_start_ns": 2 * MS, "after_end_ns": -1 * MS}
    # a kernel stamped before its replay's span still falls to its own epoch
    assert second == {"steps": 3, "kernels": 3, "after_start_ns": -1 * MS,
                      "after_end_ns": -3 * MS}


def test_idle_inside_share():
    """The device idle in [0, 20) and [50, 100) of a 100-ms window; the host
    inside render.async in [10, 30) and [40, 60), inside render.fetch in
    [60, 100): 10 + 10 and 40 ms of idle time."""
    run = run_of("render", dev=[("k", 20, 50)])
    records = [rec(1, "render.async", 10, 30), rec(2, "render.async", 40, 60),
               rec(3, "render.fetch", 60, 100)]
    assert _spans.idle_inside_share(run, records, "render.async") == pytest.approx(20.0)
    assert _spans.idle_inside_share(run, records, "render.fetch") == pytest.approx(40.0)


def test_render_readers(program):
    run = run_of("render", dev=[("k", 20, 50)])
    program["records"] = [
        rec(1, "render.async", 10, 30),
        rec(2, "render.trace", 11, 20, 1, chunk_steps=40),
        rec(3, "raster.sync", 15, 18, 2),
        rec(4, "render.infer", 20, 29, 1, rays=100, hits=30),
        rec(5, "render.async", 40, 60),
        rec(6, "render.trace", 41, 50, 5, chunk_steps=20),
        rec(7, "raster.sync", 42, 43, 6),
        rec(8, "raster.sync", 44, 49, 6),
        rec(9, "render.infer", 50, 59, 5, rays=100, hits=50),
        rec(10, "render.fetch", 60, 100),
    ]
    assert read("render.trace_wait_ms", run) == pytest.approx(3.0)
    assert read("render.idle_in_dispatch_share", run) == pytest.approx(20.0)
    assert read("render.idle_in_fetch_share", run) == pytest.approx(40.0)
    assert read("render.hit_share", run) == pytest.approx(40.0)
    assert read("render.chunk_steps_per_frame", run) == pytest.approx(30.0)
    for metric in ("train.turn_ms", "train.graph_launch_ms"):
        assert read(metric, run) is None


def test_train_readers(program):
    run = run_of("train")
    program["records"] = [
        rec(1, "train.epoch", 0, 10, steps=4), rec(2, "train.hyper_rows", 1, 2, 1),
        rec(3, "train.replay", 3, 6, 1), rec(4, "train.prefetch", 10, 11),
        rec(5, "train.epoch", 20, 26, steps=4), rec(6, "train.replay", 21, 25, 5),
        rec(7, "train.epoch", 30, 38, steps=4), rec(8, "train.replay", 31, 33, 7),
    ]
    assert read("train.turn_ms", run) == pytest.approx(6.0)  # 7, 2, 6
    assert read("train.graph_launch_ms", run) == pytest.approx(3.0)  # 3, 4, 2
    assert read("render.hit_share", run) is None


@pytest.mark.parametrize("metric", ["render.trace_wait_ms", "render.idle_in_dispatch_share",
                                    "render.idle_in_fetch_share", "render.hit_share",
                                    "render.chunk_steps_per_frame", "train.turn_ms",
                                    "train.graph_launch_ms"])
def test_nothing_to_read(program, monkeypatch, metric):
    """None for an untraced run, a window with no span, a ring that dropped
    records and a program without spans."""
    kind = metric.split(".")[0]
    full = [rec(1, "render.async", 10, 30),
            rec(2, "render.trace", 11, 20, 1, chunk_steps=4), rec(3, "raster.sync", 15, 18, 2),
            rec(4, "render.infer", 20, 29, 1, rays=100, hits=30),
            rec(5, "render.fetch", 30, 40), rec(6, "train.epoch", 50, 60, steps=1),
            rec(7, "train.replay", 51, 55, 6)]
    program["records"] = full
    assert read(metric, run_of(kind)) is not None
    assert read(metric, {"kind": kind}) is None
    assert read(metric, run_of(kind, t0=200, t1=300)) is None
    program["dropped"] = 1
    assert read(metric, run_of(kind)) is None
    program["dropped"] = 0
    monkeypatch.delattr(launches, "spans")
    assert read(metric, run_of(kind)) is None
