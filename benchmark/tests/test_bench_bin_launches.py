"""The reader of render.bin_launches_per_frame on synthetic records: the
binning's device calls per frame, and None where the run has nothing to
read, among them a program whose binning spans carry no launches."""
import pytest

from benchmark.registry import Registry

from intrinsic_neural_fields_tpu_torch.ops import launches

MS = 1_000_000
METRIC = "render.bin_launches_per_frame"


def rec(i, name, start, end, parent=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "start_ns": start * MS,
            "end_ns": end * MS, "attrs": attrs}


def run_of(kind, t0=0, t1=100):
    return {"kind": kind, "dev": [], "t0": t0 * MS, "t1": t1 * MS}


@pytest.fixture
def program(monkeypatch):
    served = {"records": [], "dropped": 0}

    def spans(t0, t1):
        return [r for r in served["records"] if t0 <= r["start_ns"] <= t1], served["dropped"]

    monkeypatch.setattr(launches, "spans", spans)
    return served


def read(run):
    return Registry().reader(METRIC)(run)


def frames(bin_attrs):
    """Two frames; the second binned in two shards (a two-device render)."""
    return [rec(1, "render.async", 10, 30),
            rec(2, "raster.bin", 11, 14, 1, **bin_attrs(0)),
            rec(3, "render.async", 40, 60),
            rec(4, "raster.bin", 41, 43, 3, **bin_attrs(1)),
            rec(5, "raster.bin", 44, 46, 3, **bin_attrs(2)),
            rec(6, "render.fetch", 60, 90)]


def test_bin_launches_per_frame(program):
    program["records"] = frames(lambda i: {"launches": 5, "mesh_hit": int(i > 0)})
    assert read(run_of("render")) == pytest.approx(7.5)


def test_nothing_to_read(program, monkeypatch):
    """None for a program before the counter (binning spans without
    launches), a window without binning spans, a train run, an untraced
    run, a ring that dropped records and a program without spans."""
    program["records"] = frames(lambda i: {})
    assert read(run_of("render")) is None
    program["records"] = [r for r in frames(lambda i: {}) if r["name"] != "raster.bin"]
    assert read(run_of("render")) is None
    program["records"] = frames(lambda i: {"launches": 5, "mesh_hit": 1})
    assert read(run_of("render")) is not None
    assert read(run_of("train")) is None
    assert read({"kind": "render"}) is None
    program["dropped"] = 1
    assert read(run_of("render")) is None
    program["dropped"] = 0
    monkeypatch.delattr(launches, "spans")
    assert read(run_of("render")) is None
