"""The reader of render.chunks_tested_per_frame on synthetic records: the
chunks the traversal tested per frame, and None where the run has nothing
to read, a program whose traces carry no chunks_tested among them."""
import pytest

from benchmark.registry import Registry

from intrinsic_neural_fields_tpu_torch.ops import launches

MS = 1_000_000
METRIC = "render.chunks_tested_per_frame"


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


def frames(trace_attrs):
    """Two frames; the second traced in two shards (a two-device render)."""
    return [rec(1, "render.async", 10, 30),
            rec(2, "render.trace", 11, 20, 1, **trace_attrs(0)),
            rec(3, "render.async", 40, 60),
            rec(4, "render.trace", 41, 45, 3, **trace_attrs(1)),
            rec(5, "render.trace", 45, 50, 3, **trace_attrs(2)),
            rec(6, "render.fetch", 60, 90)]


def test_chunks_tested_per_frame(program):
    tested = (700, 300, 200)
    program["records"] = frames(trace_attrs=lambda i: {"chunks": 2 * tested[i],
                                                       "chunks_tested": tested[i]})
    assert read(run_of("render")) == pytest.approx(600.0)


def test_a_trace_may_test_no_chunk(program):
    """A shard whose every chunk the depth bound skips counts 0."""
    program["records"] = frames(trace_attrs=lambda i: {"chunks": 5, "chunks_tested": (0, 3, 1)[i]})
    assert read(run_of("render")) == pytest.approx(2.0)


def test_a_parent_without_the_counter_reads_none(program):
    """The lockstep traversal before the counter: chunk_steps only."""
    program["records"] = frames(trace_attrs=lambda i: {"chunk_steps": 11})
    assert read(run_of("render")) is None


def test_nothing_to_read(program, monkeypatch):
    program["records"] = frames(trace_attrs=lambda i: {"chunks": 4, "chunks_tested": 2})
    assert read(run_of("render")) is not None
    assert read(run_of("train")) is None
    assert read({"kind": "render"}) is None
    assert read(run_of("render", t0=200, t1=300)) is None
    program["dropped"] = 1
    assert read(run_of("render")) is None
    program["dropped"] = 0
    monkeypatch.delattr(launches, "spans")
    assert read(run_of("render")) is None
