"""render.trace_wait_ms: the median over the traced window's frames of the
host's wait in ops/raster.py traverse's one device->host read (span
raster.sync: the packets' span lengths and the overflow chunk count), which
returns only once every frame queued before it has run."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    return _spans.median_ms([r["end_ns"] - r["start_ns"]
                             for r in _spans.named(records, "raster.sync")])
