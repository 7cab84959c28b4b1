"""render.chunks_tested_per_frame: the chunks ops/raster.py's traversal
tested per frame (attribute chunks_tested of span render.trace: the chunks
of the packets' walks whose depth bound was below the packet's frontier,
the kernel's count on the card and the plain traversal's on the CPU), over
the frames of the traced window (spans render.async). A program whose
traces carry no such attribute has nothing to read."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    frames = len(_spans.named(records, "render.async"))
    traces = [r for r in _spans.named(records, "render.trace") if "chunks_tested" in r["attrs"]]
    if not frames or not traces:
        return None
    return sum(r["attrs"]["chunks_tested"] for r in traces) / frames
