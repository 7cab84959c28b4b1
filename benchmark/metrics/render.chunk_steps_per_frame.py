"""render.chunk_steps_per_frame: the lockstep chunk steps ops/raster.py's
traversal runs per frame (attribute chunk_steps of span render.trace: per
packet group its longest tile span, then the overflow chunks), over the
frames of the traced window (spans render.async)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    frames = len(_spans.named(records, "render.async"))
    if not frames:
        return None
    return _spans.attr_sum(records, "render.trace", "chunk_steps") / frames
