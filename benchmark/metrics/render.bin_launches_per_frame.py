"""render.bin_launches_per_frame: the device calls ops/raster.py's binning
makes per frame (attribute launches of span raster.bin: each hand-written
launch and each sort call), over the frames of the traced window (spans
render.async). A program whose binning spans carry no such attribute has
nothing to read."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    frames = len(_spans.named(records, "render.async"))
    bins = [r for r in _spans.named(records, "raster.bin") if "launches" in r["attrs"]]
    if not frames or not bins:
        return None
    return sum(r["attrs"]["launches"] for r in bins) / frames
