"""render.idle_in_fetch_share: the share of the traced render window in
which no device operation runs while the host is inside
Renderer.render_fetch (span render.fetch: the copy of the raster-order
wire image to the host, its one conversion to f32)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None or not _spans.named(records, "render.fetch"):
        return None
    return _spans.idle_inside_share(run, records, "render.fetch")
