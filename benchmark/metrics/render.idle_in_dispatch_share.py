"""render.idle_in_dispatch_share: the share of the traced render window in
which no device operation runs while the host is inside
Renderer.render_async (span render.async: pixels, the trace, the
inference launches)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None or not _spans.named(records, "render.async"):
        return None
    return _spans.idle_inside_share(run, records, "render.async")
