"""render.hit_share: the rays that hit the mesh as a share of the rays the
render's inference ran the field on, over the traced window (span
render.infer: attributes hits and rays)."""
from benchmark.metrics import _spans


def read(run):
    if run["kind"] != "render":
        return None
    records = _spans.window(run)
    if records is None:
        return None
    rays = _spans.attr_sum(records, "render.infer", "rays")
    if not rays:
        return None
    return 100.0 * _spans.attr_sum(records, "render.infer", "hits") / rays
