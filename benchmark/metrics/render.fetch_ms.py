"""render.fetch_ms: the median over the orbit's views of the host clock
around render_fetch: the copy of the u8 wire image, already in raster
order, to the host and its one conversion to f32 there; each view is split
into its stages after the window."""
import statistics


def read(run):
    if run["kind"] != "render" or not run.get("stage_ms", {}).get("fetch"):
        return None
    return statistics.median(run["stage_ms"]["fetch"])
