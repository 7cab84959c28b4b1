"""render.trace_ms: the median over the orbit's views of the host clock
around the trace alone: a synchronized Renderer.trace_view (ops/raster.py's binning,
sort and lockstep traversal); each view is split into its stages after the window."""
import statistics


def read(run):
    if run["kind"] != "render" or not run.get("stage_ms", {}).get("trace"):
        return None
    return statistics.median(run["stage_ms"]["trace"])
