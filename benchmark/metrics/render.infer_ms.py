"""render.infer_ms: the median over the orbit's views of the host clock
around a synchronized render_async on the view's cached trace
(ops/interpolate.py, ops/field_infer.py, the composite); each view is split into its stages after the window."""
import statistics


def read(run):
    if run["kind"] != "render" or not run.get("stage_ms", {}).get("infer"):
        return None
    return statistics.median(run["stage_ms"]["infer"])
