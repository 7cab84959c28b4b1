"""render.fetch_ms: the median over the orbit's views of the host clock
around render_fetch: the u8 wire's copy to the host and the scatter into
the image; each view is split into its stages after the window."""
import statistics


def read(run):
    if run["kind"] != "render" or not run.get("stage_ms", {}).get("fetch"):
        return None
    return statistics.median(run["stage_ms"]["fetch"])
