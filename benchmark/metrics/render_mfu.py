"""render_mfu: the forward's model FLOPs on the hit rays of every frame in
the traced window (benchmark/work.py; hits by the reference's tracer) over
the window's seconds times the card's bf16 peak."""
from benchmark import work


def read(run):
    if run["kind"] != "render" or not run.get("hit_rays"):
        return None
    flops = work.forward_flops_per_ray(run["cfg"]) * run["hit_rays"]
    peak = work.peaks(run["device_kind"])
    if peak is None:
        return None
    return 100.0 * flops / (run["window_s"] * peak["bf16_flops"])
