"""render.fwd_roofline: the least time of the forward's work on a frame's
hit rays (benchmark/work.py; the hits counted by the reference's tracer),
as a share of the device time of the network's launches (kernels named
fused_mlp_fwd) per frame in the traced window."""
from benchmark import work
from benchmark.metrics import _trace


def read(run):
    if run["kind"] != "render" or "dev" not in run or not run.get("hit_rays"):
        return None
    net_s = _trace.device_seconds(run["dev"], run["t0"], run["t1"],
                                  lambda name: "fused_mlp_fwd" in name)
    if net_s <= 0:
        return None
    cfg, frames = run["cfg"], run["frames"]
    hits = run["hit_rays"] / frames
    least = work.least_seconds(work.forward_flops_per_ray(cfg) * hits,
                               work.forward_bytes(cfg, hits), run["device_kind"])
    if least is None:
        return None
    return 100.0 * least / (net_s / frames)
