"""train_mfu: the model FLOPs of every train step in the traced window
(benchmark/work.py) over the window's seconds times the card's bf16 peak."""
from benchmark import work


def read(run):
    if run["kind"] != "train" or not run["steps"]:
        return None
    flops = work.train_flops_per_ray(run["cfg"]) * run["batch"] * run["steps"]
    peak = work.peaks(run["device_kind"])
    if peak is None:
        return None
    return 100.0 * flops / (run["window_s"] * peak["bf16_flops"])
