"""train.step_roofline: the least time a train step's work needs (its model
FLOPs at the bf16 peak or its least bytes at the HBM peak, whichever is
longer; benchmark/work.py), as a share of the device time of all device
operations per step in the traced window."""
from benchmark import work
from benchmark.metrics import _trace


def read(run):
    if run["kind"] != "train" or "dev" not in run or not run["steps"]:
        return None
    device_s = _trace.device_seconds(run["dev"], run["t0"], run["t1"])
    if device_s <= 0:
        return None
    cfg, B = run["cfg"], run["batch"]
    least = work.least_seconds(work.train_flops_per_ray(cfg) * B,
                               work.train_step_bytes(cfg, B), run["device_kind"])
    if least is None:
        return None
    return 100.0 * least / (device_s / run["steps"])
